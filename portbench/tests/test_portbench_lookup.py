"""The harness finds configurations, mixes and per-layer readers by the
names in BENCHMARK.json, and a new one is new files plus new entries."""
from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path

import run
from conftest import BENCH, REPO, copy_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_cell_resolves():
    s = spec()
    for w in s["workloads"]:
        c = run.load_cell(w["name"])
        assert c["config"]["name"] == w["config"]
        assert c["mix"]["loop"] == "closed" and c["mix"]["callers"] >= 1
        names = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert c["per_layer"], w["name"]
        for m in c["per_layer"]:
            assert callable(run.find_reader(m["name"]))


def test_contract_shape():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert s["paths"] == ["portbench"] and s["command"][1] == "portbench/run.py"
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).exists() and c["file"].startswith("portbench/")
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert m["moves"] in {e["name"] for e in s["end_to_end"]}
        for w in m["workloads"]:
            e2e = next(e for e in s["end_to_end"] if e["name"] == m["moves"])
            assert w in e2e.get("workloads", [w])
    assert all(m["unit"] == "%" for m in s["per_layer"] if m["name"].endswith("_roofline"))


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_added_config_mix_and_metric_need_no_edit(tmp_path):
    root = copy_bench(tmp_path)
    before = _digests(root)
    bench = root / "portbench"
    (bench / "configs" / "extra.json").write_text(json.dumps(
        dict(json.loads((BENCH / "configs" / "sift1m-flat.json").read_text()),
             name="extra", rows=1234)))
    (bench / "mixes" / "eval.json").write_text(json.dumps(
        dict(json.loads((BENCH / "mixes" / "batch.json").read_text()), callers=8, batch=4000)))
    (bench / "mixes" / "eval").mkdir()
    (bench / "mixes" / "eval" / "extra.json").write_text(json.dumps({"batch": 2000}))
    (bench / "layers" / "extra.metric.py").write_text(
        "def read(ctx, metric):\n    return 42.0\n")
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "extra", "source": "x", "file": "portbench/configs/extra.json",
                         "reduced": [], "why": "x"})
    s["workloads"].append({"name": "extra.eval", "config": "extra", "traffic": "eval",
                           "chips": 1, "why": "x"})
    s["per_layer"].append({"name": "extra.metric.eval", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "Store", "moves": "setup_s",
                           "workloads": ["extra.eval"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    c = run.load_cell("extra.eval", bench)
    assert c["config"]["rows"] == 1234 and c["mix"]["callers"] == 8
    assert c["mix"]["batch"] == 2000  # the mix's file for this configuration over the mix
    assert [m["name"] for m in c["per_layer"]] == ["extra.metric.eval"]
    assert run.find_reader("extra.metric.eval", bench)({}, "extra.metric.eval") == 42.0
    after = _digests(root)
    changed = [p for p, d in before.items() if after.get(p) != d]
    assert changed == [Path("BENCHMARK.json")]
