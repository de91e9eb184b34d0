"""A tiny copy of the benchmark for CPU runs: the harness's files, the
real BENCHMARK.json and its files, and two tiny configurations (flat and
sq8r, 20,000 x 32) with a batch cell each, added as new files and
entries the way a later change adds a configuration or a cell."""
from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
sys.path[:0] = [str(BENCH), str(REPO)]

TINY_ROWS, TINY_DIM = 20_000, 32
# limits of the tiny configurations, from their own readings on the CPU
# (program: recall_short <= 0.0035 / 0.0134, score_err <= 0.0013 / 0.0055;
# control >= 0.0138 / 0.0612 and 0.0062 / 0.0287, flat / sq8r, seeds 1-6)
TINY_LIMITS = {
    "flat": {"wrong_answers": 0, "unanswered": 0, "recall_short": 0.007, "score_err": 0.003},
    "sq8r": {"wrong_answers": 0, "unanswered": 0, "recall_short": 0.03, "score_err": 0.012},
}


def add_tiny(root: Path) -> None:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for src, name, kind in (("sift1m-flat", "tiny-flat", "flat"),
                            ("deep10m-sq8r", "tiny-sq8r", "sq8r")):
        cfg = json.loads((BENCH / "configs" / f"{src}.json").read_text())
        cfg.update(name=name, dataset=name, rows=TINY_ROWS, dim=TINY_DIM,
                   limits=TINY_LIMITS[kind])
        if kind == "sq8r":
            cfg.update(index_params={"n_clusters": 64},
                       puts={"first": 4096, "each": 4096, "last": 1000})
        else:
            cfg["puts"] = {"first": 4096, "each": 4096, "last": 0}
        (root / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "a test", "reduced": [], "why": "a test",
                                "file": f"portbench/configs/{name}.json"})
        cell = f"{name}.batch"
        spec["workloads"].append({"name": cell, "config": name, "traffic": "batch",
                                  "chips": 1, "why": "a test"})
        for m in spec["end_to_end"] + spec["per_layer"]:  # the metrics of its source's cell
            if f"{src}.batch" in m.get("workloads", []):
                m["workloads"].append(cell)
    p = root / "portbench" / "mixes" / "batch.json"
    p.write_text(json.dumps(dict(json.loads(p.read_text()), batch=500, callers=2,
                                 client_cores=1, check_queries=1000)))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def copy_bench(root: Path) -> Path:
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A checkout-like root with the tiny cells; its run.py imported."""
    root = copy_bench(tmp_path)
    add_tiny(root)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(REPO)] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    monkeypatch.setenv("LONGBOW_LOG_LEVEL", "warning")
    return root


def run_tiny(root: Path, cell: str, seed: int, trace: int, capsys, seconds: float = 2.0):
    """main() of the copy's run.py on the CPU -> (exit code, result or None)."""
    import run

    monkey_bench = root / "portbench"
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], device="cpu", bench=monkey_bench)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if rc == 0 and out else None)
