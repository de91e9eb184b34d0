"""The sift1m-hnsw configuration at a test's size on the CPU: a tiny copy
(20,000 x 32, M 16, m_max 32, efConstruction 200, ef_search 150; a bulk
build, then a 1,000-row put through the incremental insert), run through
the port's Flight server against the reference with and without the
trace, and once with the beam loop cut to its entry scan, which must read
`correct` false."""
from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import BENCH, REPO, TINY_DIM, TINY_ROWS, copy_bench, run_tiny

CELL = "tiny-hnsw.batch"
# from the tiny copy's own readings on the CPU, nearer the control
# (program: recall_short <= 0.0039, score_err <= 0.00130; control >= 0.0125
# and 0.0061, seeds 1-6)
LIMITS = {"wrong_answers": 0, "unanswered": 0, "recall_short": 0.009, "score_err": 0.004}
SETUP = {"setup.before_runtime_s", "setup.data_s", "setup.warm_flight_s"}


def add_tiny_hnsw(root) -> None:
    """The tiny configuration and its batch cell, added the way
    sift1m-hnsw and sift1m-hnsw.batch were: new files and appended
    entries, the cell appended to the metrics of its source's cell."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "sift1m-hnsw.json").read_text())
    cfg.update(name="tiny-hnsw", dataset="tiny-hnsw", rows=TINY_ROWS, dim=TINY_DIM,
               limits=LIMITS, puts={"first": 16_384, "each": 4_096, "last": 1_000})
    (root / "portbench" / "configs" / "tiny-hnsw.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "tiny-hnsw", "source": "a test", "reduced": [],
                            "why": "a test", "file": "portbench/configs/tiny-hnsw.json"})
    spec["workloads"].append({"name": CELL, "config": "tiny-hnsw", "traffic": "batch",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "sift1m-hnsw.batch" in m.get("workloads", []):
            m["workloads"].append(CELL)
    p = root / "portbench" / "mixes" / "batch.json"
    p.write_text(json.dumps(dict(json.loads(p.read_text()), batch=500, callers=2,
                                 client_cores=1, check_queries=1000)))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture
def hnsw_root(tmp_path, monkeypatch):
    """A checkout-like root with the tiny hnsw cell. The run leaves the
    server every core but the callers' one; torch, imported here before
    that, would keep a thread on each core and oversubscribe them (the
    1,000-row insert took 137 s against 6)."""
    root = copy_bench(tmp_path)
    add_tiny_hnsw(root)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(REPO)] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    monkeypatch.setenv("LONGBOW_LOG_LEVEL", "warning")
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) - 1))
    yield root
    torch.set_num_threads(threads)


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_hnsw_run(hnsw_root, capsys, trace):
    rc, res = run_tiny(hnsw_root, CELL, 3_000_000_019, trace, capsys)
    assert rc == 0 and res is not None
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    names = set(res["metrics"])
    if trace:
        assert names == SETUP | {"graph.iters.hnsw"}
        assert res["metrics"]["graph.iters.hnsw"]["value"] > 1
    else:
        assert names == {"recall_at_10", "setup_s"}
        assert all(v["value"] > 0 for v in res["metrics"].values())


def entry_scan_only(state, queries, sample_rows, k, ef, *, stats=None, normalize=False, **kw):
    """beam_search with its loop cut: the entry scan's best k rows."""
    from longbow_tpu_torch.index.graph import entry_candidates

    qf = queries.float()
    d, r = entry_candidates(state, qf, (qf * qf).sum(dim=1, keepdim=True), sample_rows,
                            min(k, sample_rows.shape[0]))
    if stats is not None:
        stats.update(iters=0, distances=torch.zeros((), dtype=torch.int64))
    return d, r.int()


def test_loop_cut_to_its_entry_scan_is_not_correct(hnsw_root, capsys, monkeypatch):
    monkeypatch.setattr("longbow_tpu_torch.index.hnsw.beam_search", entry_scan_only)
    rc, res = run_tiny(hnsw_root, CELL, 91, 0, capsys)
    assert rc == 0 and res["correct"] is False, res["checks"]
    assert res["checks"]["recall_short"]["value"] > LIMITS["recall_short"]


def test_graph_readers_from_the_counters(monkeypatch):
    """layers/graph.py on counters written by hand: iterations a call, and
    the loop's roofline share from the window's store spans; nothing from
    a registry where no graph search ran (the counters at 0)."""
    import run

    import longbow_tpu_torch.metrics.registry as registry
    from roofline import peaks

    monkeypatch.setattr(registry, "_global", registry.MetricsRegistry())
    read = run.find_reader("graph.loop_roofline.hnsw", BENCH)
    server = {"hnsw_m_max": 32, "hnsw_search_expand": 4}
    ctx = {"trace": {"busy_s": 2.0}, "device_name": "NVIDIA H100 80GB HBM3", "seconds": 45.0,
           "config": {"dim": 128, "row_bytes": 2, "server": server},
           "spans": {"store": [(2_000, 0.1, 0.2), (1_000, 9.0, 9.1), (4_000, 46.0, 46.1)]}}
    assert read(ctx, "graph.iters.hnsw") is None
    reg = registry.get_registry()
    for name, v in (("searches", 2), ("queries", 4_000), ("beam_iterations", 80),
                    ("distance_calculations", 4_000 * 2_500)):
        reg.inc(f"longbow_hnsw_{name}_total", v)
    assert read(ctx, "graph.iters.hnsw") == 40
    bw, flops = peaks(ctx["device_name"])
    q_bytes = 2_500 * (128 * 2 + 4 + 4) + 40 * 4 * 32 * 4
    least = max(q_bytes / bw, 2 * 128 * 2_500 / flops)
    assert read(ctx, "graph.loop_roofline.hnsw") == pytest.approx(100 * 3_000 * least / 2.0)
