"""The metric arithmetic on synthetic records."""
from __future__ import annotations

import numpy as np
import pytest

import measure
import roofline
from devtrace import reduce_trace


def test_window_rate_is_all_work_over_all_time():
    done = np.array([0.5, 1.0, 9.9, 10.0, 10.2, 3.0])
    ok = np.array([True, True, True, True, True, False])
    # 4 answered inside [0, 10] of 1,000 queries each; one late, one failed
    assert measure.window_rate(done, ok, 1000, 10.0) == pytest.approx(400.0)


def test_roofline_from_shapes():
    bw, flops = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert (bw, flops) == (3.35e12, 989e12)
    t, by = roofline.least_seconds(1000, 1_000_000, 128, 64, 2, bw, flops)
    assert by == "operations" and t == pytest.approx(2 * 1000 * 1_000_000 * 128 / 989e12)
    t1, by1 = roofline.least_seconds(1, 1_000_000, 128, 64, 2, bw, flops)
    moved = 1_000_000 * 128 * 2 + 1_000_000 * 5 + 128 * 4 + 64 * 8
    assert by1 == "bytes" and t1 == pytest.approx(moved / bw)
    assert roofline.scan_bytes(2, 10, 96, 64, 1, groups=3) == 10 * 96 + 50 + 2 * 3 * 2 + 2 * 96 * 4 + 2 * 64 * 8
    with pytest.raises(KeyError):
        roofline.peaks("a CPU")


def test_kernel_share():
    ctx = {"device_name": "NVIDIA H100 80GB HBM3", "seconds": 10.0,
           "scan": {"rows": 1_000_000, "dim": 128, "pool": 64, "row_bytes": 2, "groups": 0},
           "spans": {"store": [(1000, 1.0, 1.01), (1000, 2.0, 2.01), (1000, 11.0, 11.01)]},
           "trace": {"kernels": [("void scan_wgmma_kernel<__nv_bfloat16, 2, 64>(WScanArgs)", 1.0, 1.001),
                                 ("void scan_wgmma_kernel<__nv_bfloat16, 2, 64>(WScanArgs)", 2.0, 2.001),
                                 ("aten::topk", 2.0, 2.5)]}}
    least = 2 * (2 * 1000 * 1_000_000 * 128 / 989e12)
    share = roofline.kernel_share(ctx, lambda n: "scan_wgmma_kernel" in n)
    assert share == pytest.approx(100 * least / 0.002)
    assert roofline.kernel_share(ctx, lambda n: "fused_codes" in n) is None


def test_idle_share_from_a_synthetic_trace():
    device = [("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("memcpy", 3.0, 3.5), ("k1", 9.0, 11.0)]
    host = [("aten::to", 2.1, 2.9), ("portbench.store.search", 1.5, 3.6),
            ("python", 3.6, 3.7)]
    tr = reduce_trace(device, host, (0.0, 10.0))
    assert tr["window_s"] == 10.0
    assert tr["busy_s"] == pytest.approx(2.0 + 0.5 + 1.0)
    gaps = dict((n, s) for n, s in tr["idle_gaps"])
    # the gaps [2, 3) and [3.5, 9) began inside the search span (aten::to
    # began after the first gap did)
    assert gaps == pytest.approx({"portbench.store.search": 1.0 + 5.5})
    tr = reduce_trace(device, host + [("aten::item", 1.9, 2.2)], (0.0, 10.0))
    assert dict((n, s) for n, s in tr["idle_gaps"]) == pytest.approx(
        {"aten::item": 1.0, "portbench.store.search": 5.5})
    assert dict(tr["device_ops"])["k1"] == pytest.approx(2.0)
    with pytest.raises(RuntimeError):
        reduce_trace(device, host, None)


def test_union_and_gaps():
    iv = np.array([[0, 1], [0.5, 2], [5, 6]], float)
    assert measure.union_seconds(iv, 0, 10) == pytest.approx(3.0)
    assert measure.idle_gaps(iv, 0, 10).tolist() == [[2.0, 5.0], [6.0, 10.0]]


def test_callers_merged():
    import run

    def caller(req, send, done, pick):
        k = 2
        return {"request": np.array(req), "send": np.array(send), "done": np.array(done),
                "ok": np.ones(len(req), bool), "queries_per_request": np.int64(3),
                "cpu_s": np.float64(0.5), "check_request": np.array(pick),
                "check_ids": np.zeros((3 * len(pick), k), np.int64),
                "check_scores": np.zeros((3 * len(pick), k), np.float32),
                "errors": np.zeros(0, str)}

    got = run.merge([caller([0, 2], [0.0, 0.5], [0.4, 0.9], [2]),
                     caller([1, 3], [0.0, 0.3], [0.1, 0.8], [1])])
    assert got["request"].tolist() == [0, 2, 1, 3] and got["queries_per_request"] == 3
    # request r holds the stream's queries 3r, 3r + 1, 3r + 2
    assert got["check_query"].tolist() == [6, 7, 8, 3, 4, 5]
    # each caller's answer-to-next-send: 0.1 and 0.2 s
    assert got["turnaround_ms"]["mean"] == pytest.approx(150.0)
    assert got["turnaround_ms"]["max"] == pytest.approx(200.0)
    assert got["client_cpu_s"] == [0.5, 0.5]
