"""spansplit.py: the join of device intervals to the program's spans, the
idle split and the window's clipping, on synthetic events; and a tiny
traced run on the CPU, where the program's store spans agree with the
harness's wraps of VectorStore.search."""
from __future__ import annotations

import json

import pytest

import spansplit as sp

DISPATCH, HANDLER = 501, 502  # native ids
# the threads' idents; the dispatch thread's low 32 bits read negative as
# a signed runtime resource id
THREADS = {DISPATCH: (0x7F12_8000_1000, "longbow-coalesce-0"), HANDLER: (0x7F12_0000_2000, "h")}


def call(corr: int, t0: int, thread: int) -> sp.Event:
    low = THREADS[thread][0] & 0xFFFFFFFF
    signed = low - (1 << 32) if low >= 1 << 31 else low
    return sp.Event("cudaLaunchKernel", True, t0, t0 + 5, corr, 0, signed, "cuda_runtime")


def kernel(name: str, corr: int, t0: int, t1: int) -> sp.Event:
    return sp.Event(name, False, t0, t1, corr, corr, 7, "kernel")


def span(name: str, thread: int, t0: int, t1: int) -> tuple:
    return (name, thread, t0, t1, {})


SPANS = [
    span("longbow.coalescer.idle", DISPATCH, 0, 100),
    span("longbow.store.search", DISPATCH, 100, 400),
    span("longbow.sq8r.main", DISPATCH, 110, 200),
    span("longbow.sq8r.delta", DISPATCH, 200, 300),
    span("longbow.dataset.answer", DISPATCH, 330, 390),
    span("longbow.coalescer.idle", DISPATCH, 400, 600),
    span("longbow.coalescer.queue", HANDLER, 50, 100),
    span("longbow.edge.encode", HANDLER, 410, 430),
]
EVENTS = [
    # an aten op whose correlation id collides with a runtime call's
    sp.Event("aten::add", True, 0, 1, 2, 0, HANDLER, "cpu_op"),
    call(1, 120, DISPATCH), kernel("scan_wgmma_kernel<signed char, 128>", 1, 130, 180),
    call(2, 210, DISPATCH), kernel("topk", 2, 220, 320),
    # launched on the dispatch thread between its spans' ends: under the store only
    call(3, 310, DISPATCH), kernel("copy", 3, 320, 325),
    # launched by the handler thread: under no dispatch span
    call(4, 415, HANDLER), kernel("elementwise", 4, 440, 450),
]


def test_a_kernel_is_joined_by_correlation_to_the_span_that_launched_it():
    got = {x[0]: x for x in sp.launches(EVENTS, THREADS, 0, 1000)}
    assert got["topk"][3:] == (DISPATCH, 210)  # the runtime call, not the aten op
    assert got["elementwise"][3:] == (HANDLER, 415)
    # a thread the profiler saw record CPU ops: its calls carry its system id
    seen = [sp.Event("cudaLaunchKernel", True, 500, 505, 5, 0, DISPATCH, "cuda_runtime"),
            kernel("by_system_id", 5, 510, 520)]
    assert sp.launches(seen, THREADS, 0, 1000)[0][3:] == (DISPATCH, 500)
    under = sp.device_under(list(got.values()), SPANS)
    assert under["longbow.sq8r.main"] == pytest.approx(50e-9)
    assert under["longbow.sq8r.delta"] == pytest.approx(100e-9)
    assert under["longbow.store.search"] == pytest.approx(155e-9)  # main, delta, the copy
    assert under["longbow.dataset.answer"] == 0.0


def test_a_kernel_launched_outside_every_span_counts_nowhere():
    stray = [call(9, 700, DISPATCH), kernel("stray", 9, 710, 720),
             kernel("unjoined", 99, 730, 740)]
    got = sp.launches(EVENTS + stray, THREADS, 0, 1000)
    under = sp.device_under(got, SPANS)
    assert under["outside"] == pytest.approx(30e-9)  # the handler's 10, stray 10, unjoined 10
    assert sum(v for k, v in under.items() if k not in ("outside", "longbow.store.search")) \
        == pytest.approx(150e-9)
    (unjoined,) = [x for x in got if x[0] == "unjoined"]
    assert unjoined[3:] == (None, None)


def test_idle_overlaps_the_dispatch_threads_empty_queue():
    got = sp.launches(EVENTS, THREADS, 0, 1000)
    idle, split = sp.idle_by_span(got, SPANS, DISPATCH, 0, 1000)
    # busy: 130-180, 220-325, 440-450 -> idle 1000 - 165
    assert idle == pytest.approx(835)
    # the empty queue: 0-100 and 400-600, both idle but 440-450
    assert split["longbow.coalescer.idle"] == pytest.approx(100 + 190)
    assert split["longbow.dataset.answer"] == pytest.approx(60)
    assert split["longbow.sq8r.main"] == pytest.approx(40)  # 110-130, 180-200
    # the handler's spans are not the dispatch thread's
    _, other = sp.idle_by_span(got, SPANS, HANDLER, 0, 1000)
    assert other["longbow.coalescer.idle"] == 0.0


def test_spans_and_intervals_are_clipped_to_the_window():
    lo, hi = 150, 500
    got = sp.launches(EVENTS, THREADS, lo, hi)
    assert {x[0]: x[1:3] for x in got}["scan_wgmma_kernel<signed char, 128>"] == (150, 180)
    idle, split = sp.idle_by_span(got, SPANS, DISPATCH, lo, hi)
    assert idle == pytest.approx(350 - 30 - 105 - 10)
    assert split["longbow.coalescer.idle"] == pytest.approx(90)  # 400-500 less 440-450
    r = sp.readings(SPANS, got, lo, hi, is_k2=lambda n: "signed char" in n)
    # the window's store searches: none begins inside [150, 500]
    assert r["store_searches"] == 0 and r["store.main_device_ms"] is None
    assert r["coalescer.wait_ms"] is None  # the queue wait began before the window
    assert r["edge.encode_ms"] == pytest.approx(20e-6)
    r = sp.readings(SPANS, sp.launches(EVENTS, THREADS, 0, 1000), 0, 1000,
                    is_k2=lambda n: "signed char" in n)
    assert r["store_searches"] == 1 and r["dispatch_thread"] == DISPATCH
    assert r["store.main_device_ms"] == pytest.approx(50e-6)
    assert r["store.delta_device_ms"] == pytest.approx(100e-6)
    assert r["store.answer_ms"] == pytest.approx(60e-6)
    assert r["coalescer.wait_ms"] == pytest.approx(50e-6)
    assert r["device.idle_starved"] == pytest.approx(290 / 1000)
    assert r["device.idle_starved"] <= r["device.idle"]
    assert r["k2_share_under_main"] == 1.0


def test_clock_mapping_and_agreement():
    mapped = sp.on_profiler_clock([span("longbow.store.search", 1, 1_000, 2_000)], 500, 10_500)
    assert mapped[0][2:4] == (11_000, 12_000)
    program = [span("longbow.store.search", 1, 1_000_000_100, 1_000_000_900),
               span("longbow.store.search", 1, 2_000_000_000, 2_000_000_500)]
    harness = [(50, 1.0, 1.000001), (50, 2.0, 2.0000004)]
    a = sp.agreement(program, harness)
    assert (a["program_n"], a["harness_n"], a["inside"]) == (2, 2, 1)
    assert a["program_s"] == pytest.approx(1.3e-6)


def test_tiny_traced_run_agrees_with_the_harness(tiny_root, capsys):
    rc = sp.main(["--workload", "tiny-sq8r.batch", "--seed", "3000000021", "--seconds", "2",
                  "--device", "cpu"], bench=tiny_root / "portbench")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"] is True
    a = out["agree"]
    assert a["program_n"] == a["harness_n"] == a["inside"] > 0
    assert abs(a["program_s"] - a["harness_s"]) <= 0.05 * a["harness_s"]
    for m in ("coalescer.wait_ms", "store.answer_ms", "edge.encode_ms"):
        assert out[m] > 0, m
    for m in ("store.main_device_ms", "store.delta_device_ms", "device.idle_starved"):
        assert out[m] is None, m  # no device intervals on the CPU
    assert out["dropped"] == 0 and out["records"] > 0
    import devtrace
    import run

    assert devtrace.DeviceTrace.stop.__qualname__ == "DeviceTrace.stop"  # wraps undone
    assert run.merge.__qualname__ == "merge"
