"""The port's span recorder (utils/tracing.py) and the spans on its search
path: off, a span costs a check and records nothing; on, spans from every
thread come back with their names, threads, nesting and attributes, on a
clock that the anchor ties to torch.profiler's; and the store's span sits
at the boundary that the benchmark's own wrap of VectorStore.search times."""
from __future__ import annotations

import json
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from longbow_tpu_torch.metrics import get_registry
from longbow_tpu_torch.serving.coalescer import SearchCoalescer
from longbow_tpu_torch.serving.flight_handlers import (
    CollectingWriter, ExchangeChunk, FlightHandlers,
)
from longbow_tpu_torch.storage.arrow_ipc import Table
from longbow_tpu_torch.store.vector_store import VectorStore
from longbow_tpu_torch.utils import tracing


@pytest.fixture
def recorder():
    """Starts the recorder; stops it after the test if the test did not."""
    tracing.start()
    yield
    if tracing.recording():
        tracing.stop()


def _by_name(records) -> dict:
    out: dict = {}
    for r in records:
        out.setdefault(r[0], []).append(r)
    return out


def _inside(inner, outer) -> bool:
    return inner[1] == outer[1] and outer[2] <= inner[2] and inner[3] <= outer[3]


def test_span_off_is_a_shared_noop_that_allocates_nothing(monkeypatch):
    assert not tracing.recording()

    def refuse(*a, **kw):
        raise AssertionError("a span opened a profiler range while the recorder was off")

    monkeypatch.setattr("torch.profiler.record_function", refuse)
    assert tracing.span("longbow.a") is tracing.span("longbow.b", rows=3)
    with tracing.span("longbow.a"):  # warm: the first call may cache
        pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(10_000):
            with tracing.span("longbow.a"):
                pass
            tracing.interval("longbow.q", 0, 1)
        grown = tracemalloc.take_snapshot().compare_to(before, "filename")
    finally:
        tracemalloc.stop()
    assert not [s for s in grown if s.traceback[0].filename == tracing.__file__
                and s.size_diff > 0]
    text = get_registry().text()
    assert b"longbow_trace_spans_total{" not in text
    assert b"longbow_tpu_span_duration_seconds_count{" not in text
    monkeypatch.undo()
    tracing.start()
    assert tracing.stop().records == []  # nothing from before the start


def test_spans_from_two_threads_nest_with_their_attributes(recorder):
    main = threading.get_native_id()
    seen = {}

    def other():
        seen["tid"], seen["ident"] = threading.get_native_id(), threading.get_ident()
        with tracing.span("longbow.t.outer", rows=7):
            with tracing.span("longbow.t.inner"):
                time.sleep(0.002)
        t1 = time.perf_counter_ns()
        tracing.interval("longbow.t.queue", seen["t0"], t1, thread=main, requests=2)

    with tracing.span("longbow.m.outer", who="main"):
        seen["t0"] = time.perf_counter_ns()
        th = threading.Thread(target=other, name="tracing-other")
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
        with tracing.span("longbow.m.inner"):
            pass
    tr = tracing.stop()
    assert tr.dropped == 0 and tr.anchor_ns > 0
    by = _by_name(tr.records)
    assert {n: len(v) for n, v in by.items()} == {
        "longbow.t.inner": 1, "longbow.t.outer": 1, "longbow.t.queue": 1,
        "longbow.m.inner": 1, "longbow.m.outer": 1}
    (mo,), (mi,), (to,), (ti,), (tq,) = (by[n] for n in (
        "longbow.m.outer", "longbow.m.inner", "longbow.t.outer", "longbow.t.inner",
        "longbow.t.queue"))
    assert mo[1] == main and to[1] == seen["tid"] != main
    assert _inside(mi, mo) and _inside(ti, to) and not _inside(to, mo)
    assert ti[3] - ti[2] >= 2_000_000
    assert mo[4] == {"who": "main"} and to[4] == {"rows": 7} and mi[4] == {}
    # the interval: stamped on two threads, recorded on the one it names
    assert tq[1] == main and tq[2] == seen["t0"] and tq[2] < tq[3] <= mo[3]
    assert tq[4] == {"requests": 2}
    assert tr.threads == {main: (threading.get_ident(), threading.current_thread().name),
                          to[1]: (seen["ident"], "tracing-other")}
    assert tracing.span("longbow.after") is tracing.span("longbow.after")  # off again


def test_full_buffer_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 3)
    tracing.start()
    try:
        for i in range(5):
            with tracing.span(f"longbow.s{i}"):
                pass
    finally:
        tr = tracing.stop()
    assert [r[0] for r in tr.records] == ["longbow.s2", "longbow.s3", "longbow.s4"]
    assert tr.dropped == 2
    with pytest.raises(RuntimeError):
        tracing.stop()


def test_anchor_maps_spans_onto_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.start()
        try:
            for _ in range(3):
                time.sleep(0.01)
                with tracing.span("longbow.mapped"):
                    with record_function("beside"):
                        torch.ones(8).sum()
        finally:
            tr = tracing.stop()
    events = list(prof.profiler.kineto_results.events())
    (clock,) = [e for e in events if e.name() == tracing.CLOCK]
    ranges = sorted(e.start_ns() for e in events if e.name() == "beside")
    off = clock.end_ns() - tr.anchor_ns
    spans = sorted(r[2] + off for r in tr.records if r[0] == "longbow.mapped")
    assert len(ranges) == len(spans) == 3
    assert all(abs(s - r) < 1_000_000 for s, r in zip(spans, ranges))


def test_device_trace_writes_the_spans_beside_the_profilers_events(tmp_path):
    def worker():
        with tracing.span("longbow.worker", n=3):
            torch.ones(4).sum()

    with tracing.device_trace(tmp_path / "tr") as out:
        with tracing.span("longbow.step"):
            with tracing.annotate("scan"):
                torch.ones(4).sum()
        th = threading.Thread(target=worker, name="trace-worker")
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
    assert out == str(tmp_path / "tr") and not tracing.recording()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    (scan,) = [e for e in events if e.get("name") == "scan"]
    (step,) = [e for e in events if e.get("name") == "longbow.step"]
    (work,) = [e for e in events if e.get("name") == "longbow.worker"]
    assert step["cat"] == "longbow" and step["tid"] == scan["tid"] == threading.get_native_id()
    assert abs(step["ts"] - scan["ts"]) < 1000 and step["dur"] >= scan["dur"] - 1000
    assert work["args"] == {"n": 3} and work["tid"] != step["tid"]
    names = [(e["tid"], e["args"]["name"]) for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"]
    assert (work["tid"], "trace-worker") in names  # named though it ended before the trace did
    assert any(e.get("name") == tracing.CLOCK for e in events)


def test_spans_sit_on_the_tracks_torch_gives_their_threads(tmp_path):
    """A profiler that records every thread's ranges writes each thread's
    CPU work on a track of its own; a thread's spans land on that track."""
    from torch._C._profiler import _ExperimentalConfig

    def worker():
        with tracing.span("longbow.worker"):
            with record_function("worker.range"):
                torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        tracing.start()
        try:
            with tracing.span("longbow.main"):
                with record_function("main.range"):
                    torch.ones(4).sum()
            th = threading.Thread(target=worker, name="track-worker")
            th.start()
            th.join(timeout=10)
        finally:
            tr = tracing.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    tracing.add_spans(path, tr, threading.get_native_id())
    tid = {e["name"]: e["tid"] for e in json.loads(path.read_text())["traceEvents"]
           if e.get("ph") == "X"}
    assert tid["longbow.main"] == tid["main.range"]
    assert tid["longbow.worker"] == tid["worker.range"] != tid["main.range"]


_ON_CARD = """
import json, sys, threading, torch
from longbow_tpu_torch.utils import tracing
x = torch.ones(1 << 20, device="cuda")

def worker():
    with tracing.span("longbow.worker"):
        (x * 2).sum().item()

with tracing.device_trace(sys.argv[1]):
    with tracing.span("longbow.main"):
        (x * 3).sum().item()
    th = threading.Thread(target=worker, name="cuda-worker")
    th.start()
    th.join(timeout=60)
"""


@pytest.mark.cuda
def test_spans_sit_on_their_threads_cuda_runtime_tracks_on_card(tmp_path):
    """In a process that has run no other profiler (the profiler keeps
    the system ids of the threads it saw, stale once they end), each
    thread's spans share the track of its own cudaLaunchKernel calls."""
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the runtime calls' tracks come from CUPTI")
    subprocess.run([sys.executable, "-c", _ON_CARD, str(tmp_path / "tr")], check=True,
                   timeout=300)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "longbow"}
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and e.get("name", "").startswith("cudaLaunch")]
    for name in ("longbow.main", "longbow.worker"):
        s = spans[name]
        mine = [e for e in launches if s["ts"] <= e["ts"] <= s["ts"] + s["dur"]]
        assert mine and {e["tid"] for e in mine} == {s["tid"]}, name
    assert spans["longbow.main"]["tid"] != spans["longbow.worker"]["tid"]


def test_debug_mux_serves_a_device_trace():
    import urllib.error
    import urllib.request

    from longbow_tpu_torch.metrics.registry import MetricsRegistry

    stop = threading.Event()

    def busy():
        while not stop.is_set():
            with tracing.span("longbow.busy"):
                time.sleep(0.01)

    th = threading.Thread(target=busy, name="mux-busy")
    th.start()
    reg = MetricsRegistry()
    port = reg.serve(0, host="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{port}"
        resp = urllib.request.urlopen(f"{base}/debug/trace?seconds=0.3", timeout=60)
        assert resp.headers["Content-Type"] == "application/json"
        events = json.loads(resp.read())["traceEvents"]
        busy_spans = [e for e in events if e.get("name") == "longbow.busy"]
        assert busy_spans and {e["tid"] for e in busy_spans} == {th.native_id}
        assert any(e.get("name") == tracing.CLOCK for e in events)
        assert not tracing.recording()
        tracing.start()  # a second recorder is refused, the first left on
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(f"{base}/debug/trace?seconds=0.1", timeout=60)
            assert err.value.code == 500 and tracing.recording()
        finally:
            tracing.stop()
    finally:
        stop.set()
        th.join(timeout=10)
        reg.close()


# -- the search path ---------------------------------------------------------

DIM = 16


def _sq8r_store():
    """An sq8r dataset with rows in its main and its delta region."""
    rng = np.random.default_rng(5)
    store = VectorStore(device="cpu")
    ds = store.get_or_create("d", DIM, index_kind="sq8r", index_params={"n_clusters": 8})
    idx = ds.index._inner
    idx.rebuild_min = 2000  # the first put folds into the main region, the second stays
    v = rng.standard_normal((6000, DIM)).astype(np.float32)
    store.put("d", np.arange(5000), v[:5000])
    store.put("d", np.arange(5000, 6000), v[5000:])
    assert idx.m_codes.shape[0] > 0 and idx.d_count > 0
    return store, rng


def test_store_spans_agree_with_a_wrap_of_vector_store_search(recorder):
    """The benchmark times VectorStore.search by wrapping it on the
    instance; the program's longbow.store.search lies inside each such
    call, one for one, and their summed times agree within 5%."""
    store, rng = _sq8r_store()
    wrapped: list = []
    orig = store.search

    def timed(*a, **kw):
        t0 = time.perf_counter_ns()
        try:
            return orig(*a, **kw)
        finally:
            wrapped.append((threading.get_native_id(), t0, time.perf_counter_ns()))

    store.search = timed
    co = SearchCoalescer(store, shards=1)
    dispatchers = {t.native_id for t in co._ts}
    callers, per = 4, 6
    err: list = []

    def caller():
        try:
            for _ in range(per):
                _, _, ok = co.search("d", rng.standard_normal((50, DIM)), 10, use_cache=False)
                assert ok.all()
        except Exception as e:  # noqa: BLE001 - handed to the main thread
            err.append(e)

    ths = [threading.Thread(target=caller) for _ in range(callers)]
    try:
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
    finally:
        co.stop()
    assert not err and not any(t.is_alive() for t in ths)
    tr = tracing.stop()
    by = _by_name(tr.records)
    stores = sorted(by["longbow.store.search"], key=lambda r: r[2])
    assert len(stores) == len(wrapped) == co.dispatches > 0
    for s, w in zip(stores, sorted(wrapped, key=lambda w: w[1])):
        assert s[1] == w[0] and w[1] <= s[2] and s[3] <= w[2]
    own = sum(s[3] - s[2] for s in stores)
    theirs = sum(w[2] - w[1] for w in wrapped)
    assert abs(own - theirs) <= 0.05 * theirs
    # each step of a store search inside it, on the dispatch thread
    for name in ("longbow.dataset.answer", "longbow.index.to_host", "longbow.sq8r.prep",
                 "longbow.sq8r.main", "longbow.sq8r.delta", "longbow.sq8r.merge"):
        assert len(by[name]) >= len(stores), name
        assert all(any(_inside(r, s) for s in stores) for r in by[name]), name
    # the coalescer: a queue wait a request, on its caller's thread, and
    # the dispatch threads' idle and waits for the launch turn
    queue = by["longbow.coalescer.queue"]
    assert len(queue) == callers * per
    assert {r[1] for r in queue} == {t.native_id for t in ths}
    assert all(r[2] <= r[3] for r in queue)
    assert {s[1] for s in stores} <= dispatchers
    idle = {r[1] for r in by["longbow.coalescer.idle"]}
    assert stores[0][1] in idle and idle <= dispatchers
    assert {r[1] for r in by["longbow.coalescer.turn"]} == dispatchers


def test_exchange_spans_wrap_the_edge_steps(recorder):
    store, rng = _sq8r_store()
    h = FlightHandlers(store)
    cmd = json.dumps({"protocol": "search", "dataset": "d", "k": 5}).encode()
    chunks = [ExchangeChunk(data=Table({"vector": rng.standard_normal((20, DIM)).astype(
        np.float32)})) for _ in range(3)]
    w = CollectingWriter()
    h.do_exchange(cmd, None, chunks, w)
    tr = tracing.stop()
    assert len(w.batches) == 3 and all(len(b.column("id")) == 100 for b in w.batches)
    by = _by_name(tr.records)
    (ex,) = by["longbow.edge.exchange"]
    for name in ("longbow.edge.decode", "longbow.edge.encode", "longbow.store.search"):
        assert len(by[name]) == 3 and all(_inside(r, ex) for r in by[name]), name
