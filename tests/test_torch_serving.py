"""longbow_tpu_torch's serving core on the CPU: the coalescer, the ingest
queue, request sanitizing and auditing, health, tracing spans, the
ticket parse and the environment config.

The coalescer's and the ingest queue's answers are held EQUAL to direct
store calls on the same store; Filter.cache_key, parse_ticket and
load_config are held equal to longbow_tpu's. Every wait on a thread or a
future carries a timeout.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from longbow_tpu import config as jax_config
from longbow_tpu.query.parser import Filter as JaxFilter
from longbow_tpu.query.parser import parse_ticket as jax_parse_ticket
from longbow_tpu_torch import config as torch_config
from longbow_tpu_torch.metrics import get_registry
from longbow_tpu_torch.metrics.registry import MetricsRegistry
from longbow_tpu_torch.query.parser import Filter, VectorSearchRequest, parse_ticket
from longbow_tpu_torch.serving.coalescer import SearchCoalescer, _Future
from longbow_tpu_torch.serving.ingest import IngestQueue
from longbow_tpu_torch.serving.security import (
    AuditLogger,
    SanitizationError,
    sanitize_dataset_name,
    sanitize_search_request,
)
from longbow_tpu_torch.store.vector_store import VectorStore
from longbow_tpu_torch.utils.health import (
    HealthManager,
    device_checker,
    storage_checker,
    store_checker,
)
from longbow_tpu_torch.utils.tracing import annotate, device_trace, span

WAIT = 10.0  # seconds: every future and join in this file



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_per_worker():
    """Under pytest-xdist, one intra-op thread for this file's many small
    torch ops: several worker processes share the cores, torch's thread
    pools oversubscribe them, and these ops then slow down tens of times.
    Restored after the file; a lone process keeps every thread."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _vecs(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d), dtype=np.float32)


def _mk_store():
    vs = VectorStore(device="cpu")
    v = _vecs(300, 16)
    vs.put("d", np.arange(300), v, columns={"par": (np.arange(300) % 2).astype(np.int64)})
    return vs, v


def _same(got, want):
    ids, scores, ok = got
    assert (ids == want[0]).all() and (ok == want[2]).all()
    np.testing.assert_array_equal(scores, want[1])


# -- the coalescer (tests/test_coalescer.py's counterparts) ------------------

def test_coalesced_batch_matches_individual():
    vs, v = _mk_store()
    co = SearchCoalescer(vs, autostart=False)
    futs = []
    for i in range(6):
        f = _Future()
        co._q.put(("d", v[i * 3: i * 3 + 3], 5, None, None, False, True, f))
        futs.append(f)
    co._drain([co._q.get_nowait() for _ in range(6)])
    assert co.dispatches == 1 and co.coalesced == 6
    for i, f in enumerate(futs):
        _same(f.get(WAIT), vs.search("d", v[i * 3: i * 3 + 3], 5, use_cache=False))


def test_incompatible_requests_split_groups():
    vs, v = _mk_store()
    co = SearchCoalescer(vs, autostart=False)
    f1, f2, f3 = _Future(), _Future(), _Future()
    flt = [Filter("par", "eq", "0")]
    co._q.put(("d", v[:2], 5, None, None, False, True, f1))
    co._q.put(("d", v[2:4], 5, flt, None, False, True, f2))
    co._q.put(("d", v[4:6], 5, None, None, False, True, f3))
    co._drain([co._q.get_nowait() for _ in range(3)])
    assert co.dispatches == 2  # {plain x2} + {filtered}
    ids2, _, ok2 = f2.get(WAIT)
    assert ok2.any() and all(i % 2 == 0 for i in ids2[ok2])
    _same(f2.get(WAIT), vs.search("d", v[2:4], 5, filters=flt, use_cache=False))
    _same(f1.get(WAIT), vs.search("d", v[:2], 5, use_cache=False))
    _same(f3.get(WAIT), vs.search("d", v[4:6], 5, use_cache=False))


def test_max_batch_row_ceiling():
    vs, v = _mk_store()
    co = SearchCoalescer(vs, max_batch=4, autostart=False)
    futs = [_Future() for _ in range(3)]
    for i, f in enumerate(futs):
        co._q.put(("d", v[i * 3: i * 3 + 3], 2, None, None, False, True, f))
    co._drain([co._q.get_nowait() for _ in range(3)])
    # 3 rows each, ceiling 4: no two requests fit together
    assert co.dispatches == 3 and co.coalesced == 0
    for f in futs:
        f.get(WAIT)


def test_error_propagates_to_all_futures():
    vs, v = _mk_store()
    co = SearchCoalescer(vs, autostart=False)
    f1, f2 = _Future(), _Future()
    co._q.put(("missing", v[:1], 5, None, None, False, True, f1))
    co._q.put(("missing", v[1:2], 5, None, None, False, True, f2))
    co._drain([co._q.get_nowait() for _ in range(2)])
    for f in (f1, f2):
        with pytest.raises(KeyError):
            f.get(WAIT)


def test_stop_fails_queued_futures_fast():
    """Requests still queued when the coalescer stops get an error at
    once instead of blocking their callers for the request timeout."""
    vs, v = _mk_store()
    co = SearchCoalescer(vs, autostart=False)
    fut = _Future()
    co._q.put(("d", v[:1], 5, None, None, False, True, fut))
    co._stop.set()
    co.start()
    co.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        fut.get(WAIT)


def test_grouping_failure_fails_batch_not_hangs():
    """A malformed filter whose cache_key raises fails every future of the
    batch with the error instead of orphaning them."""
    vs, v = _mk_store()
    co = SearchCoalescer(vs, autostart=False)

    class BadFilter:
        def cache_key(self):
            raise ValueError("malformed filter")

    f1, f2 = _Future(), _Future()
    co._q.put(("d", v[:1], 5, [BadFilter()], None, False, True, f1))
    co._q.put(("d", v[1:2], 5, None, None, False, True, f2))
    co.start()
    try:
        for f in (f1, f2):
            with pytest.raises(ValueError, match="malformed"):
                f.get(WAIT)
    finally:
        co.stop()


def test_threaded_end_to_end():
    """Concurrent callers get what each would get alone: a lone request
    keeps the query cache, a coalesced one bypasses it."""
    vs, v = _mk_store()
    co = SearchCoalescer(vs)
    results = {}

    def worker(i):
        results[i] = co.search("d", v[i: i + 2], 3, timeout=WAIT)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT)
    co.stop()
    assert not any(t.is_alive() for t in ts) and len(results) == 8
    for i, got in results.items():
        _same(got, vs.search("d", v[i: i + 2], 3, use_cache=False))
    assert co.requests == 8 and 1 <= co.dispatches <= 8


def test_dataset_sharding_isolates_slow_tenants():
    """One dataset's stalled dispatch does not head-of-line-block other
    datasets: dispatch threads are sharded by the dataset's hash."""
    block, entered = threading.Event(), threading.Event()

    class SlowStore:
        def search(self, dataset, qs, k, **kw):
            if dataset == "slow":
                entered.set()
                block.wait(WAIT)
            b = qs.shape[0]
            return np.zeros((b, k), object), np.zeros((b, k), np.float32), np.ones((b, k), bool)

    co = SearchCoalescer(SlowStore(), shards=4)
    n = len(co._qs)
    other = next(f"fast{i}" for i in range(64) if hash(f"fast{i}") % n != hash("slow") % n)
    q = np.zeros((1, 8), np.float32)
    t = threading.Thread(target=lambda: co.search("slow", q, 1, timeout=WAIT))
    t.start()
    try:
        assert entered.wait(WAIT)
        t0 = time.time()
        co.search(other, q, 1, timeout=WAIT)  # must NOT wait for "slow"
        assert time.time() - t0 < 5.0
    finally:
        block.set()
        t.join(WAIT)
        co.stop()
    assert not t.is_alive()


def test_coalescer_stress_counts_every_request():
    """More callers than cores, a short switch interval: every request is
    answered as alone and counted once (no lost update)."""
    import sys

    vs, v = _mk_store()
    co = SearchCoalescer(vs, max_batch=16)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    got, errors = {}, []

    def worker(i):
        try:
            for j in range(4):
                r = (i * 4 + j) % 290
                got[(i, j)] = (r, co.search("d", v[r:r + 1], 5, timeout=WAIT))
        except Exception as e:  # the assertion below reports it
            errors.append(e)

    try:
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT * 3)
    finally:
        sys.setswitchinterval(old)
        co.stop()
    assert not errors and not any(t.is_alive() for t in ts)
    assert co.requests == 128 and len(got) == 128
    for r, res in got.values():
        _same(res, vs.search("d", v[r:r + 1], 5, use_cache=False))


def _answer(qs, k):
    b = qs.shape[0]
    return np.zeros((b, k), object), np.zeros((b, k), np.float32), np.ones((b, k), bool)


def _wait_for(cond):
    deadline = time.time() + WAIT
    while not cond():
        assert time.time() < deadline, "timed out"
        time.sleep(0.005)


def _callers(co, n):
    """n threads, each one co.search of a single query on dataset "d" ->
    (threads, {i: answer or error})."""
    out = {}

    def call(i):
        try:
            out[i] = co.search("d", np.full((1, 8), i, np.float32), 1, timeout=WAIT)
        except Exception as e:  # the test reads it
            out[i] = e

    ts = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    return ts, out


def test_launch_signal_lets_the_next_batch_launch():
    """A store whose search signals its launch and then waits: the other
    dispatch thread takes the turn and runs the next batch before the
    first search returns, and every request that queued while the first
    launched rides in that one batch."""
    from longbow_tpu_torch.utils.launch import launched

    entered, go_launch, release = threading.Event(), threading.Event(), threading.Event()
    second = threading.Event()
    calls = []

    class Store:
        def search(self, dataset, qs, k, **kw):
            calls.append(qs.shape[0])
            if len(calls) == 1:
                entered.set()
                go_launch.wait(WAIT)
                launched()
                release.wait(WAIT)
            else:
                launched()
                second.set()
            return _answer(qs, k)

    co = SearchCoalescer(Store(), shards=1)
    try:
        first, got = _callers(co, 1)
        assert entered.wait(WAIT)
        more, got_more = _callers(co, 3)
        _wait_for(lambda: co._q.qsize() == 3)  # queued while the first launches
        go_launch.set()
        assert second.wait(WAIT)
        assert not release.is_set() and calls == [1, 3]
        assert co.overlapped == 1 and co.dispatches == 2
    finally:
        release.set()
        for t in first + more:
            t.join(WAIT)
        co.stop()
    assert not any(t.is_alive() for t in first + more)
    assert all(isinstance(r, tuple) for r in [*got.values(), *got_more.values()])


def test_searches_without_a_signal_stay_serial():
    """A store that never signals: the turn comes back only when its
    search returns, so one search runs at a time and requests queued
    meanwhile wait for it."""
    entered, release = threading.Event(), threading.Event()
    mu = threading.Lock()
    calls, active, peak = [], [0], [0]

    class Store:
        def search(self, dataset, qs, k, **kw):
            with mu:
                calls.append(qs.shape[0])
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            if len(calls) == 1:
                entered.set()
                release.wait(WAIT)
            with mu:
                active[0] -= 1
            return _answer(qs, k)

    co = SearchCoalescer(Store(), shards=1)
    try:
        first, _ = _callers(co, 1)
        assert entered.wait(WAIT)
        more, got = _callers(co, 3)
        _wait_for(lambda: co._q.qsize() == 3)
        time.sleep(0.1)  # room for a second dispatch, were the turn free
        assert calls == [1] and co._q.qsize() == 3
    finally:
        release.set()
        for t in first + more:
            t.join(WAIT)
        co.stop()
    assert not any(t.is_alive() for t in first + more) and len(got) == 3
    assert calls == [1, 3] and peak[0] == 1 and co.overlapped == 0


def test_overlapped_sq8r_answers_equal_one_search_a_request():
    """Many callers on an sq8r dataset through the coalescer, each store
    search held after its answer until the next has begun (so dispatches
    overlap): every answer equals that request searched alone."""
    import sys

    vs = VectorStore(device="cpu")
    v = _vecs(1500, 16, seed=3)
    vs.get_or_create("s", 16, index_kind="sq8r")
    vs.put("s", np.arange(600), v[:600])
    vs.get("s").index._inner.rebuild_min = 512  # a main region and a delta
    vs.put("s", np.arange(600, 1500), v[600:])
    begun, searches = threading.Condition(), [0]

    class Held:
        def search(self, *a, **kw):
            with begun:
                searches[0] += 1
                mine = searches[0]
                begun.notify_all()
            out = vs.search(*a, **kw)
            with begun:  # until the next search has begun, or none is queued
                begun.wait_for(lambda: searches[0] > mine, timeout=0.2)
            return out

    co = SearchCoalescer(Held(), shards=1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    got, errors = {}, []

    def worker(i):
        try:
            for j in range(4):
                r = (i * 37 + j * 11) % 1500
                got[(i, j)] = (r, co.search("s", v[r:r + 1] + 0.01, 5, timeout=WAIT))
        except Exception as e:  # the assertion below reports it
            errors.append(e)

    try:
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT * 3)
    finally:
        sys.setswitchinterval(old)
        co.stop()
    assert not errors and not any(t.is_alive() for t in ts) and len(got) == 128
    assert co.overlapped >= 1
    for r, res in got.values():
        _same(res, vs.search("s", v[r:r + 1] + 0.01, 5, use_cache=False))


def test_stop_with_two_dispatches_in_flight_orphans_nothing():
    """Two dispatches in flight (each signalled, each waiting) and more
    requests queued: stop fails the queued ones, the two in flight still
    answer, and no caller is left to its timeout."""
    from longbow_tpu_torch.utils.launch import launched

    release = threading.Event()
    calls = []

    class Store:
        def search(self, dataset, qs, k, **kw):
            calls.append(qs.shape[0])
            launched()
            release.wait(WAIT)
            return _answer(qs, k)

    co = SearchCoalescer(Store(), shards=1)
    first, got = _callers(co, 1)
    _wait_for(lambda: len(calls) == 1)
    second, got2 = _callers(co, 1)
    _wait_for(lambda: len(calls) == 2)
    queued, got3 = _callers(co, 3)
    _wait_for(lambda: co._q.qsize() == 3)
    stopper = threading.Thread(target=co.stop)
    t0 = time.time()
    stopper.start()
    _wait_for(co._stop.is_set)
    release.set()
    for t in first + second + queued + [stopper]:
        t.join(WAIT)
    assert not any(t.is_alive() for t in first + second + queued + [stopper])
    assert time.time() - t0 < 5.0
    assert calls == [1, 1] and co.overlapped == 1
    assert all(isinstance(r, tuple) for r in [*got.values(), *got2.values()])
    assert len(got3) == 3
    assert all(isinstance(r, RuntimeError) and "stopped" in str(r) for r in got3.values())


# -- the ingest queue (tests/test_ingest.py:86-165, :273) ---------------------

def test_ingest_queue_coalesces_same_dataset():
    vs = VectorStore(device="cpu")
    calls = []
    orig = vs.put

    def counting_put(*a, **kw):
        calls.append(len(a[1]))
        return orig(*a, **kw)

    vs.put = counting_put
    q = IngestQueue(vs, max_depth=64)
    v = _vecs(10, 8)
    for i in range(20):
        q.submit("c", np.arange(i * 10, i * 10 + 10), v, None, None, float(i))
    assert q.drain(timeout_s=WAIT)
    q.close()
    assert vs.get("c").live_count == 200
    assert len(calls) < 20  # fewer store.put calls than jobs
    # per-row timestamps keep each job's origin timestamp
    assert vs.get("c")._lww[5] == 0.0 and vs.get("c")._lww[195] == 19.0


def test_ingest_queue_bad_job_spares_group_mates():
    """A wrong-width job in a group does not drop its group mates' rows:
    the width is part of the group key, and a failed merged apply
    retries each job alone."""
    vs = VectorStore(device="cpu")
    q = IngestQueue(vs, max_depth=64)
    good, bad = _vecs(10, 8), _vecs(10, 12)
    q.submit("g", np.arange(0, 10), good, None, None, 1.0)
    q.submit("g", np.arange(100, 110), bad, None, None, 2.0)
    q.submit("g", np.arange(10, 20), good, None, None, 3.0)
    assert q.drain(timeout_s=WAIT)
    q.close()
    assert vs.get("g").live_count == 20
    assert len(q.errors) >= 1


def test_ingest_queue_depth_spans_submit_to_applied():
    """depth counts a job from before it is queued until it is applied: a
    checkpoint polling drain() never sees 0 with accepted rows in flight."""
    vs = VectorStore(device="cpu")
    release, entered = threading.Event(), threading.Event()
    orig = vs.put

    def slow_put(*a, **kw):
        entered.set()
        release.wait(WAIT)
        return orig(*a, **kw)

    vs.put = slow_put
    depth = get_registry().gauge("longbow_index_queue_depth")._only()
    q = IngestQueue(vs, max_depth=8)
    try:
        q.submit("s", np.arange(5), _vecs(5, 8), None, None, 1.0)
        assert entered.wait(WAIT)
        assert q.depth == 1 and q.pressure == 1 / 8
        assert not q.drain(timeout_s=0.1)
        assert depth.value == 1
    finally:
        release.set()
    assert q.drain(timeout_s=WAIT)
    q.close()
    assert depth.value == 0
    assert vs.get("s").live_count == 5


def test_ingest_queue_malformed_job_spares_the_worker():
    """A job whose columns are not a mapping fails alone: the worker lives
    on, the next job lands and the depth returns to 0. (longbow_tpu's
    worker dies on it in the grouping step, serving/ingest.py:157, and
    the depth stays up for good.)"""
    vs = VectorStore(device="cpu")
    q = IngestQueue(vs, max_depth=8)
    q.submit("x", np.arange(3), _vecs(3, 4), [1, 2], None, 1.0)
    q.submit("x", np.arange(3, 6), _vecs(3, 4, seed=1), None, None, 2.0)
    assert q.drain(timeout_s=WAIT)
    assert all(t.is_alive() for t in q._threads)
    q.close()
    assert len(q.errors) == 1 and vs.get("x").live_count == 3


def test_ingest_queue_merged_blocks_roundtrip():
    """Merged groups ride the list-of-blocks path; the store then answers
    as one fed by direct puts of the same rows."""
    vs, direct = VectorStore(device="cpu"), VectorStore(device="cpu")
    q = IngestQueue(vs, max_depth=64)
    blocks = [(_vecs(20, 16, seed=s), np.arange(s * 20, s * 20 + 20)) for s in range(12)]
    for v, ids in blocks:
        q.submit("mb", ids, v, {"g": ids % 3}, None, None)
        direct.put("mb", ids, v, {"g": ids % 3})
    assert q.drain(timeout_s=WAIT)
    q.close()
    assert vs.get("mb").live_count == 240
    qs = np.concatenate([v[:2] for v, _ in blocks])
    _same(vs.search("mb", qs, 5), direct.search("mb", qs, 5))
    flt = [Filter("g", "eq", "1")]
    _same(vs.search("mb", qs, 5, filters=flt), direct.search("mb", qs, 5, filters=flt))


# -- security, health, tracing (tests/test_aux.py:18-45, :70-96) ---------------

def test_sanitize_dataset_name():
    assert sanitize_dataset_name("ns1/docs-v2.1") == "ns1/docs-v2.1"
    for bad in ("", "../etc/passwd", "/abs", "a b", "x" * 300, "a;b"):
        with pytest.raises(SanitizationError):
            sanitize_dataset_name(bad)


def test_sanitize_search_request():
    sanitize_search_request(VectorSearchRequest(dataset="ok", vector=[1.0], k=5))
    for bad in (
        VectorSearchRequest(dataset="ok", vector=[1.0], k=999_999),
        VectorSearchRequest(dataset="../bad", vector=[1.0], k=5),
        VectorSearchRequest(dataset="ok", vectors=np.zeros((4097, 2), np.float32), k=5),
        VectorSearchRequest(dataset="ok", vector=[1.0], filters=[Filter("a", "eq", "1")] * 65),
    ):
        with pytest.raises(SanitizationError):
            sanitize_search_request(bad)


def test_audit_logger(tmp_path):
    log = AuditLogger(tmp_path / "audit.jsonl")
    log.record("put", "docs", {"rows": 10})
    log.record("delete", "docs", {"ids": [1]})
    lines = (tmp_path / "audit.jsonl").read_text().strip().splitlines()
    assert len(lines) == 2
    assert json.loads(lines[0])["op"] == "put" and json.loads(lines[1])["ids"] == [1]
    AuditLogger(None).record("put", "docs")  # disabled: writes nothing


def test_health_manager_failure_path(tmp_path):
    hm = HealthManager()
    hm.register("ok", lambda: {"healthy": True})
    hm.register("boom", lambda: 1 / 0)
    out = hm.check()
    assert out["status"] == "unhealthy"
    assert "error" in out["checks"]["boom"]
    # the device checker asks CUDA: with no card it is unhealthy, never a
    # CPU reported as a device
    hm2 = HealthManager()
    hm2.register("dev", device_checker())
    dev = hm2.check()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert dev["checks"]["dev"]["count"] == n and dev["checks"]["dev"]["backend"] == "cuda"
    assert dev["status"] == ("healthy" if n else "unhealthy")
    # the store and storage checkers, and the registry's /healthz hook
    vs = VectorStore(device="cpu", persist_dir=tmp_path, wal_sync="always")
    vs.put("a", np.arange(3), _vecs(3, 4))
    hm3 = HealthManager()
    hm3.register("store", store_checker(vs))
    hm3.register("storage", storage_checker(vs))
    out = hm3.check()
    assert out["status"] == "healthy" and out["checks"]["store"]["datasets"] == 1
    assert out["checks"]["storage"]["wal_bytes"] > 0
    reg = MetricsRegistry()
    reg.health_fn = hm3.check
    assert reg.health_fn()["status"] == "healthy"
    vs.close()


def test_tracing_span_records_metric(tmp_path):
    """A span is recorded into the device trace, beside the profiler's
    ranges, and never into the metrics registry (its two series stay
    declared for the catalog's parity with longbow_tpu, unwritten)."""
    with device_trace(tmp_path / "trace") as out:
        with span("TestOp"):
            with annotate("scan"):
                torch.ones(4).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert out == str(tmp_path / "trace")
    names = {e.get("name"): e for e in trace["traceEvents"]}
    assert "scan" in names and names["TestOp"]["cat"] == "longbow"
    text = get_registry().text()
    assert b'longbow_trace_spans_total{name="TestOp"}' not in text
    assert b'longbow_tpu_span_duration_seconds_count{name="TestOp"}' not in text


# -- equal to longbow_tpu ------------------------------------------------------

@pytest.mark.parametrize("args", [
    ("a", "=", "3", ""), ("b", "gte", "1.5", "or"), ("c", "in", ["x", "y"], ""),
    ("name", "!=", "doc 1", "and"),
])
def test_filter_cache_key_equals_jax(args):
    assert Filter(*args).cache_key() == JaxFilter(*args).cache_key()


def _tickets():
    rng = np.random.default_rng(3)
    vec = rng.standard_normal(384).astype(np.float32).tolist()
    rows = rng.standard_normal((6, 64)).astype(np.float32).tolist()
    flt = [{"field": "g", "op": ">=", "value": 2, "logic": "or"}]
    native = [
        {"name": "d", "search": {"vector": vec, "k": 7, "filters": flt}},
        {"search": {"dataset": "d", "vectors": rows, "k": 3, "local_only": True}},
        {"name": "d", "limit": 5, "search": {"vector": vec, "text_query": "a b", "alpha": 0.5}},
    ]
    stdlib = [
        {"name": "d", "search": {"vector": vec[:8], "k": 2}},  # under 1 KiB
        # a second "vector" key: ambiguous, stdlib
        {"name": "d", "meta": {"vector": [1.0]}, "search": {"vector": vec}},
        # the span is not search.vector: params' floats must not be taken
        {"params": {"vector": vec}, "search": {"dataset": "d", "k": 1}},
        # nesting deeper than 2 and a nested "vector"
        {"name": "d", "search": {"vectors": [[[1.0]] * 3] * 200}},
        {"name": "d", "search": {"vector": [vec[:4]] * 80}},
    ]
    return [(t, True) for t in native] + [(t, False) for t in stdlib]


@pytest.mark.parametrize("ticket,fast", _tickets())
def test_parse_ticket_equals_jax(ticket, fast):
    from longbow_tpu_torch.query import parser

    data = json.dumps(ticket).encode()
    route = len(data) >= parser._FAST_MIN_BYTES and parser._fast_parse(data) is not None
    assert route == fast
    got, want = parse_ticket(data), jax_parse_ticket(data)
    assert (got.name, got.limit, got.filters) == (want.name, want.limit, want.filters)
    if want.search is None:
        assert got.search is None
        return
    for f in ("dataset", "k", "local_only", "text_query", "alpha", "graph_alpha", "graph_depth",
              "fusion", "include_vectors", "vector_format", "consistency"):
        assert getattr(got.search, f) == getattr(want.search, f), f
    assert [x.cache_key() for x in got.search.filters] == \
        [x.cache_key() for x in want.search.filters]
    for f in ("vector", "vectors"):
        a, b = getattr(got.search, f), getattr(want.search, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert type(a) is type(b), f
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_parse_ticket_errors_equal_jax():
    for bad in (b"[1, 2]", b"{not json", json.dumps({"search": {"k": 0}}).encode(),
                json.dumps({"search": {"vector": [1.0] * 400, "k": -1}}).encode()):
        with pytest.raises(Exception) as want:
            jax_parse_ticket(bad)
        with pytest.raises(type(want.value)):
            parse_ticket(bad)


_ENV = {
    "LONGBOW_DATA_PORT": "4000",
    "LONGBOW_HNSW_M": "16",
    "LONGBOW_INDEX_KIND": "mesh_flat",
    "LONGBOW_MESH_SHARDS": "8",
    "LONGBOW_ASYNC_INGEST": "false",
    "LONGBOW_SEARCH_COALESCE_MAX_BATCH": "1024",
    # the reference's own names: Go durations, byte sizes, addresses
    "LONGBOW_MAX_WAL_SIZE": "256MiB",
    "LONGBOW_MAX_MEMORY": "4GiB",
    "LONGBOW_SNAPSHOT_INTERVAL": "1h30m",
    "LONGBOW_TTL": "300ms",
    "LONGBOW_COMPACTION_INTERVAL": "45s",
    "LONGBOW_LISTEN_ADDR": "127.0.0.1:5000",
    "LONGBOW_META_ADDR": ":5001",
    "LONGBOW_STORAGE_ASYNC_FSYNC": "true",
    "LONGBOW_DATA_PATH": "/var/lib/longbow",
}


@pytest.mark.parametrize("env", [{}, _ENV], ids=["defaults", "reference_env"])
def test_load_config_equals_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    def longbow_env():
        return {k: v for k, v in os.environ.items() if k.startswith("LONGBOW_")}

    before = longbow_env()
    got = torch_config.load_config()
    assert longbow_env() == before  # the aliases are not left behind
    assert got.__dict__ == jax_config.load_config().__dict__
    if env:
        assert (got.max_wal_mb, got.hbm_hard_limit_mb) == (256, 4096)
        assert (got.snapshot_interval_s, got.dataset_ttl_s) == (5400.0, 0.3)
        assert (got.host, got.data_port, got.meta_port) == ("127.0.0.1", 4000, 5001)


@pytest.mark.parametrize("var,value", [("LONGBOW_INDEX_KIND", "nope"),
                                       ("LONGBOW_WAL_SYNC", "sometimes"),
                                       ("LONGBOW_MAX_WAL_SIZE", "lots")])
def test_config_validate_rejects_like_jax(monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    with pytest.raises(ValueError):
        jax_config.load_config()
    with pytest.raises(ValueError):
        torch_config.load_config()
    assert torch_config._go_duration_s("1h2m3.5s") == jax_config._go_duration_s("1h2m3.5s")
    assert torch_config._byte_size("1.5GB") == jax_config._byte_size("1.5GB")


def test_rerank_is_batch_invariant():
    """A query's re-ranked distances are the same bits alone and inside a
    coalesced batch (ops/scan.py::row_sum), for l2 and dot."""
    from longbow_tpu_torch.ops.scan import flat_search_rerank, row_sum

    rng = np.random.default_rng(4)
    corpus = torch.from_numpy(rng.standard_normal((5000, 100)).astype(np.float32) * 4)
    corpus = corpus.to(torch.bfloat16)
    norms = (corpus.float() ** 2).sum(1)
    valid = torch.ones(5000, dtype=torch.bool)
    q = torch.from_numpy(rng.standard_normal((64, 100)).astype(np.float32) * 4)
    for metric in ("l2", "dot"):
        db, ib = flat_search_rerank(q, corpus, norms, valid, 10, metric, device="cpu")
        for j in (0, 17, 63):
            d1, i1 = flat_search_rerank(q[j:j + 1], corpus, norms, valid, 10, metric,
                                        device="cpu")
            assert torch.equal(d1[0], db[j]) and torch.equal(i1[0], ib[j])
    x = torch.from_numpy(rng.standard_normal((3, 100)).astype(np.float32))
    np.testing.assert_allclose(row_sum(x).numpy(), x.double().sum(1).numpy(), rtol=1e-5)
