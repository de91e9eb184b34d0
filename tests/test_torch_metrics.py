"""longbow_tpu_torch's metrics registry (metrics/registry.py, a standard
library backing) and profiler (utils/profiling.py) against longbow_tpu's,
which builds on prometheus_client, on the CPU.

The catalog is the same; one sequence of store calls gives the same
samples (names and label sets) and the same counter and histogram counts
in both packages, the scan dispatch labels compared through the port's
DISPATCH_LABELS; the text exposition equals prometheus_client's
generate_latest line for line, the `_created` timestamps aside.
"""
import re
import threading
import urllib.request

import numpy as np
import pytest
from prometheus_client import CollectorRegistry, Counter, Gauge, Histogram, generate_latest
from prometheus_client.parser import text_string_to_metric_families

import longbow_tpu.metrics.registry as jax_registry
import longbow_tpu.utils.query_cache as jax_query_cache
import longbow_tpu_torch.metrics.registry as registry
import longbow_tpu_torch.utils.query_cache as query_cache
from longbow_tpu.store.vector_store import VectorStore as JaxStore
from longbow_tpu_torch.metrics.registry import DISPATCH_LABELS, MetricsRegistry
from longbow_tpu_torch.store.vector_store import VectorStore
from longbow_tpu_torch.utils.profiling import sample_stacks, snapshot_stacks

D = 16


def test_catalog_equals_jax():
    assert registry._CATALOG == jax_registry._CATALOG
    assert len(registry._CATALOG) == 119
    assert registry._LATENCY_BUCKETS == jax_registry._LATENCY_BUCKETS
    assert registry._SIZE_BUCKETS == jax_registry._SIZE_BUCKETS
    ours, theirs = MetricsRegistry(), jax_registry.MetricsRegistry()
    for name, (kind, labels) in registry._CATALOG.items():
        m, w = ours._metrics[name], theirs._metrics[name]
        assert m.kind == w._type, name
        assert m.labelnames == tuple(w._labelnames) == labels, name
        if m.kind == "histogram":
            assert list(m.buckets) == list(w._upper_bounds), name


def _samples(text: str) -> dict:
    """{(sample name, sorted label pairs): value} of an exposition,
    without the `_created` timestamps."""
    out = {}
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if not s.name.endswith("_created"):
                out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def _sequence(store):
    """put (with float and string columns), a search missed and hit in
    the query cache, an sq8 dataset, deletes, a drop."""
    rng = np.random.default_rng(3)
    v = rng.standard_normal((300, D), dtype=np.float32)
    q = rng.standard_normal((4, D), dtype=np.float32)
    cols = {"price": np.arange(300.0), "cat": np.array(["a", "b", "c"])[np.arange(300) % 3]}
    store.put("flat", np.arange(300), v, cols)
    store.search("flat", q, 10)
    store.search("flat", q, 10)  # a cache hit
    store.search("flat", q, 100, exact=True)
    store.delete("flat", np.arange(0, 300, 7))
    store.search("flat", q, 10)
    store.get_or_create("codes", D, index_kind="sq8")
    store.put("codes", np.arange(300), v)
    store.search("codes", q, 10)
    store.search("codes", q, 80)
    store.put("gone", np.arange(20), v[:20])
    assert store.drop("gone")


@pytest.fixture
def fresh_registries(monkeypatch):
    """A new global registry in both packages (and the query caches'
    resolved counters cleared), so the sequence starts from zero."""
    monkeypatch.setattr(jax_registry, "_global", jax_registry.MetricsRegistry())
    monkeypatch.setattr(jax_query_cache, "_COUNTERS", {})
    monkeypatch.setattr(registry, "_global", registry.MetricsRegistry())
    monkeypatch.setattr(query_cache, "_COUNTERS", {})


# timing-dependent: the reference observes a search of over a second as a
# kernel compile, which JAX's first call on a shape may take on the CPU
_TIMED = ("longbow_tpu_kernel_compile_seconds",)
# set on every cycle by the sync thread of any WAL alive in the process
# (another test file's store on the same pytest-xdist worker writes them
# into whichever registry is global), never by this sequence, which logs
# nothing
_WAL_THREAD = ("longbow_wal_adaptive_interval_ms", "longbow_wal_write_rate_per_second")
# the port's graph loop counts its own calls and real neighbour distances
# (index/graph.py count_searches); the reference's store counts every
# search of a non-flat kind and estimates 2 * ef * m_max distances a query
_GRAPH_LOOP = ("longbow_hnsw_searches_total", "longbow_hnsw_distance_calculations_total")


def test_store_calls_give_the_same_samples_and_counts(fresh_registries):
    _sequence(JaxStore())
    _sequence(VectorStore(device="cpu"))
    want = _samples(generate_latest(jax_registry.get_registry().registry).decode())
    got = _samples(registry.get_registry().text().decode())
    # this package's own metrics are outside the reference's catalog; those
    # without labels show from their declaration, at 0 here (no sq8r, no
    # graph, no coalescer)
    for name in ("longbow_sq8r_delta_views_total", "longbow_hnsw_beam_iterations_total",
                 "longbow_hnsw_queries_total", "longbow_coalescer_overlapped_dispatches_total"):
        assert got.pop((name, ())) == 0
    assert not any(name in registry.PORT_METRICS for name, _ in got)
    assert want[("longbow_hnsw_searches_total", ())] == 2  # the sq8 searches
    for name in _GRAPH_LOOP:  # the sequence runs no graph search
        assert got.pop((name, ())) == 0
        want.pop((name, ()))

    def mapped(key):
        name, labels = key
        if name == "longbow_simd_dispatch_total":
            labels = tuple((k, DISPATCH_LABELS[v]) for k, v in labels)
        return name, labels

    want = {mapped(k): v for k, v in want.items()}
    assert set(got) == set(want)
    assert ("longbow_simd_dispatch_total", (("implementation", "torch"),)) in got
    for key, value in want.items():
        name, labels = key
        if name.startswith(_TIMED) or name in _WAL_THREAD:
            continue
        if name.endswith("_total") or name.endswith("_count"):
            assert got[key] == value, key
        elif name == "longbow_tpu_hbm_bytes_in_use" and dict(labels)["dataset"] == "codes":
            # the port also counts the sq8 affine: two f32 rows of D
            assert got[key] == value + 2 * D * 4
        elif not (name.endswith("_sum") or name.endswith("_bucket")):  # gauges
            assert got[key] == value, key
    assert got[("longbow_query_cache_hits_total", ())] == 1
    assert got[("longbow_store_dropped_datasets_total", ())] == 1
    # a cache hit is served before the timer: 3 of the 4 searches
    assert got[("longbow_vector_search_latency_seconds_count", (("dataset", "flat"),))] == 3


def test_dispatch_labels_name_the_reference_routes():
    assert set(DISPATCH_LABELS) == {"pallas_fused", "pallas_sq8_fused", "pallas_sq8r_fused",
                                    "pallas_coarse_i8", "xla"}
    assert registry.dispatch_label("pallas_fused", True) == "cuda_fused"
    assert registry.dispatch_label("pallas_coarse_i8", True) == "cuda_coarse_i8"
    assert registry.dispatch_label("pallas_sq8r_fused", True) == "cuda_sq8r_fused"
    assert registry.dispatch_label("pallas_fused", False) == "torch"


def _families(reg_cls_factory):
    """The same counter, gauge and histogram (labelled and not), with the
    same updates, in one registry."""
    counter, gauge, histogram, text = reg_cls_factory()
    c = counter("longbow_a_total", ["dataset", "status"])
    c0 = counter("longbow_b_total", [])
    g = gauge("longbow_g", ["dataset"])
    g0 = gauge("longbow_g0", [])
    h = histogram("longbow_h_seconds", ["dataset", "aa"], registry._LATENCY_BUCKETS)
    hs = histogram("longbow_sizes", [], registry._SIZE_BUCKETS)
    c.labels(dataset='a"b\\c\nd', status="ok").inc(3)
    c.labels(dataset="x", status="error").inc()
    c0.inc(2.5)
    g.labels(dataset="x").set(1e20)
    g.labels(dataset="y").set(-2.5)
    g0.set(123456789)
    for x in (0.00005, 0.003, 0.003, 7.0):
        h.labels(dataset="x", aa="1").observe(x)
    for x in (1, 3, 2e6):
        hs.observe(x)
    return text()


def _prometheus():
    r = CollectorRegistry()
    return (
        lambda n, ls: Counter(n, n.replace("_", " "), ls, registry=r),
        lambda n, ls: Gauge(n, n.replace("_", " "), ls, registry=r),
        lambda n, ls, b: Histogram(n, n.replace("_", " "), ls, registry=r, buckets=b),
        lambda: generate_latest(r).decode(),
    )


def _ours():
    reg = MetricsRegistry()
    reg.registry = registry.CollectorRegistry()
    reg._metrics = {}
    return (
        reg.counter,
        reg.gauge,
        lambda n, ls, b: reg._get_or_make("histogram", n, ls, b),
        lambda: reg.text().decode(),
    )


def test_text_format_equals_generate_latest_line_for_line():
    strip = lambda t: re.sub(r"_created(\{[^}]*\})? \S+", r"_created\1 T", t)  # noqa: E731
    want, got = _families(_prometheus), _families(_ours)
    assert strip(got).splitlines() == strip(want).splitlines()
    assert _samples(got) == _samples(want)
    assert 'longbow_a_total{dataset="a\\"b\\\\c\\nd",status="ok"} 3.0' in got
    assert 'longbow_sizes_bucket{le="1e+06"} 2.0' in got


def test_registry_api_and_errors():
    reg = MetricsRegistry()
    reg.inc("longbow_flight_rows_processed_total", 5, method="DoPut", status="ok")
    reg.gauge("longbow_vector_index_size", ("dataset",)).labels(dataset="d").set(42)
    with reg.time_op("DoGet"):
        pass
    with pytest.raises(RuntimeError):
        with reg.time_op("DoPut"):
            raise RuntimeError("boom")
    with reg.timer("longbow_snapshot_duration_seconds"):
        pass
    reg.inc("longbow_custom_total", 2, kind="x")  # ad hoc, made on first use
    text = reg.text().decode()
    assert 'longbow_flight_rows_processed_total{method="DoPut",status="ok"} 5.0' in text
    assert 'longbow_vector_index_size{dataset="d"} 42.0' in text
    assert 'longbow_flight_operations_total{method="DoGet",status="ok"} 1.0' in text
    assert 'longbow_flight_operations_total{method="DoPut",status="error"} 1.0' in text
    assert "longbow_snapshot_duration_seconds_count 1.0" in text
    assert 'longbow_custom_total{kind="x"} 2.0' in text
    with pytest.raises(ValueError):
        reg.counter("longbow_evictions_total").inc()  # labels missing
    with pytest.raises(ValueError):
        reg.inc("longbow_evictions_total", -1, reason="ttl")
    with pytest.raises(ValueError):
        reg.inc("longbow_evictions_total", why="ttl")


def test_kernel_launches_reach_the_registry(monkeypatch):
    """Kernel.count_launch adds one to the kernel's own count and to
    longbow_kernel_launches_total{kernel}, this package's metric beside
    the reference's catalog, which a node's /metrics exposes to another
    process; a fresh registry declares it with no sample."""
    from longbow_tpu_torch.ops._kernels import Kernel

    monkeypatch.setattr(registry, "_global", registry.MetricsRegistry())
    assert set(registry.PORT_METRICS).isdisjoint(registry._CATALOG)
    fresh = registry.get_registry().text().decode()
    assert "# TYPE longbow_kernel_launches_total counter" in fresh
    assert not any(k[0].startswith("longbow_kernel_launches") for k in _samples(fresh))
    kernel = Kernel("probe_kernel", "csrc/none.cu", bind=None)
    for _ in range(3):
        kernel.count_launch()
    got = _samples(registry.get_registry().text().decode())
    assert kernel.launches == 3
    assert got[("longbow_kernel_launches_total", (("kernel", "probe_kernel"),))] == 3


def test_registry_counts_under_threads():
    reg = MetricsRegistry()

    def work():
        for _ in range(2000):
            reg.inc("longbow_evictions_total", reason="lru")
            reg.observe("longbow_wal_batch_size", 3)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = _samples(reg.text().decode())
    assert got[("longbow_evictions_total", (("reason", "lru"),))] == 8000
    assert got[("longbow_wal_batch_size_count", ())] == 8000
    assert got[("longbow_wal_batch_size_bucket", (("le", "5.0"),))] == 8000


def test_debug_mux_on_loopback():
    """/metrics, /healthz, /debug/pprof/threads and a short profile over
    a loopback port, each request with its own timeout."""
    import json

    reg = MetricsRegistry()
    reg.health_fn = lambda: {"status": "healthy"}
    port = reg.serve(0, host="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{port}"
        resp = urllib.request.urlopen(f"{base}/metrics", timeout=10)
        body = resp.read()
        assert resp.headers["Content-Type"] == registry.CONTENT_TYPE_LATEST
        assert resp.headers["X-Frame-Options"] == "DENY"
        assert body == reg.text() and b"longbow_flight_operations_total" in body
        hz = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=10).read())
        assert hz == {"status": "healthy"}
        thr = urllib.request.urlopen(f"{base}/debug/pprof/threads", timeout=10).read().decode()
        assert "MainThread" in thr
        prof = urllib.request.urlopen(f"{base}/debug/pprof/profile?seconds=0.2&hz=100",
                                      timeout=10).read().decode()
        assert "MainThread;" in prof
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope", timeout=10)
    finally:
        reg.close()
    assert reg._debug_server is None


def test_profiler_collapsed_stack_format():
    """One `thread;file:function:line;... count` line per stack; the
    sampling thread leaves itself out."""
    stop = threading.Event()

    def burn():
        while not stop.is_set():
            sum(i * i for i in range(2000))

    t = threading.Thread(target=burn, name="burner", daemon=True)
    t.start()
    try:
        out = sample_stacks(seconds=0.2, hz=100)
    finally:
        stop.set()
        t.join(timeout=10)
    assert "burner;" in out and ":burn:" in out and "MainThread" not in out
    for line in out.splitlines():
        stack, _, count = line.rpartition(" ")
        assert stack and int(count) >= 1
        assert all(frame.count(":") == 2 for frame in stack.split(";")[1:])
    stacks = snapshot_stacks()
    assert "MainThread" in stacks
    assert stacks["MainThread"].split(";")[-1].split(":")[1] == "snapshot_stacks"
