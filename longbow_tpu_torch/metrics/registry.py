"""Prometheus metrics with the reference's names, on a stdlib backing.

Counterpart of longbow_tpu/metrics/registry.py. The registry pre-declares
the same catalog (names, types, label sets and buckets), so dashboards
and alerts built for longbow keep working, and exposes counter() /
gauge() / histogram() for ad-hoc ones. The reference builds on
prometheus_client; this module keeps its own thread-safe counters,
gauges and histograms and writes the Prometheus text exposition format
as prometheus_client's generate_latest does (`# HELP` / `# TYPE`,
`_total`, `_bucket{le=...}` / `_count` / `_sum`, `_created`, label
names sorted, label values escaped), so this package imports neither
prometheus_client nor anything outside the standard library.

The metrics the reference leaves out on purpose are left out here too
(see longbow_tpu/metrics/registry.py's docstring). The scan dispatch
counter `longbow_simd_dispatch_total{implementation}` names what ran
here: DISPATCH_LABELS maps the reference's label values to this
package's.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Optional

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"

# longbow_simd_dispatch_total{implementation}: the reference's label
# value -> the one this package writes for the same route. "cuda_*" is a
# hand-written kernel's launch; "torch" is plain PyTorch (the exact
# scan, or a kernel's plain version on a CPU tensor). "cuda_coarse_i8" is
# the flat tier's opt-in int8 shadow (kernel K2 and the re-rank).
DISPATCH_LABELS = {
    "pallas_fused": "cuda_fused",
    "pallas_sq8_fused": "cuda_sq8_fused",
    "pallas_sq8r_fused": "cuda_sq8r_fused",
    "pallas_coarse_i8": "cuda_coarse_i8",
    "xla": "torch",
}


def dispatch_label(reference_label: str, on_card: bool) -> str:
    """The implementation label of a route the reference calls
    `reference_label`: its kernel's when the kernel ran on the card,
    else "torch"."""
    return DISPATCH_LABELS[reference_label] if on_card else "torch"


def count_dispatch(reference_label: str, on_card: bool = False) -> None:
    """Count one search in longbow_simd_dispatch_total{implementation}
    under dispatch_label(). Only the registry call is guarded: a metric
    never fails a search, and a kernel's failure is never swallowed here
    (the search has already returned)."""
    count("longbow_simd_dispatch_total", implementation=dispatch_label(reference_label, on_card))


def count(name: str, **labels) -> None:
    """One more of the counter `name` with `labels`; a metric never fails
    the caller."""
    try:
        get_registry().inc(name, **labels)
    except Exception:
        pass


_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)
# sizes/counts (batch sizes, fan-outs, rows visited)
_SIZE_BUCKETS = (
    1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
    10000, 25000, 100000, 1000000,
)

_C, _G, _H, _HS = "counter", "gauge", "histogram", "size_histogram"

# The catalog: name -> (type, labels), longbow_tpu's exactly.
_CATALOG: dict[str, tuple[str, tuple[str, ...]]] = {
    # ---- Flight & RPC ----
    "longbow_flight_operations_total": (_C, ("method", "status")),
    "longbow_flight_duration_seconds": (_H, ("method",)),
    "longbow_flight_bytes_processed_total": (_C, ("method",)),
    "longbow_flight_rows_processed_total": (_C, ("method", "status")),
    "longbow_flight_ticket_parse_duration_seconds": (_H, ()),
    "longbow_do_exchange_calls_total": (_C, ()),
    "longbow_do_exchange_duration_seconds": (_H, ()),
    "longbow_doget_pipeline_steps_total": (_C, ("method",)),
    "longbow_doget_zero_copy_total": (_C, ("type",)),
    "longbow_grpc_max_recv_msg_size_bytes": (_G, ()),
    "longbow_grpc_max_send_msg_size_bytes": (_G, ()),
    "longbow_grpc_initial_window_size_bytes": (_G, ()),
    # ---- Vector search ----
    "longbow_vector_search_latency_seconds": (_H, ("dataset",)),
    "longbow_vector_search_action_requests_total": (_C, ()),
    "longbow_vector_search_action_errors_total": (_C, ()),
    "longbow_vector_search_action_duration_seconds": (_H, ()),
    "longbow_active_search_contexts": (_G, ()),
    "longbow_bruteforce_searches_total": (_C, ()),
    "longbow_zero_alloc_vector_search_parse_total": (_C, ()),
    "longbow_vector_search_parse_fallback_total": (_C, ()),
    "longbow_id_resolution_duration_seconds": (_H, ()),
    # ---- HNSW / index ----
    "longbow_hnsw_node_count": (_G, ("dataset",)),
    "longbow_hnsw_graph_height": (_G, ("dataset",)),
    "longbow_hnsw_distance_calculations_total": (_C, ()),
    "longbow_hnsw_nodes_visited": (_HS, ("dataset",)),
    "longbow_hnsw_searches_total": (_C, ()),
    "longbow_hnsw_active_readers": (_G, ("dataset",)),
    "longbow_hnsw_epoch_transitions_total": (_C, ()),
    "longbow_hnsw_pq_enabled": (_G, ("dataset",)),
    "longbow_hnsw_pq_training_duration_seconds": (_H, ("dataset",)),
    "longbow_hnsw_pq_compressed_bytes_total": (_G, ("dataset",)),
    "longbow_hnsw_parallel_search_splits_total": (_C, ("dataset",)),
    "longbow_adaptive_index_migrations_total": (_C, ()),
    "longbow_hnsw_adaptive_m_value": (_G, ("index_name",)),
    "longbow_hnsw_intrinsic_dimensionality": (_G, ("index_name",)),
    "longbow_hnsw_adaptive_adjustments_total": (_C, ("index_name",)),
    "longbow_hnsw_sharding_migrations_total": (_C, ()),
    "longbow_sharded_hnsw_shard_size": (_G, ("dataset", "shard")),
    "longbow_sharded_hnsw_load_factor": (_G, ("dataset", "shard")),
    "longbow_simd_dispatch_total": (_C, ("implementation",)),
    # ---- Hybrid ----
    "longbow_hybrid_search_vector_total": (_C, ()),
    "longbow_hybrid_search_keyword_total": (_C, ()),
    "longbow_bm25_documents_indexed_total": (_C, ()),
    # ---- WAL & persistence ----
    "longbow_wal_writes_total": (_C, ("status",)),
    "longbow_wal_bytes_written_total": (_C, ()),
    "longbow_wal_fsync_duration_seconds": (_H, ("status",)),
    "longbow_wal_batch_size": (_HS, ()),
    "longbow_wal_pending_entries": (_G, ()),
    "longbow_wal_write_rate_per_second": (_G, ()),
    "longbow_wal_adaptive_interval_ms": (_G, ()),
    "longbow_wal_replay_duration_seconds": (_H, ()),
    "longbow_wal_replay_skipped_frames_total": (_C, ()),
    "longbow_snapshot_duration_seconds": (_H, ()),
    "longbow_s3_operations_total": (_C, ("operation", "status")),
    "longbow_s3_request_duration_seconds": (_H, ("operation",)),
    "longbow_s3_retries_total": (_C, ("operation",)),
    # ---- Memory ----
    "longbow_memory_heap_in_use_bytes": (_G, ()),
    "longbow_arrow_memory_used_bytes": (_G, ("allocator",)),
    "longbow_memory_pressure_level": (_G, ()),
    "longbow_memory_fragmentation_ratio": (_G, ()),
    "longbow_memory_backpressure_rejects_total": (_C, ()),
    "longbow_memory_backpressure_acquires_total": (_C, ()),
    "longbow_memory_backpressure_releases_total": (_C, ()),
    "longbow_evictions_total": (_C, ("reason",)),
    # ---- Dataset / store ----
    "longbow_vector_index_size": (_G, ("dataset",)),
    "longbow_tombstones_total": (_G, ("dataset",)),
    "longbow_index_queue_depth": (_G, ()),
    "longbow_store_active_datasets": (_G, ()),
    "longbow_store_dropped_datasets_total": (_C, ()),
    # labels match the reference exactly; `from` is a valid prometheus
    # label — call sites pass it via **{"from": ...}
    "longbow_store_circuit_breaker_state_changes_total": (
        _C, ("name", "from", "to"),
    ),
    "longbow_store_circuit_breaker_rejections_total": (_C, ()),
    "longbow_store_circuit_breaker_successes_total": (_C, ()),
    "longbow_store_circuit_breaker_failures_total": (_C, ()),
    "longbow_warmup_progress_percent": (_G, ()),
    # ---- Compaction & background ----
    "longbow_compaction_operations_total": (_C, ("dataset", "status")),
    "longbow_compaction_duration_seconds": (_H, ("dataset",)),
    "longbow_compaction_records_removed_total": (_C, ("dataset",)),
    "longbow_compaction_auto_triggers_total": (_C, ()),
    # ---- Mesh / gossip / replication ----
    "longbow_gossip_active_members": (_G, ()),
    "longbow_gossip_pings_total": (_C, ("direction",)),
    "longbow_mesh_sync_deltas_total": (_C, ("status",)),
    "longbow_mesh_sync_bytes_total": (_C, ()),
    "longbow_mesh_merkle_match_total": (_C, ("result",)),
    "longbow_replication_peers_total": (_G, ()),
    "longbow_replication_success_total": (_C, ()),
    "longbow_replication_failures_total": (_C, ()),
    "longbow_replication_retries_total": (_C, ()),
    "longbow_replication_queued_total": (_C, ()),
    "longbow_replication_lag_seconds": (_G, ("peer",)),
    "longbow_replication_queue_depth": (_G, ()),
    "longbow_replication_conflicts_total": (_C, ()),
    # ---- Quorum / consistency / failover ----
    "longbow_quorum_operation_duration_seconds": (
        _H, ("operation", "consistency"),
    ),
    "longbow_quorum_success_total": (_C, ("operation", "consistency")),
    "longbow_quorum_failure_total": (
        _C, ("operation", "consistency", "reason"),
    ),
    "longbow_split_brain_heartbeats_total": (_C, ()),
    "longbow_split_brain_healthy_peers": (_G, ()),
    "longbow_split_brain_partitions_total": (_C, ()),
    "longbow_split_brain_fenced_state": (_G, ()),
    "longbow_vector_clock_merges_total": (_C, ()),
    "longbow_vector_clock_conflicts_total": (_C, ()),
    # ---- Routing / global search ----
    "longbow_load_balancer_replicas_total": (_G, ()),
    "longbow_load_balancer_unhealthy_total": (_G, ()),
    "longbow_load_balancer_selections_total": (_C, ("strategy",)),
    "longbow_proxy_requests_forwarded_total": (_C, ("method", "status")),
    "longbow_proxy_request_latency_seconds": (_H, ("method",)),
    "longbow_global_search_duration_seconds": (_H, ()),
    "longbow_global_search_fanout_size": (_HS, ()),
    "longbow_global_search_partial_failures_total": (_C, ()),
    # ---- Observability / misc ----
    "longbow_trace_spans_total": (_C, ("name",)),
    "longbow_ipc_decode_errors_total": (_C, ()),
    "longbow_pipeline_worker_utilization": (_G, ("worker_id",)),
    # ---- TPU-native additions (no reference analogue) ----
    "longbow_tpu_kernel_compile_seconds": (_H, ()),
    "longbow_tpu_hbm_bytes_in_use": (_G, ("dataset",)),
    "longbow_query_cache_hits_total": (_C, ()),
    "longbow_query_cache_misses_total": (_C, ()),
    "longbow_degraded_fallback_served_total": (_C, ()),
    "longbow_cluster_split_brain": (_G, ()),
    "longbow_search_coalesce_batch_size": (_HS, ()),
    "longbow_tpu_span_duration_seconds": (_H, ("name",)),
}

# This package's own metrics, declared beside the catalog (which stays the
# reference's exactly): longbow_kernel_launches_total{kernel} goes up by one
# each time a wrapper launches a hand-written kernel (ops/_kernels.py
# Kernel.count_launch), so another process can read a node's launches, and
# longbow_kernel_variant_launches_total{kernel,variant} splits them by the
# variant launched ("mma" or "wgmma"). sq8r's delta region:
# longbow_sq8r_delta_scans_total{route} counts the scans of a non-empty delta
# by route ("k2", through its cluster-grouped view, or "plain"), and
# longbow_sq8r_delta_views_total the views built. The graph loop
# (index/graph.py count_searches), beside the catalog's
# longbow_hnsw_searches_total (a beam_search call) and
# longbow_hnsw_distance_calculations_total (the neighbour distances it
# computed): longbow_hnsw_beam_iterations_total counts its iterations (one
# host read each) and longbow_hnsw_queries_total the queries it searched.
PORT_METRICS: dict[str, tuple[str, tuple[str, ...]]] = {
    "longbow_kernel_launches_total": (_C, ("kernel",)),
    "longbow_kernel_variant_launches_total": (_C, ("kernel", "variant")),
    "longbow_sq8r_delta_scans_total": (_C, ("route",)),
    "longbow_sq8r_delta_views_total": (_C, ()),
    "longbow_hnsw_beam_iterations_total": (_C, ()),
    "longbow_hnsw_queries_total": (_C, ()),
}


def _float_text(d: float) -> str:
    """A sample value or bucket bound as Go prints it (prometheus_client's
    floatToGoString)."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    # Go switches to exponents sooner than Python
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_value(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _escape_help(doc: str) -> str:
    return doc.replace("\\", r"\\").replace("\n", r"\n")


def _label_text(pairs) -> str:
    """{a="x",b="y"} with label names sorted, or "" without labels."""
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_value(str(v))}"' for k, v in sorted(pairs))
    return "{" + body + "}"


class _Child:
    """One labelled series: its value (or histogram state) and creation
    time, under its metric's lock."""

    __slots__ = ("_metric", "value", "counts", "total", "created")

    def __init__(self, metric: "_Metric"):
        self._metric = metric
        self.value = 0.0
        self.counts = [0] * len(metric.buckets) if metric.buckets else None
        self.total = 0.0
        self.created = time.time()

    def inc(self, amount: float = 1.0) -> None:
        if self._metric.kind == "counter" and amount < 0:
            raise ValueError("Counters can only be incremented by non-negative amounts.")
        with self._metric._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        if self._metric.kind != "gauge":
            raise AttributeError(f"{self._metric.kind} has no dec()")
        with self._metric._lock:
            self.value -= amount

    def set(self, value: float) -> None:
        if self._metric.kind != "gauge":
            raise AttributeError(f"{self._metric.kind} has no set()")
        with self._metric._lock:
            self.value = float(value)

    def observe(self, amount: float) -> None:
        if self._metric.kind != "histogram":
            raise AttributeError(f"{self._metric.kind} has no observe()")
        m = self._metric
        with m._lock:
            self.total += amount
            for j, bound in enumerate(m.buckets):
                if amount <= bound:
                    self.counts[j] += 1
                    break


class _Metric:
    """A counter, gauge or histogram family with its label names.

    The surface of prometheus_client that the store uses: labels(**kw) (or
    positional values) -> a child with inc/dec/set/observe; without label
    names the family is its own single child."""

    def __init__(self, name: str, documentation: str, labelnames=(), *,
                 kind: str, buckets=None):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self.kind = kind
        self.buckets = None
        if kind == "histogram":
            bounds = sorted(float(b) for b in buckets)
            if bounds[-1] != math.inf:
                bounds.append(math.inf)
            self.buckets = tuple(bounds)
        self._lock = threading.Lock()
        self._children: dict[tuple, _Child] = {}
        if not self.labelnames:
            self._children[()] = _Child(self)

    def labels(self, *values, **kw) -> _Child:
        if not self.labelnames:
            raise ValueError(f"no label names were set for {self.name}")
        if values and kw:
            raise ValueError("labels(): pass values positionally or by name, not both")
        if kw:
            if set(kw) != set(self.labelnames):
                raise ValueError(f"{self.name}: incorrect label names {sorted(kw)}")
            values = tuple(kw[n] for n in self.labelnames)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: incorrect label count")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child(self)
            return child

    def _only(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"{self.kind} metric {self.name} is missing label values")
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._only().dec(amount)

    def set(self, value: float) -> None:
        self._only().set(value)

    def observe(self, amount: float) -> None:
        self._only().observe(amount)

    def samples(self) -> list[tuple[str, tuple, float]]:
        """(sample name, ((label, value), ...), value) rows in exposition
        order; `_created` rows last, as generate_latest puts them."""
        base = self.name
        if self.kind == "counter" and base.endswith("_total"):
            base = base[: -len("_total")]
        with self._lock:
            children = [(k, c.value, c.total, list(c.counts or ()), c.created)
                        for k, c in self._children.items()]
        rows, created = [], []
        for key, value, total, counts, born in children:
            pairs = tuple(zip(self.labelnames, key))
            if self.kind == "counter":
                rows.append((base + "_total", pairs, value))
            elif self.kind == "gauge":
                rows.append((base, pairs, value))
            else:
                acc = 0
                for bound, c in zip(self.buckets, counts):
                    acc += c
                    rows.append((base + "_bucket", pairs + (("le", _float_text(bound)),), acc))
                rows.append((base + "_count", pairs, acc))
                rows.append((base + "_sum", pairs, total))
            if self.kind != "gauge":
                created.append((base + "_created", pairs, born))
        return rows + created

    def exposition(self) -> str:
        rows = self.samples()
        main = self.name
        if self.kind == "counter" and not main.endswith("_total"):
            main += "_total"
        base = main[: -len("_total")] if self.kind == "counter" else main
        doc = _escape_help(self.documentation)
        out = [f"# HELP {main} {doc}\n", f"# TYPE {main} {self.kind}\n"]
        created = [r for r in rows if r[0] == base + "_created"]
        for name, pairs, value in rows:
            if name != base + "_created":
                out.append(f"{name}{_label_text(pairs)} {_float_text(value)}\n")
        if created:
            out += [f"# HELP {base}_created {doc}\n", f"# TYPE {base}_created gauge\n"]
            out += [f"{n}{_label_text(p)} {_float_text(v)}\n" for n, p, v in created]
        return "".join(out)


class CollectorRegistry:
    """Metric families in registration order."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> None:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"Duplicated timeseries in CollectorRegistry: {metric.name}")
            self._metrics[metric.name] = metric

    def collect(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())


def generate_latest(registry: CollectorRegistry) -> bytes:
    """The Prometheus text exposition of every metric in `registry`."""
    return "".join(m.exposition() for m in registry.collect()).encode("utf-8")


class MetricsRegistry:
    def __init__(self):
        self.registry = CollectorRegistry()
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self._size_hist = set()
        # /healthz hook: a server points this at its health check (read
        # at request time, so late registration is fine)
        self.health_fn = None
        self._debug_server = None
        for name, (kind, labels) in {**_CATALOG, **PORT_METRICS}.items():
            if kind == _C:
                self.counter(name, labels)
            elif kind == _G:
                self.gauge(name, labels)
            elif kind == _HS:
                self._size_hist.add(name)
                self.histogram(name, labels)
            else:
                self.histogram(name, labels)

    def _get_or_make(self, kind: str, name: str, labels=(), buckets=None) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = _Metric(name, name.replace("_", " "), labels, kind=kind, buckets=buckets)
                self.registry.register(m)
                self._metrics[name] = m
            return m

    def counter(self, name: str, labels=()) -> _Metric:
        return self._get_or_make("counter", name, labels)

    def gauge(self, name: str, labels=()) -> _Metric:
        return self._get_or_make("gauge", name, labels)

    def histogram(self, name: str, labels=()) -> _Metric:
        buckets = _SIZE_BUCKETS if name in self._size_hist else _LATENCY_BUCKETS
        return self._get_or_make("histogram", name, labels, buckets)

    # -- convenience observers (labels applied by name) --

    # first params are underscore-prefixed so label names like `name`
    # (trace_spans_total, circuit_breaker_state_changes) don't collide

    def inc(self, _name: str, _amount: float = 1.0, **labels) -> None:
        m = self._metrics.get(_name) or self.counter(_name, tuple(labels.keys()))
        (m.labels(**labels) if labels else m).inc(_amount)

    def observe(self, _name: str, _value: float, **labels) -> None:
        m = self._metrics.get(_name) or self.histogram(_name, tuple(labels.keys()))
        (m.labels(**labels) if labels else m).observe(_value)

    def set(self, _name: str, _value: float, **labels) -> None:
        m = self._metrics.get(_name) or self.gauge(_name, tuple(labels.keys()))
        (m.labels(**labels) if labels else m).set(_value)

    def time_op(self, op: str):
        """Context manager timing a flight op into the duration histogram
        and the ops counter (status ok or error from whether the body
        raised; labels method/status)."""
        return _OpTimer(self, op)

    def timer(self, name: str, **labels):
        """Context manager observing elapsed seconds into `name`."""
        return _HistTimer(self, name, labels)

    def text(self) -> bytes:
        """The Prometheus text exposition of every metric."""
        return generate_latest(self.registry)

    def serve(self, port: int = 9090, host: str = "0.0.0.0") -> int:
        """Expose the debug mux; returns the port it listens on (port 0
        takes a free one):

        - /metrics                       Prometheus text exposition
        - /healthz                       health JSON (``health_fn``)
        - /debug/pprof/profile?seconds=5 wall-clock stack samples,
                                         collapsed-stack text
        - /debug/pprof/threads           one stack per live thread
        - /debug/trace?seconds=5         torch.profiler's device trace with
                                         the program's spans
                                         (``utils/tracing.device_trace``),
                                         Chrome trace JSON for Perfetto

        ``close()`` stops it."""
        import json as _json
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse

        reg = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet; ops logs are JSON
                pass

            def _send(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("X-Frame-Options", "DENY")
                self.send_header("X-Content-Type-Options", "nosniff")
                self.send_header("Content-Security-Policy", "default-src 'self'")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                try:
                    if u.path == "/metrics":
                        self._send(reg.text(), CONTENT_TYPE_LATEST)
                    elif u.path == "/healthz":
                        fn = reg.health_fn
                        body = _json.dumps(fn() if fn else {"status": "unknown"}).encode()
                        self._send(body, "application/json")
                    elif u.path == "/debug/pprof/profile":
                        from longbow_tpu_torch.utils.profiling import sample_stacks

                        q = parse_qs(u.query)
                        secs = float(q.get("seconds", ["5"])[0])
                        hz = int(q.get("hz", ["97"])[0])
                        self._send(sample_stacks(min(secs, 120.0), hz).encode(),
                                   "text/plain; charset=utf-8")
                    elif u.path == "/debug/pprof/threads":
                        from longbow_tpu_torch.utils.profiling import snapshot_stacks

                        body = "\n".join(
                            f"{k} {v}" for k, v in snapshot_stacks().items()
                        ).encode()
                        self._send(body, "text/plain; charset=utf-8")
                    elif u.path == "/debug/trace":
                        import tempfile
                        from pathlib import Path

                        from longbow_tpu_torch.utils.tracing import device_trace

                        q = parse_qs(u.query)
                        secs = min(float(q.get("seconds", ["5"])[0]), 60.0)
                        with tempfile.TemporaryDirectory(prefix="longbow-trace-") as d:
                            with device_trace(d):
                                time.sleep(secs)
                            body = (Path(d) / "trace.json").read_bytes()
                        self._send(body, "application/json")
                    else:
                        self._send(b"not found", "text/plain", 404)
                except Exception as e:  # never kill the mux thread
                    self._send(str(e).encode(), "text/plain", 500)

        srv = ThreadingHTTPServer((host, port), Handler)
        self._debug_server = srv
        threading.Thread(target=srv.serve_forever, daemon=True,
                         name="longbow-debug-mux").start()
        return srv.server_address[1]

    def close(self) -> None:
        """Stop the debug mux, if serve() started one."""
        srv, self._debug_server = self._debug_server, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()


class _OpTimer:
    def __init__(self, reg: MetricsRegistry, op: str):
        self.reg = reg
        self.op = op

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc):
        status = "error" if exc_type is not None else "ok"
        self.reg.inc("longbow_flight_operations_total", method=self.op, status=status)
        self.reg.observe("longbow_flight_duration_seconds",
                         time.perf_counter() - self.t0, method=self.op)
        return False


class _HistTimer:
    def __init__(self, reg: MetricsRegistry, name: str, labels: dict):
        self.reg = reg
        self.name = name
        self.labels = labels

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.reg.observe(self.name, time.perf_counter() - self.t0, **self.labels)
        return False


_global: Optional[MetricsRegistry] = None
_glock = threading.Lock()


def get_registry() -> MetricsRegistry:
    global _global
    with _glock:
        if _global is None:
            _global = MetricsRegistry()
        return _global
