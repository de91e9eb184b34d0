"""Process entry point: `python -m longbow_tpu_torch.serve`.

Counterpart of longbow_tpu/serve.py (reference: cmd/longbow/main.go:137
run(): config, recovery, the metrics server, the data and meta Flight
servers, a graceful shutdown with a final snapshot, :524-565), in two
parts:

- build_runtime(cfg) builds everything but the transport, without
  pyarrow: the store (recovered from LONGBOW_DATA_PATH), the handlers,
  the middleware and degradation, the ingest queue, the coalescer, the
  audit log, compaction, eviction and backpressure, the metrics mux, the
  memory and periodic snapshot loops, and, where a discovery setting
  (LONGBOW_PEERS, _PEERS_DNS, _PEERS_K8S, _PEERS_LAN) is set, the cluster
  coordinator (distributed/cluster.py: membership, replication,
  anti-entropy, partitioned placement, global search; it imports
  pyarrow.flight for its peer clients, so a single node still needs no
  pyarrow). Runtime.stop() stops and joins them. chip_smoke.py drives a
  runtime's handlers on the card.
- main() binds the Flight servers (serving/flight_server.py, which needs
  pyarrow) and the AF_UNIX mirrors over the runtime's handlers and serves
  until SIGINT or SIGTERM.

The store runs on the CUDA card (device.py raises without one); only
LONGBOW_FORCE_CPU=1 puts it on the CPU, as the reference's flag does. The
reference's XLA compile cache has no counterpart: compile_cache_dir is
read and nothing uses it. Warm-up here builds the CUDA kernels with nvcc
and runs one search per recovered dataset before the servers listen (a
first query that waited for nvcc would time its client out).
"""
from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Optional

import torch

from longbow_tpu_torch.config import Config, load_config
from longbow_tpu_torch.device import resolve_device
from longbow_tpu_torch.metrics import get_registry
from longbow_tpu_torch.serving.flight_handlers import FlightHandlers
from longbow_tpu_torch.serving.middleware import MiddlewareChain
from longbow_tpu_torch.utils.logging import setup_logging

JOIN_S = 5.0  # the longest stop() waits for each background thread


def serve_device() -> torch.device:
    """The CPU under LONGBOW_FORCE_CPU=1, else the CUDA card."""
    if os.environ.get("LONGBOW_FORCE_CPU") == "1":
        return torch.device("cpu")
    return resolve_device(None)


def has_discovery(cfg: Config) -> bool:
    return bool(cfg.peers.strip() or cfg.peers_dns.strip() or cfg.peers_k8s.strip()
                or cfg.peers_lan.strip())


def node_identity(cfg: Config) -> str:
    """This node's cluster id: LONGBOW_NODE_ID, else host:data_port.
    Partitioned placement hashes the id into the ring and hands it to
    clients as an address to dial, so a bind address (0.0.0.0) raises
    ValueError there: it would own a slice of the keys nobody can reach."""
    self_id = cfg.node_id or f"{cfg.host}:{cfg.data_port}"
    if cfg.placement == "partitioned":
        if self_id.rsplit(":", 1)[0] in ("", "0.0.0.0", "::", "[::]"):
            raise ValueError(
                "partitioned placement requires a dialable node identity: set "
                f"LONGBOW_NODE_ID=<advertised-host:port> (got {self_id!r} from the bind address)")
    return self_id


def build_cluster(cfg: Config, store, self_id: str):
    """The ClusterCoordinator of cfg's discovery settings for the node
    `self_id`, started (reference: serve.py:299-350)."""
    from longbow_tpu_torch.distributed.cluster import ClusterCoordinator

    peer_ca = None
    if cfg.tls_ca_file:
        with open(cfg.tls_ca_file, "rb") as f:
            peer_ca = f.read()
    cluster = ClusterCoordinator(
        store, self_id, [p for p in cfg.peers.split(",") if p.strip()],
        replication_mode=cfg.replication, replication_level=cfg.replication_level,
        sync_interval_s=cfg.sync_interval_s, probe_interval_s=cfg.probe_interval_s,
        dns_name=cfg.peers_dns, k8s_service=cfg.peers_k8s, region=cfg.region,
        lan_group=cfg.peers_lan, placement=cfg.placement, api_key=cfg.auth_token,
        tls_root_certs=peer_ca, spatial_routing=cfg.spatial_routing,
        spatial_margin=cfg.spatial_margin,
    )
    cluster.start()
    return cluster


def _rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


class Runtime:
    """What build_runtime made; stop() ends its loops and workers (the
    store stays open: close it after the servers stopped)."""

    def __init__(self, cfg: Config, store, handlers: FlightHandlers, log):
        self.cfg = cfg
        self.store = store
        self.handlers = handlers
        self.log = log
        self.middleware = handlers.middleware
        self.ingest = handlers.ingest
        self.coalescer = handlers.coalescer
        self.cluster = handlers.cluster
        self.degradation = None
        self.compactor = None
        self.metrics_port: Optional[int] = None
        self.snapshots_taken = 0
        self.warmed: dict = {}  # dataset -> seconds of its warm-up search
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._closed = False

    def every(self, interval_s: float, fn, name: str) -> None:
        """Run fn every interval_s seconds on a thread until stop()."""

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    fn()
                except Exception:
                    self.log.exception("%s failed", name)

        t = threading.Thread(target=loop, daemon=True, name=name)
        t.start()
        self._threads.append(t)

    def _snapshot(self) -> None:
        self.store.snapshot()
        self.snapshots_taken += 1
        self.log.info("periodic snapshot complete")

    def stop(self) -> None:
        self._stop.set()
        if self.degradation is not None:
            self.degradation.stop()
        if self.compactor is not None:
            self.compactor.stop()
        if self.coalescer is not None:
            self.coalescer.stop()
        if self.ingest is not None:
            self.ingest.close()  # drained before the final snapshot
        if self.cluster is not None:
            self.cluster.stop()
        for t in self._threads:
            t.join(timeout=JOIN_S)
        if self.metrics_port is not None:
            get_registry().close()

    def close(self) -> None:
        """stop(), then the store's final snapshot and WAL close (once)."""
        if self._closed:
            return
        self._closed = True
        self.stop()
        self.store.close()


def build_runtime(cfg: Optional[Config] = None, *, device=None) -> Runtime:
    """The serving process without its transport, from a Config (None:
    load_config() of the environment). device: None means serve_device()."""
    from longbow_tpu_torch.index.hnsw import HNSWConfig
    from longbow_tpu_torch.store.compaction import (
        CompactionWorker,
        EvictionManager,
        MemoryBackpressureController,
    )
    from longbow_tpu_torch.store.vector_store import VectorStore
    from longbow_tpu_torch.utils.health import (
        HealthManager,
        device_checker,
        storage_checker,
        store_checker,
    )

    cfg = cfg or load_config()
    # a partitioned node without a dialable id raises before any state exists
    self_id = node_identity(cfg) if has_discovery(cfg) else None
    device = serve_device() if device is None else torch.device(device)
    log = setup_logging()
    log.info("starting longbow-tpu-torch", extra={"fields": {"config": vars(cfg)}})

    snapshot_backend = None
    if cfg.snapshot_s3_bucket:
        from longbow_tpu_torch.storage.backends import AsyncBackend, S3Backend

        snapshot_backend = AsyncBackend(
            S3Backend(cfg.snapshot_s3_bucket, endpoint_url=cfg.snapshot_s3_endpoint or None)
        )
    elif cfg.snapshot_mirror_dir:
        from longbow_tpu_torch.storage.backends import LocalBackend

        snapshot_backend = LocalBackend(cfg.snapshot_mirror_dir)

    store = VectorStore(
        dtype=torch.bfloat16 if cfg.storage_dtype == "bfloat16" else torch.float32,
        migration_threshold=cfg.migration_threshold,
        hnsw_config=HNSWConfig(
            m=cfg.hnsw_m, m_max=cfg.hnsw_m_max, ef_construction=cfg.hnsw_ef_construction,
            ef_search=cfg.hnsw_ef_search, search_m_max=cfg.hnsw_search_m_max,
            search_expand=cfg.hnsw_search_expand,
        ),
        query_cache_size=cfg.query_cache_size,
        query_cache_ttl=cfg.query_cache_ttl_s,
        default_index_kind=cfg.index_kind,
        default_index_params={"mesh_shards": cfg.mesh_shards} if cfg.mesh_shards else None,
        device=device,
        persist_dir=cfg.data_dir or None,
        wal_sync=cfg.wal_sync,
        wal_io_uring=cfg.wal_io_uring,
        wal_direct_io=cfg.wal_direct_io,
        snapshot_backend=snapshot_backend,
    )

    middleware = MiddlewareChain(
        cfg.rate_limit_rps, cfg.rate_limit_burst, cfg.breaker_threshold,
        cfg.breaker_cooldown_s, bulkhead_max_concurrent=cfg.bulkhead_max_concurrent,
        bulkhead_max_wait_s=cfg.bulkhead_max_wait_s, ip_rate_limit_rps=cfg.ip_rate_limit_rps,
        ip_rate_limit_burst=cfg.ip_rate_limit_burst,
    )
    ingest_queue = None
    if cfg.async_ingest:
        from longbow_tpu_torch.serving.ingest import IngestQueue

        ingest_queue = IngestQueue(store, max_depth=cfg.ingest_queue_depth)
    coalescer = None
    if cfg.search_coalesce:
        from longbow_tpu_torch.serving.coalescer import SearchCoalescer

        coalescer = SearchCoalescer(store, max_batch=cfg.search_coalesce_max_batch,
                                    shards=cfg.search_coalesce_shards)
    audit = None
    if cfg.audit_log:
        from longbow_tpu_torch.serving.security import AuditLogger

        audit = AuditLogger(cfg.audit_log)
    registry = get_registry()
    cluster = None if self_id is None else build_cluster(cfg, store, self_id)
    if cluster is not None:
        log.info("cluster: self=%s peers=%s placement=%s replication=%s", cluster.self_id,
                 cfg.peers, cfg.placement, cluster.replication_mode)
    handlers = FlightHandlers(store, metrics_registry=registry, middleware_chain=middleware,
                              audit_logger=audit, ingest_queue=ingest_queue, coalescer=coalescer,
                              cluster=cluster)
    rt = Runtime(cfg, store, handlers, log)

    # the debug mux: /metrics, /healthz (reference: main.go:296-300)
    hm = HealthManager()
    hm.register("store", store_checker(store))
    hm.register("storage", storage_checker(store))
    hm.register("device", device_checker())
    registry.health_fn = hm.check
    try:
        rt.metrics_port = registry.serve(cfg.metrics_port)
        log.info("metrics on :%d/metrics (+/healthz)", rt.metrics_port)
    except OSError as e:
        log.warning("metrics port unavailable: %s", e)
    # the transport's static gauges (reference: docs/metrics.md): pyarrow
    # Flight's gRPC defaults
    registry.set("longbow_grpc_max_recv_msg_size_bytes", 2**31 - 1)
    registry.set("longbow_grpc_max_send_msg_size_bytes", 2**31 - 1)
    registry.set("longbow_grpc_initial_window_size_bytes", 65535)

    def memory_gauges() -> None:
        rss = _rss_bytes()
        if rss is not None:
            registry.set("longbow_memory_heap_in_use_bytes", rss)

    memory_gauges()
    rt.every(10.0, memory_gauges, "longbow-memory")

    if cfg.warmup:
        if device.type == "cuda":
            from longbow_tpu_torch.ops import _kernels

            t0 = time.perf_counter()
            _kernels.build_all()
            log.info("kernels built in %.1fs", time.perf_counter() - t0)
        for name in store.list_datasets():
            ds = store.get(name)
            if ds.live_count == 0:
                continue
            t0 = time.perf_counter()
            ds.warm()
            rt.warmed[name] = time.perf_counter() - t0

    # periodic snapshots beside the WAL-size trigger (reference:
    # SNAPSHOT_INTERVAL, cmd/longbow/main.go:57)
    if cfg.snapshot_interval_s > 0 and store.engine is not None:
        rt.every(cfg.snapshot_interval_s, rt._snapshot, "longbow-snapshot")

    # compaction, eviction and backpressure (reference: compaction.go:59,
    # record_eviction.go:79)
    eviction = None
    if cfg.eviction_policy or cfg.eviction_ttl_s > 0:
        eviction = EvictionManager(policy=cfg.eviction_policy or "lru",
                                   ttl_s=cfg.eviction_ttl_s or None,
                                   max_rows=cfg.eviction_max_rows or None)
        store.eviction = eviction
    backpressure = None
    if cfg.hbm_soft_limit_mb or cfg.hbm_hard_limit_mb:
        backpressure = MemoryBackpressureController(
            soft_bytes=cfg.hbm_soft_limit_mb * 1024 * 1024 or None,
            hard_bytes=cfg.hbm_hard_limit_mb * 1024 * 1024 or None,
            eviction=eviction,
        )
        store.backpressure = backpressure
    rt.compactor = CompactionWorker(
        store, interval_s=cfg.compaction_interval_s, frag_threshold=cfg.compaction_frag_threshold,
        eviction=eviction, backpressure=backpressure, dataset_ttl_s=cfg.dataset_ttl_s,
    )
    rt.compactor.start()

    if cfg.degradation_enabled:
        # health-driven degradation and stale fallback answers
        # (reference: resilience/graceful_degradation.go)
        from longbow_tpu_torch.serving.middleware import FallbackCache, GracefulDegradation

        rt.degradation = GracefulDegradation()
        rt.degradation.register_check("store", store_checker(store))
        rt.degradation.register_check("storage", storage_checker(store))
        if device.type == "cuda":  # a CPU run has no card for the check to find
            rt.degradation.register_check("device", device_checker())
        rt.degradation.start(cfg.degradation_interval_s)
        middleware.degradation = rt.degradation
        middleware.fallback = FallbackCache(ttl_s=cfg.fallback_cache_ttl_s)
    return rt


def _heal_mirrors(mirrors: list, log) -> None:
    """Re-bind every AF_UNIX mirror whose socket file is gone: a previous
    instance draining on the same directory unlinks the paths this one
    bound when its listener stops."""
    for i, m in enumerate(list(mirrors)):
        if os.path.exists(m.path):
            continue
        try:
            m.shutdown()  # before re-binding: its stop unlinks the path again
        except Exception:
            pass
        try:
            nm = m._primary.spawn_unix_mirror(m.path)
            threading.Thread(target=nm.serve, daemon=True).start()
            mirrors[i] = nm
            log.info("rebound unix socket %s", m.path)
        except Exception as e:
            log.warning("unix socket rebind failed (%s): %s", m.path, e)


def main(argv=None) -> int:
    import faulthandler
    import signal

    from longbow_tpu_torch.serving.flight_server import LongbowFlightServer

    # SIGUSR1 dumps every thread's stack to stderr
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    cfg = load_config()
    if has_discovery(cfg):
        try:
            node_identity(cfg)
        except ValueError as e:
            logging.getLogger("longbow").error("%s", e)
            return 2
    rt = build_runtime(cfg)
    log = rt.log
    sec = dict(auth_token=cfg.auth_token or None, tls_cert_file=cfg.tls_cert_file or None,
               tls_key_file=cfg.tls_key_file or None)
    data = LongbowFlightServer(rt.store, f"grpc://{cfg.host}:{cfg.data_port}",
                               handlers=rt.handlers, **sec)
    meta = LongbowFlightServer(rt.store, f"grpc://{cfg.host}:{cfg.meta_port}",
                               handlers=rt.handlers, **sec)
    # pyarrow's serve() handles SIGINT itself and returns: the data server
    # runs on this thread, and the teardown follows it
    meta_thread = threading.Thread(target=meta.serve, daemon=True)
    meta_thread.start()
    log.info("data on :%d, meta on :%d", data.port, meta.port)

    mirrors: list = []
    if cfg.unix_socket_dir:
        os.makedirs(cfg.unix_socket_dir, exist_ok=True)
        for srv, sock in ((data, "data.sock"), (meta, "meta.sock")):
            m = srv.spawn_unix_mirror(os.path.join(cfg.unix_socket_dir, sock))
            threading.Thread(target=m.serve, daemon=True).start()
            mirrors.append(m)
        log.info("unix sockets in %s", cfg.unix_socket_dir)
        rt.every(5.0, lambda: _heal_mirrors(mirrors, log), "longbow-mirror-healer")

    # SIGTERM (which pyarrow leaves alone) takes SIGINT's path
    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        data.serve()  # until a signal or shutdown()
    except KeyboardInterrupt:
        pass

    log.info("stopping servers")
    rt.stop()
    for m in mirrors:
        m.shutdown()
    data.shutdown()
    meta.shutdown()
    meta_thread.join(timeout=JOIN_S)
    rt.store.close()  # the final snapshot (reference: main.go:524-565)
    log.info("shutdown complete")
    logging.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
