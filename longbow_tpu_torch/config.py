"""Environment configuration with the reference's knob names.

Counterpart of longbow_tpu/config.py (reference: envconfig.Process
("LONGBOW", ...) over one struct with defaults, cmd/longbow/main.go:
43-126,146; ValidateConfig, cmd/longbow/config.go:24-53). Every
LONGBOW_* name and default is longbow_tpu's, so a deployment's
environment reads the same in both packages; the reference's own Go
names (durations such as "1h30m", byte sizes such as "4GiB") are
accepted as aliases by load_config.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env(name: str, default, cast=str):
    raw = os.environ.get(f"LONGBOW_{name}")
    if raw is None:
        return default
    if cast is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return cast(raw)


@dataclass
class Config:
    # serving (reference: data :3000 / meta :3001)
    data_port: int = field(default_factory=lambda: _env("DATA_PORT", 3000, int))
    meta_port: int = field(default_factory=lambda: _env("META_PORT", 3001, int))
    host: str = field(default_factory=lambda: _env("HOST", "0.0.0.0"))
    # host-local fast path: directory for AF_UNIX mirror sockets
    # (data.sock/meta.sock) beside TCP; empty = TCP only
    unix_socket_dir: str = field(
        default_factory=lambda: _env("UNIX_SOCKET", "")
    )
    metrics_port: int = field(
        default_factory=lambda: _env("METRICS_PORT", 9090, int)
    )

    # storage (reference: STORAGE_* knobs, MAX_WAL_SIZE 100MB)
    data_dir: str = field(default_factory=lambda: _env("DATA_DIR", ""))
    # io_uring WAL backend (reference: STORAGE_USE_IOURING,
    # wal_backend_linux.go:15-125); falls back to buffered FS writes
    # when the OS refuses io_uring
    wal_io_uring: bool = field(
        default_factory=lambda: _env("WAL_IOURING", False, bool)
    )
    # O_DIRECT WAL writes (reference: storage/direct_io_linux.go):
    # page-cache bypass; falls back to buffered on unsupporting fs
    wal_direct_io: bool = field(
        default_factory=lambda: _env("WAL_DIRECT", False, bool)
    )
    # transport security (reference: SDK bearer auth client.py:63-70,
    # docs/security.md TLS): empty = open plaintext (dev default)
    auth_token: str = field(default_factory=lambda: _env("AUTH_TOKEN", ""))
    # append-only JSONL audit trail of mutating ops (reference:
    # security/audit.go:16-32); empty = disabled
    audit_log: str = field(default_factory=lambda: _env("AUDIT_LOG", ""))
    tls_cert_file: str = field(default_factory=lambda: _env("TLS_CERT", ""))
    tls_key_file: str = field(default_factory=lambda: _env("TLS_KEY", ""))
    tls_ca_file: str = field(default_factory=lambda: _env("TLS_CA", ""))
    # warm each recovered dataset at startup (build its kernel, run one
    # search) so the first client query after a restart does not pay it
    warmup: bool = field(default_factory=lambda: _env("WARMUP", True, bool))
    max_wal_mb: int = field(default_factory=lambda: _env("MAX_WAL_MB", 100, int))
    wal_sync: str = field(default_factory=lambda: _env("WAL_SYNC", "batch"))
    # remote snapshot mirror (reference: s3_backend.go): either an S3
    # bucket or a local directory path (testing / NFS mirrors)
    snapshot_s3_bucket: str = field(
        default_factory=lambda: _env("SNAPSHOT_S3_BUCKET", "")
    )
    snapshot_s3_endpoint: str = field(
        default_factory=lambda: _env("SNAPSHOT_S3_ENDPOINT", "")
    )
    snapshot_mirror_dir: str = field(
        default_factory=lambda: _env("SNAPSHOT_MIRROR_DIR", "")
    )
    # periodic snapshots in addition to the WAL-size trigger
    # (reference: SNAPSHOT_INTERVAL default 1h, main.go:57); 0 = off
    snapshot_interval_s: float = field(
        default_factory=lambda: _env("SNAPSHOT_INTERVAL_S", 0.0, float)
    )

    # longbow_tpu's persistent XLA compile cache. Nothing in this package
    # reads it (kernels are built once per source hash into .cuda_build/);
    # it is kept so that the same environment parses in both packages
    compile_cache_dir: str = field(
        default_factory=lambda: _env(
            "COMPILE_CACHE_DIR",
            os.path.join(
                os.path.expanduser("~"), ".cache", "longbow_tpu", "xla"
            ),
        )
    )

    # index (reference: HNSW M/efC/efS defaults arrow_hnsw.go:77-99)
    hnsw_m: int = field(default_factory=lambda: _env("HNSW_M", 32, int))
    hnsw_m_max: int = field(default_factory=lambda: _env("HNSW_M_MAX", 64, int))
    hnsw_ef_construction: int = field(
        default_factory=lambda: _env("HNSW_EF_CONSTRUCTION", 100, int)
    )
    # search-time levers (0 = off): traverse only the best search_m_max
    # distance-sorted edges per node; expand search_expand beam nodes
    # per iteration
    hnsw_search_m_max: int = field(
        default_factory=lambda: _env("HNSW_SEARCH_M_MAX", 0, int)
    )
    hnsw_search_expand: int = field(
        default_factory=lambda: _env("HNSW_SEARCH_EXPAND", 4, int)
    )
    hnsw_ef_search: int = field(
        default_factory=lambda: _env("HNSW_EF_SEARCH", 50, int)
    )
    # rows at which an adaptive dataset moves from the flat scan to the
    # graph (the reference's default is 10k, main.go:122; longbow_tpu's,
    # kept here, is 200k)
    migration_threshold: int = field(
        default_factory=lambda: _env("AUTOSHARD_THRESHOLD", 200_000, int)
    )
    storage_dtype: str = field(
        default_factory=lambda: _env("STORAGE_DTYPE", "bfloat16")
    )
    # default index kind for datasets created implicitly by DoPut
    # (adaptive | flat | hnsw | pq | sq8 | bq | disk | ivf | mesh_flat
    # | mesh_graph); per-dataset CreateNamespace index wins
    index_kind: str = field(
        default_factory=lambda: _env("INDEX_KIND", "adaptive")
    )
    mesh_shards: int = field(
        default_factory=lambda: _env("MESH_SHARDS", 0, int)
    )

    # admission (reference: RATE_LIMIT_RPS/BURST, circuit breaker)
    rate_limit_rps: float = field(
        default_factory=lambda: _env("RATE_LIMIT_RPS", 0.0, float)
    )
    rate_limit_burst: int = field(
        default_factory=lambda: _env("RATE_LIMIT_BURST", 0, int)
    )
    # per-client-IP limit (reference: security CheckRateLimit(ip))
    ip_rate_limit_rps: float = field(
        default_factory=lambda: _env("IP_RATE_LIMIT_RPS", 0.0, float)
    )
    ip_rate_limit_burst: int = field(
        default_factory=lambda: _env("IP_RATE_LIMIT_BURST", 0, int)
    )
    breaker_threshold: int = field(
        default_factory=lambda: _env("BREAKER_THRESHOLD", 10, int)
    )
    breaker_cooldown_s: float = field(
        default_factory=lambda: _env("BREAKER_COOLDOWN_S", 30.0, float)
    )
    # resilience kit (reference: resilience/bulkhead.go,
    # graceful_degradation.go) — bulkhead 0 = unbounded concurrency
    bulkhead_max_concurrent: int = field(
        default_factory=lambda: _env("BULKHEAD_MAX_CONCURRENT", 0, int)
    )
    bulkhead_max_wait_s: float = field(
        default_factory=lambda: _env("BULKHEAD_MAX_WAIT_S", 0.2, float)
    )
    degradation_enabled: bool = field(
        default_factory=lambda: _env("DEGRADATION_ENABLED", True, bool)
    )
    degradation_interval_s: float = field(
        default_factory=lambda: _env("DEGRADATION_INTERVAL_S", 5.0, float)
    )
    fallback_cache_ttl_s: float = field(
        default_factory=lambda: _env("FALLBACK_CACHE_TTL_S", 300.0, float)
    )

    # cluster (reference: gossip/static peers cmd/longbow/main.go:383,
    # replication peer_replicator.go, quorum.go)
    node_id: str = field(default_factory=lambda: _env("NODE_ID", ""))
    peers: str = field(default_factory=lambda: _env("PEERS", ""))
    # DNS discovery: "name:data_port[:meta_port]" re-resolved per probe
    # round (reference: mesh/discovery DNS mode)
    peers_dns: str = field(default_factory=lambda: _env("PEERS_DNS", ""))
    # Kubernetes endpoints discovery: "service:data_port[:meta_port]"
    # (reference: mesh/discovery k8s pods); region label for
    # same-region-first fan-out (reference: mesh/region.go)
    peers_k8s: str = field(default_factory=lambda: _env("PEERS_K8S", ""))
    # LAN zero-config discovery: "group:port" UDP multicast beacons
    # (reference: mesh/discovery mDNS mode), e.g. 224.0.1.187:7946
    peers_lan: str = field(default_factory=lambda: _env("PEERS_LAN", ""))
    region: str = field(default_factory=lambda: _env("REGION", ""))
    # content-based fan-out pruning from peer region summaries
    # (reference: mesh/region.go Router + spatial_index.go); opt-in —
    # routing is approximate (centroid+radius*margin) and fails open
    spatial_routing: bool = field(
        default_factory=lambda: _env("SPATIAL_ROUTING", 0, int) == 1
    )
    spatial_margin: float = field(
        default_factory=lambda: _env("SPATIAL_MARGIN", 1.5, float)
    )
    # replicated: every node holds everything, reads merge freshness.
    # partitioned: rows route to ring owners (reference: sharding/ring)
    placement: str = field(
        default_factory=lambda: _env("PLACEMENT", "replicated")
    )
    replication: str = field(
        default_factory=lambda: _env("REPLICATION", "async")  # async|quorum|off
    )
    replication_level: str = field(
        default_factory=lambda: _env("REPLICATION_LEVEL", "QUORUM")
    )
    sync_interval_s: float = field(
        default_factory=lambda: _env("SYNC_INTERVAL_S", 30.0, float)
    )
    probe_interval_s: float = field(
        default_factory=lambda: _env("PROBE_INTERVAL_S", 1.0, float)
    )

    # compaction / eviction (reference: CompactionConfig compaction.go:11,
    # RecordEvictionManager record_eviction.go:79)
    compaction_interval_s: float = field(
        default_factory=lambda: _env("COMPACTION_INTERVAL_S", 30.0, float)
    )
    compaction_frag_threshold: float = field(
        default_factory=lambda: _env("COMPACTION_FRAG_THRESHOLD", 0.3, float)
    )
    eviction_policy: str = field(
        default_factory=lambda: _env("EVICTION_POLICY", "")  # ""/lru/lfu
    )
    eviction_ttl_s: float = field(
        default_factory=lambda: _env("EVICTION_TTL_S", 0.0, float)
    )
    # dataset-level TTL: drop whole datasets not read/written for this
    # long (reference: LONGBOW_TTL, docs/eviction.md; row TTL above is
    # the record-level extension)
    dataset_ttl_s: float = field(
        default_factory=lambda: _env("DATASET_TTL_S", 0.0, float)
    )
    eviction_max_rows: int = field(
        default_factory=lambda: _env("EVICTION_MAX_ROWS", 0, int)
    )
    # memory backpressure (reference: memory_backpressure.go soft/hard)
    hbm_soft_limit_mb: int = field(
        default_factory=lambda: _env("HBM_SOFT_LIMIT_MB", 0, int)
    )
    hbm_hard_limit_mb: int = field(
        default_factory=lambda: _env("HBM_HARD_LIMIT_MB", 0, int)
    )

    # ingest (reference: async dual-queue pipeline store_actions.go:426)
    async_ingest: bool = field(
        default_factory=lambda: _env("ASYNC_INGEST", True, bool)
    )
    ingest_queue_depth: int = field(
        default_factory=lambda: _env("INGEST_QUEUE_DEPTH", 256, int)
    )
    # natural search batching (serving/coalescer.py): concurrent plain
    # searches share one store search (a fused scan reads the corpus
    # once per launch, whatever its batch); 0 disables
    search_coalesce: bool = field(
        default_factory=lambda: _env("SEARCH_COALESCE", True, bool)
    )
    # dispatch threads, routed by hash(dataset): isolates tenants from
    # one another's slow dispatches (head-of-line blocking); and the
    # rows a coalesced search may hold
    search_coalesce_shards: int = field(
        default_factory=lambda: _env("SEARCH_COALESCE_SHARDS", 4, int)
    )
    search_coalesce_max_batch: int = field(
        default_factory=lambda: _env("SEARCH_COALESCE_MAX_BATCH", 4096, int)
    )

    # cache (reference: query cache in DoGet, store_query.go:625)
    query_cache_size: int = field(
        default_factory=lambda: _env("QUERY_CACHE_SIZE", 1024, int)
    )
    query_cache_ttl_s: float = field(
        default_factory=lambda: _env("QUERY_CACHE_TTL_S", 60.0, float)
    )

    def validate(self) -> "Config":
        if self.data_port == self.meta_port:
            raise ValueError("data and meta ports must differ")
        if self.hnsw_m <= 0 or self.hnsw_m_max < self.hnsw_m:
            raise ValueError("need 0 < HNSW_M <= HNSW_M_MAX")
        if self.storage_dtype not in ("bfloat16", "float32"):
            raise ValueError("STORAGE_DTYPE must be bfloat16|float32")
        if self.wal_sync not in ("always", "batch", "adaptive", "never"):
            raise ValueError("WAL_SYNC must be always|batch|adaptive|never")
        if self.replication not in ("async", "quorum", "off"):
            raise ValueError("REPLICATION must be async|quorum|off")
        if self.placement not in ("replicated", "partitioned"):
            raise ValueError("PLACEMENT must be replicated|partitioned")
        from longbow_tpu_torch.index.factory import INDEX_KINDS

        if self.index_kind not in INDEX_KINDS:
            raise ValueError(
                f"INDEX_KIND must be one of {INDEX_KINDS}"
            )
        return self


def _go_duration_s(raw: str) -> float:
    """Go time.Duration string ("300ms", "1h30m", "20s") -> seconds."""
    import re

    units = {
        "ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
        "s": 1.0, "m": 60.0, "h": 3600.0,
    }
    total, matched = 0.0, False
    for num, unit in re.findall(r"([0-9]*\.?[0-9]+)(ns|us|µs|ms|s|m|h)", raw):
        total += float(num) * units[unit]
        matched = True
    if not matched:
        return float(raw)  # plain seconds
    return total


def _byte_size(raw: str) -> int:
    """"104857600" | "100MB" | "4GiB" -> bytes."""
    import re

    m = re.fullmatch(
        r"\s*([0-9]*\.?[0-9]+)\s*([KMGT]?i?B?)\s*", raw, re.IGNORECASE
    )
    if not m:
        return int(raw)
    mult = {
        "": 1, "B": 1,
        "KB": 1000, "KIB": 1024, "KI": 1024, "K": 1000,
        "MB": 1000**2, "MIB": 1024**2, "MI": 1024**2, "M": 1000**2,
        "GB": 1000**3, "GIB": 1024**3, "GI": 1024**3, "G": 1000**3,
        "TB": 1000**4, "TIB": 1024**4, "TI": 1024**4, "T": 1000**4,
    }[m.group(2).upper()]
    return int(float(m.group(1)) * mult)


# The reference's own env names (cmd/longbow/main.go:43-126) accepted
# as aliases so a deployment switches without rewriting its env. Each
# entry: reference suffix -> (our suffix, converter). Applied only when
# our name is unset; our names win on conflict.
_REF_ALIASES: dict = {
    "DATA_PATH": ("DATA_DIR", None),
    "STORAGE_USE_IOURING": ("WAL_IOURING", None),
    "GOSSIP_STATIC_PEERS": ("PEERS", None),
    "GOSSIP_DNS_RECORD": ("PEERS_DNS", None),
    "GOSSIP_ADVERTISE_ADDR": ("NODE_ID", None),
    "AUTO_SHARDING_THRESHOLD": ("AUTOSHARD_THRESHOLD", None),
    "MEMORY_EVICTION_POLICY": ("EVICTION_POLICY", None),
    "MAX_WAL_SIZE": (
        "MAX_WAL_MB", lambda v: str(max(1, _byte_size(v) // (1024 * 1024)))
    ),
    "MAX_MEMORY": (
        "HBM_HARD_LIMIT_MB",
        lambda v: str(max(1, _byte_size(v) // (1024 * 1024))),
    ),
    # reference TTL is DATASET-level (docs/eviction.md): drops whole
    # idle datasets, not rows
    "TTL": ("DATASET_TTL_S", lambda v: str(_go_duration_s(v))),
    "SNAPSHOT_INTERVAL": (
        "SNAPSHOT_INTERVAL_S", lambda v: str(_go_duration_s(v))
    ),
    "COMPACTION_INTERVAL": (
        "COMPACTION_INTERVAL_S", lambda v: str(_go_duration_s(v))
    ),
    "GOSSIP_INTERVAL": (
        "PROBE_INTERVAL_S", lambda v: str(_go_duration_s(v))
    ),
    "STORAGE_ASYNC_FSYNC": (
        "WAL_SYNC",
        lambda v: "batch" if v.lower() in ("1", "true", "yes") else "always",
    ),
}
# addr-style aliases need splitting into host/port pairs
_REF_ADDR_ALIASES = {
    "LISTEN_ADDR": ("HOST", "DATA_PORT"),
    "META_ADDR": (None, "META_PORT"),
    "METRICS_ADDR": (None, "METRICS_PORT"),
}


def _apply_reference_aliases(env=os.environ, added=None) -> list[str]:
    """Translate reference-named vars into ours; appends each key it
    adds to `added` AS IT GOES so the caller can restore the
    environment even when a converter raises mid-way."""
    if added is None:
        added = []

    def _set(key: str, val: str) -> None:
        if key not in env:
            env[key] = val
            added.append(key)

    for ref, (ours, conv) in _REF_ALIASES.items():
        raw = env.get(f"LONGBOW_{ref}")
        if raw is not None:
            try:
                val = conv(raw) if conv else raw
            except Exception as e:
                raise ValueError(
                    f"LONGBOW_{ref}={raw!r}: cannot parse ({e})"
                ) from e
            _set(f"LONGBOW_{ours}", val)
    for ref, (host_key, port_key) in _REF_ADDR_ALIASES.items():
        raw = env.get(f"LONGBOW_{ref}")
        if raw is None:
            continue
        if ":" in raw:
            host, _, port = raw.rpartition(":")
        else:
            host, port = raw, ""  # bare hostname, keep the default port
        if host and host_key:
            _set(f"LONGBOW_{host_key}", host)
        if port and port_key:
            _set(f"LONGBOW_{port_key}", port)
    return added


def load_config() -> Config:
    """Config from the environment, the reference's names included, then
    validated (ValueError names the knob). The aliases are set in
    os.environ only while the Config is read."""
    added: list[str] = []
    try:
        _apply_reference_aliases(added=added)
        return Config().validate()
    finally:
        for k in added:
            os.environ.pop(k, None)
