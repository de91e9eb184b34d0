"""VectorStore: the top-level object owning all datasets.

Counterpart of longbow_tpu/store/vector_store.py: the same surface the
Flight handlers call (put, search, delete, the dataset lifecycle and
readiness), with the reference's metrics, the eviction and memory
backpressure hooks, hybrid dense + BM25 search, graph re-rank, the
GraphRAG actions and persistence: with a persist_dir every put, delete,
drop and edge is logged to a WAL before it is applied, snapshot() writes
every dataset's full state, and a new store on the same directory
recovers both before it serves (storage/engine.py).
"""
from __future__ import annotations

import tempfile
import threading
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from longbow_tpu_torch.device import resolve_device
from longbow_tpu_torch.hybrid.fusion import estimate_alpha, fuse_cascade, fuse_linear, fuse_rrf
from longbow_tpu_torch.metrics import get_registry
from longbow_tpu_torch.ops.distance import Metric
from longbow_tpu_torch.store.dataset import Dataset
from longbow_tpu_torch.utils.query_cache import QueryCache
from longbow_tpu_torch.utils.tracing import span
from longbow_tpu_torch.wire_types import NATIVE_VECTOR_DTYPES


class VectorStore:
    """All datasets of one process, on one device.

    dtype: storage dtype of new datasets (bf16 is what the fused scan
    serves; torch.float32 serves every flat search through exact_search).
    The default index kind is "adaptive": a flat scan until
    migration_threshold rows, a graph (hnsw_config) after.
    device: None means the CUDA card (and raises without one).

    persist_dir: a directory for the WAL and snapshots (None: nothing is
    persisted). wal_sync is the WAL's group commit ("always", "batch",
    "adaptive", "never"); wal_io_uring and wal_direct_io ask for those
    append backends (the file backend serves where the OS refuses them);
    snapshot_backend mirrors every snapshot (LocalBackend, S3Backend).

    Hooks, None until set: `eviction` (an EvictionManager fed by the
    ids every search returns), `backpressure` (a
    MemoryBackpressureController whose hard limit rejects puts) and
    `reranker` ((query_text, [ids]) -> scores, the last stage of
    hybrid_search).
    """

    def __init__(
        self,
        *,
        default_metric: str = Metric.L2,
        dtype=torch.bfloat16,
        migration_threshold: int = 200_000,
        hnsw_config=None,
        query_cache_size: int = 1024,
        query_cache_ttl: float = 60.0,
        default_index_kind: str = "adaptive",
        default_index_params: Optional[dict] = None,
        device=None,
        persist_dir=None,
        wal_sync: str = "batch",
        wal_io_uring: bool = False,
        wal_direct_io: bool = False,
        snapshot_backend=None,
    ):
        self.device = resolve_device(device)
        self._datasets: dict[str, Dataset] = {}
        self._namespaces: dict[str, set] = {}  # ns -> dataset names
        self._lock = threading.Lock()
        self.default_metric = Metric.validate(default_metric)
        self.dtype = dtype
        # rows at which an adaptive dataset moves from the flat scan to
        # the graph, and the graph's knobs (an HNSWConfig; None: defaults)
        self.migration_threshold = migration_threshold
        self.hnsw_config = hnsw_config
        self.default_index_kind = default_index_kind
        self.default_index_params = dict(default_index_params or {})
        self.query_cache = QueryCache(query_cache_size, query_cache_ttl)
        self.started_at = time.time()
        self.eviction = None
        self.reranker = None
        self.backpressure = None
        # persistence: recover the snapshot and the WAL before serving
        self.engine = None
        if persist_dir is not None:
            from longbow_tpu_torch.storage.engine import StorageEngine

            self.engine = StorageEngine(
                persist_dir, sync=wal_sync, snapshot_backend=snapshot_backend,
                io_uring=wal_io_uring, direct_io=wal_direct_io,
            )
            self.engine.recover(self)

    # -- dataset lifecycle --------------------------------------------

    def get_or_create(
        self,
        name: str,
        dim: int,
        metric: Optional[str] = None,
        *,
        index_kind: Optional[str] = None,
        index_params: Optional[dict] = None,
        dtype_hint=None,
    ) -> Dataset:
        # dtype-aware creation, in a store whose default kind is adaptive
        # and with no kind asked for: a dataset first seen with int8/uint8
        # vectors stores the bytes 1:1 as identity-affine sq8 codes; one
        # first seen with float16 stores float16 (no lossy bounce through
        # bf16). An explicit kind always wins over the hint.
        ds_dtype = self.dtype
        if dtype_hint is not None and index_kind is None and (
            self.default_index_kind in (None, "adaptive")
        ):
            hint = np.dtype(dtype_hint)
            if hint in (np.dtype(np.int8), np.dtype(np.uint8)):
                index_kind = "sq8"
            elif hint == np.dtype(np.float16):
                ds_dtype = torch.float16
        with self._lock:
            ds = self._datasets.get(name)
            if ds is None:
                params = (
                    index_params
                    if index_params is not None
                    else self.default_index_params
                )
                graph_disk_path = None
                if params and params.get("graph_disk"):
                    graph_disk_path = self._graph_disk_path(name)
                ds = Dataset(
                    name,
                    dim,
                    metric or self.default_metric,
                    dtype=ds_dtype,
                    hnsw_config=self.hnsw_config,
                    migration_threshold=self.migration_threshold,
                    index_kind=index_kind or self.default_index_kind,
                    index_params=params,
                    graph_disk_path=graph_disk_path,
                    device=self.device,
                )
                self._datasets[name] = ds
                ns = name.split("/", 1)[0] if "/" in name else "default"
                self._namespaces.setdefault(ns, set()).add(name)
                get_registry().set("longbow_store_active_datasets", len(self._datasets))
            elif ds.dim != dim:
                raise ValueError(
                    f"dataset {name!r} has dim {ds.dim}, put has {dim}"
                )
            return ds

    def _graph_disk_path(self, name: str) -> Path:
        """A disk-backed edge store's log: beside the WAL, or under the
        temp directory when the store persists nothing."""
        base = (
            self.engine.dir if self.engine is not None
            else Path(tempfile.gettempdir()) / "longbow_graphs"
        )
        return Path(base) / "graphs" / f"{name.replace('/', '_')}.edges"

    def restore_dataset(self, name: str, blob: dict) -> Dataset:
        """A dataset from a version 2 snapshot blob (this package's or
        longbow_tpu's): the index state imported (no rebuild, no
        retraining), the metadata columns, the id maps and the LWW
        timestamps. A disk-backed edge store is re-attached to its log."""
        from longbow_tpu_torch.index.factory import import_index
        from longbow_tpu_torch.index.flat import storage_dtype
        from longbow_tpu_torch.query.filters import ColumnStore

        meta = blob["meta"]
        js = blob.get("json") or {}
        aux = blob.get("aux") or {}
        try:
            dtype = storage_dtype(meta.get("dtype", "bfloat16"))
        except ValueError:
            dtype = self.dtype
        params = meta.get("index_params") or {}
        ds = Dataset(
            name,
            meta["dim"],
            meta["metric"],
            dtype=dtype,
            hnsw_config=self.hnsw_config,
            migration_threshold=meta.get("migration_threshold", self.migration_threshold),
            index_kind=meta.get("index_kind", "adaptive"),
            index_params=params,
            graph_disk_path=(
                self._graph_disk_path(name)
                if params.get("graph_disk") and self.engine is not None else None
            ),
            device=self.device,
        )
        ds.index = import_index(blob["index_state"], device=self.device)
        ds.columns = ColumnStore.import_state(
            {
                "count": js.get("col_count", 0),
                "numeric": {k[len("colnum:"):]: v for k, v in aux.items()
                            if k.startswith("colnum:")},
                "str_codes": {k[len("colstr:"):]: v for k, v in aux.items()
                              if k.startswith("colstr:")},
                "str_dicts": js.get("str_dicts", {}),
            },
            ds.index.capacity,
            device=self.device,
        )
        ds._row_to_id = list(js.get("row_to_id", []))
        ds._id_to_row = {uid: r for r, uid in enumerate(ds._row_to_id) if uid is not None}
        ds._lww = {k: ts for k, ts in js.get("lww", [])}
        with self._lock:
            self._datasets[name] = ds
            ns = name.split("/", 1)[0] if "/" in name else "default"
            self._namespaces.setdefault(ns, set()).add(name)
            get_registry().set("longbow_store_active_datasets", len(self._datasets))
        return ds

    def _guard(self, log: bool):
        """The commit guard of a logged write; nothing without a WAL."""
        return self.engine.commit_guard() if self.engine is not None and log else nullcontext()

    def get(self, name: str) -> Dataset:
        ds = self._datasets.get(name)
        if ds is None:
            raise KeyError(f"dataset {name!r} not found")
        return ds

    def drop(self, name: str, *, _log: bool = True) -> bool:
        """The 'delete-dataset' action."""
        with self._guard(_log):
            if self.engine is not None and _log:
                self.engine.log_drop(name)
            with self._lock:
                ds = self._datasets.pop(name, None)
                for members in self._namespaces.values():
                    members.discard(name)
                self.query_cache.clear()
                if ds is not None:
                    reg = get_registry()
                    reg.inc("longbow_store_dropped_datasets_total")
                    reg.set("longbow_store_active_datasets", len(self._datasets))
                return ds is not None

    def list_datasets(self) -> list[str]:
        return sorted(self._datasets)

    def list_namespaces(self) -> list[str]:
        return sorted(self._namespaces)

    def namespace_dataset_counts(self) -> dict[str, int]:
        """namespace -> live dataset count."""
        with self._lock:
            return {ns: len(m) for ns, m in self._namespaces.items()}

    # -- data plane ---------------------------------------------------

    def put(
        self,
        dataset: str,
        ids,
        vectors,
        columns: Optional[dict] = None,
        metric: Optional[str] = None,
        *,
        _log: bool = True,
        timestamp=None,
    ) -> None:
        """Upsert rows (the DoPut path). vectors: a numpy array, a list
        of numpy blocks of one dim, or a tensor (kept on its device).
        With a `backpressure` controller its hard limit may raise
        MemoryPressureError before anything is stored. With a WAL the put
        is logged, after its columns' types are checked, and applied under
        the commit guard; _log=False (the replay) logs nothing."""
        logged = self.engine is not None and _log
        dtype_hint = None
        if isinstance(vectors, list) and logged:
            vectors = np.concatenate(vectors)  # a frame holds one array
        if isinstance(vectors, list):
            dim = vectors[0].shape[1]
            if vectors[0].dtype in NATIVE_VECTOR_DTYPES:
                dtype_hint = vectors[0].dtype
        else:
            if not isinstance(vectors, torch.Tensor):
                vectors = np.atleast_2d(np.asarray(vectors))
                if vectors.dtype in NATIVE_VECTOR_DTYPES:
                    dtype_hint = vectors.dtype
                else:
                    vectors = vectors.astype(np.float32)
            dim = vectors.shape[1]
        if self.backpressure is not None:
            self.backpressure.check_admit(self)
        ds = self.get_or_create(dataset, dim, metric, dtype_hint=dtype_hint)
        # checked before the WAL append: a rejected frame in the log would
        # be rejected again on every restart
        ds.columns.check_types(columns or {})
        with self._guard(_log):
            if logged:
                self.engine.log_put(dataset, ids, vectors, columns, metric,
                                    timestamp=timestamp)
            ds.put(np.asarray(ids), vectors, columns, timestamp=timestamp)
        if self.backpressure is not None:
            # the admission slot is held only for the apply
            get_registry().inc("longbow_memory_backpressure_releases_total")
        self.query_cache.clear()
        self._observe_dataset(ds)
        if logged:
            self.engine.maybe_snapshot(self)

    def _observe_dataset(self, ds) -> None:
        """Refresh the per-dataset gauges after a mutation."""
        reg = get_registry()
        reg.set("longbow_vector_index_size", len(ds.index), dataset=ds.name)
        reg.set("longbow_tombstones_total", len(ds.index) - ds.live_count, dataset=ds.name)
        reg.set("longbow_tpu_hbm_bytes_in_use", ds.device_bytes(), dataset=ds.name)
        # graph-index internals; graph_height is 1: one layer, with beam
        # search from entry samples in place of the HNSW hierarchy
        graph = getattr(ds.index, "_graph", None)
        if graph is not None:
            reg.set("longbow_hnsw_node_count", graph.count, dataset=ds.name)
            reg.set("longbow_hnsw_graph_height", 1, dataset=ds.name)
            pq_on = graph.storage == "pq"
            reg.set("longbow_hnsw_pq_enabled", int(pq_on), dataset=ds.name)
            if pq_on:  # the graph's rows are its PQ codes
                codes = graph.state.vectors
                reg.set("longbow_hnsw_pq_compressed_bytes_total",
                        codes.numel() * codes.element_size(), dataset=ds.name)
        n_shards = getattr(ds.index, "n_shards", 0)  # the mesh kinds
        if n_shards:
            counts = ds.index._shard_counts
            per_cap = max(ds.index.capacity // n_shards, 1)
            for s in range(n_shards):
                # mesh_graph keeps no counts: its rows stripe round-robin
                c = int(counts[s]) if counts is not None else len(ds.index) // n_shards
                reg.set("longbow_sharded_hnsw_shard_size", c, dataset=ds.name, shard=str(s))
                reg.set("longbow_sharded_hnsw_load_factor", c / per_cap,
                        dataset=ds.name, shard=str(s))

    def search(
        self,
        dataset: str,
        queries,
        k: int,
        *,
        filters: Optional[list] = None,
        ef_search: Optional[int] = None,
        exact: bool = False,
        use_cache: bool = True,
    ):
        """-> (ids [B, k] object, scores [B, k] f32, ok [B, k] bool),
        the DoGet search path. Results are cached by dataset, query
        bytes and parameters until the next mutation or the TTL."""
        with span("longbow.store.search"):
            reg = get_registry()
            queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
            key = None
            if use_cache:
                key = QueryCache.hash_query(
                    dataset, queries.tobytes(), k, filters, ef_search, exact
                )
                hit = self.query_cache.get(key)
                if hit is not None:
                    try:
                        # a cache hit is a read too (dataset TTL)
                        self.get(dataset).touch()
                    except KeyError:
                        pass
                    if self.eviction is not None:
                        found = [i for i in hit[0].ravel() if i is not None]
                        if found:
                            self.eviction.record_access(found)
                    return hit
            ds = self.get(dataset)
            kind = ds.index.kind
            graph_search = not exact and kind not in ("flat", "mesh_flat")
            n_shards = getattr(ds.index, "n_shards", 0)
            if n_shards > 1:
                # one logical search fans out over every shard (the reference
                # counts per-shard splits, hnsw_parallel.go)
                reg.inc("longbow_hnsw_parallel_search_splits_total", n_shards, dataset=dataset)
            if graph_search:
                reg.gauge("longbow_hnsw_active_readers", ("dataset",)).labels(dataset=dataset).inc()
            else:
                reg.inc("longbow_bruteforce_searches_total")
            reg.gauge("longbow_active_search_contexts").inc()
            t0 = time.perf_counter()
            try:
                out = ds.search(queries, k, filters=filters, ef_search=ef_search, exact=exact)
            finally:
                reg.gauge("longbow_active_search_contexts").dec()
                if graph_search:
                    reg.gauge("longbow_hnsw_active_readers", ("dataset",)).labels(
                        dataset=dataset
                    ).dec()
            if graph_search:
                # traversal work per query, as the reference estimates it: the
                # beam gathers up to 2 * ef * m_max candidate rows. The graph
                # loop counts its searches and real distances itself
                # (index/graph.py count_searches)
                cfg = getattr(getattr(ds.index, "_graph", None) or ds.index, "config", None)
                if cfg is not None:
                    ef = ef_search or cfg.ef_search
                    visited = 2 * ef * (cfg.search_m_max or cfg.m_max)
                    reg.observe("longbow_hnsw_nodes_visited", visited, dataset=dataset)
            reg.observe("longbow_vector_search_latency_seconds", time.perf_counter() - t0,
                        dataset=dataset)
            if key is not None:
                self.query_cache.put(key, out)
            if self.eviction is not None:
                found = [i for i in out[0].ravel() if i is not None]
                if found:
                    self.eviction.record_access(found)
            return out

    def delete(self, dataset: str, ids, *, timestamp=None, replicated: bool = False,
               _log: bool = True) -> int:
        """The 'delete' action: tombstone rows by user id at `timestamp`
        (default: now). replicated: a peer's delete at its origin's time,
        applied last-writer-wins (Dataset.delete). The WAL frame
        carries no time either way, as the reference's."""
        ds = self.get(dataset)
        with self._guard(_log):
            if self.engine is not None and _log:
                self.engine.log_delete(dataset, ids)
            n = ds.delete(ids, timestamp, replicated=replicated)
        self.query_cache.clear()
        self._observe_dataset(ds)
        return n

    # -- introspection ------------------------------------------------

    def readiness(self) -> dict:
        """The 'check_readiness' action. A migration to the graph tier
        runs in the background while the flat tier serves every row, so
        the store is READY once a call returns. A migration that failed
        leaves its dataset on the flat tier and is listed by name."""
        failed = {}
        for name, ds in list(self._datasets.items()):
            err = getattr(ds.index, "migration_error", None)
            if err is not None:
                failed[name] = repr(err)
        return {
            "status": "READY",
            "datasets": len(self._datasets),
            "migration_errors": failed,
            "uptime_s": time.time() - self.started_at,
        }

    def cluster_status(self) -> dict:
        """The 'cluster-status' action's single-process view; the cluster
        layer adds its membership to it."""
        return {
            "self": {"id": "local", "status": "alive"},
            "members": [{"id": "local", "status": "alive"}],
            "datasets": {n: ds.stats() for n, ds in list(self._datasets.items())},
        }

    # -- hybrid search ------------------------------------------------

    def hybrid_search(
        self,
        dataset: str,
        queries,
        k: int,
        *,
        text_query: str = "",
        alpha: float = 0.0,
        filters: Optional[list] = None,
        graph_alpha: float = 0.0,
        graph_depth: int = 2,
        fusion: str = "linear",
        oversample: int = 3,
    ):
        """Dense + BM25 sparse fusion ("linear", "rrf" or "cascade").
        alpha: 0 = sparse only, 1 = dense only, <= 0 estimated from the
        query text. The dense half is this store's search (k * oversample
        candidates, uncached); its failure is the caller's to see. A
        reranker that raises leaves the fused order.
        -> (ids [B, k] object, scores [B, k] f32, ok [B, k] bool)."""
        reg = get_registry()
        ds = self.get(dataset)
        # sparse-only hybrids never reach ds.search: count them as access
        ds.touch()
        if alpha <= 0.0 and text_query:
            alpha = estimate_alpha(text_query)

        kk = max(k * oversample, k)
        have_dense = queries is not None and np.asarray(queries).size > 0
        if have_dense and alpha > 0.0:
            reg.inc("longbow_hybrid_search_vector_total")
            d_ids, d_scores, d_ok = self.search(
                dataset, queries, kk, filters=filters, use_cache=False
            )
            b = d_ids.shape[0]
        else:
            d_ids = d_scores = d_ok = None
            b = 1
        sparse: list = []
        if text_query and alpha < 1.0:
            reg.inc("longbow_hybrid_search_keyword_total")
            allowed = None
            mask = ds.filter_mask(filters or [])
            if mask is not None:
                m = mask.cpu().numpy()
                ids_arr = ds.row_ids_array()
                sel = ids_arr[np.nonzero(m[: len(ids_arr)])[0]]
                allowed = {i for i in sel if i is not None}
            sparse = ds.bm25.search(text_query, kk, allowed=allowed)

        out_ids = np.empty((b, k), dtype=object)
        out_scores = np.zeros((b, k), np.float32)
        out_ok = np.zeros((b, k), bool)
        for row in range(b):
            dense_pairs = []
            if d_ids is not None:
                for j in range(d_ids.shape[1]):
                    if d_ok[row, j]:
                        s = d_scores[row, j]
                        # to a similarity: distances (l2, cosine) negate
                        sim = s if ds.metric == Metric.DOT else -s
                        dense_pairs.append((d_ids[row, j], float(sim)))
            if fusion == "rrf":
                fused = fuse_rrf([dense_pairs, sparse], k)
            elif fusion == "cascade":
                fused = fuse_cascade(dense_pairs, sparse, alpha, k)
            else:
                fused = fuse_linear(dense_pairs, sparse, alpha, k)
            if graph_alpha > 0.0:
                fused = ds.graph.rank_with_graph(fused, graph_alpha, hops=graph_depth)[:k]
            if self.reranker is not None:
                try:
                    rr = self.reranker(text_query, [doc for doc, _ in fused])
                    fused = sorted(
                        zip((doc for doc, _ in fused), rr), key=lambda p: -p[1]
                    )[:k]
                except Exception:
                    pass  # the reranker's own failure degrades to the fused order
            for j, (doc, score) in enumerate(fused):
                out_ids[row, j] = doc
                out_scores[row, j] = score
                out_ok[row, j] = True
        return out_ids, out_scores, out_ok

    def graph_rerank(self, dataset: str, ids, scores, ok, graph_alpha: float,
                     graph_depth: int = 2):
        """Spreading-activation re-rank of dense results over the
        dataset's edge store."""
        ds = self.get(dataset)
        b, k = ids.shape
        out_ids = np.empty_like(ids)
        out_scores = np.zeros_like(scores)
        out_ok = np.zeros_like(ok)
        for row in range(b):
            pairs = [
                (ids[row, j],
                 float(scores[row, j]) if ds.metric == Metric.DOT else -float(scores[row, j]))
                for j in range(k)
                if ok[row, j]
            ]
            fused = ds.graph.rank_with_graph(pairs, graph_alpha, hops=graph_depth)[:k]
            for j, (doc, score) in enumerate(fused):
                out_ids[row, j] = doc
                out_scores[row, j] = score
                out_ok[row, j] = True
        return out_ids, out_scores, out_ok

    # -- GraphRAG actions ---------------------------------------------

    def add_edge(self, dataset, src, dst, edge_type="", weight=1.0, *, _log=True):
        graph = self.get(dataset).graph
        with self._guard(_log):
            if self.engine is not None and _log:
                self.engine.log_edge(dataset, src, dst, edge_type, weight)
            graph.add_edge(src, dst, edge_type, weight)

    def traverse_graph(self, dataset, src, dst=None, max_hops=3, strategy="bfs"):
        """Strategies bfs | weighted | astar | parallel. astar is guided by
        the embedding distance between stored vectors."""
        ds = self.get(dataset)
        g = ds.graph
        if dst is None:
            if strategy == "parallel":
                srcs = src if isinstance(src, (list, tuple)) else [src]
                return [
                    [node, hops, origin]
                    for node, (hops, origin) in g.parallel_bfs(srcs, max_hops).items()
                ]
            return g.traverse(src, max_hops)
        heuristic = ds.graph_heuristic() if strategy == "astar" else None
        return g.find_path(src, dst, max_hops, strategy=strategy, heuristic=heuristic)

    def graph_stats(self, dataset: str) -> dict:
        return self.get(dataset).graph.stats()

    def graph_analytics(self, dataset: str) -> dict:
        """Degree stats, hubs and weakly connected components."""
        return self.get(dataset).graph.analytics()

    # -- persistence --------------------------------------------------

    def snapshot(self) -> None:
        """Write every dataset's full state and drop the WAL it covers."""
        if self.engine is None:
            raise RuntimeError("store has no persist_dir")
        self.engine.snapshot(self)

    def close(self) -> None:
        """A final snapshot, then the WAL closed (a graceful shutdown)."""
        if self.engine is not None:
            self.engine.snapshot(self)
            self.engine.close()
