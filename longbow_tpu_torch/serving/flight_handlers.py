"""The Arrow Flight edge's request handlers, free of any transport.

Counterpart of the bodies of longbow_tpu/serving/flight_server.py
(reference: servers.go:28-190, store_actions.go, do_exchange.go): ticket
parsing, admission, search orchestration, the response columns, the
streaming table scan, the exchange protocols and the actions. The pyarrow
binding (serving/flight_server.py) maps each Flight call onto a method
here; chip_smoke.py and the tests call the methods directly.

The data model: every record batch in or out is an
storage/arrow_ipc.py::Table (numpy columns, the vector column 2-d, the
schema's custom metadata beside them), so that a batch crosses the wire
through the port's own IPC codec or through pyarrow alike. A schema is an
empty Table of the right column dtypes; a string column is an object array.
Action answers are JSON bytes. Refusals raise serving/errors.py's classes
with the reference's messages; what longbow_tpu lets propagate raw
(a ValueError out of a put, a KeyError out of an exchange) propagates raw.

The cluster layer (distributed/cluster.py's ClusterCoordinator, passed as
`cluster`) adds the replication metadata of DoPut, partition routing of
puts and exchange ingests, the search fan-out of DoGet, DoExchange and
VectorSearch (an unmet consistency level answers as unavailable), and the
cluster's actions. With `cluster=None` the node serves alone.
"""
from __future__ import annotations

import itertools
import json
import os
import queue
import socket
import threading
import time
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from longbow_tpu_torch.metrics import get_registry
from longbow_tpu_torch.query.parser import (
    _parse_filters,
    parse_consistency,
    parse_search_request,
    parse_ticket,
)
from longbow_tpu_torch.serving.errors import (
    BadRequestError,
    NotFoundError,
    ResourceExhaustedError,
    ServerError,
    UnavailableError,
)
from longbow_tpu_torch.serving.security import (
    AuditLogger,
    SanitizationError,
    sanitize_dataset_name,
    sanitize_search_request,
)
from longbow_tpu_torch.storage.arrow_ipc import Table
from longbow_tpu_torch.store.compaction import MemoryPressureError
from longbow_tpu_torch.utils.query_cache import QueryCache
from longbow_tpu_torch.utils.tracing import span
from longbow_tpu_torch.wire_types import METRIC_METADATA_KEY, NATIVE_VECTOR_DTYPES

_RESERVED = {"id", "vector", "timestamp"}

ACTIONS = [
    ("VectorSearch", "batched vector search"),
    ("VectorSearchByID", "search by stored id"),
    ("HybridSearch", "dense+sparse fusion search"),
    ("delete", "delete ids from a dataset"),
    ("delete-dataset", "drop a dataset"),
    ("CreateNamespace", "create a namespace"),
    ("check_readiness", "readiness probe"),
    ("cluster-status", "cluster membership + dataset stats"),
    ("MeshStatus", "membership member list"),
    ("MeshIdentity", "this node's own member record"),
    ("DiscoveryStatus", "discovery provider + current peers"),
    ("GetTotalNamespaceCount", "number of namespaces"),
    ("GetNamespaceDatasetCount", "datasets in one namespace"),
    ("region-summary", "spatial routing: dataset centroid+radius"),
    ("list-datasets", "list dataset names"),
    ("add-edge", "GraphRAG: add an edge"),
    ("traverse-graph", "GraphRAG: BFS traverse"),
    ("GetGraphStats", "GraphRAG: edge-store stats"),
    ("graph-analytics", "GraphRAG: degree/component analytics"),
    ("ForceSnapshot", "immediate local snapshot"),
    ("merkle-state", "anti-entropy: merkle root + leaves"),
    ("export-delta", "anti-entropy: rows of one merkle bucket"),
    ("checkpoint", "coordinated cluster snapshot (epoch barrier)"),
    ("checkpoint-prepare", "checkpoint barrier phase 1"),
    ("checkpoint-commit", "checkpoint barrier phase 2"),
]


@dataclass
class ExchangeChunk:
    """One message a DoExchange client sent: a batch, app metadata, or both."""

    data: Optional[Table] = None
    app_metadata: Optional[bytes] = None


class CollectingWriter:
    """A DoExchange writer that keeps what the handler wrote (in-process
    callers; the binding has its own that writes to the stream)."""

    def __init__(self):
        self.schema: Optional[Table] = None
        self.batches: list[Table] = []
        self.metadata: list[bytes] = []

    def begin(self, schema: Table) -> None:
        self.schema = schema

    def write_batch(self, table: Table) -> None:
        self.batches.append(table)

    def write_metadata(self, buf: bytes) -> None:
        self.metadata.append(bytes(buf))


@dataclass
class ScanStream:
    """A DoGet table scan: its schema (an empty Table) and its batches,
    made by a producer thread that stops when the generator is closed."""

    schema: Table
    batches: Iterator[Table]


@dataclass
class FlightListing:
    """A ListFlights / GetFlightInfo entry."""

    name: str
    schema: Table
    total_records: int


def _vectors(tbl: Table) -> np.ndarray:
    """The vector column, [n, d]: the reference's ingest dtypes
    (f32/f16/i8/u8/i32) kept, anything else as f32."""
    v = np.asarray(tbl.column("vector"))
    if v.ndim != 2:
        raise BadRequestError("the 'vector' column must hold fixed-size lists")
    if v.dtype not in NATIVE_VECTOR_DTYPES:
        v = v.astype(np.float32)
    return v


def _meta_columns(tbl: Table) -> dict:
    return {n: tbl.column(n) for n in tbl.column_names if n not in _RESERVED}


def _nbytes(tbl: Table) -> int:
    """The batch's payload bytes (a string column: its utf8 and offsets)."""
    total = 0
    for n in tbl.column_names:
        a = tbl.column(n)
        if a.dtype.kind in "OU":
            total += sum(len(str(v).encode()) for v in a) + 4 * (len(a) + 1)
        else:
            total += a.nbytes
    return total


def _ids_column(ids: list) -> np.ndarray:
    if ids and isinstance(ids[0], str):
        out = np.empty(len(ids), object)
        out[:] = ids
        return out
    return np.asarray([int(i) for i in ids], np.int64)


def _no_answer(qv: np.ndarray, k: int):
    """An empty local answer (the dataset lives only on peers)."""
    b = qv.shape[0] if qv.ndim == 2 else 1
    return np.empty((b, k), dtype=object), np.zeros((b, k), np.float32), np.zeros((b, k), bool)


def _key(uid):
    return uid.item() if hasattr(uid, "item") else uid


def _check_query_dim(ds, qv: np.ndarray) -> None:
    """A clear bad request on a query of the wrong width (ValueError, so
    that the callers count it as one)."""
    if ds is None:
        return
    if qv.ndim == 2 and qv.shape[1] != ds.dim:
        raise ValueError(
            f"query dimension {qv.shape[1]} != dataset {ds.name!r} dimension {ds.dim}"
        )


def _filters_to_wire(filters) -> list:
    return [
        {"field": f.field, "operator": f.operator, "value": f.value, "logic": f.logic}
        for f in (filters or [])
    ]


def _response_ids_scores(ids, scores, ok) -> dict:
    """VectorSearchResponse {ids, scores} flattened across the batch, with
    query_index (reference: requests.go:24-27)."""
    okm = np.asarray(ok)
    bi, ji = np.nonzero(okm)
    out_i = [_key(v) for v in ids[bi, ji]]
    out_s = np.asarray(scores)[bi, ji].astype(float).tolist()
    return {"ids": out_i, "scores": out_s, "query_index": bi.tolist()}


def dataset_schema(ds) -> Table:
    return Table(
        {"id": np.zeros(0, np.int64), "vector": np.zeros((0, ds.dim), np.float32)},
        {METRIC_METADATA_KEY: ds.metric},
    )


class FlightHandlers:
    """One store's Flight surface. Shared by every listener of a process
    (data, meta and their AF_UNIX mirrors), as the reference's servers
    share one VectorStore.

    metrics_registry: None means the process registry. middleware_chain:
    a MiddlewareChain (admission, breaker, degradation) or None.
    audit_logger: an AuditLogger (None: one that writes nothing).
    ingest_queue: an IngestQueue; puts are then acknowledged on enqueue.
    coalescer: a SearchCoalescer for plain searches.
    cluster: a distributed/cluster.py ClusterCoordinator, or None.
    """

    # ~2 MB record batches (reference: adaptive_chunk_strategy.go:10);
    # LONGBOW_SCAN_CHUNK_BYTES overrides
    SCAN_CHUNK_BYTES = int(os.environ.get("LONGBOW_SCAN_CHUNK_BYTES", 2 * 1024 * 1024))

    def __init__(
        self,
        store,
        *,
        metrics_registry=None,
        middleware_chain=None,
        audit_logger=None,
        ingest_queue=None,
        coalescer=None,
        cluster=None,
    ):
        self.store = store
        self.cluster = cluster
        self.coalescer = coalescer
        self.ingest = ingest_queue
        self.metrics = metrics_registry if metrics_registry is not None else get_registry()
        self.middleware = middleware_chain
        self.audit = audit_logger or AuditLogger()
        # namespaces created without a dim are "declared": listed at once,
        # materialized by the first put, persisted beside the WAL
        self._declared_mu = threading.Lock()
        self._declared_ns: set = set()
        self._declared_path = None
        eng = getattr(store, "engine", None)
        if eng is not None and getattr(eng, "dir", None) is not None:
            self._declared_path = os.path.join(str(eng.dir), "declared_namespaces.json")
            try:
                with open(self._declared_path) as f:
                    self._declared_ns = set(json.load(f))
            except (OSError, ValueError):
                pass

    # -- admission ----------------------------------------------------

    def _admit(self, op: str, peer: str) -> None:
        if self.middleware:
            self.middleware.admit(op, peer=peer)

    def _release(self, op: str) -> None:
        if self.middleware:
            self.middleware.release(op)

    # -- DoPut (reference: servers.go:44 -> store_actions.go:426) -------

    def do_put(
        self,
        dataset: Optional[str],
        schema_metadata: Optional[dict],
        batches: Iterable[Table],
        peer: str = "",
    ) -> Optional[bytes]:
        """Ingest a put stream into `dataset` (the descriptor's path).
        Returns the ack metadata to send back: the slow_down signal once
        the ingest queue is over 80% full, else None."""
        if not dataset:
            raise ServerError("DoPut requires a path descriptor")
        try:
            sanitize_dataset_name(dataset)
        except SanitizationError as e:
            raise BadRequestError(e) from e
        meta = schema_metadata or {}
        metric = meta.get(METRIC_METADATA_KEY)
        is_replication = meta.get("longbow.replication") == "1"
        origin_ts = float(meta["longbow.ts"]) if "longbow.ts" in meta else None
        if is_replication and self.cluster is not None and "longbow.vclock" in meta:
            # merge the origin's causality clock; concurrent writes are
            # counted as LWW-resolved conflicts (vector_clock.go:23)
            try:
                self.cluster.observe_remote_clock(dataset, json.loads(meta["longbow.vclock"]))
            except Exception:
                pass
        self._admit("DoPut", peer)
        try:
            with self.metrics.time_op("DoPut"):
                self._do_put_stream(batches, dataset, metric, is_replication, origin_ts)
            self.audit.record("put", dataset, {"replication": is_replication})
            if self.ingest is not None and self.ingest.pressure > 0.8:
                # the reference's backpressure contract (docs/admin_api.md)
                self.metrics.inc("longbow_wal_pressure_signals_total")
                return json.dumps({"status": "slow_down", "reason": "wal_pressure"}).encode()
            return None
        finally:
            self._release("DoPut")

    def _do_put_stream(self, batches, dataset, metric, is_replication, origin_ts) -> None:
        auto_base = None  # running id base of an id-less stream
        for tbl in batches:
            if tbl.num_rows == 0:
                continue
            if "vector" not in tbl.column_names:
                raise ServerError("DoPut batch needs a 'vector' column")
            vecs = _vectors(tbl)
            if "id" in tbl.column_names:
                ids = np.asarray(tbl.column("id"))
            else:
                if auto_base is None:
                    auto_base = len(self.store.get_or_create(dataset, vecs.shape[1], metric))
                ids = np.arange(auto_base, auto_base + len(vecs))
                auto_base += len(vecs)
            columns = _meta_columns(tbl)
            ts = origin_ts
            if ts is None and (self.cluster is not None or self.ingest is not None):
                ts = time.time()  # stamped once, so that replicas agree on LWW
            partitioned = self.cluster is not None and self.cluster.placement == "partitioned"
            if partitioned and not is_replication:
                # rows go to their ring owners; this node keeps its own
                # (reference: partition proxy sharding/proxy.go:21-145)
                keep = self.cluster.partition_put(dataset, ids, vecs, columns or None, metric, ts)
                if not keep.any():
                    continue
                ids, vecs = ids[keep], vecs[keep]
                if columns:
                    columns = {k: np.asarray(v)[keep] for k, v in columns.items()}
            try:
                if self.ingest is not None:
                    self.ingest.submit(dataset, ids, vecs, columns or None, metric, ts)
                else:
                    self.store.put(dataset, ids, vecs, columns or None, metric=metric,
                                   timestamp=ts)
            except MemoryPressureError as e:
                raise ResourceExhaustedError(e) from e
            except Exception:
                self.metrics.counter("longbow_ipc_decode_errors_total").inc()
                raise
            if self.cluster is not None and not is_replication and not partitioned:
                self.cluster.on_put(dataset, ids, vecs, columns or None, metric, ts)
            # rows applied here (after the partition split): forwarded rows
            # are counted by their owners, so the cluster-wide sum is each
            # row once
            self.metrics.inc("longbow_flight_rows_processed_total", len(ids),
                             method="DoPut", status="ok")
            self.metrics.inc("longbow_flight_bytes_processed_total", _nbytes(tbl),
                             method="DoPut")

    # -- DoGet (reference: servers.go:28 -> store_query.go:126) ---------

    def _search(self, dataset, qv, k, *, filters=None):
        """A plain search, through the coalescer where there is one."""
        if self.coalescer is not None:
            return self.coalescer.search(dataset, qv, k, filters=filters)
        return self.store.search(dataset, qv, k, filters=filters)

    def do_get(self, ticket: bytes, peer: str = ""):
        """A DoGet ticket -> a search answer (a Table) or a table scan (a
        ScanStream)."""
        self._admit("DoGet", peer)
        try:
            with self.metrics.time_op("DoGet"):
                with self.metrics.timer("longbow_flight_ticket_parse_duration_seconds"):
                    tq = parse_ticket(ticket)
                self.metrics.inc("longbow_zero_alloc_vector_search_parse_total")
                self.metrics.inc("longbow_doget_pipeline_steps_total", method="parse")
                out = self._do_search(tq) if tq.search is not None else self._do_scan(tq)
                # a success resets the breaker's consecutive failures
                if self.middleware:
                    self.middleware.record_success("DoGet")
                return out
        except KeyError as e:
            # a client's error: counted, but never toward the breaker
            self.metrics.inc("longbow_vector_search_action_errors_total")
            raise NotFoundError(e) from e
        except (ValueError, SanitizationError) as e:
            self.metrics.inc("longbow_vector_search_action_errors_total")
            raise BadRequestError(e) from e
        except TimeoutError as e:
            # a coalesced dispatch still running (a kernel's first build):
            # the server is making progress, so not toward the breaker
            self.metrics.inc("longbow_vector_search_action_errors_total")
            raise UnavailableError(str(e)) from e
        except Exception:
            if self.middleware:
                self.middleware.record_failure("DoGet")
            raise
        finally:
            self._release("DoGet")

    def _do_search(self, tq) -> Table:
        req = tq.search
        sanitize_search_request(req)
        dsname = req.dataset or tq.name
        fan_out = self._fans_out(req.local_only)
        try:
            ds = self.store.get(dsname)
        except KeyError:
            if not fan_out:
                raise
            ds = None  # the dataset lives only on peers: a global-only read
        qv = np.asarray(req.query_vectors(), dtype=np.float32)
        if qv.size == 0:
            raise ServerError("search needs vector or vectors")
        _check_query_dim(ds, qv)

        # graceful degradation: shed optional work under health pressure,
        # then serve stale cached answers (graceful_degradation.go)
        policy = None
        fb = self.middleware.fallback if self.middleware else None
        if self.middleware and self.middleware.degradation is not None:
            policy = self.middleware.degradation.search_policy()
        fb_key = None
        if fb is not None:
            fb_key = QueryCache.hash_query(
                dsname, qv.tobytes(), req.k, req.text_query, req.alpha, req.graph_alpha,
                req.fusion, req.include_vectors, _filters_to_wire(req.filters), req.local_only,
            )
            if policy is not None and policy["serve_stale"]:
                cached, found = fb.get(fb_key)
                if found:
                    self.metrics.counter("longbow_degraded_fallback_served_total").inc()
                    return cached
                if policy["cached_only"]:
                    raise UnavailableError("degraded (critical): only cached results served")
        allow_hybrid = policy is None or policy["allow_hybrid"]
        allow_graph = policy is None or policy["allow_graph_rerank"]

        t_search = time.perf_counter()
        hybrid = bool(req.text_query) and 0.0 <= req.alpha < 1.0 and allow_hybrid
        if ds is None:
            ids, scores, ok = _no_answer(qv, req.k)
        elif hybrid:
            ids, scores, ok = self.store.hybrid_search(
                ds.name, qv, req.k, text_query=req.text_query, alpha=req.alpha,
                filters=req.filters, graph_alpha=req.graph_alpha if allow_graph else 0.0,
                graph_depth=req.graph_depth, fusion=req.fusion,
            )
        else:
            ids, scores, ok = self._search(ds.name, qv, req.k, filters=req.filters)
            if req.graph_alpha > 0.0 and allow_graph:
                ids, scores, ok = self.store.graph_rerank(
                    ds.name, ids, scores, ok, req.graph_alpha, graph_depth=req.graph_depth,
                )
        if fan_out:
            # the cross-process global search: merge the alive peers' local
            # top-k (reference: store_query.go:696-717 -> global_search.go)
            hy = None
            if hybrid:
                hy = {"text_query": req.text_query, "alpha": req.alpha, "fusion": req.fusion,
                      "graph_alpha": req.graph_alpha if allow_graph else 0.0,
                      "graph_depth": req.graph_depth}
            ids, scores, ok = self._global_search(
                dsname, qv, req.k, raw_filters=_filters_to_wire(req.filters),
                local=(ids, scores, ok), metric=ds.metric if ds is not None else None,
                consistency=req.consistency, hybrid=hy,
            )
        self.metrics.inc("longbow_vector_search_action_requests_total")
        self.metrics.observe("longbow_vector_search_action_duration_seconds",
                             time.perf_counter() - t_search)
        self.metrics.inc("longbow_flight_operations_total", method="VectorSearch", status="ok")

        bi, ji = np.nonzero(np.asarray(ok))
        out_ids = ids[bi, ji].tolist()
        cols = {
            "id": _ids_column(out_ids),
            "score": np.asarray(scores)[bi, ji].astype(np.float32),
            "query_index": bi.astype(np.int32),
        }
        if req.include_vectors and out_ids and ds is not None:
            cols.update(self._result_vectors(ds, out_ids, req.vector_format))
        tbl = Table(cols)
        self.metrics.inc("longbow_flight_rows_processed_total", len(out_ids),
                         method="DoGet", status="ok")
        self.metrics.inc("longbow_flight_bytes_processed_total", _nbytes(tbl), method="DoGet")
        if fb is not None and fb_key is not None:
            fb.put(fb_key, tbl)  # the last good answer, for degraded serving
        return tbl

    def _fans_out(self, local_only) -> bool:
        return self.cluster is not None and not local_only and self.cluster.has_peers()

    def _global_search(self, dataset, qv, k, **kw):
        """cluster.global_search; an unmet consistency level is unavailable."""
        from longbow_tpu_torch.distributed.cluster import ConsistencyError

        try:
            return self.cluster.global_search(dataset, qv, k, **kw)
        except ConsistencyError as e:
            raise UnavailableError(str(e)) from e

    @staticmethod
    def _result_vectors(ds, out_ids: list, vector_format: str) -> dict:
        """The stored vectors of the answer's ids, in the requested wire
        format (reference: requests.go:19,34): "f32" (the default), "f16",
        or "quantized" (per-row symmetric int8 with its scale max|v|/127
        in a vector_scale column)."""
        rows = [ds._id_to_row.get(_key(i)) for i in out_ids]
        have = np.asarray([r is not None for r in rows])
        vecs = ds.get_vectors_by_rows(np.asarray([r if r is not None else 0 for r in rows]))
        vecs = np.where(have[:, None], vecs, 0.0).astype(np.float32)
        if vector_format == "f16":
            return {"vector": vecs.astype(np.float16)}
        if vector_format == "quantized":
            scale = np.maximum(np.abs(vecs).max(axis=1), 1e-30) / 127.0
            codes = np.clip(np.round(vecs / scale[:, None]), -127, 127).astype(np.int8)
            return {"vector": codes, "vector_scale": scale.astype(np.float32)}
        return {"vector": vecs}

    def _do_scan(self, tq) -> ScanStream:
        """A streaming table scan in ~SCAN_CHUNK_BYTES batches, never one
        host table (reference: doget_pipeline.go:33); filters, a limit,
        string ids and the metadata columns as in the reference SDK's
        download (client.py:259-291)."""
        ds = self.store.get(tq.name)
        ds.touch()  # a scan is an access (dataset TTL)
        n = ds.live_count
        limit = tq.limit if tq.limit > 0 else n
        items = ds._id_to_row
        # the (ids, rows) pairs, the index and the columns in ONE critical
        # section: a compaction between them renumbers the rows
        with ds._lock:
            str_ids = bool(items) and isinstance(next(iter(items)), str)
            take = len(items) if tq.filters or limit >= n else min(limit, len(items))
            id_dtype = object if str_ids else np.int64
            rows_all = np.fromiter(itertools.islice(items.values(), take), np.int64, take)
            id_all = np.fromiter(itertools.islice(items.keys(), take), id_dtype, take)
            idx = ds.index
            columns_snap = ds.columns
        if tq.filters:
            mask = ds.filter_mask(tq.filters, _columns=columns_snap, _index=idx)
            if mask is not None:
                keep = mask.cpu().numpy()[rows_all]
                rows_all, id_all = rows_all[keep], id_all[keep]
            rows_all, id_all = rows_all[:limit], id_all[:limit]
        npairs = len(rows_all)
        cols = columns_snap.host_view(rows_all) if columns_snap.fields() else {}
        col_names = sorted(cols)
        # f16 datasets stream f16 (the dtype they store; the reference's
        # scans return the stored dtype); everything else streams f32
        wire_f16 = getattr(ds, "dtype", None) == torch.float16
        vec_dtype = np.float16 if wire_f16 else np.float32
        schema = Table({"id": np.empty(0, id_dtype), "vector": np.zeros((0, ds.dim), vec_dtype),
                        **{c: cols[c][:0] for c in col_names}})
        rows_per = max(1, self.SCAN_CHUNK_BYTES // max(ds.dim * np.dtype(vec_dtype).itemsize, 1))
        if npairs == 0:
            return ScanStream(schema, iter(()))
        # one vector fetch per 32-batch block, sliced into wire batches: the
        # scan's memory never tracks the corpus
        superchunk = rows_per * 32
        stop = threading.Event()

        def put(q, item) -> bool:
            # a client abort sets `stop`; nothing drains the queue after it
            while not stop.is_set():
                try:
                    q.put(item, timeout=1.0)
                    return True
                except queue.Full:
                    continue
            return False

        def vectors_of(block_rows: np.ndarray) -> np.ndarray:
            if wire_f16:
                # the f16 mirror is the wire's dtype: no cast at all
                mr = getattr(idx, "mirror_rows", None)
                block = mr(block_rows) if mr else None
                if block is None or block.dtype != np.float16:
                    block = idx.get_vectors(block_rows).astype(np.float16)  # lossless
                return block
            return idx.get_vectors(block_rows)

        def produce(q) -> None:
            try:
                for soff in range(0, npairs, superchunk):
                    if stop.is_set():
                        return
                    block_rows = rows_all[soff: soff + superchunk]
                    vec_block = vectors_of(block_rows)
                    batches = []
                    for off in range(0, len(block_rows), rows_per):
                        a, b = soff + off, soff + min(off + rows_per, len(block_rows))
                        batch = {"id": id_all[a:b], "vector": vec_block[off: off + b - a]}
                        batch.update({c: cols[c][a:b] for c in col_names})
                        batches.append(Table(batch))
                    if not put(q, batches):
                        return
                put(q, None)
            except Exception as e:  # handed to the consumer, which raises it
                put(q, e)

        def gen() -> Iterator[Table]:
            q: queue.Queue = queue.Queue(maxsize=2)
            t = threading.Thread(target=produce, args=(q,), daemon=True, name="longbow-scan")
            t.start()
            n_batches = 0
            try:
                while True:
                    item = q.get()
                    if item is None:
                        break
                    if isinstance(item, Exception):
                        raise item
                    for b in item:
                        yield b
                        n_batches += 1
            finally:
                stop.set()  # an aborted stream releases the producer
                t.join(timeout=5.0)
                self.metrics.inc("longbow_doget_pipeline_steps_total", n_batches, method="scan")
                self.metrics.inc("longbow_doget_zero_copy_total", n_batches, type="vector")

        return ScanStream(schema, gen())

    # -- DoExchange (reference: do_exchange.go:47-284) -------------------

    def do_exchange(self, command: Optional[bytes], path: Optional[str],
                    reader: Iterable[ExchangeChunk], writer, peer: str = "") -> None:
        """A bidirectional stream. command: the descriptor's command (None
        for a path descriptor, whose path names an ingest); writer: begin /
        write_batch / write_metadata."""
        with span("longbow.edge.exchange"):
            self._admit("DoExchange", peer)
            self.metrics.inc("longbow_do_exchange_calls_total")
            t0 = time.perf_counter()
            try:
                cmd: Optional[dict] = {}
                if command is not None:
                    try:
                        cmd = json.loads(command or b"{}")
                    except ValueError:
                        cmd = None
                    if not isinstance(cmd, dict):
                        # any other command acks each message (do_exchange.go:186-260)
                        return self._exchange_legacy_ack(reader, writer)
                elif path:
                    cmd = {"protocol": "ingest", "dataset": path}
                proto = cmd.get("protocol", "ingest")
                if proto == "ingest":
                    return self._exchange_ingest(cmd, reader, writer)
                if proto in ("search", "VectorSearch"):
                    return self._exchange_search(cmd, reader, writer)
                return self._exchange_legacy_ack(reader, writer)
            finally:
                self.metrics.observe("longbow_do_exchange_duration_seconds",
                                     time.perf_counter() - t0)
                self._release("DoExchange")

    def _exchange_legacy_ack(self, reader, writer) -> None:
        writer.begin(Table({}))
        n = 0
        for chunk in reader:
            if chunk.data is None and chunk.app_metadata is None:
                continue
            writer.write_metadata(b"ack")
            n += 1
        self.metrics.inc("longbow_do_exchange_batches_sent_total", n)

    def _exchange_ingest(self, cmd, reader, writer) -> None:
        """Put batches in, one ack each with the running row count."""
        dataset = sanitize_dataset_name(cmd["dataset"])
        writer.begin(Table({"rows_ingested": np.zeros(0, np.int64)}))
        total = 0
        auto_base = None
        for chunk in reader:
            tbl = chunk.data
            if tbl is None or tbl.num_rows == 0:
                continue
            vecs = _vectors(tbl)
            if "id" in tbl.column_names:
                ids = np.asarray(tbl.column("id"))
            else:
                if auto_base is None:
                    # based at the dataset's current length, like DoPut
                    auto_base = len(self.store.get_or_create(dataset, vecs.shape[1], None))
                ids = np.arange(auto_base, auto_base + len(vecs))
                auto_base += len(vecs)
            columns = _meta_columns(tbl)
            ts = time.time() if self.cluster is not None else None
            partitioned = self.cluster is not None and self.cluster.placement == "partitioned"
            if partitioned:
                keep = self.cluster.partition_put(dataset, ids, vecs, columns or None, None, ts)
                ids, vecs = ids[keep], vecs[keep]
                columns = {k: np.asarray(v)[keep] for k, v in columns.items()}
            if len(ids):
                self.store.put(dataset, ids, vecs, columns or None, timestamp=ts)
                if self.cluster is not None and not partitioned:
                    # replicated placement: exchange-ingested rows are
                    # replicated as DoPut rows are
                    self.cluster.on_put(dataset, ids, vecs, columns or None, None, ts)
            total += tbl.num_rows
            writer.write_batch(Table({"rows_ingested": np.asarray([total], np.int64)}))

    def _exchange_search(self, cmd, reader, writer) -> None:
        """Query batches in, one result batch out for each, tagged with
        the incoming batch's index; the schema metadata carries the
        dataset's metric."""
        dataset = cmd["dataset"]
        k = int(cmd.get("k", 10))
        filters = _parse_filters(cmd["filters"]) if cmd.get("filters") else None
        text_query = cmd.get("text_query", "") or ""
        hy_alpha = float(cmd.get("alpha", 0.0))
        hy_fusion = cmd.get("fusion", "linear") or "linear"
        hy_galpha = float(cmd.get("graph_alpha", 0.0))
        hy_gdepth = int(cmd.get("graph_depth", 2))
        try:  # the ticket's rule (parse_search_request)
            consistency = parse_consistency(cmd.get("consistency"))
        except ValueError as e:
            raise BadRequestError(e) from e
        metric, str_ids, ds_metric = "", False, None
        try:
            ds = self.store.get(dataset)
            metric = ds_metric = ds.metric
            str_ids = isinstance(next(iter(ds._id_to_row), None), str)
        except KeyError:
            pass
        # the DoGet rule: peers' hops set local_only, a client's batch
        # merges the alive peers' top-k
        fan_out = self._fans_out(bool(cmd.get("local_only")))
        id_dtype = object if str_ids else np.int64
        writer.begin(Table(
            {"batch_index": np.zeros(0, np.int32), "query_index": np.zeros(0, np.int32),
             "id": np.empty(0, id_dtype), "score": np.zeros(0, np.float32)},
            {METRIC_METADATA_KEY: metric},
        ))
        bi = 0
        for chunk in reader:
            tbl = chunk.data
            if tbl is None or tbl.num_rows == 0:
                continue
            with span("longbow.edge.decode"):
                qv = _vectors(tbl)
            try:
                if text_query and 0.0 <= hy_alpha < 1.0:
                    ids, scores, ok = self.store.hybrid_search(
                        dataset, qv, k, text_query=text_query, alpha=hy_alpha,
                        filters=filters, fusion=hy_fusion, graph_alpha=hy_galpha,
                        graph_depth=hy_gdepth,
                    )
                else:
                    ids, scores, ok = self._search(dataset, qv, k, filters=filters)
            except KeyError:
                if not fan_out:
                    raise NotFoundError(repr(dataset)) from None
                ids, scores, ok = _no_answer(qv, k)
            if fan_out:
                hy = None
                if text_query and 0.0 <= hy_alpha < 1.0:
                    hy = {"text_query": text_query, "alpha": hy_alpha, "fusion": hy_fusion,
                          "graph_alpha": hy_galpha, "graph_depth": hy_gdepth}
                ids, scores, ok = self._global_search(
                    dataset, qv, k, raw_filters=cmd.get("filters"), local=(ids, scores, ok),
                    metric=ds_metric, consistency=consistency, hybrid=hy,
                )
            with span("longbow.edge.encode"):
                qi, ji = np.nonzero(np.asarray(ok))
                id_vals = ids[qi, ji]
                if str_ids:
                    id_arr = np.empty(len(id_vals), object)
                    id_arr[:] = [str(v) for v in id_vals]
                else:
                    id_arr = np.asarray([int(v) for v in id_vals], np.int64)
                writer.write_batch(Table(
                    {"batch_index": np.full(len(qi), bi, np.int32),
                     "query_index": qi.astype(np.int32), "id": id_arr,
                     "score": np.asarray(scores)[qi, ji].astype(np.float32)},
                    {METRIC_METADATA_KEY: metric},
                ))
            bi += 1

    # -- DoAction (reference: store_actions.go:29, servers.go:157) ------

    def do_action(self, name: str, body: Optional[bytes], peer: str = "") -> list[bytes]:
        """An action -> its answers, each JSON bytes."""
        self._admit(name, peer)
        try:
            with self.metrics.time_op(name):
                return self._do_action(name, body)
        except KeyError as e:
            raise NotFoundError(e) from e
        except ValueError as e:  # json.JSONDecodeError and SanitizationError too
            raise BadRequestError(e) from e
        finally:
            self._release(name)

    def _do_action(self, name: str, body: Optional[bytes]) -> list[bytes]:
        body = bytes(body) if body else b"{}"

        def ok(obj) -> list:
            return [json.dumps(obj).encode()]

        def req() -> dict:
            return json.loads(body or b"{}")

        if name == "check_readiness":
            r = self.store.readiness()
            if self.ingest is not None:
                depth = self.ingest.depth
                if depth > 0:
                    r["status"] = "BUSY"
                r["index_queue_depth"] = depth
            return ok(r)
        if name in ("health", "Health"):
            from longbow_tpu_torch.utils.health import (
                HealthManager,
                device_checker,
                storage_checker,
                store_checker,
            )

            hm = HealthManager()
            hm.register("store", store_checker(self.store))
            hm.register("storage", storage_checker(self.store))
            hm.register("device", device_checker())
            out = hm.check()
            if self.middleware is not None:
                if self.middleware.degradation is not None:
                    out["degradation"] = self.middleware.degradation.stats()
                if self.middleware.bulkhead.max_concurrent > 0:
                    out["bulkhead"] = self.middleware.bulkhead.stats()
            return ok(out)
        if name == "cluster-status":
            st = self.store.cluster_status()
            if self.cluster is not None:
                st.update(self.cluster.status())
            return ok(st)
        if name == "gossip-probe":
            # the SWIM relay (reference: mesh/gossip.go:235 ping-req,
            # :493-559 piggyback): probe a target for the asker, and always
            # exchange membership digests
            r = req()
            resp = {"ok": True}
            target = r.get("target")
            if target and self.cluster is not None:
                host, _, port = str(target).rpartition(":")
                try:
                    with socket.create_connection(
                        (host, int(port)), timeout=self.cluster.membership.probe_timeout_s,
                    ):
                        resp["ok"] = True
                except (OSError, ValueError):
                    resp["ok"] = False
            if self.cluster is not None:
                self.cluster.membership.merge_digest(r.get("digest"))
                resp["digest"] = self.cluster.membership.digest()
            return ok(resp)
        if name == "region-summary":
            # spatial routing: a centroid + radius per dataset, which peers
            # pull on a timer into their RegionRouter (mesh/region.go)
            from longbow_tpu_torch.distributed.spatial import dataset_region

            out = {}
            for nm in req().get("datasets") or self.store.list_datasets():
                try:
                    out[nm] = dataset_region(self.store.get(nm))
                except KeyError:
                    continue
            return ok({"regions": out})
        if name == "MeshStatus":
            if self.cluster is not None:
                st = self.cluster.status()
                return ok({"self": st.get("self"), "members": st.get("members", [])})
            return ok({"self": None, "members": []})
        if name == "MeshIdentity":
            if self.cluster is not None:
                me = self.cluster.status().get("self")
                return ok(me if isinstance(me, dict) else {"id": me, "status": "alive"})
            return ok({"id": "", "status": "alive"})
        if name == "DiscoveryStatus":
            if self.cluster is not None:
                mem = self.cluster.membership
                provider = (
                    "dns" if mem.dns_name
                    else "kubernetes" if mem.k8s_service
                    else "multicast" if mem.lan_group
                    else "static"
                )
                return ok({"provider": provider, "peers": [m.id for m in mem.members.values()]})
            return ok({"provider": "none", "peers": []})
        if name in ("list-datasets", "ListDatasets"):
            return ok(self.store.list_datasets())
        if name == "ListNamespaces":
            ns = sorted(self._all_namespaces())
            return ok({"namespaces": ns, "count": len(ns)})
        if name == "GetTotalNamespaceCount":
            return ok({"count": len(self._all_namespaces())})
        if name == "GetNamespaceDatasetCount":
            nsname = req().get("name", "")
            counts = self.store.namespace_dataset_counts()
            if nsname not in counts:
                raise ServerError(f"namespace {nsname!r} not found")
            return ok({"namespace": nsname, "count": counts[nsname]})
        if name == "CreateNamespace":
            r = req()
            dsname = sanitize_dataset_name(r.get("name", ""))
            if "dim" in r:
                self.store.get_or_create(
                    dsname, int(r["dim"]), r.get("metric"), index_kind=r.get("index"),
                    index_params={
                        k: v for k, v in r.items()
                        if k in ("pq_m", "rerank", "rerank_factor", "path", "storage",
                                 "n_cells", "n_probe", "mesh_shards", "graph_disk",
                                 "capacity", "n_clusters")
                    },
                )
            else:
                with self._declared_mu:
                    self._declared_ns.add(dsname)
                self._persist_declared()
            self.audit.record("create_namespace", dsname)
            return ok({"created": dsname})
        if name in ("delete-dataset", "DeleteNamespace"):
            r = req()
            # the reference SDK sends {"dataset": ...}; "name" is accepted too
            target = r.get("name") or r.get("dataset") or ""
            with self._declared_mu:
                was_declared = target in self._declared_ns
                self._declared_ns.discard(target)
            if was_declared:
                self._persist_declared()
            dropped = self.store.drop(target)
            self.audit.record("drop_dataset", target, {"dropped": dropped})
            return ok({"dropped": dropped})
        if name in ("delete", "Delete", "delete-vector"):
            r = req()
            # a port peer's replicated delete carries its origin's time and
            # is applied last-writer-wins; a client's, or a longbow_tpu
            # peer's (no time), is stamped here
            origin_ts = r.get("timestamp") if r.get("replicated") else None
            ts = time.time() if origin_ts is None else float(origin_ts)
            at = {"timestamp": ts, "replicated": origin_ts is not None}
            ids = r.get("ids")
            if ids is None and "id" in r:
                # the reference SDK's shape: one stringified id a call; tried
                # as sent (string ids), then as an int
                raw = r["id"]
                ids = [raw]
                n = self.store.delete(r["dataset"], ids, **at)
                if n == 0 and isinstance(raw, str) and raw.lstrip("-").isdigit():
                    ids = [int(raw)]
                    n = self.store.delete(r["dataset"], ids, **at)
            else:
                ids = ids or []
                n = self.store.delete(r["dataset"], ids, **at)
            self.audit.record("delete", r["dataset"], {"n": n})
            if self.cluster is not None and not r.get("replicated"):
                self.cluster.on_delete(r["dataset"], ids, ts)
            return ok({"deleted": n})
        if name == "VectorSearch":
            sreq = parse_search_request(json.loads(body))
            sanitize_search_request(sreq)  # the same caps as DoGet
            qv = np.asarray(sreq.query_vectors(), dtype=np.float32)
            local_ds = self.store._datasets.get(sreq.dataset)
            _check_query_dim(local_ds, qv)
            fan_out = self._fans_out(sreq.local_only)
            try:
                ids, scores, okm = self._search(sreq.dataset, qv, sreq.k, filters=sreq.filters)
            except KeyError:
                if not fan_out:
                    raise
                ids, scores, okm = _no_answer(qv, sreq.k)
            if fan_out:
                ids, scores, okm = self._global_search(
                    sreq.dataset, qv, sreq.k, raw_filters=_filters_to_wire(sreq.filters),
                    local=(ids, scores, okm),
                    metric=local_ds.metric if local_ds is not None else None,
                    consistency=sreq.consistency,
                )
            resp = _response_ids_scores(ids, scores, okm)
            if local_ds is not None:
                # the metric, so that a coordinator merges in the right direction
                resp["metric"] = local_ds.metric
            return ok(resp)
        if name == "VectorSearchByID":
            r = json.loads(body)
            ds = self.store.get(r["dataset"])
            ids, scores, okm = ds.search_by_id(r["id"], int(r.get("k", 10)))
            return ok(_response_ids_scores(ids, scores, okm))
        if name == "HybridSearch":
            sreq = parse_search_request(json.loads(body))
            sanitize_search_request(sreq)
            qv = np.asarray(sreq.query_vectors(), dtype=np.float32)
            if qv.size:
                _check_query_dim(self.store._datasets.get(sreq.dataset), qv)
            ids, scores, okm = self.store.hybrid_search(
                sreq.dataset, qv if qv.size else None, sreq.k, text_query=sreq.text_query,
                alpha=sreq.alpha, filters=sreq.filters, graph_alpha=sreq.graph_alpha,
                graph_depth=sreq.graph_depth, fusion=sreq.fusion,
            )
            return ok(_response_ids_scores(ids, scores, okm))
        if name == "add-edge":
            r = json.loads(body)
            # the reference SDK sends subject/predicate/object; from/to/type too
            src = r["from"] if "from" in r else r["subject"]
            dst = r["to"] if "to" in r else r["object"]
            etype = r.get("type", r.get("predicate", ""))
            self.store.add_edge(r["dataset"], src, dst, etype, float(r.get("weight", 1.0)))
            return ok({"added": True})
        if name == "traverse-graph":
            r = json.loads(body)
            if "start" in r and "from" not in r:
                # the reference's wire shape (graph_api.go:60): simple paths
                ds = self.store.get(r["dataset"])
                return ok(ds.graph.traverse_paths(
                    r["start"], max_hops=int(r.get("max_hops", 2) or 2),
                    incoming=bool(r.get("incoming", False)),
                    weighted=bool(r.get("weighted", True)),
                    decay=float(r.get("decay", 0.0) or 0.0),
                ))
            path = self.store.traverse_graph(
                r["dataset"], r["from"], r.get("to"), int(r.get("max_hops", 3)),
                strategy=r.get("strategy", "bfs"),
            )
            return ok({"path": path})
        if name == "GetGraphStats":
            return ok(self.store.graph_stats(json.loads(body).get("dataset", "")))
        if name == "graph-analytics":
            return ok(self.store.graph_analytics(json.loads(body).get("dataset", "")))
        if name == "checkpoint-prepare":
            # barrier phase 1: drain in-flight ingest so the snapshot covers
            # every acknowledged write
            r = req()
            ready = True
            if self.ingest is not None:
                ready = self.ingest.drain(timeout_s=float(r.get("timeout_s", 30.0)))
            return ok({"ready": ready, "epoch": r.get("epoch")})
        if name == "checkpoint-commit":
            r = req()
            if self.store.engine is None:
                return ok({"committed": False, "error": "no persist_dir"})
            self.store.snapshot()
            self.audit.record("checkpoint_commit", "*", {"epoch": r.get("epoch")})
            return ok({"committed": True, "epoch": r.get("epoch")})
        if name == "ForceSnapshot":
            drained = True
            if self.ingest is not None:
                drained = self.ingest.drain(timeout_s=30.0)
            if self.store.engine is None:
                return ok({"ok": False, "error": "no persist_dir"})
            self.store.snapshot()
            self.audit.record("snapshot", "*", {"drained": drained})
            if not drained:
                # rows still queued are NOT in this snapshot
                return ok({"ok": False, "drained": False,
                           "error": "ingest queue did not drain"})
            return ok({"ok": True})
        if name == "checkpoint":
            # the coordinator's entry point: a barrier of the alive peers on
            # an epoch, then a commit everywhere (alone: a local snapshot)
            r = req()
            if self.ingest is not None:
                self.ingest.drain(timeout_s=float(r.get("timeout_s", 30.0)))
            if self.cluster is not None and self.cluster.has_peers():
                result = self.cluster.coordinated_checkpoint(
                    timeout_s=float(r.get("timeout_s", 30.0)))
                if result["ok"] and self.store.engine is not None:
                    self.store.snapshot()
                    result["local"] = True
                return ok(result)
            if self.store.engine is None:
                return ok({"ok": False, "error": "no persist_dir"})
            self.store.snapshot()
            self.audit.record("checkpoint", "*")
            return ok({"ok": True, "local": True})
        if name == "merkle-state":
            return ok(self.store.get(json.loads(body)["dataset"]).merkle_state())
        if name == "export-delta":
            r = json.loads(body)
            ds = self.store.get(r["dataset"])
            if "buckets" in r:
                # the batched form: one round trip for many buckets
                haves = r.get("haves") or {}
                rows: list = []
                for b in r["buckets"]:
                    rows.extend(ds.export_delta(int(b), have=haves.get(str(b)))["rows"])
                return ok({"dataset": r["dataset"], "rows": rows})
            return ok(ds.export_delta(int(r["bucket"]), have=r.get("have")))
        raise ServerError(f"unknown action {name!r}")

    def list_actions(self) -> list[tuple[str, str]]:
        return list(ACTIONS)

    # -- discovery -------------------------------------------------------

    def _all_namespaces(self) -> set:
        with self._declared_mu:
            declared = {d.split("/", 1)[0] for d in self._declared_ns}
        return set(self.store.list_namespaces()) | declared

    def _persist_declared(self) -> None:
        if not self._declared_path:
            return
        try:
            with self._declared_mu:
                data = sorted(self._declared_ns)
            tmp = self._declared_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(data, f)
            os.replace(tmp, self._declared_path)
        except OSError:
            pass  # the in-memory set still serves

    def list_flights(self) -> list[FlightListing]:
        existing = self.store.list_datasets()
        out = []
        for name in existing:
            try:
                ds = self.store.get(name)
            except KeyError:  # dropped meanwhile
                continue
            out.append(FlightListing(name, dataset_schema(ds), ds.live_count))
        # declared, not yet materialized: an empty schema, no records
        with self._declared_mu:
            declared = set(self._declared_ns)
        out.extend(FlightListing(n, Table({}), 0) for n in sorted(declared - set(existing)))
        return out

    def get_flight_info(self, name: str) -> FlightListing:
        try:
            ds = self.store.get(name)
        except KeyError:
            with self._declared_mu:
                declared = name in self._declared_ns
            if declared:
                return FlightListing(name, Table({}), 0)
            raise
        return FlightListing(name, dataset_schema(ds), ds.live_count)

    def get_schema(self, name: str) -> Table:
        return dataset_schema(self.store.get(name))
