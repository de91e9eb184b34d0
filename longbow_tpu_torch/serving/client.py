"""Python client SDK — mirrors the reference SDK surface
(reference: longbowclientsdk/src/longbow/client.py:16 LongbowClient —
write/search/search_by_id/delete/namespaces over pyarrow.flight).

Counterpart of longbow_tpu/serving/client.py: the same calls and wire
shapes, so that it talks to either package's server; of the package it
reads only wire_types.py and distributed/ring.py.
"""
from __future__ import annotations

import json
from typing import Any, Optional

import numpy as np
import pyarrow as pa
import pyarrow.flight as flight

from longbow_tpu_torch.wire_types import METRIC_METADATA_KEY, NATIVE_VECTOR_DTYPES


class LongbowClient:
    def __init__(
        self,
        host: str = "localhost",
        data_port: int = 3000,
        meta_port: int = 3001,
        *,
        api_key: Optional[str] = None,
        tls_root_certs: Optional[bytes] = None,
        call_timeout_s: Optional[float] = None,
    ):
        """api_key: sent as `authorization: Bearer <key>` on every call
        (reference: SDK client.py:63-70). tls_root_certs: PEM CA bundle
        — switches the connection to grpc+tls. call_timeout_s: gRPC
        deadline applied to every call — a TCP-blackholed server then
        fails the call instead of hanging it forever (the cluster sets
        this on peer hops so circuit breakers actually open)."""
        scheme = "grpc+tls" if tls_root_certs else "grpc"
        if host.startswith("unix:"):
            # host-local fast path: host="unix:/run/longbow" connects
            # to <dir>/data.sock + <dir>/meta.sock mirrors (the server
            # side spawns them under LONGBOW_UNIX_SOCKET); measured
            # 1.3-1.6 GB/s vs 0.5-0.9 GB/s loopback TCP on this host
            # class (tools/flight_floor_probe.py)
            d = host[len("unix:"):]
            self.data_location = f"grpc+unix://{d}/data.sock"
            self.meta_location = f"grpc+unix://{d}/meta.sock"
        else:
            self.data_location = f"{scheme}://{host}:{data_port}"
            self.meta_location = f"{scheme}://{host}:{meta_port}"
        self._tls_root_certs = tls_root_certs
        _opt_kw = {}
        if api_key:
            _opt_kw["headers"] = [
                (b"authorization", f"Bearer {api_key}".encode())
            ]
        if call_timeout_s:
            _opt_kw["timeout"] = float(call_timeout_s)
        self._opts = flight.FlightCallOptions(**_opt_kw) if _opt_kw else None
        self._data: Optional[flight.FlightClient] = None
        self._meta: Optional[flight.FlightClient] = None
        # smart routing (reference: Go SmartClient client/client.go:15
        # — per-addr connection cache + ring-aware request placement)
        self._ring = None
        # last DoPut ack metadata (None, or {"status": "slow_down", ...})
        self.last_put_status: Optional[dict] = None
        self._route_conns: dict = {}

    def _new_conn(self, location: str) -> flight.FlightClient:
        if self._tls_root_certs:
            return flight.FlightClient(
                location, tls_root_certs=self._tls_root_certs
            )
        return flight.FlightClient(location)

    def connect(self) -> "LongbowClient":
        self._data = self._new_conn(self.data_location)
        self._meta = self._new_conn(self.meta_location)
        return self

    def enable_smart_routing(self) -> "LongbowClient":
        """Route writes directly to their partition owners (reference:
        SmartClient). Fetches cluster-status; a no-op on replicated
        deployments. Safe against a stale ring: the server re-routes
        any row it doesn't own."""
        st = self.cluster_status()
        if st.get("placement") == "partitioned" and st.get("ring_nodes"):
            from longbow_tpu_torch.distributed.ring import ConsistentHashRing

            self._ring = ConsistentHashRing(st["ring_nodes"])
        return self

    def _conn_for(self, node: str) -> flight.FlightClient:
        c = self._route_conns.get(node)
        if c is None:
            scheme = "grpc+tls" if self._tls_root_certs else "grpc"
            c = self._new_conn(f"{scheme}://{node}")
            self._route_conns[node] = c
        return c

    def close(self) -> None:
        for c in (self._data, self._meta, *self._route_conns.values()):
            if c is not None:
                c.close()
        self._route_conns.clear()

    def _dc(self) -> flight.FlightClient:
        if self._data is None:
            self.connect()
        return self._data

    def _mc(self) -> flight.FlightClient:
        if self._meta is None:
            self.connect()
        return self._meta

    # ------------------------------------------------------------------

    def write(
        self,
        dataset: str,
        ids,
        vectors: np.ndarray,
        columns: Optional[dict] = None,
        metric: Optional[str] = None,
        *,
        timestamp: Optional[float] = None,
        replicated: bool = False,
        clock: Optional[dict] = None,
    ) -> None:
        """DoPut a batch (reference: client.py write :113).

        timestamp/replicated ride as schema metadata: replica writes
        carry the ORIGIN timestamp (LWW stays correct across hops) and
        the replication marker stops the receiving node from fanning
        the write out again (reference marks replication traffic via
        its dedicated exchange protocol, do_exchange.go:47)."""
        vectors = np.atleast_2d(np.asarray(vectors))
        if vectors.dtype not in self._VEC_DTYPES:
            vectors = vectors.astype(np.float32)
        n, d = vectors.shape
        ids = np.asarray(ids)
        meta = {}
        if metric:
            meta[METRIC_METADATA_KEY] = metric
        if timestamp is not None:
            meta["longbow.ts"] = repr(float(timestamp))
        if replicated:
            meta["longbow.replication"] = "1"
        if clock:
            # origin vector clock: receivers merge + flag concurrent
            # (conflicting) writes (reference: vector_clock.go:23)
            meta["longbow.vclock"] = json.dumps(clock)
        if self._ring is not None and not replicated:
            # smart routing: one direct put per owner (reference:
            # SmartClient routes by key, saving the server-side
            # forward hop). Stamp the timestamp once so owners agree.
            if "longbow.ts" not in meta:
                import time as _t

                meta["longbow.ts"] = repr(_t.time())
            owners = np.asarray(
                [self._ring.lookup(str(i)) for i in ids.tolist()]
            )
            for node in sorted(set(owners.tolist())):
                sl = owners == node
                self._put_slice(
                    self._conn_for(node), dataset, ids[sl], vectors[sl],
                    {k: np.asarray(v)[sl] for k, v in (columns or {}).items()},
                    meta,
                )
            return
        self._put_slice(
            self._dc(), dataset, ids, vectors, columns or {}, meta
        )

    def _put_slice(self, conn, dataset, ids, vectors, columns, meta):
        d = vectors.shape[1]
        id_arr = (
            pa.array([str(i) for i in ids], pa.string())
            if ids.dtype.kind in "OUS"
            else pa.array(ids.astype(np.int64), pa.int64())
        )
        cols = {
            "id": id_arr,
            "vector": pa.FixedSizeListArray.from_arrays(
                pa.array(
                    np.ascontiguousarray(vectors).reshape(-1),
                    pa.from_numpy_dtype(vectors.dtype),
                ),
                d,
            ),
        }
        for name, vals in (columns or {}).items():
            cols[name] = pa.array(np.asarray(vals))
        table = pa.table(cols)
        if meta:
            table = table.replace_schema_metadata(meta)
        descriptor = flight.FlightDescriptor.for_path(dataset)
        writer, meta_reader = conn.do_put(
            descriptor, table.schema, options=self._opts
        )
        writer.write_table(table)
        writer.done_writing()
        # server backpressure signal (reference: admin_api.md — DoPut
        # acks {"status": "slow_down"} at 80% queue pressure); callers
        # poll last_put_status and back off
        try:
            buf = meta_reader.read()
            self.last_put_status = (
                json.loads(buf.to_pybytes()) if buf is not None else None
            )
        except Exception:
            self.last_put_status = None
        writer.close()

    def search(
        self,
        dataset: str,
        vector=None,
        k: int = 10,
        *,
        vectors=None,
        filters: Optional[list] = None,
        text_query: str = "",
        alpha: float = 0.0,
        graph_alpha: float = 0.0,
        graph_depth: int = 0,
        include_vectors: bool = False,
    ) -> pa.Table:
        """DoGet search -> arrow table {id, score, query_index[, vector]}
        (reference: client.py search :192 ticket format)."""
        req: dict[str, Any] = {"dataset": dataset, "k": k}
        if vector is not None:
            v = np.asarray(vector, dtype=np.float32)
            if (
                v.ndim >= 2
                and v.shape[0] >= 256
                and not text_query
                and not graph_alpha
                and not graph_depth
                and not include_vectors
            ):
                # large batches ride DoExchange (Arrow both ways): the
                # JSON ticket measured 253 ms for one 2048x128 batch
                # (float text dominates) vs 8.0 ms via exchange — served
                # 257k QPS on chip, parity with the bare kernel
                t = self.exchange_search(
                    dataset, [v.reshape(v.shape[0], -1)], k=k,
                    filters=filters,
                )[0]
                return t.drop_columns(["batch_index"])
            if v.ndim >= 2:
                # a [B, D] batch passed positionally: send as "vectors"
                # — ravel()ing it read as one (B*D)-dim query and the
                # server rejected the dimension
                req["vectors"] = v.reshape(v.shape[0], -1).tolist()
            else:
                req["vector"] = v.ravel().tolist()
        if vectors is not None:
            req["vectors"] = np.asarray(vectors, dtype=np.float32).tolist()
        if filters:
            req["filters"] = filters
        if text_query:
            req["text_query"] = text_query
            req["alpha"] = alpha
        if graph_alpha:
            req["graph_alpha"] = graph_alpha
        if graph_depth:
            req["graph_depth"] = graph_depth
        if include_vectors:
            req["include_vectors"] = True
        ticket = flight.Ticket(json.dumps({"search": req}).encode())
        return self._dc().do_get(ticket, options=self._opts).read_all()

    def scan(
        self, dataset: str, limit: int = 0, filters: list | None = None
    ) -> pa.Table:
        req: dict = {"name": dataset, "limit": limit}
        if filters:
            req["filters"] = filters
        ticket = flight.Ticket(json.dumps(req).encode())
        return self._dc().do_get(ticket, options=self._opts).read_all()

    def scan_stream(self, dataset: str, filters: list | None = None):
        """Stream record batches (reference SDK download_stream,
        client.py:259-291) — bounded client memory at any size."""
        req: dict = {"name": dataset}
        if filters:
            req["filters"] = filters
        ticket = flight.Ticket(json.dumps(req).encode())
        for chunk in self._dc().do_get(ticket, options=self._opts):
            yield chunk.data

    def snapshot(self) -> dict:
        """Force an immediate local snapshot (reference SDK snapshot(),
        ForceSnapshot action)."""
        return self._action("ForceSnapshot", {})

    def get_info(self, dataset: str) -> dict:
        """Dataset schema + row count (reference SDK get_info,
        client.py:357-369: GetFlightInfo on the meta port)."""
        info = self._mc().get_flight_info(
            flight.FlightDescriptor.for_path(dataset), options=self._opts
        )
        return {
            "schema": str(info.schema),
            "total_records": info.total_records,
            "total_bytes": info.total_bytes,
        }

    # -- actions -------------------------------------------------------

    def _action(self, name: str, body: dict, meta: bool = True):
        client = self._mc() if meta else self._dc()
        action = flight.Action(name, json.dumps(body).encode())
        out = [
            json.loads(r.body.to_pybytes())
            for r in client.do_action(action, options=self._opts)
        ]
        return out[0] if out else {}

    def search_by_id(self, dataset: str, id, k: int = 10) -> dict:
        return self._action(
            "VectorSearchByID", {"dataset": dataset, "id": id, "k": k}
        )

    def hybrid_search(
        self, dataset: str, vector=None, text_query: str = "",
        k: int = 10, alpha: float = 0.5, filters: list | None = None,
    ) -> dict:
        body = {"dataset": dataset, "k": k, "alpha": alpha,
                "text_query": text_query}
        if vector is not None:
            body["vector"] = np.asarray(vector, np.float32).ravel().tolist()
        if filters:
            body["filters"] = filters
        return self._action("HybridSearch", body)

    def delete(self, dataset: str, ids: list) -> int:
        ids = [i.item() if hasattr(i, "item") else i for i in ids]
        return self._action("delete", {"dataset": dataset, "ids": ids})[
            "deleted"
        ]

    def delete_namespace(self, dataset: str) -> bool:
        return self._action("delete-dataset", {"name": dataset})["dropped"]

    def create_namespace(
        self, name: str, force: bool = False, *, dim: int = 0,
        index: str = "", metric: str = "", **index_params,
    ) -> dict:
        """Create a namespace; with dim (+ optional index kind, metric
        and index params like capacity/pq_m/n_clusters/storage) the
        dataset is created eagerly with that index instead of the
        first-put default (reference: pluggable index selection)."""
        body: dict = {"name": name, "overwrite": force}
        if dim:
            body["dim"] = int(dim)
            if index:
                body["index"] = index
            if metric:
                body["metric"] = metric
            body.update(index_params)
        return self._action("CreateNamespace", body)

    def list_namespaces(self) -> list:
        flights = (
            self._mc().list_flights(options=self._opts)
            if self._opts is not None
            else self._mc().list_flights()
        )
        return [f.descriptor.path[0].decode() for f in flights]

    def check_readiness(self) -> dict:
        return self._action("check_readiness", {})

    def cluster_status(self) -> dict:
        return self._action("cluster-status", {})

    def add_edge(self, dataset: str, src, dst, edge_type="", weight=1.0):
        return self._action(
            "add-edge",
            {"dataset": dataset, "from": src, "to": dst,
             "type": edge_type, "weight": weight},
        )

    def traverse_graph(self, dataset: str, src, dst=None, max_hops=3):
        return self._action(
            "traverse-graph",
            {"dataset": dataset, "from": src, "to": dst,
             "max_hops": max_hops},
        )["path"]

    # -- DoExchange (reference: do_exchange.go protocols) --------------

    def exchange_ingest(self, dataset: str, batches) -> int:
        """Stream put-batches; returns total acked rows. `batches` is an
        iterable of (ids, vectors) pairs."""
        descriptor = flight.FlightDescriptor.for_command(
            json.dumps({"protocol": "ingest", "dataset": dataset}).encode()
        )
        first_ids, first_vecs = None, None
        it = iter(batches)
        first = next(it)
        schema = self._put_schema(first)
        writer, reader = self._dc().do_exchange(descriptor, options=self._opts)
        total = 0
        writer.begin(schema)
        for ids, vecs in [first, *it]:
            writer.write_table(self._put_table(ids, vecs))
            ack = reader.read_chunk().data
            total = ack.column("rows_ingested")[0].as_py()
        writer.close()
        return total

    def exchange_search(
        self,
        dataset: str,
        query_batches,
        k: int = 10,
        *,
        filters=None,
        local_only: bool = False,
        with_metric: bool = False,
        hybrid: dict | None = None,
    ):
        """Stream query batches; returns one arrow table per batch
        (Arrow both directions — the peer global-search transport).
        with_metric=True -> (tables, metric_from_schema_metadata).
        hybrid: optional {"text_query", "alpha", "fusion",
        "graph_alpha", "graph_depth"} carried in the command so peers
        run their LOCAL hybrid pipeline — the reference forwards the
        entire VectorSearchRequest through global search
        (global_search.go:48; requests.go:4-21)."""
        cmd = {"protocol": "search", "dataset": dataset, "k": k}
        if filters:
            cmd["filters"] = filters
        if local_only:
            cmd["local_only"] = True
        if hybrid and hybrid.get("text_query"):
            cmd.update({
                "text_query": hybrid["text_query"],
                "alpha": float(hybrid.get("alpha", 0.0)),
                "fusion": hybrid.get("fusion", "linear") or "linear",
                "graph_alpha": float(hybrid.get("graph_alpha", 0.0)),
                "graph_depth": int(hybrid.get("graph_depth", 2)),
            })
        descriptor = flight.FlightDescriptor.for_command(
            json.dumps(cmd).encode()
        )
        writer, reader = self._dc().do_exchange(descriptor, options=self._opts)
        out = []
        first = np.atleast_2d(np.asarray(query_batches[0], np.float32))
        schema = pa.schema(
            [pa.field("vector", pa.list_(pa.float32(), first.shape[1]))]
        )
        writer.begin(schema)
        for q in query_batches:
            q = np.atleast_2d(np.asarray(q, np.float32))
            writer.write_table(
                pa.table(
                    {
                        "vector": pa.FixedSizeListArray.from_arrays(
                            pa.array(q.reshape(-1), pa.float32()), q.shape[1]
                        )
                    }
                )
            )
            out.append(pa.Table.from_batches([reader.read_chunk().data]))
        writer.close()
        if with_metric:
            metric = ""
            meta = out[0].schema.metadata if out else None
            key = METRIC_METADATA_KEY.encode()
            if meta and key in meta:
                metric = meta[key].decode()
            return out, metric
        return out

    # wire dtypes preserved end-to-end (canonical matrix:
    # wire_types.NATIVE_VECTOR_DTYPES); everything else casts to f32.
    # float64 is deliberately NOT preserved: np.asarray over plain
    # Python lists (the most common SDK input) defaults to f64, which
    # would double wire + WAL bytes for precision every index kind
    # discards at staging anyway.
    _VEC_DTYPES = NATIVE_VECTOR_DTYPES

    @classmethod
    def _put_table(cls, ids, vecs) -> pa.Table:
        vecs = np.atleast_2d(np.asarray(vecs))
        if vecs.dtype not in cls._VEC_DTYPES:
            vecs = vecs.astype(np.float32)
        ids = np.asarray(ids)
        id_arr = (
            pa.array([str(i) for i in ids], pa.string())
            if ids.dtype.kind in "OUS"
            else pa.array(ids.astype(np.int64), pa.int64())
        )
        return pa.table(
            {
                "id": id_arr,
                "vector": pa.FixedSizeListArray.from_arrays(
                    pa.array(
                        np.ascontiguousarray(vecs).reshape(-1),
                        pa.from_numpy_dtype(vecs.dtype),
                    ),
                    vecs.shape[1],
                ),
            }
        )

    def _put_schema(self, first) -> pa.Schema:
        return self._put_table(*first).schema
