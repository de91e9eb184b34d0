"""The Arrow Flight binding: gRPC servers over serving/flight_handlers.py.

Counterpart of longbow_tpu/serving/flight_server.py's transport: the
`LongbowFlightServer` (bearer tokens and TLS through serving/security.py),
the AF_UNIX `UnixSocketMirror`, `ServerHandle` and `serve()`, which start
the data (:3000) and meta (:3001) servers over one store (reference:
cmd/longbow/main.go:476-521). Every Flight call converts its pyarrow
batches to arrow_ipc.Table columns (numpy views, no IPC round trip), calls
the handler and converts the answer back; the handlers' refusals become
the Flight errors longbow_tpu raises, with the same messages.

This module and serving/client.py are the only ones of the package that
import pyarrow at module level, and nothing imports them on the card's
path: the handlers, the middleware and serve.py's build_runtime run
without pyarrow.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

import numpy as np
import pyarrow as pa
import pyarrow.flight as flight

from longbow_tpu_torch.serving.errors import ServerError, ServingError, UnavailableError
from longbow_tpu_torch.serving.flight_handlers import (
    ExchangeChunk,
    FlightHandlers,
    ScanStream,
)
from longbow_tpu_torch.storage.arrow_ipc import Table
from longbow_tpu_torch.wire_types import NATIVE_VECTOR_DTYPES


def _flight_error(e: ServingError) -> flight.FlightError:
    if isinstance(e, UnavailableError):
        return flight.FlightUnavailableError(str(e))
    return flight.FlightServerError(str(e))


@contextlib.contextmanager
def _as_flight_errors():
    try:
        yield
    except ServingError as e:
        raise _flight_error(e) from e


# -- pyarrow <-> Table ----------------------------------------------------

def _vector_column(col: pa.Array) -> np.ndarray:
    """list<T> / fixed_size_list<T> -> [n, d]: the reference's ingest
    dtypes (f32/f16/i8/u8/i32) kept, f32 otherwise."""
    if pa.types.is_fixed_size_list(col.type):
        vals = np.asarray(col.flatten())
        if vals.dtype not in NATIVE_VECTOR_DTYPES:
            vals = vals.astype(np.float32)
        return vals.reshape(-1, col.type.list_size)
    return np.asarray(col.to_pylist(), dtype=np.float32)


def _plain_column(col: pa.Array) -> np.ndarray:
    """An id or metadata column -> numpy (strings as an object array).
    A null would silently turn an int column into floats: refused."""
    if col.null_count:
        raise ServerError("null values are not allowed in id/metadata columns")
    return np.asarray(col.to_numpy(zero_copy_only=False))


def to_table(data) -> Table:
    """A pyarrow RecordBatch or Table -> Table."""
    cols = {}
    for name, col in zip(data.schema.names, data.columns):
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        cols[name] = _vector_column(col) if name == "vector" else _plain_column(col)
    meta = {k.decode(): v.decode() for k, v in (data.schema.metadata or {}).items()}
    return Table(cols, meta)


def _arrow_array(a: np.ndarray) -> pa.Array:
    if a.ndim == 2:
        return pa.FixedSizeListArray.from_arrays(
            pa.array(np.ascontiguousarray(a).reshape(-1), pa.from_numpy_dtype(a.dtype)),
            a.shape[1],
        )
    if a.dtype.kind in "OU":
        return pa.array(a, pa.string())
    return pa.array(a)


def to_record_batch(t: Table) -> pa.RecordBatch:
    arrays = [_arrow_array(np.asarray(t.column(n))) for n in t.column_names]
    schema = pa.schema(
        [pa.field(n, a.type) for n, a in zip(t.column_names, arrays)],
        metadata=t.schema_metadata or None,
    )
    return pa.RecordBatch.from_arrays(arrays, schema=schema)


def to_schema(t: Table) -> pa.Schema:
    return to_record_batch(t).schema


def _peer(context) -> str:
    """The client's address ('' where the binding gives none): the
    per-client rate limiter's key."""
    try:
        return context.peer() or ""
    except Exception:
        return ""


class _ExchangeWriter:
    """The handlers' writer protocol over a Flight stream writer."""

    def __init__(self, writer):
        self._w = writer

    def begin(self, schema: Table) -> None:
        self._w.begin(to_schema(schema))

    def write_batch(self, t: Table) -> None:
        self._w.write_batch(to_record_batch(t))

    def write_metadata(self, buf: bytes) -> None:
        self._w.write_metadata(buf)


def _exchange_chunks(reader):
    for chunk in reader:
        meta = chunk.app_metadata
        yield ExchangeChunk(
            to_table(chunk.data) if chunk.data is not None else None,
            meta.to_pybytes() if meta is not None else None,
        )


def _record_batches(batches):
    """A scan's Tables as RecordBatches; closing this closes the scan
    (whose producer thread then stops)."""
    try:
        with _as_flight_errors():
            for t in batches:
                yield to_record_batch(t)
    finally:
        batches.close()


class LongbowFlightServer(flight.FlightServerBase):
    """One Flight listener over a store's FlightHandlers (built here
    unless `handlers` is given: a meta server shares the data server's).

    auth_token: a token (or list of tokens) every call must carry as
    `authorization: Bearer <token>`. tls_cert_file / tls_key_file: serve
    grpc+tls. cluster: a ClusterCoordinator (distributed/cluster.py) or None."""

    def __init__(
        self,
        store,
        location: str = "grpc://0.0.0.0:3000",
        *,
        metrics_registry=None,
        middleware_chain=None,
        audit_logger=None,
        cluster=None,
        ingest_queue=None,
        coalescer=None,
        auth_token=None,
        tls_cert_file=None,
        tls_key_file=None,
        handlers: Optional[FlightHandlers] = None,
        **kw,
    ):
        if auth_token:
            from longbow_tpu_torch.serving.security import bearer_middleware

            tokens = [auth_token] if isinstance(auth_token, str) else auth_token
            mw = dict(kw.pop("middleware", None) or {})
            mw.update(bearer_middleware(tokens))
            kw["middleware"] = mw
        if tls_cert_file or tls_key_file:
            from longbow_tpu_torch.serving.security import load_tls_certificates

            if not (tls_cert_file and tls_key_file):
                missing = "LONGBOW_TLS_KEY_FILE" if tls_cert_file else "LONGBOW_TLS_CERT_FILE"
                raise ValueError(f"TLS needs both cert and key: {missing} is not set")
            kw["tls_certificates"] = load_tls_certificates(tls_cert_file, tls_key_file)
            location = location.replace("grpc://", "grpc+tls://", 1)
        # auth carries over to a unix-socket mirror; TLS does not (AF_UNIX
        # is protected by the file's permissions)
        self._mirror_kw = {"middleware": kw["middleware"]} if "middleware" in kw else {}
        super().__init__(location, **kw)
        self.store = store
        self.location = location
        self.handlers = handlers or FlightHandlers(
            store, metrics_registry=metrics_registry, middleware_chain=middleware_chain,
            audit_logger=audit_logger, ingest_queue=ingest_queue, coalescer=coalescer,
            cluster=cluster,
        )

    def do_put(self, context, descriptor, reader, writer):
        dataset = descriptor.path[0].decode() if descriptor.path else None
        meta = {k.decode(): v.decode() for k, v in (reader.schema.metadata or {}).items()}
        batches = (to_table(chunk.data) for chunk in reader)
        with _as_flight_errors():
            ack = self.handlers.do_put(dataset, meta, batches, peer=_peer(context))
        if ack is not None and writer is not None:
            try:
                writer.write(pa.py_buffer(ack))
            except Exception:
                pass  # the client went away; its rows are in

    def do_get(self, context, ticket):
        with _as_flight_errors():
            out = self.handlers.do_get(ticket.ticket, peer=_peer(context))
        if isinstance(out, ScanStream):
            return flight.GeneratorStream(to_schema(out.schema), _record_batches(out.batches))
        return flight.RecordBatchStream(pa.Table.from_batches([to_record_batch(out)]))

    def do_exchange(self, context, descriptor, reader, writer):
        command, path = None, None
        if descriptor.descriptor_type == flight.DescriptorType.CMD:
            command = descriptor.command or b""
        elif descriptor.path:
            path = descriptor.path[0].decode()
        with _as_flight_errors():
            self.handlers.do_exchange(command, path, _exchange_chunks(reader),
                                      _ExchangeWriter(writer), peer=_peer(context))

    def do_action(self, context, action):
        body = action.body.to_pybytes() if action.body else b"{}"
        with _as_flight_errors():
            return self.handlers.do_action(action.type, body, peer=_peer(context))

    def list_actions(self, context):
        return self.handlers.list_actions()

    def list_flights(self, context, criteria):
        for f in self.handlers.list_flights():
            yield flight.FlightInfo(
                to_schema(f.schema), flight.FlightDescriptor.for_path(f.name.encode()), [],
                f.total_records, -1,
            )

    def get_flight_info(self, context, descriptor):
        f = self.handlers.get_flight_info(descriptor.path[0].decode())
        return flight.FlightInfo(to_schema(f.schema), descriptor, [], f.total_records, -1)

    def get_schema(self, context, descriptor):
        return flight.SchemaResult(to_schema(self.handlers.get_schema(descriptor.path[0].decode())))

    def spawn_unix_mirror(self, path: str) -> "UnixSocketMirror":
        """A companion listener on an AF_UNIX socket sharing this server's
        handlers: the fast path for co-located clients."""
        return UnixSocketMirror(self, path, **self._mirror_kw)


class UnixSocketMirror(flight.FlightServerBase):
    """A delegating listener: every call is served by the primary
    LongbowFlightServer; only the transport differs."""

    def __init__(self, primary: LongbowFlightServer, path: str, **kw):
        if os.path.exists(path):
            os.unlink(path)  # a stale socket of an earlier run
        super().__init__(f"grpc+unix://{path}", **kw)
        self._primary = primary
        self.path = path
        try:
            os.chmod(path, 0o600)  # local only; no TLS on AF_UNIX
        except OSError:
            pass

    def do_put(self, context, descriptor, reader, writer):
        return self._primary.do_put(context, descriptor, reader, writer)

    def do_get(self, context, ticket):
        return self._primary.do_get(context, ticket)

    def do_exchange(self, context, descriptor, reader, writer):
        return self._primary.do_exchange(context, descriptor, reader, writer)

    def do_action(self, context, action):
        return self._primary.do_action(context, action)

    def list_actions(self, context):
        return self._primary.list_actions(context)

    def list_flights(self, context, criteria):
        return self._primary.list_flights(context, criteria)

    def get_flight_info(self, context, descriptor):
        return self._primary.get_flight_info(context, descriptor)

    def get_schema(self, context, descriptor):
        return self._primary.get_schema(context, descriptor)


class ServerHandle:
    def __init__(self, data_server, meta_server, threads, mirrors=()):
        self.data_server = data_server
        self.meta_server = meta_server
        self.mirrors = list(mirrors)
        self._threads = threads

    def shutdown(self):
        for m in self.mirrors:
            m.shutdown()
        self.data_server.shutdown()
        self.meta_server.shutdown()
        for t in self._threads:
            t.join(timeout=5)


def serve(
    store,
    data_port: int = 3000,
    meta_port: int = 3001,
    host: str = "0.0.0.0",
    block: bool = False,
    middleware_chain=None,
    unix_socket_dir: Optional[str] = None,
    handlers: Optional[FlightHandlers] = None,
) -> ServerHandle:
    """Start the data and meta Flight servers over one store's handlers
    (the given ones, else new ones); unix_socket_dir: also listen on
    <dir>/data.sock and <dir>/meta.sock."""
    handlers = handlers or FlightHandlers(store, middleware_chain=middleware_chain)
    data = LongbowFlightServer(store, f"grpc://{host}:{data_port}", handlers=handlers)
    meta = LongbowFlightServer(store, f"grpc://{host}:{meta_port}", handlers=handlers)
    threads, mirrors = [], []
    if unix_socket_dir:
        os.makedirs(unix_socket_dir, exist_ok=True)
        for srv, sock in ((data, "data.sock"), (meta, "meta.sock")):
            m = srv.spawn_unix_mirror(os.path.join(unix_socket_dir, sock))
            t = threading.Thread(target=m.serve, daemon=True)
            t.start()
            threads.append(t)
            mirrors.append(m)
    if block:
        t = threading.Thread(target=meta.serve, daemon=True)
        t.start()
        threads.append(t)
        data.serve()
    else:
        for srv in (data, meta):
            t = threading.Thread(target=srv.serve, daemon=True)
            t.start()
            threads.append(t)
    return ServerHandle(data, meta, threads, mirrors)
