"""longbow_tpu_torch's Flight edge against longbow_tpu's on the CPU.

Most tests call both packages' LongbowFlightServer methods in process (no
socket): the same pyarrow put streams, tickets, exchanges and actions go to
longbow_tpu's server and to the port's binding, which converts them to
arrow_ipc.Table and calls serving/flight_handlers.py. Both servers' stream
answers are captured by swapping, for the call only, the binding module's
`flight` for one whose RecordBatchStream / GeneratorStream return their
data. A few tests go over gRPC on loopback (port 0, client timeouts):
the port's client against both servers, bearer tokens, TLS, the audit
trail and concurrent clients. The host scan mirror is held bit for bit
against longbow_tpu's.

Tolerances: the rows are small integers, so that bf16 storage and every
l2 / dot distance are exact in f32; scores must be EQUAL and ids equal
except inside a group of tied scores that the k-th slot cuts (each
package breaks such ties its own way: the counts must agree there).
Errors must agree in their Flight class and message.
"""
import contextlib
import json
import os
import shutil
import subprocess
import threading
import types

import numpy as np
import pyarrow as pa
import pyarrow.flight as flight
import pytest
import torch

from longbow_tpu.index.flat import FlatIndex as JaxFlat
from longbow_tpu.serving import flight_server as jfs
from longbow_tpu.serving import middleware as jmw
from longbow_tpu.serving.client import LongbowClient as JaxClient
from longbow_tpu.store.compaction import compact_dataset as jax_compact
from longbow_tpu.store.vector_store import VectorStore as JaxStore
from longbow_tpu_torch.index.flat import FlatIndex
from longbow_tpu_torch.serving import flight_server as tfs
from longbow_tpu_torch.serving import middleware as tmw
from longbow_tpu_torch.serving.client import LongbowClient
from longbow_tpu_torch.serving.flight_handlers import FlightHandlers
from longbow_tpu_torch.serving.security import AuditLogger
from longbow_tpu_torch.storage import native
from longbow_tpu_torch.store.compaction import compact_dataset
from longbow_tpu_torch.store.vector_store import VectorStore

D = 8
TIMEOUT = 20.0  # seconds: every client call over a socket


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_per_worker():
    """Under pytest-xdist, one intra-op torch thread (several workers
    share the cores); restored after the file."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(n, d=D, seed=0):
    """Small integer rows: exact in bf16, exact distances in f32."""
    return np.random.default_rng(seed).integers(-6, 7, (n, d)).astype(np.float32)


def _table(ids, vecs, columns=None, metric=None, dtype=None):
    vecs = np.asarray(vecs)
    if dtype is not None:
        vecs = vecs.astype(dtype)
    cols = {}
    if ids is not None:
        ids = np.asarray(ids)
        cols["id"] = pa.array(ids.tolist(), pa.string() if ids.dtype.kind in "OUS" else pa.int64())
    cols["vector"] = pa.FixedSizeListArray.from_arrays(
        pa.array(vecs.reshape(-1), pa.from_numpy_dtype(vecs.dtype)), vecs.shape[1])
    for k, v in (columns or {}).items():
        cols[k] = pa.array(np.asarray(v).tolist() if np.asarray(v).dtype.kind in "OUS" else v)
    t = pa.table(cols)
    return t.replace_schema_metadata({"longbow.metric": metric}) if metric else t


class _Reader:
    """A DoPut / DoExchange reader over pyarrow record batches."""

    def __init__(self, tables, schema=None):
        tables = [tables] if isinstance(tables, pa.Table) else list(tables)
        self.schema = schema if schema is not None else tables[0].schema
        self._chunks = [b for t in tables for b in t.to_batches()]

    def __iter__(self):
        for b in self._chunks:
            yield types.SimpleNamespace(data=b, app_metadata=None)


class _PutWriter:
    def __init__(self):
        self.acks = []

    def write(self, buf):
        self.acks.append(buf.to_pybytes())


class _ExWriter:
    def __init__(self):
        self.schema, self.batches, self.metadata = None, [], []

    def begin(self, schema):
        self.schema = schema

    def write_batch(self, b):
        self.batches.append(b)

    def write_metadata(self, m):
        self.metadata.append(bytes(m))


class _Captured:
    """pyarrow.flight with the two stream classes returning their data."""

    def __getattr__(self, name):
        return getattr(flight, name)

    @staticmethod
    def RecordBatchStream(data):
        return data

    @staticmethod
    def GeneratorStream(schema, gen):
        return ("stream", schema, gen)


@contextlib.contextmanager
def _captured():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfs, "flight", _Captured())
        mp.setattr(tfs, "flight", _Captured())
        yield


def _read(out) -> pa.Table:
    if isinstance(out, tuple):
        _, schema, gen = out
        return pa.Table.from_batches([b if isinstance(b, pa.RecordBatch) else b.to_batches()[0]
                                      for b in gen], schema=schema)
    return out


def _err(fn):
    """(class name, message) of what fn raises."""
    with pytest.raises(Exception) as ei:
        fn()
    return type(ei.value).__name__, str(ei.value)


class _Pair:
    """longbow_tpu's server and the port's binding over fresh stores."""

    def __init__(self, jax_store=None, store=None):
        self.jstore = jax_store or JaxStore()
        self.tstore = store or VectorStore(device="cpu")
        self.j = jfs.LongbowFlightServer(self.jstore, "grpc://127.0.0.1:0")
        self.t = tfs.LongbowFlightServer(self.tstore, "grpc://127.0.0.1:0")

    def both(self, fn):
        return fn(self.j), fn(self.t)

    def put(self, name, table):
        acks = []
        for srv in (self.j, self.t):
            w = _PutWriter()
            srv.do_put(None, flight.FlightDescriptor.for_path(name), _Reader(table), w)
            acks.append(w.acks)
        return acks

    def get(self, ticket: dict):
        raw = flight.Ticket(json.dumps(ticket).encode())
        with _captured():
            return tuple(_read(srv.do_get(None, raw)) for srv in (self.j, self.t))

    def action(self, name, body=None):
        act = flight.Action(name, json.dumps(body or {}).encode())
        return tuple(json.loads(srv.do_action(None, act)[0]) for srv in (self.j, self.t))

    def exchange(self, descriptor, tables, schema=None):
        out = []
        for srv in (self.j, self.t):
            w = _ExWriter()
            srv.do_exchange(None, descriptor, _Reader(tables, schema), w)
            out.append(w)
        return out

    def close(self):
        self.j.shutdown()
        self.t.shutdown()


@pytest.fixture
def pair():
    p = _Pair()
    yield p
    p.close()


def _same_search(jt: pa.Table, tt: pa.Table, k: int, atol: float = 0.0):
    """atol: 0 (equal scores) but for longbow_tpu's int8-codes path, whose
    f32 affine fold leaves up to 2e-4 on these integer distances."""
    assert tt.schema.names == jt.schema.names
    assert [f.type for f in tt.schema] == [f.type for f in jt.schema]
    jq, tq = jt.column("query_index").to_numpy(), tt.column("query_index").to_numpy()
    np.testing.assert_array_equal(tq, jq)
    js, ts = jt.column("score").to_numpy(), tt.column("score").to_numpy()
    np.testing.assert_allclose(ts, js, rtol=0, atol=atol)
    js = np.round(js) if atol else js  # integer distances: the tie groups
    jid, tid = jt.column("id").to_pylist(), tt.column("id").to_pylist()
    for q in np.unique(jq):
        sel = np.nonzero(jq == q)[0]
        full = len(sel) == k
        for s in np.unique(js[sel]):
            g = sel[js[sel] == s]
            if full and s == js[sel].max():
                continue  # the group the k-th slot cuts: equal counts, checked above
            assert sorted(tid[i] for i in g) == sorted(jid[i] for i in g)


def _search(ds, vecs, k=5, **extra):
    body = {"dataset": ds, "k": k, **extra}
    if np.asarray(vecs).ndim == 2:
        body["vectors"] = np.asarray(vecs).tolist()
    else:
        body["vector"] = np.asarray(vecs).tolist()
    return {"search": body}


# -- DoPut ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float16", "int8", "uint8", "int32"])
def test_put_each_vector_dtype(pair, dtype):
    v = np.abs(_ints(60, seed=1)) if dtype == "uint8" else _ints(60, seed=1)
    pair.put("d", _table(np.arange(60), v, dtype=dtype))
    js, ts = pair.action("cluster-status")
    for key in ("index_kind", "dim", "metric", "live_rows", "fields"):
        assert ts["datasets"]["d"][key] == js["datasets"]["d"][key]
    assert (pair.tstore.get("d").dtype == torch.float16) == (dtype == "float16")
    _same_search(*pair.get(_search("d", v[:4])), k=5, atol=1e-3 if "int" in dtype else 0.0)


def test_put_idless_streams_and_metadata(pair):
    v = _ints(30, seed=2)
    pair.put("m", _table(None, v[:20], columns={"price": np.arange(20.0)}, metric="dot_product"))
    pair.put("m", _table(None, v[20:], columns={"price": np.arange(20.0, 30.0)}, metric="dot"))
    js, ts = pair.action("cluster-status")
    assert ts["datasets"]["m"]["metric"] == js["datasets"]["m"]["metric"] == "dot"
    assert ts["datasets"]["m"]["live_rows"] == 30
    assert sorted(pair.tstore.get("m")._id_to_row) == sorted(pair.jstore.get("m")._id_to_row)
    jt, tt = pair.get({"name": "m", "filters": [{"field": "price", "op": ">=", "value": "25"}]})
    assert sorted(tt.column("id").to_pylist()) == sorted(jt.column("id").to_pylist()) == \
        list(range(25, 30))
    _same_search(*pair.get(_search("m", v[3])), k=5)


def test_put_slow_down_ack_under_queue_pressure(pair):
    from longbow_tpu.serving.ingest import IngestQueue as JaxQueue
    from longbow_tpu_torch.serving.ingest import IngestQueue

    release = threading.Event()
    queues = []
    for srv, cls in ((pair.j, JaxQueue), (pair.t.handlers, IngestQueue)):
        q = cls(srv.store, max_depth=4)
        real = q._apply

        def stalled(*a, _real=real, **kw):
            release.wait(TIMEOUT)
            return _real(*a, **kw)

        q._apply = stalled
        srv.ingest = q
        queues.append(q)
    try:
        acks = [pair.put("press", _table(np.arange(i * 5, i * 5 + 5), _ints(5))) for i in range(4)]
        seen = [[json.loads(a[0]) if a else None for a in step] for step in acks]
        assert all(j == t for j, t in seen)  # the same acks at the same puts
        assert [{"status": "slow_down", "reason": "wal_pressure"}] * 2 in seen
    finally:
        release.set()
        for q in queues:
            assert q.drain(timeout_s=TIMEOUT)
            q.close()
    assert pair.tstore.get("press").live_count == pair.jstore.get("press").live_count == 20


# -- DoGet search ----------------------------------------------------------------

@pytest.fixture
def loaded(pair):
    v = _ints(200, seed=3)
    cats = np.array(["a", "b", "c", "d"])[np.arange(200) % 4]
    words = np.array(["apple pie", "orange juice", "apple tree", "pear"])[np.arange(200) % 4]
    pair.put("s", _table(np.arange(200), v, columns={
        "price": np.arange(200.0), "cat": cats, "text": words}))
    return pair, v


def test_search_batch_and_query_index(loaded):
    pair, v = loaded
    jt, tt = pair.get(_search("s", v[:6] + 1, k=5))
    assert sorted(set(tt.column("query_index").to_pylist())) == list(range(6))
    _same_search(jt, tt, k=5)


@pytest.mark.parametrize("flt", [
    [{"field": "price", "op": "<", "value": "50"}],
    [{"field": "cat", "op": "=", "value": "b"}],
    [{"field": "cat", "op": "in", "value": ["a", "c"]}, {"field": "price", "op": ">=", "value": "20"}],
])
def test_search_filters(loaded, flt):
    pair, v = loaded
    jt, tt = pair.get(_search("s", v[:4], k=5, filters=flt))
    _same_search(jt, tt, k=5)
    assert tt.num_rows > 0


@pytest.mark.parametrize("fmt", ["f32", "f16", "quantized"])
def test_include_vectors_formats(loaded, fmt):
    pair, v = loaded
    jt, tt = pair.get(_search("s", v[:3], k=4, include_vectors=True, vector_format=fmt))
    _same_search(jt, tt, k=4)
    assert tt.schema == jt.schema
    for t in (jt, tt):  # each id's vector, in each package's own order
        vec = np.asarray(t.column("vector").combine_chunks().flatten()).reshape(t.num_rows, D)
        if fmt == "quantized":
            scale = t.column("vector_scale").to_numpy()
            got = vec.astype(np.float32) * scale[:, None]
            want = v[t.column("id").to_numpy()]
            assert np.all(np.abs(got - want) <= scale[:, None] / 2 + 1e-6)
        else:
            np.testing.assert_array_equal(vec.astype(np.float32), v[t.column("id").to_numpy()])


def test_hybrid_search_and_graph_rerank_tickets(loaded):
    pair, v = loaded
    jt, tt = pair.get(_search("s", v[5], k=5, text_query="apple", alpha=0.5))
    np.testing.assert_allclose(tt.column("score").to_numpy(), jt.column("score").to_numpy(),
                               rtol=1e-6)
    assert tt.column("id").to_pylist() == jt.column("id").to_pylist()
    for a, b in ((5, 7), (7, 9), (9, 11)):
        pair.action("add-edge", {"dataset": "s", "from": a, "to": b, "type": "rel"})
    jt, tt = pair.get(_search("s", v[5], k=5, graph_alpha=0.5, graph_depth=2))
    np.testing.assert_allclose(tt.column("score").to_numpy(), jt.column("score").to_numpy(),
                               rtol=1e-6)
    assert tt.column("id").to_pylist() == jt.column("id").to_pylist()


def test_degraded_serving_fallback_cache(loaded):
    pair, v = loaded
    for srv, mw in ((pair.j, jmw), (pair.t.handlers, tmw)):
        chain = mw.MiddlewareChain()
        chain.degradation, chain.fallback = mw.GracefulDegradation(), mw.FallbackCache(60.0)
        srv.middleware = chain
    fresh = pair.get(_search("s", v[5], k=3))
    for srv in (pair.j, pair.t.handlers):
        srv.middleware.degradation.set_level(jmw.DEGRADATION_SEVERE)
        srv.store.delete("s", [5])
    stale = pair.get(_search("s", v[5], k=3))  # the cached answer, 5 included
    assert stale[1].column("id").to_pylist() == fresh[1].column("id").to_pylist()
    assert 5 in stale[0].column("id").to_pylist() and 5 in stale[1].column("id").to_pylist()
    for srv in (pair.j, pair.t.handlers):
        srv.middleware.degradation.set_level(jmw.DEGRADATION_CRITICAL)
    assert pair.both(lambda s: _err(lambda: _get_raw(s, _search("s", v[9] + 50, k=3)))) == (
        ("FlightUnavailableError", "degraded (critical): only cached results served"),) * 2


def _get_raw(srv, ticket):
    with _captured():
        return _read(srv.do_get(None, flight.Ticket(json.dumps(ticket).encode())))


# -- scans -----------------------------------------------------------------------

def _rows(t: pa.Table) -> list:
    d = t.to_pydict()
    return sorted(zip(*[d[c] for c in t.column_names]), key=lambda r: str(r[0]))


@pytest.mark.parametrize("ticket", [
    {"name": "s"},
    {"name": "s", "limit": 17},
    {"name": "s", "filters": [{"field": "cat", "op": "=", "value": "a"}]},
    {"name": "s", "limit": 9, "filters": [{"field": "price", "op": ">", "value": "150"}]},
])
def test_scan_full_limited_filtered(loaded, ticket):
    pair, _ = loaded
    pair.action("delete", {"dataset": "s", "ids": [0, 1, 2, 151]})
    jt, tt = pair.get(ticket)
    assert tt.schema == jt.schema
    assert _rows(tt) == _rows(jt) and tt.num_rows > 0


def test_scan_string_ids_f16_and_chunks(pair, monkeypatch):
    ids = np.array([f"doc-{i}" for i in range(300)])
    v = _ints(300, seed=4)
    pair.put("str", _table(ids, v, columns={"n": np.arange(300)}))
    pair.put("half", _table(np.arange(300), v, dtype="float16"))
    monkeypatch.setattr(jfs.LongbowFlightServer, "SCAN_CHUNK_BYTES", 1024)
    monkeypatch.setattr(FlightHandlers, "SCAN_CHUNK_BYTES", 1024)
    for name in ("str", "half"):
        with _captured():
            outs = [srv.do_get(None, flight.Ticket(json.dumps({"name": name}).encode()))
                    for srv in (pair.j, pair.t)]
        batches = [list(o[2]) for o in outs]
        assert [b.num_rows for b in batches[1]] == [b.num_rows for b in batches[0]]
        assert len(batches[1]) > 1
        jt, tt = (pa.Table.from_batches(b, schema=o[1]) for b, o in zip(batches, outs))
        # an int column streams as put (int64); longbow_tpu's columns hold
        # int32 (JAX without x64), a known difference
        assert [f.type for f in tt.schema if f.name != "n"] == \
            [f.type for f in jt.schema if f.name != "n"]
        assert _rows(tt) == _rows(jt)
    assert tt.schema.field("vector").type.value_type == pa.float16()


def test_scan_producer_stops_when_the_client_aborts(pair, monkeypatch):
    pair.put("big", _table(np.arange(3000), _ints(3000, seed=5)))
    monkeypatch.setattr(FlightHandlers, "SCAN_CHUNK_BYTES", 512)
    before = {t.ident for t in threading.enumerate()}
    with _captured():
        _, _, gen = pair.t.do_get(None, flight.Ticket(b'{"name": "big"}'))
    next(gen)
    scan_threads = [t for t in threading.enumerate()
                    if t.name == "longbow-scan" and t.ident not in before]
    assert scan_threads
    gen.close()  # the client went away
    for t in scan_threads:
        t.join(TIMEOUT)
        assert not t.is_alive()


def test_scan_consistent_across_a_compaction(pair, monkeypatch):
    v = _ints(2000, seed=6)
    pair.put("sc", _table(np.arange(2000), v))
    pair.action("delete", {"dataset": "sc", "ids": list(range(0, 2000, 2))})
    monkeypatch.setattr(FlightHandlers, "SCAN_CHUNK_BYTES", 1024)
    with _captured():
        _, schema, gen = pair.t.do_get(None, flight.Ticket(b'{"name": "sc"}'))
    batches = [next(gen)]
    compact_dataset(pair.tstore.get("sc"))  # renumbers the rows mid-stream
    batches += list(gen)
    t = pa.Table.from_batches(batches, schema=schema)
    ids = np.asarray(t.column("id").to_pylist())
    assert sorted(ids) == list(range(1, 2000, 2))
    got = np.asarray(t.column("vector").combine_chunks().flatten()).reshape(-1, D)
    np.testing.assert_array_equal(got, v[ids])


# -- DoExchange ------------------------------------------------------------------

def test_exchange_ingest_search_and_legacy_ack(pair):
    v = _ints(40, seed=7)
    cmd = flight.FlightDescriptor.for_command(b'{"protocol": "ingest", "dataset": "ex"}')
    jw, tw = pair.exchange(cmd, [_table(np.arange(20), v[:20]), _table(np.arange(20, 40), v[20:])])
    assert tw.schema == jw.schema
    assert [b.to_pydict() for b in tw.batches] == [b.to_pydict() for b in jw.batches]
    assert tw.batches[-1].to_pydict() == {"rows_ingested": [40]}
    # an id-less stream named by the path continues after the last id
    pair.exchange(flight.FlightDescriptor.for_path("ex"), [_table(None, v[:5])])
    assert sorted(pair.tstore.get("ex")._id_to_row) == sorted(pair.jstore.get("ex")._id_to_row)
    qs = pa.table({"vector": pa.FixedSizeListArray.from_arrays(pa.array(v[:3].reshape(-1)), D)})
    qs2 = pa.table({"vector": pa.FixedSizeListArray.from_arrays(pa.array(v[3:5].reshape(-1)), D)})
    cmd = flight.FlightDescriptor.for_command(
        json.dumps({"protocol": "search", "dataset": "ex", "k": 4}).encode())
    jw, tw = pair.exchange(cmd, [qs, qs2])
    assert tw.schema == jw.schema and tw.schema.metadata == {b"longbow.metric": b"l2"}
    assert len(tw.batches) == 2
    for jb, tb in zip(jw.batches, tw.batches):
        jt, tt = pa.Table.from_batches([jb]), pa.Table.from_batches([tb])
        assert tt.column("batch_index").to_pylist() == jt.column("batch_index").to_pylist()
        _same_search(jt.drop_columns(["batch_index"]), tt.drop_columns(["batch_index"]), k=4)
    # anything else acks each message (the reference's ops_test sends b"fetch")
    text = pa.table({"data": pa.array(["ping", "pong"])})
    jw, tw = pair.exchange(flight.FlightDescriptor.for_command(b"fetch"),
                           [text.slice(0, 1), text.slice(1, 1)])
    assert tw.metadata == jw.metadata == [b"ack", b"ack"]
    assert tw.schema == jw.schema == pa.schema([])


# -- actions -----------------------------------------------------------------------

def _norm(name, ans):
    """The parts of an answer both packages define alike."""
    if name == "check_readiness":
        return {k: ans[k] for k in ("status", "datasets")}
    if name == "health":  # the port's device check wants a card: none here
        return sorted(ans["checks"]), ans["checks"]["store"]["status"], ans["checks"]["storage"]
    if name == "cluster-status":
        return ans["self"], ans["members"], {
            n: {k: s[k] for k in ("dim", "metric", "live_rows", "index_kind", "fields")}
            for n, s in ans["datasets"].items()}
    if name == "GetGraphStats":
        return {k: ans[k] for k in ("nodes", "edges")} if "nodes" in ans else ans
    return ans


_ACTIONS = [
    ("check_readiness", {}), ("health", {}), ("cluster-status", {}), ("gossip-probe", {}),
    ("MeshStatus", {}), ("MeshIdentity", {}), ("DiscoveryStatus", {}), ("list-datasets", {}),
    ("ListNamespaces", {}), ("GetTotalNamespaceCount", {}),
    ("GetNamespaceDatasetCount", {"name": "default"}),
    ("CreateNamespace", {"name": "declared-x"}),
    ("CreateNamespace", {"name": "eager", "dim": 8, "index": "flat"}),
    ("delete", {"dataset": "s", "ids": [1, 2, 999]}), ("delete", {"dataset": "s", "id": "3"}),
    ("delete-dataset", {"name": "s"}), ("DeleteNamespace", {"dataset": "nope"}),
    ("VectorSearch", {"dataset": "s", "vector": [1, 0, 0, 0, 0, 0, 0, 2], "k": 5}),
    ("VectorSearchByID", {"dataset": "s", "id": 7, "k": 5}),
    ("HybridSearch", {"dataset": "s", "text_query": "apple", "alpha": 0.0, "k": 5}),
    ("add-edge", {"dataset": "s", "subject": 1, "predicate": "rel", "object": 2}),
    ("traverse-graph", {"dataset": "s", "from": 1, "to": 3}),
    ("traverse-graph", {"dataset": "s", "start": 1, "max_hops": 2}),
    ("GetGraphStats", {"dataset": "s"}), ("graph-analytics", {"dataset": "s"}),
    ("checkpoint-prepare", {"epoch": 3}), ("checkpoint-commit", {"epoch": 3}),
    ("ForceSnapshot", {}), ("checkpoint", {}),
]


@pytest.mark.parametrize("name,body", _ACTIONS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(_ACTIONS)])
def test_action_answers(loaded, name, body):
    pair, _ = loaded
    for a, b in ((1, 2), (2, 3)):
        pair.action("add-edge", {"dataset": "s", "from": a, "to": b, "type": "rel"})
    ja, ta = pair.action(name, body)
    if name in ("VectorSearch", "VectorSearchByID"):
        assert ta["query_index"] == ja["query_index"] and ta["scores"] == ja["scores"]
        assert sorted(ta["ids"][:-1]) == sorted(ja["ids"][:-1]) or ta["scores"][-1] == ta["scores"][-2]
        assert ta.get("metric") == ja.get("metric")
    else:
        assert _norm(name, ta) == _norm(name, ja)
    # the store agrees afterwards, as the answer said
    js, ts = pair.action("cluster-status")
    assert _norm("cluster-status", ts) == _norm("cluster-status", js)
    assert [f.descriptor.path for f in pair.t.list_flights(None, None)] == \
        [f.descriptor.path for f in pair.j.list_flights(None, None)]


def test_list_actions_discovery_and_declared_namespaces(pair, tmp_path):
    assert pair.t.list_actions(None) == pair.j.list_actions(None)
    pair.put("nsa/alpha", _table(np.arange(5), _ints(5)))
    for p in ("nsa/alpha",):
        d = flight.FlightDescriptor.for_path(p)
        ji, ti = pair.j.get_flight_info(None, d), pair.t.get_flight_info(None, d)
        assert ti.schema == ji.schema and ti.total_records == ji.total_records == 5
        assert pair.t.get_schema(None, d).schema == pair.j.get_schema(None, d).schema
    assert pair.action("CreateNamespace", {"name": "lazy"})[1] == {"created": "lazy"}
    names = [f.descriptor.path[0] for f in pair.t.list_flights(None, None)]
    assert b"lazy" in names
    info = pair.t.get_flight_info(None, flight.FlightDescriptor.for_path("lazy"))
    assert info.total_records == 0 and info.schema == pa.schema([])
    # declared names persist beside the WAL
    store = VectorStore(device="cpu", persist_dir=tmp_path)
    srv = tfs.LongbowFlightServer(store, "grpc://127.0.0.1:0")
    try:
        srv.do_action(None, flight.Action("CreateNamespace", b'{"name": "durable-ns"}'))
    finally:
        srv.shutdown()
        store.close()
    store2 = VectorStore(device="cpu", persist_dir=tmp_path)
    h = FlightHandlers(store2)
    assert "durable-ns" in [f.name for f in h.list_flights()]
    store2.close()


# -- errors ------------------------------------------------------------------------

def _put_err(srv, name, table):
    return _err(lambda: srv.do_put(None, flight.FlightDescriptor.for_path(name), _Reader(table),
                                   _PutWriter()))


_NULL_ID = pa.table({"id": pa.array([0, None], pa.int64()),
                     "vector": pa.FixedSizeListArray.from_arrays(pa.array(np.ones(16, np.float32)), D)})


@pytest.mark.parametrize("case", [
    "unknown dataset", "bad name", "dimension mismatch", "query dimension", "no vector column",
    "null id", "unknown action", "malformed ticket", "unknown dataset action", "rate limited",
])
def test_errors_agree(loaded, case):
    pair, v = loaded
    if case == "unknown dataset":
        got = pair.both(lambda s: _err(lambda: _get_raw(s, _search("nope", v[0]))))
    elif case == "bad name":
        got = pair.both(lambda s: _put_err(s, "../evil", _table(np.arange(3), v[:3])))
    elif case == "dimension mismatch":
        got = pair.both(lambda s: _put_err(s, "s", _table(np.arange(3), np.ones((3, 16)))))
    elif case == "query dimension":
        got = pair.both(lambda s: _err(lambda: _get_raw(s, _search("s", np.ones(5)))))
    elif case == "no vector column":
        got = pair.both(lambda s: _put_err(s, "s", pa.table({"id": [1, 2]})))
    elif case == "null id":
        got = pair.both(lambda s: _put_err(s, "nn", _NULL_ID))
    elif case == "unknown action":
        got = pair.both(lambda s: _err(lambda: s.do_action(None, flight.Action("Nope", b"{}"))))
    elif case == "malformed ticket":
        got = pair.both(lambda s: _err(lambda: s.do_get(None, flight.Ticket(b"not json"))))
        assert got[1][1].startswith("bad request:")
    elif case == "unknown dataset action":
        got = pair.both(lambda s: _err(lambda: s.do_action(
            None, flight.Action("VectorSearchByID", b'{"dataset": "zz", "id": 1}'))))
    else:
        pair.j.middleware = jmw.MiddlewareChain(rate_limit_rps=0.001, rate_limit_burst=1)
        pair.t.handlers.middleware = tmw.MiddlewareChain(rate_limit_rps=0.001, rate_limit_burst=1)
        pair.get(_search("s", v[0]))
        got = pair.both(lambda s: _err(lambda: _get_raw(s, _search("s", v[0]))))
        assert got[1] == ("FlightUnavailableError", "rate limit exceeded")
    assert got[1] == got[0]


@pytest.mark.parametrize("name", ["region-summary", "merkle-state", "export-delta"])
def test_cluster_layer_actions_refused(pair, name):
    """The cluster layer's three actions answer as longbow_tpu's do (the
    rows carry one origin timestamp, so that the LWW state is equal).
    (The name dates from when the package refused them; it now checks
    their answers against longbow_tpu's.)"""
    t = _table(np.arange(40), _ints(40, seed=3), columns={"price": np.arange(40.0)})
    pair.put("d", t.replace_schema_metadata({"longbow.ts": "1000.5"}))
    pair.tstore.delete("d", [3])
    pair.jstore.delete("d", [3])
    for st in (pair.tstore, pair.jstore):
        st.get("d")._lww[3] = 2000.25  # the delete's marker, equal on both
    from longbow_tpu_torch.distributed.merkle import bucket_of

    body = {"dataset": "d", "buckets": [bucket_of(3), bucket_of(7)]}
    js, ts = pair.action(name, body)
    if name == "region-summary":
        jr, tr = js["regions"]["d"], ts["regions"]["d"]
        assert tr["n"] == jr["n"] == 39
        np.testing.assert_allclose(tr["centroid"], jr["centroid"], rtol=1e-6)
        np.testing.assert_allclose(tr["radius"], jr["radius"], rtol=1e-6)
    elif name == "merkle-state":
        assert ts == js
    else:
        key = lambda r: str(r["id"])  # noqa: E731
        assert sorted(ts["rows"], key=key) == sorted(js["rows"], key=key)
        assert {r["id"] for r in ts["rows"]} >= {3, 7}


def test_breaker_counts_server_faults_not_client_errors_or_timeouts(loaded):
    pair, v = loaded
    h = pair.t.handlers
    h.middleware = tmw.MiddlewareChain(breaker_threshold=3)
    for _ in range(6):  # client errors never open it
        with pytest.raises(flight.FlightServerError):
            _get_raw(pair.t, _search("missing", v[0]))

    class _Raising:
        def __init__(self, exc):
            self.exc = exc

        def search(self, *a, **kw):
            raise self.exc

    h.coalescer = _Raising(TimeoutError("coalesced search timed out"))
    for _ in range(6):  # a dispatch still running: unavailable, not a fault
        with pytest.raises(flight.FlightUnavailableError):
            _get_raw(pair.t, _search("s", v[0]))
    assert h.middleware.breaker.allow()
    h.coalescer = _Raising(RuntimeError("device fell over"))
    for _ in range(3):
        with pytest.raises(RuntimeError):
            _get_raw(pair.t, _search("s", v[0]))
    assert not h.middleware.breaker.allow()


def test_data_and_meta_servers_share_their_declared_namespaces():
    """longbow_tpu's serve() gives the data and meta servers a set of
    declared namespaces each, so a name declared through one is missing
    from the other's ListFlights; the port's servers share one
    FlightHandlers."""
    store = VectorStore(device="cpu")
    h = tfs.serve(store, data_port=0, meta_port=0, host="127.0.0.1")
    try:
        assert h.data_server.handlers is h.meta_server.handlers
        h.data_server.do_action(None, flight.Action("CreateNamespace", b'{"name": "via-data"}'))
        assert b"via-data" in [f.descriptor.path[0] for f in h.meta_server.list_flights(None, None)]
    finally:
        h.shutdown()
    jh = jfs.serve(JaxStore(), data_port=0, meta_port=0, host="127.0.0.1")
    try:
        jh.data_server.do_action(None, flight.Action("CreateNamespace", b'{"name": "via-data"}'))
        assert b"via-data" not in [f.descriptor.path[0]
                                   for f in jh.meta_server.list_flights(None, None)]
    finally:
        jh.shutdown()


# -- the host scan mirror --------------------------------------------------------------

_STORAGE = {"bfloat16": ("bfloat16", torch.bfloat16), "float16": ("float16", torch.float16),
            "float32": ("float32", torch.float32)}


@pytest.mark.parametrize("dt", sorted(_STORAGE))
def test_mirror_rows_bit_for_bit_against_longbow_tpu(dt):
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    v = (rng.standard_normal((5000, 16)) * rng.choice([1e-3, 1.0, 1e3], (5000, 1))).astype(np.float32)
    v[0, :4] = [0.0, -0.0, 1e-40, -3e-39]  # zeros and subnormals
    j = JaxFlat(16, "l2", dtype=getattr(jnp, _STORAGE[dt][0]))
    t = FlatIndex(16, "l2", _STORAGE[dt][1], device="cpu")
    for s in range(0, 5000, 1700):
        j.add(v[s:s + 1700])
        t.add(v[s:s + 1700])
    rows = np.r_[np.arange(5000), np.array([4999, 3, 3, 1200])]
    jm, tm = j.mirror_rows(rows), t.mirror_rows(rows)
    assert tm.dtype == jm.dtype
    np.testing.assert_array_equal(tm.view(np.uint8), np.asarray(jm).view(np.uint8))
    # the mirror is the stored rows, bit for bit; get_vectors reads it
    stored = t.vectors[torch.as_tensor(rows)]
    if dt == "bfloat16":
        stored = stored.view(torch.int16)
    np.testing.assert_array_equal(tm.view(np.uint8), stored.numpy().view(np.uint8))
    np.testing.assert_array_equal(t.get_vectors(rows), t.get_vectors_device(rows).numpy())


def test_mirror_across_a_compaction_and_opt_out(monkeypatch):
    v = _ints(3000, 16, seed=9) * 0.37
    jstore, store = JaxStore(), VectorStore(device="cpu")
    for s in (jstore, store):
        s.put("c", np.arange(3000), v)
        s.delete("c", np.arange(0, 3000, 3))
    jax_compact(jstore.get("c"))
    compact_dataset(store.get("c"))
    tf, jf = store.get("c").index._flat, jstore.get("c").index._flat
    assert tf.count == 2000 and tf._host_mirror is not None
    rows = np.arange(2000)
    np.testing.assert_array_equal(tf.mirror_rows(rows), np.asarray(jf.mirror_rows(rows)))
    store.put("c", np.arange(5000, 5100), v[:100])  # rows after the compaction join the mirror
    live = np.asarray(sorted(store.get("c")._id_to_row.values()))
    got = tf.mirror_to_f32(tf.mirror_rows(live))
    np.testing.assert_array_equal(got, tf.get_vectors_device(live).numpy())
    # LONGBOW_SCAN_MIRROR=0: no mirror, the device gather serves
    monkeypatch.setenv("LONGBOW_SCAN_MIRROR", "0")
    off, joff = FlatIndex(16, "l2", torch.bfloat16, device="cpu"), JaxFlat(16, "l2")
    off.add(v[:100])
    joff.add(v[:100])
    assert off.mirror_rows(np.arange(5)) is None and joff.mirror_rows(np.arange(5)) is None
    np.testing.assert_array_equal(off.get_vectors(np.arange(100)),
                                  torch.from_numpy(v[:100]).bfloat16().float().numpy())
    off.adopt_mirror(np.zeros((100, 16), np.uint16))
    assert off.mirror_rows(np.arange(5)) is None


def test_device_rows_disable_the_mirror_and_cosine_mirrors_the_stored_rows():
    t = FlatIndex(8, "l2", torch.bfloat16, device="cpu")
    t.add(_ints(10))
    t.add(torch.ones(4, 8))
    assert t.mirror_rows(np.arange(3)) is None
    c = FlatIndex(8, "cosine", torch.bfloat16, device="cpu")
    c.add(np.random.default_rng(1).standard_normal((300, 8)).astype(np.float32))
    np.testing.assert_array_equal(c.mirror_rows(np.arange(300)),
                                  c.vectors[:300].view(torch.int16).numpy().view(np.uint16))


def test_native_bf16_converts_against_numpy_and_torch():
    rng = np.random.default_rng(10)
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    special = np.array([0, 0x80000000, 0x7F800000, 0xFF800000, 0x7F800001, 0xFFC00001,
                        0x7FFFFFFF, 0x00000001, 0x807FFFFF, 0x00008000, 0x00018000,
                        0x3F808000, 0x3F818000, 0x7F7FFFFF, 0xFF7F8000], np.uint32)
    x = np.concatenate([special, bits]).view(np.float32)
    got = native.f32_to_bf16_bits(x)
    np.testing.assert_array_equal(got, native._np_f32_to_bf16(x))  # NaN: sign | 0x7FC0
    nan = np.isnan(x)
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got[~nan], want[~nan])  # torch's own NaN bits differ
    back = native.bf16_bits_to_f32(got)
    np.testing.assert_array_equal(back[~nan], torch.from_numpy(x[~nan]).to(torch.bfloat16).float().numpy())
    assert np.isnan(back[nan]).all()
    assert (got[nan] & 0x7FFF == 0x7FC0).all() and ((got[nan] >> 15) == (x[nan].view(np.uint32) >> 31)).all()


# -- over gRPC: the port's client against both servers --------------------------------

@pytest.fixture(scope="module")
def wire():
    jh = jfs.serve(JaxStore(), data_port=0, meta_port=0, host="127.0.0.1")
    th = tfs.serve(VectorStore(device="cpu"), data_port=0, meta_port=0, host="127.0.0.1")
    clients = []
    for h in (jh, th):
        c = LongbowClient("127.0.0.1", h.data_server.port, h.meta_server.port,
                          call_timeout_s=TIMEOUT)
        clients.append(c.connect())
    try:
        yield clients, (jh, th)
    finally:
        for c in clients:
            c.close()
        jh.shutdown()
        th.shutdown()


def test_client_against_both_servers(wire):
    (jc, tc), _ = wire
    v = _ints(300, seed=11)
    out = []
    for c in (jc, tc):
        c.write("w", np.arange(300), v, columns={"price": np.arange(300.0)})
        r = {"search": c.search("w", v[3], k=5), "batch": c.search("w", v[:5] + 1, k=3),
             "big": c.search("w", v[:256], k=2),
             "filtered": c.search("w", v[0], k=5, filters=[
                 {"field": "price", "op": "<", "value": "100"}]),
             "scan": c.scan("w", limit=50), "stream": sum(b.num_rows for b in c.scan_stream("w")),
             "exchange": c.exchange_search("w", [v[:2]], k=3, with_metric=True)[1],
             "ingest": c.exchange_ingest("w2", [(np.arange(10), v[:10])]),
             "byid": c.search_by_id("w", 7, k=3)["ids"][0],
             "deleted": c.delete("w", [0, 1]), "info": c.get_info("w")["total_records"],
             "ns": "w" in c.list_namespaces(), "ready": c.check_readiness()["status"],
             "snap": c.snapshot(), "drop": c.delete_namespace("w2")}
        out.append(r)
    j, t = out
    for key in ("search", "batch", "big", "filtered"):
        k = 2 if key == "big" else 3 if key == "batch" else 5
        _same_search(j[key], t[key], k=k)
    assert _rows(t["scan"]) == _rows(j["scan"])
    for key in ("stream", "exchange", "ingest", "byid", "deleted", "info", "ns", "ready", "snap",
                "drop"):
        assert t[key] == j[key], key
    # the JAX client against the port's server reads the same answer
    (_, th) = wire[1]
    jax_client = JaxClient("127.0.0.1", th.data_server.port, th.meta_server.port,
                           call_timeout_s=TIMEOUT).connect()
    try:
        _same_search(jc.search("w", v[9], k=5), jax_client.search("w", v[9], k=5), k=5)
    finally:
        jax_client.close()


def test_concurrent_clients_over_the_wire(wire):
    (_, tc), (_, th) = wire
    v = _ints(400, seed=12)
    tc.write("conc", np.arange(400), v)
    want = {i: tc.search("conc", v[i], k=3).column("score").to_pylist() for i in range(32)}
    errors, got = [], {}

    def worker(w):
        c = LongbowClient("127.0.0.1", th.data_server.port, th.meta_server.port,
                          call_timeout_s=TIMEOUT).connect()
        try:
            for i in range(w, 32, 8):
                got[i] = c.search("conc", v[i], k=3).column("score").to_pylist()
        except Exception as e:  # reported by the assert below
            errors.append(repr(e))
        finally:
            c.close()

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
    for th_ in threads:
        th_.start()
    for th_ in threads:
        th_.join(TIMEOUT * 2)
    assert not errors and not any(x.is_alive() for x in threads)
    assert got == want


def _free_server(store, **kw):
    srv = tfs.LongbowFlightServer(store, "grpc://127.0.0.1:0", **kw)
    t = threading.Thread(target=srv.serve, daemon=True)
    t.start()
    return srv, t


def test_bearer_token_and_audit_trail(tmp_path):
    audit = tmp_path / "audit.jsonl"
    srv, t = _free_server(VectorStore(device="cpu"), auth_token="sekrit",
                          audit_logger=AuditLogger(audit))
    port = srv.port
    try:
        v = _ints(10)
        c = LongbowClient("127.0.0.1", port, port, api_key="sekrit", call_timeout_s=TIMEOUT)
        c.write("a", np.arange(10), v)
        assert c.search("a", v[0], k=1).num_rows == 1
        c.delete("a", [3])
        c.create_namespace("made")
        c.delete_namespace("a")
        c.close()
        for key in (None, "wrong"):
            c2 = LongbowClient("127.0.0.1", port, port, api_key=key, call_timeout_s=TIMEOUT)
            with pytest.raises(flight.FlightUnauthenticatedError):
                c2.search("a", v[0], k=1)
            c2.close()
    finally:
        srv.shutdown()
        t.join(TIMEOUT)
    ops = [json.loads(line)["op"] for line in audit.read_text().splitlines()]
    assert ops == ["put", "delete", "create_namespace", "drop_dataset"]


@pytest.mark.skipif(shutil.which("openssl") is None, reason="openssl not available")
def test_tls_with_token(tmp_path):
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", str(key),
                    "-out", str(cert), "-days", "1", "-nodes", "-subj", "/CN=localhost",
                    "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
                   check=True, capture_output=True, timeout=60)
    srv, t = _free_server(VectorStore(device="cpu"), auth_token="tls-tok",
                          tls_cert_file=str(cert), tls_key_file=str(key))
    try:
        assert srv.location.startswith("grpc+tls://")
        v = _ints(6)
        c = LongbowClient("localhost", srv.port, srv.port, api_key="tls-tok",
                          tls_root_certs=cert.read_bytes(), call_timeout_s=TIMEOUT)
        c.write("t", np.arange(6), v)
        assert c.search("t", v[2], k=1).column("id").to_pylist() == [2]
        c.close()
        c2 = LongbowClient("localhost", srv.port, srv.port, api_key="tls-tok",
                           call_timeout_s=TIMEOUT)
        with pytest.raises(flight.FlightError):
            c2.check_readiness()
        c2.close()
    finally:
        srv.shutdown()
        t.join(TIMEOUT)
    with pytest.raises(ValueError, match="LONGBOW_TLS_KEY_FILE"):
        tfs.LongbowFlightServer(VectorStore(device="cpu"), "grpc://127.0.0.1:0",
                                tls_cert_file=str(cert))
