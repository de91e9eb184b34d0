"""longbow_tpu_torch/distributed/ (replication, anti-entropy, quorum,
vector clocks, spatial routing) against longbow_tpu's on the CPU.

The counterpart of tests/test_distributed.py and tests/test_consistency.py.
Units and the cross-package checks run without sockets: the same seeded
numpy rows with the same explicit LWW timestamps go into a longbow_tpu
Dataset and a port Dataset, and their Merkle state, Anti-entropy deltas,
tombstone guard and the coordinator's merge are held equal (vectors to
rtol 1e-6; the rows are bf16-exact integers, so they are in fact equal).
The end-to-end tests run in-process servers on loopback gRPC: every server
binds port 0 and is read back, every wait polls against a deadline, and
every client call has a timeout.

tests/test_distributed.py::test_dcn_two_process_dryrun has no counterpart:
it runs jax.distributed across two processes, and the port's mesh is
single-controller (ROADMAP.md §1 item 6).
"""
import json
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.flight as flight
import pytest
import torch

from longbow_tpu.distributed import cluster as jcluster
from longbow_tpu.distributed import membership as jmembership
from longbow_tpu.distributed import replicator as jreplicator
from longbow_tpu.distributed.merkle import MerkleTree as JaxMerkle
from longbow_tpu.store.dataset import Dataset as JaxDataset
from longbow_tpu.store.vector_store import VectorStore as JaxStore
from longbow_tpu_torch.distributed import cluster as tcluster
from longbow_tpu_torch.distributed import membership as tmembership
from longbow_tpu_torch.distributed.cluster import ClusterCoordinator, ConsistencyError
from longbow_tpu_torch.distributed.merkle import N_BUCKETS, MerkleTree, bucket_of
from longbow_tpu_torch.distributed.replicator import (
    ALL,
    ONE,
    QUORUM,
    Peer,
    PeerReplicator,
    SyncWorker,
    required_acks,
)
from longbow_tpu_torch.distributed.spatial import RegionRouter
from longbow_tpu_torch.distributed.vector_clock import SplitBrainDetector, VectorClock
from longbow_tpu_torch.serving.client import LongbowClient
from longbow_tpu_torch.serving.flight_server import LongbowFlightServer, serve
from longbow_tpu_torch.store.dataset import Dataset
from longbow_tpu_torch.store.vector_store import VectorStore

D = 8
DEADLINE = 20.0  # seconds: every wait, and every client call over a socket


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_per_worker():
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _peer_call_timeout(monkeypatch):
    monkeypatch.setenv("LONGBOW_PEER_CALL_TIMEOUT_S", str(DEADLINE))


def _ints(n, d=D, seed=0):
    """Small integer rows: exact in bf16, exact distances in f32."""
    return np.random.default_rng(seed).integers(-6, 7, (n, d)).astype(np.float32)


def _vecs(n, d=D, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d), dtype=np.float32)


def _wait(cond, what: str):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > DEADLINE:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _store():
    return VectorStore(device="cpu")


# -- units -------------------------------------------------------------------


def test_vector_clock_ordering():
    a = VectorClock().tick("n1")
    b = VectorClock(a.to_dict()).tick("n2")
    assert a.compare(b) == "before" and b.compare(a) == "after"
    c = VectorClock().tick("n3")
    assert b.compare(c) == "concurrent"
    assert a.compare(VectorClock(a.to_dict())) == "equal"


def test_split_brain_detector():
    det = SplitBrainDetector()
    my = {"a": True, "b": False, "c": True}
    peers = {"c": {"a": True, "b": True}}
    out = det.check(my, peers)
    assert out["suspects"] == ["b"]
    assert out["have_quorum"]
    assert det.check({"a": True, "b": False, "c": False}, peers)["split_brain"]


@pytest.mark.parametrize("level", [ONE, QUORUM, ALL])
def test_required_acks(level):
    """Equal to longbow_tpu's for 0-9 peers; QUORUM counts the local
    replica toward the majority."""
    for n in range(10):
        assert required_acks(level, n) == jreplicator.required_acks(level, n)
    want = {ONE: [0, 1, 1, 1], QUORUM: [0, 1, 1, 2], ALL: [0, 1, 2, 3]}[level]
    assert [required_acks(level, n) for n in range(4)] == want


def test_merkle_diff_localizes_changes():
    ds1, ds2 = Dataset("d", D, device="cpu"), Dataset("d", D, device="cpu")
    v = _ints(50)
    ds1.put(np.arange(50), v, timestamp=10.0)
    ds2.put(np.arange(50), v, timestamp=10.0)
    t1, t2 = MerkleTree.from_dataset(ds1), MerkleTree.from_dataset(ds2)
    assert t1.root == t2.root
    ds1.put(np.array([7]), _ints(1, seed=9), timestamp=11.0)
    assert MerkleTree.from_dataset(ds1).diff_buckets(t2.leaves) == [bucket_of(7)]


def test_breaker_reopens_after_failed_half_open_probe():
    from longbow_tpu_torch.serving.middleware import CircuitBreaker

    br = CircuitBreaker(threshold=2, cooldown_s=0.2, name="t")
    br.record_failure()
    br.record_failure()
    assert br.state == "open"
    time.sleep(0.25)
    assert br.state == "half-open"
    br.record_failure()
    assert br.state == "open"
    time.sleep(0.25)
    assert br.state == "half-open"
    br.record_success()
    assert br.state == "closed"


# -- across the two packages, no sockets -------------------------------------

def _pair_datasets(n=300, seed=0, columns=True):
    """A longbow_tpu and a port Dataset with the same rows, the same LWW
    timestamps, a few upserts and deletes with timestamps of their own."""
    v = _ints(n, seed=seed)
    ts = 1000.0 + np.arange(n, dtype=np.float64) * 0.5
    cols = None
    if columns:
        cols = {"price": np.arange(n, dtype=np.float64) * 1.5,
                "text": np.asarray([f"doc {i} word{i % 7}" for i in range(n)])}
    out = []
    for ds in (JaxDataset("d", D), Dataset("d", D, device="cpu")):
        ds.put(np.arange(n), v, cols, timestamp=ts)
        ds.put(np.arange(0, n, 10), _ints(len(range(0, n, 10)), seed=seed + 1),
               None if cols is None else {k: c[::10] for k, c in cols.items()},
               timestamp=5000.0)
        ds.apply_remote_tombstones([3, 4, 5, 999], [6000.0, 6000.0, 6000.0, 6000.0])
        out.append(ds)
    return out


def test_merkle_state_and_export_delta_equal_jax():
    jds, tds = _pair_datasets()
    js, ts = jds.merkle_state(), tds.merkle_state()
    assert ts == js and len(ts["leaves"]) == N_BUCKETS
    assert MerkleTree.from_dataset(tds).root == JaxMerkle.from_dataset(jds).root
    # the port's leaf computation against the reference's, on the port's rows
    assert MerkleTree.from_dataset(tds).leaves == JaxMerkle.from_dataset(tds).leaves
    n_rows = 0
    for b in range(N_BUCKETS):
        jd, td = jds.export_delta(b), tds.export_delta(b)
        assert td["bucket"] == jd["bucket"] == b and td["dataset"] == jd["dataset"]
        jr = sorted(jd["rows"], key=lambda r: r["id"])
        tr = sorted(td["rows"], key=lambda r: r["id"])
        assert [(r["id"], r["ts"], r.get("deleted", False)) for r in tr] == \
            [(r["id"], r["ts"], r.get("deleted", False)) for r in jr]
        for a, e in zip(tr, jr):
            if e.get("deleted"):
                continue
            np.testing.assert_allclose(a["vector"], e["vector"], rtol=1e-6)
            assert a["columns"]["text"] == e["columns"]["text"]
            np.testing.assert_allclose(a["columns"]["price"], e["columns"]["price"], rtol=1e-6)
        n_rows += len(tr)
    assert n_rows == 301  # 297 live rows and 4 tombstones


def test_export_delta_have_filter_sends_only_divergence():
    """With a `have` list only strictly newer or missing rows come back,
    in both packages alike."""
    jds, tds = _pair_datasets(columns=False)
    for ds in (jds, tds):
        for b, uids in ds._bucket_map().items():
            assert ds.export_delta(b, have=[[u, ds._lww[u]] for u in uids])["rows"] == []
    target = 17
    b = bucket_of(target)
    for ds in (jds, tds):
        have = [[u, ds._lww[u]] for u in ds._bucket_map()[b] if u != target]
        assert [r["id"] for r in ds.export_delta(b, have=have)["rows"]] == [target]
        have = [[u, ds._lww[u] - (10.0 if u == target else 0.0)] for u in ds._bucket_map()[b]]
        assert [r["id"] for r in ds.export_delta(b, have=have)["rows"]] == [target]


def test_bucket_map_grows_with_the_id_set():
    """The port's bucket map is extended by the uids added since it was
    last read, not rebuilt: after puts of new ids, upserts and tombstones
    of live and unseen ids it equals longbow_tpu's map of the same
    dataset, and a map handed out earlier is left as it was."""
    jds, tds = _pair_datasets(columns=False)

    def canon(m):
        return {b: sorted(u) for b, u in m.items()}

    first = canon(tds._bucket_map())
    held = tds._bucket_map()
    for ds in (jds, tds):
        ds.put(np.arange(300, 420), _ints(120, seed=7), timestamp=7000.0)
        ds.put(np.arange(0, 40), _ints(40, seed=8), timestamp=7001.0)
        ds.apply_remote_tombstones(list(range(50, 60)) + [5000, 5001], [8000.0] * 12)
    assert canon(held) == first
    assert canon(tds._bucket_map()) == canon(jds._bucket_map())
    assert sum(len(u) for u in tds._bucket_map().values()) == len(tds._lww) == 423
    assert tds.merkle_state() == jds.merkle_state()


def test_apply_remote_tombstones_lww_guard():
    """A remote tombstone older than the local write neither deletes the
    row nor rolls its timestamp back; both packages count alike."""
    counts = []
    for ds in (JaxDataset("t", D), Dataset("t", D, device="cpu")):
        ds.put(np.arange(5), _ints(5), timestamp=100.0)
        got = [ds.apply_remote_tombstones([2], [50.0]), ds.live_count, ds._lww[2]]
        got += [ds.apply_remote_tombstones([2, 3, 77], [200.0, 100.0, 1.0]), ds.live_count,
                ds._lww[2], ds._lww[77]]
        counts.append(got)
    assert counts[1] == counts[0] == [0, 5, 100.0, 2, 4, 200.0, 1.0]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_delta_crosses_packages(direction):
    """A delta exported by either package, applied by the other's
    SyncWorker apply path, leaves equal Merkle roots."""
    jds, tds = _pair_datasets(seed=4)
    src = jds if direction == "jax_to_port" else tds
    jstore, tstore = JaxStore(), _store()
    dst_store = tstore if direction == "jax_to_port" else jstore
    worker = (SyncWorker if direction == "jax_to_port" else jreplicator.SyncWorker)(dst_store, [])
    dst_store.put("d", np.arange(2), _ints(2, seed=99), timestamp=1.0)  # stale copies
    applied = 0
    for b in range(N_BUCKETS):
        applied += worker._apply_delta("d", json.loads(json.dumps(src.export_delta(b))))
    assert applied == 301
    dst = dst_store.get("d")
    assert dst.merkle_state()["root"] == src.merkle_state()["root"]
    assert dst.live_count == src.live_count == 297
    rows = np.asarray([dst._id_to_row[i] for i in (10, 20, 299)])
    src_rows = np.asarray([src._id_to_row[i] for i in (10, 20, 299)])
    np.testing.assert_array_equal(np.asarray(dst.index.get_vectors(rows)),
                                  np.asarray(src.index.get_vectors(src_rows)))


class _ActionClient:
    """A peer client that answers the anti-entropy actions from a dataset,
    through a JSON round trip as on the wire, and records what it was
    asked."""

    def __init__(self, ds):
        self.ds, self.calls = ds, []

    def _action(self, name, body):
        self.calls.append(name)
        if name == "merkle-state":
            out = self.ds.merkle_state()
        elif name == "export-delta":
            rows = []
            for b in body["buckets"]:
                rows += self.ds.export_delta(int(b), have=body["haves"].get(str(b)))["rows"]
            out = {"dataset": body["dataset"], "rows": rows}
        else:
            raise KeyError(name)
        return json.loads(json.dumps(out))


def test_sync_round_compares_the_next_peer_with_the_healed_tree():
    """A node behind two current peers: one round pulls the divergent rows
    from the first and then finds the second equal, so the second is asked
    for its root and nothing else. longbow_tpu compares the second peer
    with the tree of the round's start and sends it every have list again
    (a cost fault of the reference, ROADMAP.md section 3); both end with
    the same rows."""
    from types import SimpleNamespace

    asked = {}
    for name, make_ds, make_store, worker in (
            ("jax", lambda: JaxDataset("d", D), JaxStore, jreplicator.SyncWorker),
            ("port", lambda: Dataset("d", D, device="cpu"), _store, SyncWorker)):
        current = []
        for _ in range(2):
            ds = make_ds()
            ds.put(np.arange(200), _ints(200), timestamp=10.0)
            ds.put(np.arange(0, 200, 9), _ints(23, seed=2), timestamp=20.0)
            ds.apply_remote_tombstones([1, 2], [30.0, 30.0])
            current.append(ds)
        behind = make_store()
        behind.put("d", np.arange(200), _ints(200), timestamp=10.0)
        clients = [_ActionClient(ds) for ds in current]
        w = worker(behind, [SimpleNamespace(client=c) for c in clients])
        assert w.sync_dataset_once("d") == 23 + 2
        assert behind.get("d").merkle_state() == current[0].merkle_state()
        asked[name] = [c.calls for c in clients]
    assert asked["jax"][1].count("export-delta") > 0
    assert asked["port"][0] == asked["jax"][0]
    assert asked["port"][1] == ["merkle-state"]


class _FixedClient:
    """A peer client whose exchange_search answers from fixed rows."""

    def __init__(self, answers, metric):
        self.answers, self.metric = answers, metric

    def exchange_search(self, dataset, batches, k, **kw):
        ids, scores, qi = self.answers
        t = pa.table({"batch_index": pa.array([0] * len(ids), pa.int32()),
                      "query_index": pa.array(qi, pa.int32()), "id": pa.array(ids, pa.int64()),
                      "score": pa.array(scores, pa.float32())})
        return [t], self.metric

    def close(self):
        pass


@pytest.mark.parametrize("mode", ["l2", "dot", "unknown-metric", "rrf"])
def test_global_search_merge_equals_jax(mode):
    """global_search's merge of fixed peer answers and a local answer:
    the exact score merge (l2, dot, a metric resolved from the peers) and
    the RRF merge of a hybrid query give longbow_tpu's answer."""
    rng = np.random.default_rng(3)
    b, k = 3, 5
    peers = ["127.0.0.1:9001", "127.0.0.1:9003"]
    answers = []
    for p in range(2):
        n = 12
        answers.append((rng.integers(0, 40, n).tolist(),
                        np.round(rng.uniform(0, 10, n), 2).tolist(),
                        np.repeat(np.arange(b), n // b).tolist()))
    lid = rng.integers(0, 40, (b, k)).astype(object)
    lsc = np.round(rng.uniform(0, 10, (b, k)), 2).astype(np.float32)
    lok = rng.uniform(size=(b, k)) < 0.8
    metric = {"l2": "l2", "dot": "dot", "unknown-metric": None, "rrf": "l2"}[mode]
    hybrid = {"text_query": "w", "alpha": 0.5} if mode == "rrf" else None
    out = []
    for mod in (jcluster, tcluster):
        cc = mod.ClusterCoordinator(None, "127.0.0.1:9000", peers, replication_mode="off")
        for i, m in enumerate(sorted(cc.membership.members)):
            cc._peers[m].client = _FixedClient(answers[i], "dot" if mode == "unknown-metric" else "l2")
        try:
            out.append(cc.global_search("d", np.zeros((b, D), np.float32), k,
                                        local=(lid, lsc, lok), metric=metric, hybrid=hybrid))
        finally:
            cc.stop()
    (ji, js, jo), (ti, ts, to) = out
    np.testing.assert_array_equal(to, jo)
    assert ti[to].tolist() == ji[jo].tolist()
    np.testing.assert_allclose(ts, js, rtol=1e-6)


def test_membership_rules_equal_jax():
    """parse_peer, the digest merge rules and self-refutation give the
    same member states in both packages."""
    specs = ["h:3000", "h:3000:3005", "h:3000@us-east", "h:3000:3005@eu"]
    assert [tmembership.parse_peer(s) for s in specs] == \
        [jmembership.parse_peer(s) for s in specs]
    script = [
        [{"id": "127.0.0.1:7001", "host": "127.0.0.1", "data_port": 7001, "status": "alive",
          "incarnation": 1}],
        [{"id": "127.0.0.1:7001", "host": "127.0.0.1", "data_port": 7001, "status": "alive",
          "incarnation": 2}],
        [{"id": "127.0.0.1:7001", "host": "127.0.0.1", "data_port": 7001, "status": "dead",
          "incarnation": 3}],
        [{"id": "10.0.0.9:7002", "host": "10.0.0.9", "data_port": 7002, "meta_port": 7003,
          "status": "alive", "incarnation": 0, "region": "eu"}],
        [{"id": "self:9", "host": "self", "data_port": 9, "status": "suspect",
          "incarnation": 0}],
        [{"id": "10.0.0.9:7002", "status": "dead", "incarnation": 4}],
        [{"id": "", "status": "alive"}, {"id": "x:1", "data_port": "zz"}],
    ]
    states = []
    for mod in (jmembership, tmembership):
        mm = mod.MembershipManager("self:9", ["127.0.0.1:7001"])
        m = mm.members["127.0.0.1:7001"]
        m.status, m.incarnation = mod.SUSPECT, 1
        events = []
        mm.subscribe(lambda mem, ev=events: ev.append((mem.id, mem.status)))
        trace = []
        for entries in script:
            mm.merge_digest(entries)
            trace.append((sorted((x.id, x.status, x.incarnation, x.region, x.meta_port)
                                 for x in mm.members.values()), mm.self_incarnation))
        states.append((trace, events, mm.digest()[0]))
    assert states[1] == states[0]


@pytest.mark.parametrize("nodes", [3, 8])
def test_ring_ownership_equals_jax(nodes):
    from longbow_tpu.distributed.ring import ConsistentHashRing as JaxRing
    from longbow_tpu_torch.distributed.ring import ConsistentHashRing

    names = [f"127.0.0.1:{5000 + 2 * i}" for i in range(nodes)]
    keys = [str(i) for i in range(5000)] + [f"doc-{i}" for i in range(500)]
    jr, tr = JaxRing(names), ConsistentHashRing(names)
    assert [tr.lookup(k) for k in keys] == [jr.lookup(k) for k in keys]
    jr.remove(names[1])
    tr.remove(names[1])
    assert [tr.preference_list(k, 2) for k in keys[:500]] == \
        [jr.preference_list(k, 2) for k in keys[:500]]


def test_unknown_metric_names_register_like_the_reference():
    """distributed/cluster.py counts longbow_spatial_routing_skipped_total
    and longbow_global_search_peer_saturated_total, which the catalog
    lacks: the registry makes them on first use (as the reference's
    get_or_create does) and never raises."""
    from longbow_tpu_torch.metrics.registry import MetricsRegistry

    reg = MetricsRegistry()
    reg.inc("longbow_spatial_routing_skipped_total", 2)
    reg.inc("longbow_global_search_peer_saturated_total")
    text = reg.text().decode()
    assert "longbow_spatial_routing_skipped_total 2.0" in text
    assert "longbow_global_search_peer_saturated_total 1.0" in text


def test_dead_member_pruned_from_replication_and_ring():
    from longbow_tpu_torch.distributed.membership import ALIVE, DEAD, Member

    cc = ClusterCoordinator(_store(), self_id="127.0.0.1:3000", peers=["127.0.0.1:4000:4001"],
                            placement="partitioned")
    try:
        m = Member("127.0.0.1:4000", "127.0.0.1", 4000, 4001, status=ALIVE)
        cc._on_member_change(m)
        assert "127.0.0.1:4000" in cc._peers and "127.0.0.1:4000" in cc.ring.nodes
        m.status = DEAD
        cc._on_member_change(m)
        assert "127.0.0.1:4000" not in cc._peers
        assert "127.0.0.1:4000" not in cc.ring.nodes
        assert cc.replicator is None  # partitioned: no replication at all
    finally:
        cc.stop()


def test_region_router_routes_and_fails_open():
    r = RegionRouter(margin=1.5)
    r.update("A", "ds", np.zeros(D), radius=1.0, n=100)
    r.update("B", "ds", np.full(D, 100.0), radius=1.0, n=100)
    q = np.zeros((2, D), np.float32)
    assert r.route("ds", q, ["A", "B", "C"]) == (["A", "C"], 1)
    q2 = np.stack([np.zeros(D), np.full(D, 100.0)]).astype(np.float32)
    assert r.route("ds", q2, ["A", "B"]) == (["A", "B"], 0)
    assert r.route("other", q, ["A", "B"])[0] == ["A", "B"]
    r.drop_peer("B")
    assert r.route("ds", q2, ["A", "B"])[0] == ["A", "B"]


def test_region_router_is_metric_aware():
    r = RegionRouter(margin=1.5)
    e0, e1 = np.eye(D, dtype=np.float32)[0], np.eye(D, dtype=np.float32)[1]
    r.update("A", "ds", e0, radius=0.2, n=100)
    r.update("B", "ds", e1, radius=0.2, n=100)
    q = (e0 * 1000.0)[None, :]
    assert r.route("ds", q, ["A", "B"], metric="cosine") == (["A"], 1)
    assert r.route("ds", q, ["A", "B"], metric="dot") == (["A", "B"], 0)
    assert r.route("ds", q, ["A", "B"], metric="mahalanobis")[0] == ["A", "B"]
    assert r.route("ds", q, ["A", "B"], metric="l2") == ([], 2)


def test_dataset_region_equals_jax():
    """dataset_region over the index's host rows equals longbow_tpu's."""
    from longbow_tpu.distributed.spatial import dataset_region as jax_region
    from longbow_tpu_torch.distributed.spatial import dataset_region

    v = _ints(5000, seed=7) + 7.0
    jds, tds = JaxDataset("s", D), Dataset("s", D, device="cpu")
    for ds in (jds, tds):
        ds.put(np.arange(5000), v)
    jr, tr = jax_region(jds), dataset_region(tds)
    assert tr["n"] == jr["n"] == 4096
    np.testing.assert_allclose(tr["centroid"], jr["centroid"], rtol=1e-6)
    np.testing.assert_allclose(tr["radius"], jr["radius"], rtol=1e-6)


# -- end to end, in-process servers on loopback ------------------------------


@pytest.fixture()
def two_nodes():
    s1, s2 = _store(), _store()
    h1 = serve(s1, data_port=0, meta_port=0, host="127.0.0.1")
    h2 = serve(s2, data_port=0, meta_port=0, host="127.0.0.1")
    yield (s1, h1), (s2, h2)
    h1.shutdown()
    h2.shutdown()


def _peer(h):
    return Peer("127.0.0.1", h.data_server.port, h.meta_server.port, call_timeout_s=DEADLINE)


def _spec(h):
    return f"127.0.0.1:{h.data_server.port}:{h.meta_server.port}"


def test_async_replication(two_nodes):
    (s1, _), (s2, h2) = two_nodes
    rep = PeerReplicator([_peer(h2)], mode="async")
    try:
        v = _vecs(20)
        s1.put("r", np.arange(20), v)
        rep.on_put("r", np.arange(20), v)
        rep.drain()
        _wait(lambda: "r" in s2.list_datasets() and s2.get("r").live_count == 20, "20 rows")
        rep.on_delete("r", [3, 4])
        rep.drain()
        _wait(lambda: s2.get("r").live_count == 18, "2 deletes")
    finally:
        rep.close()


@pytest.mark.parametrize("mode", ["async", "quorum"])
def test_replicated_delete_carries_the_origin_time(two_nodes, mode):
    """A delete through the origin's handlers reaches the replica with the
    time the origin stamped on it: equal tombstone times and Merkle roots
    with no anti-entropy round. A newer write on the replica survives the
    delete, and ids neither node held get no tombstone on either."""
    (s1, h1), (s2, h2) = two_nodes
    v = _vecs(40)
    for s in (s1, s2):
        s.put("t", np.arange(40), v, timestamp=100.0)
    s2.put("t", np.arange(39, 40), v[39:], timestamp=1e12)  # newer than any delete
    coord = ClusterCoordinator(s1, _spec(h1), [_spec(h2)], replication_mode=mode,
                               sync_interval_s=3600)
    h1.data_server.handlers.cluster = coord
    try:
        h1.data_server.handlers.do_action("delete", json.dumps(
            {"dataset": "t", "ids": [3, 5, 17, 39, 1000]}).encode())
        coord.replicator.drain()
        _wait(lambda: s2.get("t").live_count == 37, "the replicated delete")
        lww1, lww2 = s1.get("t")._lww, s2.get("t")._lww
        assert len({lww1[i] for i in (3, 5, 17)}) == 1  # one stamp a delete
        assert {i: lww2[i] for i in (3, 5, 17)} == {i: lww1[i] for i in (3, 5, 17)}
        assert 1000 not in lww1 and 1000 not in lww2
        assert lww2[39] == 1e12 and 39 in s2.get("t")._id_to_row
        s1.put("t", np.arange(39, 40), v[39:], timestamp=1e12)  # the newer write, on both
        assert s1.get("t").merkle_state() == s2.get("t").merkle_state()
    finally:
        h1.data_server.handlers.cluster = None
        coord.stop()


def test_quorum_replication_counts_acks(two_nodes):
    _, (s2, h2) = two_nodes
    good = _peer(h2)
    dead = Peer("127.0.0.1", 1, 1, call_timeout_s=DEADLINE)  # nothing listens there
    rep = PeerReplicator([good, dead], mode="quorum", level=ONE)
    rep_all = PeerReplicator([good, dead], mode="quorum", level=ALL)
    try:
        assert rep.on_put("q", np.arange(5), _vecs(5))
        assert not rep_all.on_put("q", np.arange(5), _vecs(5))
        assert rep.failed == 1 and rep.replicated == 1
    finally:
        rep.close()
        rep_all.close()


def test_anti_entropy_sync(two_nodes):
    (s1, h1), (s2, _) = two_nodes
    v = _vecs(30)
    s1.put("ae", np.arange(30), v, timestamp=200.0)
    s2.put("ae", np.arange(20), v[:20], timestamp=100.0)
    s1.delete("ae", [2])
    s1.get("ae")._lww[2] = 300.0
    sw = SyncWorker(s2, [_peer(h1)])
    assert sw.run_once() == 30  # 10 missing, 19 stale, 1 tombstone
    assert s2.get("ae").live_count == 29
    ids, _, _ = s2.search("ae", v[25], 1, use_cache=False)
    assert ids[0, 0] == 25
    assert 2 not in s2.get("ae")._id_to_row
    assert s2.get("ae").merkle_state() == s1.get("ae").merkle_state()
    assert sw.run_once() == 0  # equal roots: nothing more to pull


def test_vector_clock_wired_into_replication(two_nodes):
    (s1, _), (s2, h2) = two_nodes
    c1 = ClusterCoordinator(s1, "n1", [_spec(h2)], replication_mode="async")
    c2 = ClusterCoordinator(s2, "n2", [], replication_mode="off")
    h2.data_server.handlers.cluster = c2
    try:
        v = _vecs(5)
        s1.put("vc", np.arange(5), v)
        c1.on_put("vc", np.arange(5), v, None, None, time.time())
        assert c1.clocks["vc"].to_dict() == {"n1": 1}
        _wait(lambda: "vc" in s2.list_datasets() and c2.clocks.get("vc") is not None, "a clock")
        assert c2.clocks["vc"].to_dict().get("n1") == 1
        assert c2.conflicts == 0
        c2.observe_remote_clock("vc", {"n3": 1})
        assert c2.conflicts == 1
        assert c2.clocks["vc"].to_dict() == {"n1": 1, "n3": 1}
        assert c2.status()["write_conflicts_lww_resolved"] == 1
    finally:
        c1.stop()
        c2.stop()
        h2.data_server.handlers.cluster = None


def test_split_brain_check_over_wire(two_nodes):
    (s1, _), (s2, h2) = two_nodes
    c1 = ClusterCoordinator(s1, "n1", [_spec(h2)], replication_mode="off")
    c2 = ClusterCoordinator(s2, _spec(h2), [], replication_mode="off")
    h2.data_server.handlers.cluster = c2
    try:
        verdict = c1.check_split_brain()
        assert verdict == {"split_brain": False, "suspects": [], "have_quorum": True}
    finally:
        c1.stop()
        c2.stop()
        h2.data_server.handlers.cluster = None


def test_anti_entropy_carries_columns_and_bm25(two_nodes):
    from longbow_tpu_torch.query.parser import Filter

    (s1, h1), (s2, _) = two_nodes
    v = _vecs(20, seed=9)
    s1.put("cols", np.arange(20), v, columns={
        "price": np.arange(20.0), "text": np.asarray([f"doc {i} alpha" for i in range(20)])})
    assert SyncWorker(s2, [_peer(h1)]).run_once() == 20
    ds2 = s2.get("cols")
    assert ds2.live_count == 20
    ids, _, _ = s2.search("cols", v[3], 3, filters=[Filter("price", "<", "5")], use_cache=False)
    got = [i for i in ids[0] if i is not None]
    assert got and all(i < 5 for i in got)
    assert len(ds2.bm25) == 20


def test_sync_pulls_dataset_missing_locally(two_nodes):
    (s1, h1), (s2, _) = two_nodes
    v = _vecs(40, seed=11)
    s1.put("lost", np.arange(40), v)
    assert SyncWorker(s2, [_peer(h1)]).run_once() == 40
    assert s2.get("lost").live_count == 40
    ids, _, _ = s2.search("lost", v[7], 1, use_cache=False)
    assert ids[0, 0] == 7


def test_dataset_region_and_action(two_nodes):
    (s1, h1), _ = two_nodes
    v = np.random.default_rng(5).standard_normal((300, 16)).astype(np.float32) + 7.0
    s1.put("spat", np.arange(300), v)
    c = LongbowClient("127.0.0.1", h1.data_server.port, h1.meta_server.port,
                      call_timeout_s=DEADLINE)
    try:
        reg = c._action("region-summary", {"datasets": ["spat"]})["regions"]["spat"]
    finally:
        c.close()
    assert reg["n"] == 300
    cent = np.asarray(reg["centroid"], np.float32)
    assert np.allclose(cent, v.mean(axis=0), atol=0.5)
    assert reg["radius"] >= 0.9 * np.sqrt(((v - cent) ** 2).sum(axis=1).max())


# -- read consistency and checkpoints (tests/test_consistency.py) -------------


def test_quorum_read_fails_when_peers_dead():
    vs = _store()
    vs.put("d", np.arange(8), _vecs(8))
    coord = ClusterCoordinator(vs, "127.0.0.1:59990", ["127.0.0.1:1", "127.0.0.1:2"],
                               replication_mode="off", global_search_timeout_s=DEADLINE)
    try:
        q = _vecs(1, seed=1)
        local = vs.search("d", q, 3, use_cache=False)
        assert coord.global_search("d", q, 3, local=local)[2].any()
        coord.global_search("d", q, 3, local=local, consistency="ONE")
        for level in ("QUORUM", "ALL"):
            with pytest.raises(ConsistencyError):
                coord.global_search("d", q, 3, local=local, consistency=level)
    finally:
        coord.stop()


def test_quorum_read_met_with_live_peer(two_nodes):
    (s1, _), (s2, h2) = two_nodes
    s2.put("d", np.arange(5), _vecs(5, seed=1))
    s1.put("d", np.arange(10, 15), _vecs(5))
    coord = ClusterCoordinator(s1, "127.0.0.1:59990", [_spec(h2)], replication_mode="off",
                               global_search_timeout_s=DEADLINE)
    try:
        q = _vecs(1, seed=2)
        out_ids, _, out_ok = coord.global_search(
            "d", q, 4, local=s1.search("d", q, 4, use_cache=False), consistency="ALL")
        got = {i for i in out_ids[0][out_ok[0]]}
        assert got & {0, 1, 2, 3, 4} and got & {10, 11, 12, 13, 14}
    finally:
        coord.stop()


def test_partitioned_all_refused_after_a_death():
    """Partitioned placement: each node holds the only copy of its share.
    After node B is called dead, ALL must be refused (B's share cannot
    answer) while QUORUM (2 of 3) answers. longbow_tpu judges the level
    against the alive members only and answers ALL from the live shares
    (a reference fault, ROADMAP.md section 3); the port counts every
    member it knows."""
    from longbow_tpu_torch.distributed.membership import DEAD

    peers = ["127.0.0.1:9001", "127.0.0.1:9003"]
    answer = ([5, 6], [0.5, 0.7], [0, 0])
    local = (np.array([[1, 2]], dtype=object), np.array([[0.1, 0.2]], np.float32),
             np.ones((1, 2), bool))
    got = {}
    for name, mod in (("jax", jcluster), ("port", tcluster)):
        cc = mod.ClusterCoordinator(None, "127.0.0.1:9000", peers, placement="partitioned")
        try:
            cc._peers[peers[0]].client = _FixedClient(answer, "l2")
            gone = cc.membership.members[peers[1]]
            gone.status = DEAD
            cc._on_member_change(gone)
            q = np.zeros((1, D), np.float32)
            ids, _, ok = cc.global_search("d", q, 3, local=local, consistency="QUORUM")
            assert sorted(ids[ok].tolist()) == [1, 2, 5]
            try:
                cc.global_search("d", q, 3, local=local, consistency="ALL")
                got[name] = "answered"
            except mod.ConsistencyError as e:
                got[name] = str(e)
        finally:
            cc.stop()
    assert got["jax"] == "answered"
    assert got["port"] == "consistency ALL not met: 2/3 nodes answered, required 3"


def test_search_ticket_consistency_unavailable():
    vs = _store()
    vs.put("d", np.arange(4), _vecs(4))
    coord = ClusterCoordinator(vs, "127.0.0.1:59990", ["127.0.0.1:1"], replication_mode="off",
                               global_search_timeout_s=DEADLINE)
    srv = LongbowFlightServer(vs, "grpc://127.0.0.1:0", cluster=coord)
    threading.Thread(target=srv.serve, daemon=True).start()
    c = LongbowClient("127.0.0.1", srv.port, srv.port, call_timeout_s=DEADLINE)
    try:
        assert c.search("d", _vecs(1)[0], k=2).num_rows > 0
        ticket = flight.Ticket(json.dumps({"search": {
            "dataset": "d", "vector": _vecs(1)[0].tolist(), "k": 2, "consistency": "ALL"}}).encode())
        with pytest.raises(flight.FlightUnavailableError, match="consistency ALL not met"):
            c._dc().do_get(ticket, options=c._opts).read_all()
    finally:
        c.close()
        srv.shutdown()
        coord.stop()


def test_single_node_checkpoint_action(tmp_path):
    vs = VectorStore(device="cpu", persist_dir=tmp_path)
    vs.put("d", np.arange(6), _vecs(6))
    srv = LongbowFlightServer(vs, "grpc://127.0.0.1:0")
    threading.Thread(target=srv.serve, daemon=True).start()
    c = LongbowClient("127.0.0.1", srv.port, srv.port, call_timeout_s=DEADLINE)
    try:
        r = c._action("checkpoint", {})
        assert r["ok"] and r["local"]
    finally:
        c.close()
        srv.shutdown()
    vs.close()
    vs2 = VectorStore(device="cpu", persist_dir=tmp_path)
    try:
        assert vs2.get("d").live_count == 6
    finally:
        vs2.close()


def test_coordinated_checkpoint_two_nodes(tmp_path):
    stores, servers = [], []
    for i in range(2):
        st = VectorStore(device="cpu", persist_dir=tmp_path / f"n{i}")
        st.put("d", np.arange(4), _vecs(4, seed=i))
        srv = LongbowFlightServer(st, "grpc://127.0.0.1:0")
        threading.Thread(target=srv.serve, daemon=True).start()
        stores.append(st)
        servers.append(srv)
    coord = ClusterCoordinator(stores[0], f"127.0.0.1:{servers[0].port}",
                               [f"127.0.0.1:{servers[1].port}:{servers[1].port}"],
                               replication_mode="off")
    servers[0].handlers.cluster = coord
    c = LongbowClient("127.0.0.1", servers[0].port, servers[0].port, call_timeout_s=DEADLINE)
    try:
        result = coord.coordinated_checkpoint()
        assert result["ok"] and result["committed"] == [f"127.0.0.1:{servers[1].port}"]
        # the action through the coordinator's node: the barrier, then its own snapshot
        r = c._action("checkpoint", {})
        assert r["ok"] and r["local"] and r["phase"] == "commit"
    finally:
        c.close()
        coord.stop()
        for srv in servers:
            srv.shutdown()
        for st in stores:
            st.close()
