"""longbow_tpu_torch's cluster tier on the CPU: membership, replication
through the serving path, the global search, partitioned placement, and a
cluster of a longbow_tpu node and a port node.

The counterpart of tests/test_cluster.py. Nodes run in process: each
binds its data and meta servers to port 0 first, and its coordinator,
made with the ports read back, is then handed to the servers' shared
handlers. Membership is driven by calling probe_round() (no probe
threads) except where a test is about them, every wait polls against a
deadline, and every client call has a timeout. One test starts three
`python -m longbow_tpu_torch.serve` processes (LONGBOW_FORCE_CPU=1).
"""
import http.server
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pyarrow.flight as flight
import pytest
import torch

from longbow_tpu_torch.distributed.cluster import ClusterCoordinator
from longbow_tpu_torch.distributed.membership import (
    ALIVE,
    DEAD,
    SUSPECT,
    MembershipManager,
    parse_peer,
)
from longbow_tpu_torch.distributed.ring import ConsistentHashRing
from longbow_tpu_torch.serving.client import LongbowClient
from longbow_tpu_torch.serving.flight_server import serve
from longbow_tpu_torch.store.vector_store import VectorStore

REPO = Path(__file__).resolve().parent.parent
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


def _vecs(n, d=D, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _wait(cond, what: str, deadline: float = DEADLINE):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _count(store, name):
    try:
        return store.get(name).live_count
    except KeyError:
        return 0


class _Node:
    """One in-process node: a CPU store, its data and meta servers on
    loopback (port 0) over shared handlers, and, after join(), a
    coordinator and a client."""

    def __init__(self, store=None):
        self.store = store or VectorStore(device="cpu")
        self.h = serve(self.store, data_port=0, meta_port=0, host="127.0.0.1")
        self.dp, self.mp = self.h.data_server.port, self.h.meta_server.port
        self.id = f"127.0.0.1:{self.dp}"
        self.spec = f"{self.id}:{self.mp}"
        self.cluster = None
        self.client = LongbowClient("127.0.0.1", self.dp, self.mp, call_timeout_s=DEADLINE)

    def join(self, specs, **kw):
        kw.setdefault("sync_interval_s", 3600)
        kw.setdefault("probe_interval_s", 0.2)
        self.cluster = ClusterCoordinator(self.store, self.id, specs, **kw)
        self.h.data_server.handlers.cluster = self.cluster
        return self

    def stop(self):
        if self.cluster is not None:
            self.cluster.stop()
        self.h.shutdown()
        self.client.close()


def _cluster(n, **kw):
    nodes = [_Node() for _ in range(n)]
    specs = [x.spec for x in nodes]
    for x in nodes:
        x.join(specs, **kw)
    return nodes


@pytest.fixture
def three_nodes():
    nodes = _cluster(3, replication_mode="async")
    yield nodes
    for n in nodes:
        n.stop()


@pytest.fixture
def three_partitioned_nodes():
    nodes = _cluster(3, placement="partitioned")
    yield nodes
    for n in nodes:
        n.stop()


# -- membership ----------------------------------------------------------------


def test_parse_peer():
    assert parse_peer("h:3000") == ("h", 3000, 3001, "")
    assert parse_peer("h:3000:3005") == ("h", 3000, 3005, "")
    assert parse_peer("h:3000@us-east") == ("h", 3000, 3001, "us-east")
    assert parse_peer("h:3000:3005@eu") == ("h", 3000, 3005, "eu")


def test_membership_transitions():
    mm = MembershipManager("self:1", ["127.0.0.1:1", "127.0.0.1:2"], suspect_after=1,
                           dead_after=2, probe_timeout_s=0.2)
    events = []
    mm.subscribe(lambda m: events.append((m.id, m.status)))
    mm.probe_round()
    assert all(m.status == SUSPECT for m in mm.members.values())
    mm.probe_round()
    assert all(m.status == DEAD for m in mm.members.values())
    assert mm.alive() == []
    assert ("127.0.0.1:1", SUSPECT) in events and ("127.0.0.1:1", DEAD) in events
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    try:
        mm2 = MembershipManager("self:1", [f"127.0.0.1:{srv.getsockname()[1]}"],
                                probe_timeout_s=DEADLINE)
        mm2.probe_round()
        assert [m.status for m in mm2.members.values()] == [ALIVE]
    finally:
        srv.close()


def test_dns_discovery():
    mm = MembershipManager("self:1", [], dns_name="localhost:12345", probe_timeout_s=0.2,
                           suspect_after=1, dead_after=2)
    mm.probe_round()
    assert mm.members
    assert all(m.data_port == 12345 for m in mm.members.values())


def test_region_aware_alive_ordering():
    mm = MembershipManager("self:1", ["a:3000@eu", "b:3000@us", "c:3000@eu"], self_region="eu")
    for m in mm.members.values():
        m.status = "alive"
    assert [m.region for m in mm.alive()] == ["eu", "eu", "us"]


def test_k8s_endpoint_discovery(monkeypatch, tmp_path):
    payload = {"subsets": [{"addresses": [
        {"ip": "10.0.0.7", "nodeName": "node-a.zone1"},
        {"ip": "10.0.0.8", "nodeName": "node-b.zone2"},
    ]}]}
    seen = {}

    class FakeK8s(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            seen["path"] = self.path
            seen["auth"] = self.headers.get("Authorization")
            body = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), FakeK8s)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        tok = tmp_path / "token"
        tok.write_text("sekret")
        monkeypatch.setenv("LONGBOW_K8S_API", f"http://127.0.0.1:{srv.server_port}")
        monkeypatch.setenv("LONGBOW_K8S_TOKEN_FILE", str(tok))
        monkeypatch.setenv("LONGBOW_K8S_NAMESPACE", "prod")
        mm = MembershipManager("self:1", [], k8s_service="longbow:3000")
        mm._discover_k8s()
        assert seen["path"] == "/api/v1/namespaces/prod/endpoints/longbow"
        assert seen["auth"] == "Bearer sekret"
        assert sorted(mm.members) == ["10.0.0.7:3000", "10.0.0.8:3000"]
        assert mm.members["10.0.0.7:3000"].region == "node-a"
        assert mm.members["10.0.0.7:3000"].meta_port == 3001
    finally:
        srv.shutdown()
        srv.server_close()


def test_lan_multicast_discovery():
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("", 0))
    port = probe.getsockname()[1]
    probe.close()
    group = f"224.0.1.187:{port}"
    a = MembershipManager("127.0.0.1:4100", [], lan_group=group, self_region="r1")
    b = MembershipManager("127.0.0.1:4200", [], lan_group=group, self_region="r2")
    try:
        t0 = time.monotonic()
        while time.monotonic() - t0 < DEADLINE:
            a.probe_round()
            b.probe_round()
            if "127.0.0.1:4100" in b.members and "127.0.0.1:4200" in a.members:
                break
            time.sleep(0.05)
        assert b.members["127.0.0.1:4100"].region == "r1"
        assert a.members["127.0.0.1:4200"].meta_port == 4201
    finally:
        a.stop()
        b.stop()


def test_digest_merge_rules():
    mm = MembershipManager("self:9", ["127.0.0.1:7001"])
    m = mm.members["127.0.0.1:7001"]
    m.status, m.incarnation = SUSPECT, 1
    events = []
    mm.subscribe(lambda mem: events.append((mem.id, mem.status)))

    def rumor(status, inc, **kw):
        mm.merge_digest([{"id": "127.0.0.1:7001", "host": "127.0.0.1", "data_port": 7001,
                          "status": status, "incarnation": inc, **kw}])

    rumor(ALIVE, 1)
    assert m.status == SUSPECT  # a stale alive refutes nothing
    rumor(ALIVE, 2)
    assert m.status == ALIVE and m.incarnation == 2 and m.misses == 0
    assert ("127.0.0.1:7001", ALIVE) in events
    rumor(DEAD, 3)
    assert m.status == ALIVE  # a remote dead never kills an alive member
    m.status = SUSPECT
    rumor(DEAD, 4)
    assert m.status == DEAD  # ...but confirms a suspicion
    mm.merge_digest([{"id": "10.0.0.9:7002", "host": "10.0.0.9", "data_port": 7002,
                      "meta_port": 7003, "status": ALIVE, "incarnation": 0, "region": "eu"}])
    new = mm.members["10.0.0.9:7002"]
    assert new.status == SUSPECT and new.region == "eu"
    mm.merge_digest([{"id": "self:9", "host": "self", "data_port": 9, "status": DEAD,
                      "incarnation": 99}])
    assert "self:9" not in mm.members


def test_self_refutation_bumps_incarnation():
    mm = MembershipManager("self:9", ["127.0.0.1:7001"])
    assert mm.self_incarnation == 0

    def about_self(status, inc):
        mm.merge_digest([{"id": "self:9", "host": "self", "data_port": 9, "status": status,
                          "incarnation": inc}])

    about_self(SUSPECT, 0)
    assert mm.self_incarnation == 1
    me = mm.digest()[0]
    assert me["incarnation"] == 1 and me["status"] == ALIVE
    about_self(ALIVE, 1)
    about_self(SUSPECT, 0)
    assert mm.self_incarnation == 1
    m = mm.members["127.0.0.1:7001"]
    m.status, m.incarnation = SUSPECT, 0
    mm.merge_digest([{"id": "127.0.0.1:7001", "host": "127.0.0.1", "data_port": 7001,
                      "status": ALIVE, "incarnation": 1}])
    assert m.status == ALIVE and m.incarnation == 1


def test_consistent_hash_ring():
    from collections import Counter

    ring = ConsistentHashRing(["a:1", "b:1", "c:1"])
    keys = [str(i) for i in range(3000)]
    owners = [ring.lookup(k) for k in keys]
    c = Counter(owners)
    assert set(c) == {"a:1", "b:1", "c:1"} and min(c.values()) > 3000 * 0.15
    pl = ring.preference_list(keys[0], 2)
    assert pl[0] == ring.lookup(keys[0]) and len(set(pl)) == 2
    before = dict(zip(keys, owners))
    ring.remove("b:1")
    assert not [k for k in keys if before[k] != ring.lookup(k) and before[k] != "b:1"]
    assert all(ring.lookup(k) != "b:1" for k in keys)


# -- replicated placement --------------------------------------------------------


def test_replicated_put_searchable_on_peer(three_nodes):
    n0, n1, n2 = three_nodes
    v = _vecs(50)
    n0.client.write("docs", np.arange(50), v)
    _wait(lambda: _count(n2.store, "docs") == 50, "50 replicated rows")
    assert n2.client.search("docs", v[7], k=1).column("id")[0].as_py() == 7
    # the origin's timestamp rode the hop
    assert n2.store.get("docs")._lww[7] == n0.store.get("docs")._lww[7]
    n0.client.delete("docs", [7])
    _wait(lambda: _count(n2.store, "docs") == 49, "a replicated delete")
    assert _count(n0.store, "docs") == 49 and _count(n1.store, "docs") == 49
    st = n0.cluster.status()["replication"]
    assert st["mode"] == "async" and st["failed"] == 0


def test_global_search_honors_local_only(three_nodes):
    n0, n1, _ = three_nodes
    v = _vecs(40, seed=3)
    n1.store.put("solo", np.arange(40), v)
    ticket = flight.Ticket(json.dumps({"search": {
        "dataset": "solo", "k": 3, "vector": v[5].tolist(), "local_only": True}}).encode())
    with pytest.raises(flight.FlightError):
        n0.client._dc().do_get(ticket, options=n0.client._opts).read_all()
    assert n0.client.search("solo", v[5], k=3).column("id")[0].as_py() == 5
    resp = n0.client._action("VectorSearch", {"dataset": "solo", "vector": v[9].tolist(), "k": 2},
                             meta=False)
    assert resp["ids"][0] == 9 and "metric" not in resp


def test_global_search_merges_topk(three_nodes):
    q = _vecs(30, seed=4)[0]
    for i, n in enumerate(three_nodes):
        vecs = q[None, :] + (0.1 * (np.arange(10) * 3 + i + 1))[:, None]
        n.store.put("parts", np.arange(10) * 3 + i, vecs.astype(np.float32))
    tbl = three_nodes[0].client.search("parts", q, k=6)
    assert tbl.column("id").to_pylist() == [0, 1, 2, 3, 4, 5]


def test_cluster_status_reports_members(three_nodes):
    n0 = three_nodes[0]
    st = n0.client.cluster_status()
    assert st["self"]["id"] == n0.id
    assert len(st["members"]) == 2 and all(m["status"] == "alive" for m in st["members"])
    assert "replication" in st and st["placement"] == "replicated"
    assert n0.client._action("MeshIdentity", {})["id"] == n0.id
    assert n0.client._action("DiscoveryStatus", {})["provider"] == "static"
    assert len(n0.client._action("MeshStatus", {})["members"]) == 2


def test_anti_entropy_heals_missed_writes(three_nodes):
    n0, _, n2 = three_nodes
    v = _vecs(20, seed=5)
    n0.store.put("heal", np.arange(20), v)  # a missed replication: local only
    assert "heal" not in n2.store.list_datasets()
    n2.store.get_or_create("heal", D)
    assert n2.cluster.sync_worker.run_once() >= 20
    assert n2.store.get("heal").live_count == 20
    assert n2.store.get("heal").merkle_state() == n0.store.get("heal").merkle_state()


def test_asymmetric_partition_no_false_dead(three_nodes):
    a, bnode, _ = three_nodes
    orig = a.cluster.membership._probe_one
    a.cluster.membership._probe_one = lambda m: False if m.id == bnode.id else orig(m)
    for _ in range(12):  # past dead_after (5): only the relays keep B alive
        a.cluster.membership.probe_round()
    m = a.cluster.membership.members[bnode.id]
    assert m.status == ALIVE and m.misses == 0


def test_indirect_probe_cannot_save_a_dead_node(three_nodes):
    a, bnode, _ = three_nodes
    bnode.h.shutdown()
    bnode.cluster.stop()
    for _ in range(14):
        a.cluster.membership.probe_round()
    assert a.cluster.membership.members[bnode.id].status == DEAD
    # the dead member is pruned from the replication fan-out
    assert all(p.addr != bnode.id for p in a.cluster.replicator.peers)


def test_digest_piggyback_spreads_membership(three_nodes):
    a, bnode, c = three_nodes
    # a member only `a` knows of, on a loopback port where nothing listens
    ghost = "127.0.0.1:1"
    a.cluster.membership.merge_digest([{"id": ghost, "host": "127.0.0.1", "data_port": 1,
                                        "meta_port": 2, "status": ALIVE, "incarnation": 0,
                                        "region": ""}])
    a.cluster.membership.digest_every = 1
    for _ in range(3):
        a.cluster.membership.probe_round()
    assert ghost in bnode.cluster.membership.members
    assert ghost in c.cluster.membership.members


def test_global_hybrid_search_forwards_text_query(three_nodes):
    n0, n1, n2 = three_nodes
    rng = np.random.default_rng(11)
    q = rng.standard_normal(D).astype(np.float32)
    n0.store.put("hyb", np.arange(10), q[None, :] + 0.05 * rng.standard_normal((10, D)).astype(
        np.float32), columns={"text": [f"common filler doc {i}" for i in range(10)]})
    n1.store.put("hyb", np.arange(100, 105),
                 q[None, :] + 5.0 + rng.standard_normal((5, D)).astype(np.float32),
                 columns={"text": ["quantum flux capacitor blueprint", "unrelated beta",
                                   "unrelated gamma", "unrelated delta", "unrelated epsilon"]})
    n2.store.put("hyb", np.arange(200, 205),
                 q[None, :] + 3.0 + rng.standard_normal((5, D)).astype(np.float32),
                 columns={"text": [f"noise doc {i}" for i in range(5)]})
    dense = set(n0.client.search("hyb", q, k=5).column("id").to_pylist())
    assert 100 not in dense
    hy = n0.client.search("hyb", q, k=5, text_query="quantum flux capacitor", alpha=0.3)
    hy_ids = hy.column("id").to_pylist()
    assert 100 in hy_ids and any(i < 10 for i in hy_ids)


# -- partitioned placement -------------------------------------------------------


def test_partitioned_placement(three_partitioned_nodes):
    nodes = three_partitioned_nodes
    v = _vecs(90, seed=5)
    nodes[0].client.write("parts", np.arange(90), v)
    counts = [_count(n.store, "parts") for n in nodes]
    assert sum(counts) == 90 and all(c < 90 for c in counts), counts
    ring = ConsistentHashRing(sorted(n.id for n in nodes))
    for n in nodes:
        assert set(n.store.get("parts")._id_to_row) == \
            {i for i in range(90) if ring.lookup(str(i)) == n.id}
        assert n.client.search("parts", v[17], k=3).column("id")[0].as_py() == 17
    nodes[2].client.delete("parts", [17])
    assert sum(_count(n.store, "parts") for n in nodes) == 89
    assert 17 not in nodes[0].client.search("parts", v[17], k=3).column("id").to_pylist()
    st = nodes[0].client.cluster_status()
    assert st["placement"] == "partitioned" and len(st["ring_nodes"]) == 3


def test_smart_client_routes_to_owners(three_partitioned_nodes):
    n0, n1, n2 = three_partitioned_nodes
    c = n0.client.enable_smart_routing()
    assert c._ring is not None
    v = _vecs(60, seed=11)
    ids = np.arange(1000, 1060)
    c.write("smart", ids, v)
    ring = ConsistentHashRing(sorted(n.id for n in (n0, n1, n2)))
    for n in (n0, n1, n2):
        want = {int(i) for i in ids if ring.lookup(str(i)) == n.id}
        got = set(n.store.get("smart")._id_to_row) if _count(n.store, "smart") else set()
        assert got == want
    assert n1.client.search("smart", v[7], k=1).column("id")[0].as_py() == 1007


def test_exchange_batch_search_fans_out(three_partitioned_nodes):
    n0, n1, n2 = three_partitioned_nodes
    v = _vecs(300, seed=21)
    n0.client.write("xfan", np.arange(300), v)
    assert sum(_count(n.store, "xfan") for n in (n0, n1, n2)) == 300
    plain = LongbowClient("127.0.0.1", n0.dp, n0.mp, call_timeout_s=DEADLINE)
    try:
        t = plain.search("xfan", v[:256] + 0.0005, k=1)  # 256 queries: DoExchange
    finally:
        plain.close()
    ids = t.column("id").to_numpy(zero_copy_only=False)
    qi = t.column("query_index").to_numpy()
    assert all(b in ids[qi == b] for b in range(256))
    # the exchange ingest routes rows to their owners too
    assert n0.client.exchange_ingest("xin", [(np.arange(30), v[:30])]) == 30
    assert sum(_count(n.store, "xin") for n in (n0, n1, n2)) == 30
    assert _count(n0.store, "xin") < 30


# -- across the two packages, over loopback --------------------------------------


def test_jax_and_port_nodes_replicate_to_each_other():
    """A longbow_tpu node and a port node in one replicated cluster: a
    put to either becomes searchable on the other with the origin's
    timestamp, and the two Merkle roots become equal."""
    from longbow_tpu.distributed.cluster import ClusterCoordinator as JaxCoordinator
    from longbow_tpu.serving.client import LongbowClient as JaxClient
    from longbow_tpu.serving.flight_server import serve as jax_serve
    from longbow_tpu.store.vector_store import VectorStore as JaxStore

    jstore = JaxStore()
    jh = jax_serve(jstore, data_port=0, meta_port=0, host="127.0.0.1")
    node = _Node()
    jid = f"127.0.0.1:{jh.data_server.port}"
    jspec = f"{jid}:{jh.meta_server.port}"
    jc = JaxCoordinator(jstore, jid, [jspec, node.spec], replication_mode="async",
                        sync_interval_s=3600)
    jh.data_server.cluster = jc
    jh.meta_server.cluster = jc
    node.join([jspec, node.spec], replication_mode="async")
    jclient = JaxClient("127.0.0.1", jh.data_server.port, jh.meta_server.port,
                        call_timeout_s=DEADLINE)
    try:
        v = np.random.default_rng(8).integers(-6, 7, (60, D)).astype(np.float32)
        jclient.write("x", np.arange(30), v[:30])
        _wait(lambda: _count(node.store, "x") == 30, "the JAX node's rows on the port node")
        assert node.client.search("x", v[4], k=1).column("id")[0].as_py() == 4
        assert node.store.get("x")._lww == jstore.get("x")._lww
        node.client.write("x", np.arange(30, 60), v[30:])
        _wait(lambda: _count(jstore, "x") == 60, "the port node's rows on the JAX node")
        assert jclient.search("x", v[44], k=1).column("id")[0].as_py() == 44
        node.client.delete("x", [3])
        _wait(lambda: _count(jstore, "x") == 59, "a delete from the port node")
        # a delete's marker is each node's own time; anti-entropy aligns them
        node.cluster.sync_worker.run_once()
        jc.sync_worker.run_once()
        assert node.store.get("x").merkle_state() == jstore.get("x").merkle_state()
    finally:
        jclient.close()
        jc.stop()
        jh.shutdown()
        node.stop()


# -- three processes ---------------------------------------------------------------


def _free_ports(n):
    """Ports for processes that must name each other before they start
    (a static peer list): bound and released here, so a start may lose a
    port to another process; the caller then tries again."""
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _start_cluster(tmp_path, attempt):
    ports = _free_ports(6)
    specs = ",".join(f"127.0.0.1:{ports[2 * i]}:{ports[2 * i + 1]}" for i in range(3))
    procs = []
    for i in range(3):
        env = {k: v for k, v in os.environ.items() if not k.startswith("LONGBOW_")}
        env.update(
            LONGBOW_DATA_PORT=str(ports[2 * i]), LONGBOW_META_PORT=str(ports[2 * i + 1]),
            LONGBOW_HOST="127.0.0.1", LONGBOW_METRICS_PORT="0",
            LONGBOW_DATA_DIR=str(tmp_path / f"a{attempt}-node{i}"),
            LONGBOW_NODE_ID=f"127.0.0.1:{ports[2 * i]}", LONGBOW_PEERS=specs,
            LONGBOW_REPLICATION="async", LONGBOW_SYNC_INTERVAL_S="3600",
            LONGBOW_FORCE_CPU="1", LONGBOW_WARMUP="0",
            PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
        )
        log = open(tmp_path / f"a{attempt}-node{i}.log", "w")
        procs.append((subprocess.Popen([sys.executable, "-m", "longbow_tpu_torch.serve"],
                                       env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT),
                      log))
    return ports, procs


def test_three_process_cluster(tmp_path):
    """Three `python -m longbow_tpu_torch.serve` processes: a put to node 0
    is searchable through node 2, and node 0 sees two members."""
    for attempt in range(3):
        ports, procs = _start_cluster(tmp_path, attempt)
        c0 = LongbowClient("127.0.0.1", ports[0], ports[1], call_timeout_s=DEADLINE)
        c2 = LongbowClient("127.0.0.1", ports[4], ports[5], call_timeout_s=DEADLINE)
        try:
            t0 = time.monotonic()
            while time.monotonic() - t0 < 90 and all(p.poll() is None for p, _ in procs):
                try:
                    c0.check_readiness()
                    c2.check_readiness()
                    break
                except Exception:
                    time.sleep(0.2)
            if any(p.poll() is not None for p, _ in procs):
                continue  # a port was taken meanwhile: fresh ports
            v = _vecs(30, seed=6)
            c0.write("docs", np.arange(30), v)

            def found():
                try:
                    t = c2.search("docs", v[4], k=1)
                    return t.num_rows and t.column("id")[0].as_py() == 4
                except flight.FlightError:
                    return False

            _wait(found, "node 0's put searchable through node 2", 60.0)
            assert len(c0.cluster_status()["members"]) == 2
            return
        finally:
            c0.close()
            c2.close()
            for p, log in procs:
                p.kill()
                p.wait(timeout=30)
                log.close()
    raise AssertionError("no attempt started three nodes: "
                         + (tmp_path / "a2-node0.log").read_text()[-2000:])
