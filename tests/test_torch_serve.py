"""longbow_tpu_torch/serve.py on the CPU: build_runtime from an
environment, the process entry point under the reference's environment
names (the counterpart of tests/test_persistence.py's
test_periodic_snapshot_with_reference_env), the pyarrow-free import of
the card's path, and the cluster wiring.

Every wait has a deadline and every process and runtime is stopped in a
finally.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from longbow_tpu_torch import serve
from longbow_tpu_torch.config import load_config
from longbow_tpu_torch.serving.errors import ServerError
from longbow_tpu_torch.serving.flight_handlers import FlightHandlers
from longbow_tpu_torch.storage.arrow_ipc import Table, decode_stream, encode_stream
from longbow_tpu_torch.store.vector_store import VectorStore

REPO = Path(__file__).resolve().parent.parent
DEADLINE = 30.0  # seconds: every wait in this file


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_per_worker():
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vecs(n, d=8, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d), dtype=np.float32)


def _wait(cond, what: str):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > DEADLINE:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _env(monkeypatch, tmp_path, **extra):
    for k in list(os.environ):
        if k.startswith("LONGBOW_"):
            monkeypatch.delenv(k)
    env = {"LONGBOW_DATA_PATH": str(tmp_path / "data"), "LONGBOW_SNAPSHOT_INTERVAL": "1s",
           "LONGBOW_FORCE_CPU": "1", "LONGBOW_METRICS_PORT": "0", **extra}
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _put(handlers, name, ids, vecs, **cols):
    """A DoPut as the wire carries it: an Arrow IPC stream, decoded."""
    tbl = decode_stream(encode_stream(Table({"id": ids, "vector": vecs, **cols},
                                            {"longbow.metric": "l2"})))
    return handlers.do_put(name, tbl.schema_metadata, [tbl])


def _ticket(name, q, k=5):
    return json.dumps({"search": {"dataset": name, "k": k, "vectors": q.tolist()}}).encode()


def test_runtime_from_the_environment(monkeypatch, tmp_path):
    _env(monkeypatch, tmp_path, LONGBOW_RATE_LIMIT_RPS="1000", LONGBOW_BREAKER_THRESHOLD="7",
         LONGBOW_AUDIT_LOG=str(tmp_path / "audit.jsonl"), LONGBOW_INGEST_QUEUE_DEPTH="8")
    rt = serve.build_runtime(load_config())
    try:
        assert rt.store.device.type == "cpu" and rt.store.engine is not None
        assert rt.middleware.limiter.rps == 1000 and rt.middleware.breaker.threshold == 7
        assert rt.ingest is not None and rt.ingest._q.maxsize == 8
        assert rt.coalescer is not None and rt.degradation is not None
        assert rt.metrics_port
        v = _vecs(300)
        _put(rt.handlers, "env", np.arange(300), v, category=np.arange(300) % 3)
        _wait(lambda: json.loads(rt.handlers.do_action("check_readiness", b"{}")[0])["status"]
              == "READY", "the ingest queue to drain")
        got = decode_stream(encode_stream(rt.handlers.do_get(_ticket("env", v[:3]))))
        assert got.column("id")[got.column("query_index") == 0][0] == 0
        _wait(lambda: rt.snapshots_taken >= 1, "a periodic snapshot")
        audit = (tmp_path / "audit.jsonl").read_text().splitlines()
        assert json.loads(audit[0])["op"] == "put"
    finally:
        rt.stop()
    assert not any(t.is_alive() for t in rt._threads)
    rt.store.close()
    # a second runtime on the same data path recovers and warms the dataset
    rt2 = serve.build_runtime(load_config())
    try:
        assert rt2.store.get("env").live_count == 300 and "env" in rt2.warmed
        a = rt2.handlers.do_get(_ticket("env", v[:3]))
        np.testing.assert_array_equal(a.column("score"), got.column("score"))
    finally:
        rt2.close()


def test_runtime_needs_a_card_unless_forced_to_the_cpu(monkeypatch, tmp_path):
    _env(monkeypatch, tmp_path)
    monkeypatch.delenv("LONGBOW_FORCE_CPU")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_runtime(load_config())


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_serve_module_with_the_reference_env_names(tmp_path):
    from longbow_tpu_torch.serving.client import LongbowClient

    dp, mp = _free_port(), _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("LONGBOW_")}
    env.update(LONGBOW_LISTEN_ADDR=f"127.0.0.1:{dp}", LONGBOW_META_ADDR=f"0.0.0.0:{mp}",
               LONGBOW_METRICS_PORT="0", LONGBOW_DATA_PATH=str(tmp_path / "data"),
               LONGBOW_SNAPSHOT_INTERVAL="2s", LONGBOW_FORCE_CPU="1",
               PYTHONPATH=str(REPO) + os.pathsep + env.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "longbow_tpu_torch.serve"], env=env,
                            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    c = LongbowClient("127.0.0.1", dp, mp, call_timeout_s=10.0)
    try:
        def up():
            try:
                return c.check_readiness()["status"] == "READY"
            except Exception:
                assert proc.poll() is None, "the server exited"
                return False

        _wait(up, "the server to answer")
        c.write("snapdocs", np.arange(25), _vecs(25, seed=9))

        def applied():
            try:  # "not found" until the ingest queue has applied the put
                return c.scan("snapdocs").num_rows == 25
            except Exception:
                return False

        _wait(applied, "the write to be applied")
        t_vis = time.time()
        snapdir = tmp_path / "data" / "snapshot"
        _wait(lambda: snapdir.exists() and any(
            f.stat().st_mtime >= t_vis for f in snapdir.rglob("*")), "a newer periodic snapshot")
    finally:
        c.close()
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=DEADLINE)
    vs = VectorStore(device="cpu", persist_dir=tmp_path / "data")
    try:
        assert vs.get("snapdocs").live_count == 25
    finally:
        vs.close()


def test_sigterm_stops_the_server_with_a_final_snapshot(tmp_path):
    dp, mp = _free_port(), _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("LONGBOW_")}
    env.update(LONGBOW_DATA_PORT=str(dp), LONGBOW_META_PORT=str(mp), LONGBOW_HOST="127.0.0.1",
               LONGBOW_METRICS_PORT="0", LONGBOW_DATA_DIR=str(tmp_path / "d"),
               LONGBOW_FORCE_CPU="1", LONGBOW_ASYNC_INGEST="0",
               PYTHONPATH=str(REPO) + os.pathsep + env.get("PYTHONPATH", ""))
    from longbow_tpu_torch.serving.client import LongbowClient

    proc = subprocess.Popen([sys.executable, "-m", "longbow_tpu_torch.serve"], env=env,
                            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    c = LongbowClient("127.0.0.1", dp, mp, call_timeout_s=10.0)
    try:
        def up():
            try:
                return bool(c.check_readiness())
            except Exception:
                assert proc.poll() is None, "the server exited"
                return False

        _wait(up, "the server to answer")
        c.write("final", np.arange(10), _vecs(10))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=DEADLINE) == 0
    finally:
        c.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=DEADLINE)
    assert (tmp_path / "d" / "snapshot").exists()
    vs = VectorStore(device="cpu", persist_dir=tmp_path / "d")
    try:
        assert vs.get("final").live_count == 10
    finally:
        vs.close()


_BLOCKED = r"""
import sys
sys.modules["pyarrow"] = None  # any import of pyarrow now raises ImportError
import numpy as np
from longbow_tpu_torch.serve import build_runtime
from longbow_tpu_torch.config import load_config
from longbow_tpu_torch.serving import middleware, errors, flight_handlers
from longbow_tpu_torch.storage.arrow_ipc import Table, decode_stream, encode_stream
rt = build_runtime(load_config())
try:
    v = np.random.default_rng(0).standard_normal((50, 8), dtype=np.float32)
    t = decode_stream(encode_stream(Table({"id": np.arange(50), "vector": v})))
    rt.handlers.do_put("p", {}, [t])
    assert rt.ingest.drain(timeout_s=30)
    out = rt.handlers.do_get(b'{"search": {"dataset": "p", "k": 3, "vector": %s}}'
                             % str(v[4].tolist()).encode())
    assert int(out.column("id")[0]) == 4
    try:
        import longbow_tpu_torch.serving.flight_server  # noqa: F401
    except ImportError:
        pass
    else:
        raise SystemExit("the binding imported without pyarrow")
    bad = [m for m in sys.modules if m.startswith(("jax", "longbow_tpu.")) or m == "longbow_tpu"]
    assert not bad, bad
finally:
    rt.stop()
print("ok")
"""


def test_card_path_imports_and_runs_with_pyarrow_blocked(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("LONGBOW_")}
    env.update(LONGBOW_FORCE_CPU="1", LONGBOW_DATA_PATH=str(tmp_path / "d"), LONGBOW_METRICS_PORT="0",
               PYTHONPATH=str(REPO) + os.pathsep + env.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", _BLOCKED], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


def test_cluster_coordinator_is_served(tmp_path):
    """A cluster coordinator is served: the handlers and both listeners
    of a process hold the one given."""
    from longbow_tpu_torch.distributed.cluster import ClusterCoordinator
    from longbow_tpu_torch.serving.flight_server import LongbowFlightServer

    store = VectorStore(device="cpu")
    cc = ClusterCoordinator(store, "127.0.0.1:1", [], replication_mode="off")
    try:
        assert FlightHandlers(store, cluster=cc).cluster is cc
        srv = LongbowFlightServer(store, "grpc://127.0.0.1:0", cluster=cc)
        try:
            assert srv.handlers.cluster is cc
            st = json.loads(srv.handlers.do_action("cluster-status", b"{}")[0])
            assert st["self"]["id"] == "127.0.0.1:1" and st["placement"] == "replicated"
        finally:
            srv.shutdown()
    finally:
        cc.stop()


def test_main_refuses_a_peer_list(monkeypatch, tmp_path):
    """A peer list with partitioned placement and no dialable identity
    (the bind address 0.0.0.0) exits 2 before any state is built."""
    _env(monkeypatch, tmp_path, LONGBOW_PEERS="10.0.0.2:3000", LONGBOW_PLACEMENT="partitioned")
    assert serve.main() == 2
    assert not (tmp_path / "data").exists()


@pytest.mark.parametrize("name", ["region-summary", "merkle-state", "export-delta"])
def test_cluster_actions_answer_on_a_single_node(name):
    """The three actions answer on a single node (no cluster needed)."""
    store = VectorStore(device="cpu")
    store.put("d", np.arange(5), _vecs(5), timestamp=7.0)
    h = FlightHandlers(store)
    out = json.loads(h.do_action(name, b'{"dataset": "d", "bucket": 0}')[0])
    if name == "region-summary":
        assert out["regions"]["d"]["n"] == 5
        np.testing.assert_allclose(out["regions"]["d"]["centroid"], _vecs(5).mean(0), atol=0.02)
    elif name == "merkle-state":
        assert len(out["leaves"]) == 256 and len(out["root"]) == 32
    else:
        from longbow_tpu_torch.distributed.merkle import bucket_of

        assert sorted(r["id"] for r in out["rows"]) == [i for i in range(5) if bucket_of(i) == 0]
    with pytest.raises(ServerError, match="not found"):
        h.do_action(name if name != "region-summary" else "merkle-state", b'{"dataset": "zz"}')
