"""longbow_tpu_torch's operator entry points (longbow_tpu_torch/tools/:
ops, bench_tool, soak_mixed, chaos_soak, start_local_cluster) on the CPU,
each held to its counterpart in tools/ or scripts/.

Servers run in process on loopback (port 0, client timeouts): the port's
`serve` over a CPU VectorStore, and longbow_tpu's. The reference's
tools/ops.py and tools/bench_tool.py are loaded by file path. The chaos
soak starts three `python -m longbow_tpu_torch.serve` processes with
--device cpu. Rows come from numpy's default_rng, as the tools draw them.

Tolerance: ops search answers agree in ids and in scores to rtol 1e-6
(both packages store bf16 rows and sum in f32, in other orders). The
queries are drawn at seeds whose vectors are not stored rows: a query that
is a stored row has a distance of bf16 rounding error, about 2e-5, which
no relative tolerance can hold across two summation orders.
"""
import contextlib
import importlib.util
import io
import json
import os
import stat
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from longbow_tpu.serving.flight_server import serve as jax_serve
from longbow_tpu.store.vector_store import VectorStore as JaxStore
from longbow_tpu_torch.serving.flight_server import serve
from longbow_tpu_torch.store.vector_store import VectorStore
from longbow_tpu_torch.tools import bench_tool, ops, soak_mixed, start_local_cluster

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_per_worker():
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(path: str):
    spec = importlib.util.spec_from_file_location(f"ref_{Path(path).stem}", REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _addr(h) -> list:
    return ["--host", "127.0.0.1", "--data-port", str(h.data_server.port),
            "--meta-port", str(h.meta_server.port)]


def _json_out(fn, *args) -> dict:
    """Runs a tool's main, which must return 0, and reads its last line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    assert rc == 0, buf.getvalue()
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _recorded_env(path: Path) -> dict:
    """The environment a stand-in interpreter wrote to `path`, once whole."""
    for _ in range(200):
        if path.exists() and path.read_text().endswith("\n"):
            break
        time.sleep(0.05)
    return dict(line.split("=", 1) for line in path.read_text().splitlines() if "=" in line)


def _reference_ops(ref, argv, monkeypatch) -> dict:
    monkeypatch.setattr(sys, "argv", ["ops.py", *argv])
    return _json_out(ref.main)


@pytest.fixture
def port_server():
    h = serve(VectorStore(device="cpu"), data_port=0, meta_port=0, host="127.0.0.1")
    yield h
    h.shutdown()


@pytest.fixture
def jax_server():
    h = jax_serve(JaxStore(), data_port=0, meta_port=0, host="127.0.0.1")
    yield h
    h.shutdown()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_ops_answers_as_the_reference_cli(server, port_server, jax_server, monkeypatch):
    """The port's ops CLI against a port server, and against a JAX server
    (the wire is the same), answers as tools/ops.py does against a JAX
    server: put, search, get, info, delete, ns-list."""
    ref = _reference("tools/ops.py")
    mine = _addr(port_server if server == "port" else jax_server)
    theirs = _addr(jax_server)
    if server == "jax":  # one JAX server for both CLIs: its own dataset each
        mine = mine + ["--dataset", "port_cli"]
        theirs = theirs + ["--dataset", "ref_cli"]
    cmds = (["put", "--rows", "300", "--dim", "16"], ["search", "--k", "8", "--seed", "5"],
            ["get", "--limit", "5"], ["info"], ["delete", "--ids", "3,4,5"],
            ["search", "--k", "8", "--seed", "9"], ["get"])
    for cmd in cmds:
        got = _json_out(ops.main, cmd + mine)
        want = _reference_ops(ref, cmd + theirs, monkeypatch)
        if cmd[0] == "search":
            assert got["ids"] == want["ids"]
            np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-6)
        else:
            assert got == want, cmd
    assert _json_out(ops.main, ["get"] + mine)["rows"] == 297
    names = _json_out(ops.main, ["ns-list"] + mine)
    assert names == _reference_ops(ref, ["ns-list"] + mine, monkeypatch)


def test_ops_search_equals_the_store(port_server):
    """`put` then `search` through the CLI answer as the store searched
    in process with the same seeded rows and query."""
    addr = _addr(port_server)
    _json_out(ops.main, ["put", "--rows", "200", "--dim", "8", "--seed", "2"] + addr)
    got = _json_out(ops.main, ["search", "--k", "5", "--seed", "3"] + addr)
    rows = np.random.default_rng(2).standard_normal((200, 8), dtype=np.float32)
    q = np.random.default_rng(3).standard_normal((8,), dtype=np.float32)
    store = VectorStore(device="cpu")
    store.put("ops_test", np.arange(200), rows)
    ids, scores, ok = store.search("ops_test", q[None], 5, use_cache=False)
    assert got["ids"] == [int(i) for i in ids[0][ok[0]]]
    np.testing.assert_allclose(got["scores"], scores[0][ok[0]], rtol=1e-6)


def test_parse_filter_as_the_reference():
    ref = _reference("tools/ops.py")
    for expr in ("price<10", "cat=a", "n>=5", "x!=3", "y<=2.5", "z>1"):
        assert ops._parse_filter(expr) == ref._parse_filter(expr)
    with pytest.raises(SystemExit):
        ops._parse_filter("nonsense")


def test_bench_tool_micro_keys_equal_the_reference():
    """micro on the CPU prints the reference micro mode's keys, all
    positive rates."""
    got = _json_out(bench_tool.run_micro, None, "cpu")
    want = _json_out(_reference("tools/bench_tool.py").run_micro, None)
    assert set(got) == set(want)
    assert all(v > 0 for v in got.values())


@pytest.mark.parametrize("mode", ["ingest", "search"])
def test_bench_tool_modes_run_without_errors(mode, port_server):
    extra = (["--index", "flat"] if mode == "ingest" else ["--warmup-rows", "2000"])
    out = _json_out(bench_tool.main, ["--mode", mode, "--duration", "2", "--concurrency", "2",
                                      "--dim", "16", "--batch-size", "500", *extra]
                    + _addr(port_server))
    assert out["mode"] == mode and out["errors"] == 0 and out["ops"] > 0
    ds = port_server.data_server.handlers.store.get("bench")
    if mode == "ingest":
        assert ds.index_kind == "flat" and ds.live_count == out["ops"] * 500
    else:
        assert ds.live_count == 2000


def test_bench_tool_int8_payload_makes_an_identity_sq8_dataset(port_server):
    out = _json_out(bench_tool.main, ["--mode", "ingest", "--duration", "1", "--concurrency",
                                      "1", "--dim", "16", "--dtype", "i8", "--dataset", "b8"]
                    + _addr(port_server))
    assert out["errors"] == 0 and out["mb_per_s"] is not None
    ds = port_server.data_server.handlers.store.get("b8")
    assert ds.index_kind == "sq8" and ds.live_count == out["ops"] * 1000


def test_start_local_cluster_env_equals_the_shell_script(tmp_path):
    """scripts/start_local_cluster.sh run with a stand-in `python` that
    records each node's environment: every LONGBOW_* value equals
    node_env's, with the two pass-through settings unset and set."""
    fake = tmp_path / "bin"
    fake.mkdir()
    (fake / "python").write_text('#!/bin/sh\nenv > "$LONGBOW_DATA_DIR.env"\n')
    (fake / "python").chmod(stat.S_IRWXU)
    for passed in ({}, {"LONGBOW_REPLICATION": "quorum", "LONGBOW_SYNC_INTERVAL_S": "3"}):
        root = tmp_path / f"root{len(passed)}"
        env = {k: v for k, v in os.environ.items() if not k.startswith("LONGBOW_")}
        env.update(passed, PATH=f"{fake}{os.pathsep}{env['PATH']}")
        res = subprocess.run(["bash", str(REPO / "scripts/start_local_cluster.sh"), str(root)],
                             env=env, capture_output=True, text=True, timeout=60)
        assert res.returncode == 0, res.stderr
        for i in range(3):  # the script backgrounds each node
            got = {k: v for k, v in _recorded_env(root / f"node{i}.env").items()
                   if k.startswith("LONGBOW_")}
            assert got == start_local_cluster.node_env(i, str(root), env)


def test_start_local_cluster_launches_and_writes_pids(tmp_path, monkeypatch):
    """main() starts a process a node with node_env's settings, prints
    the script's lines and writes the pids file (a stand-in interpreter
    records the environment and exits)."""
    fake = tmp_path / "python"
    fake.write_text('#!/bin/sh\nenv > "$LONGBOW_DATA_DIR.env"\n')
    fake.chmod(stat.S_IRWXU)
    monkeypatch.setattr(start_local_cluster.sys, "executable", str(fake))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert start_local_cluster.main([str(tmp_path / "c"), "--device", "cpu"]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("node0: data :3000 meta :3001 metrics :9090 pid ")
    assert lines[3] == f"cluster up; stop with: kill $(cat {tmp_path / 'c'}/pids)"
    assert len((tmp_path / "c" / "pids").read_text().split()) == 3
    for i in range(3):
        env = _recorded_env(tmp_path / "c" / f"node{i}.env")
        assert env["LONGBOW_FORCE_CPU"] == "1"
        for k, v in start_local_cluster.node_env(i, str(tmp_path / "c"), os.environ).items():
            assert env[k] == v


def test_soak_mixed_read_back_check_passes(port_server, monkeypatch):
    """A short mixed soak (seed and capacity cut for the CPU) against a
    port server: no write, search or delete error, every kept write found
    first, no deleted id in the final scan, exit 0."""
    monkeypatch.setattr(soak_mixed, "N0", 4_000)
    monkeypatch.setattr(soak_mixed, "SEED_BATCH", 2_000)
    monkeypatch.setattr(soak_mixed, "CAPACITY", 16_384)
    monkeypatch.setattr(soak_mixed, "DELETE_EVERY_S", 0.5)
    out = _json_out(soak_mixed.main, ["2", "--metrics-port", "1"] + _addr(port_server))
    assert out["ok"] and out["serr"] == out["werr"] == out["derr"] == 0
    assert out["top1_self_match"] == out["checked"] > 0
    assert out["deleted_ids"] > 0 and out["deleted_ids_back"] == []
    store = port_server.data_server.handlers.store
    assert store.get("soak").live_count == out["live_rows"]


def test_chaos_soak_heals_on_the_cpu():
    """Three CPU node processes; node 1 killed and restarted under writes;
    HEALED, every acknowledged row on all three nodes with equal roots."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("LONGBOW_")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # one torch thread a node: the test workers share the cores
    # at a lower priority (the nodes inherit it): other test files' server
    # processes have 30 s deadlines, this soak's waits are minutes long
    res = subprocess.run(["nice", "-n", "10", sys.executable, "-m",
                          "longbow_tpu_torch.tools.chaos_soak",
                          "--device", "cpu", "--duration", "10"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert "HEALED" in lines and "cluster up" in lines
    out = json.loads(lines[-1])
    assert out["every_row_on_every_node"] and out["live_rows"] == [out["rows_acked"]] * 3
    assert out["heal_s"] is not None and out["reads_ok"] > 0 and out["errors"] == 0
