"""longbow_tpu_torch's VectorStore against longbow_tpu's on the CPU, on one
put / delete / filtered-search sequence, and the port's import rules.

Both stores keep bf16 rows and rank them exactly in f32, so ids and ok
masks agree and scores within rtol 1e-5 / atol 1e-4.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.query.parser import Filter as JaxFilter
from longbow_tpu.query.parser import parse_ticket as jax_parse_ticket
from longbow_tpu.store.vector_store import VectorStore as JaxStore
from longbow_tpu_torch.index.factory import (
    INDEX_KINDS,
    PORTED_KINDS,
    import_index,
    make_index,
)
from longbow_tpu_torch.query.parser import Filter, parse_ticket
from longbow_tpu_torch.store.vector_store import VectorStore

REPO = Path(__file__).resolve().parent.parent
D = 32


def _sequence(store, filt, ids_of, metric):
    """Puts (with an in-batch duplicate and an overwrite), deletes and
    searches; returns every search result."""
    rng = np.random.default_rng(7)
    v1 = rng.standard_normal((1200, D), dtype=np.float32)
    v2 = rng.standard_normal((400, D), dtype=np.float32)
    q = rng.standard_normal((5, D), dtype=np.float32)
    n1 = np.arange(1200)
    ids1 = ids_of(n1)
    ids1[10] = ids1[11]  # in-batch duplicate: the later row wins
    color = np.array(["red", "green", "blue"])[n1 % 3]
    store.put("ds", ids1, v1, {"color": color, "n": n1 % 10}, metric=metric)
    out = [store.search("ds", q, 10)]
    n2 = np.arange(1000, 1400)  # 200 overwrites, 200 new
    store.put("ds", ids_of(n2), v2,
              {"color": np.array(["red", "blue"])[n2 % 2], "n": n2 % 10})
    assert store.delete("ds", ids_of(np.arange(0, 300, 4))) == 75
    out.append(store.search("ds", q, 10))
    out.append(store.search("ds", v1[:5], 12, filters=[filt("color", "eq", "red")]))
    out.append(store.search("ds", q, 10, filters=[filt("n", ">=", "7"),
                                                  filt("color", "!=", "blue")]))
    out.append(store.search("ds", q, 100))  # past the scan's pool: exact path
    return out


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("id_kind", ["int", "str"])
def test_store_matches_jax(id_kind, metric):
    ids_of = (lambda n: n.astype(np.int64)) if id_kind == "int" else (
        lambda n: np.array([f"doc-{x}" for x in n], dtype=object))
    want = _sequence(JaxStore(dtype=jnp.bfloat16, default_index_kind="flat"),
                     JaxFilter, ids_of, metric)
    got = _sequence(VectorStore(device="cpu", dtype=torch.bfloat16,
                                default_index_kind="flat"),
                    Filter, ids_of, metric)
    for (wi, ws, wok), (gi, gs, gok) in zip(want, got):
        np.testing.assert_array_equal(gok, wok)
        np.testing.assert_array_equal(np.where(gok, gi, None), np.where(wok, wi, None))
        np.testing.assert_allclose(np.where(gok, gs, 0), np.where(wok, ws, 0),
                                   rtol=1e-5, atol=1e-4)
    # the filters held: red rows only, and n >= 7 and not blue
    ids3, _, ok3 = got[2]
    nums = [int(str(x).replace("doc-", "")) for x in ids3[ok3]]
    assert all((x % 2 == 0) if x >= 1000 else (x % 3 == 0) for x in nums)


def test_store_lifecycle_and_cache():
    store = VectorStore(device="cpu", dtype=torch.bfloat16, default_index_kind="flat")
    v = np.random.default_rng(0).standard_normal((50, 8), dtype=np.float32)
    store.put("ns/a", np.arange(50), v)
    assert store.list_datasets() == ["ns/a"] and store.list_namespaces() == ["ns"]
    first = store.search("ns/a", v[:2], 3)
    assert store.search("ns/a", v[:2], 3) is first  # cached
    assert store.query_cache.hits == 1
    store.put("ns/a", [50], v[:1])  # a mutation clears the cache
    assert store.search("ns/a", v[:2], 3) is not first
    store.put("ns/a", [3], v[3:4])  # an overwrite frees the old row
    store.delete("ns/a", [7])
    rows = store.get("ns/a").row_ids_array()
    assert rows[3] is None and rows[7] is None and rows[51] == 3 and len(rows) == 52
    with pytest.raises(ValueError):
        store.put("ns/a", [1], np.ones((1, 9), np.float32))
    assert store.readiness()["status"] == "READY"
    stats = store.get("ns/a").stats()
    assert (stats["live_rows"], stats["tombstones"]) == (50, 2)
    assert store.drop("ns/a") and not store.drop("ns/a")
    with pytest.raises(KeyError):
        store.get("ns/a")


def test_factory_ports_flat_only():
    """Every kind, the device-mesh kinds included, is ported and reads its
    own export back. An adaptive index below its threshold is of kind
    flat."""
    assert set(PORTED_KINDS) == set(INDEX_KINDS) == {
        "adaptive", "flat", "hnsw", "pq", "sq8", "sq8r", "bq", "disk", "ivf",
        "mesh_flat", "mesh_graph"}
    rows = _clustered(300, 16, 5)  # pq trains 256 centroids: at least 256 rows
    for kind in PORTED_KINDS:
        idx = make_index(kind, 16, "l2", dtype=torch.bfloat16, device="cpu")
        idx.add(rows)
        again = import_index(idx.export_state(), device="cpu")
        assert len(again) == 300 and again.kind == {"adaptive": "flat"}.get(kind, kind)
        assert type(again) is type(idx)
        np.testing.assert_array_equal(again.search(rows[:4], 3)[1], idx.search(rows[:4], 3)[1])
    with pytest.raises(ValueError):
        make_index("nope", 8, "l2", dtype=torch.bfloat16, device="cpu")


def _clustered(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, d)).astype(np.float32) * 3.0
    return (centers[rng.integers(0, 16, n)] + rng.standard_normal((n, d))).astype(np.float32)


def _small_graph_store(**kw):
    from longbow_tpu_torch.index.hnsw import HNSWConfig

    return VectorStore(
        device="cpu", migration_threshold=1024,
        hnsw_config=HNSWConfig(m=8, m_max=16, ef_construction=32, ef_search=64,
                               insert_batch_size=256), **kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_default_kind_migrates_and_serves_from_the_graph(dtype):
    """No kind named: f32 puts land in the flat tier, the dataset
    migrates at the threshold and is served from the graph, like the JAX
    store's; recall against the store's own exact path."""
    from longbow_tpu.index.hnsw import HNSWConfig as JaxConfig

    data, q = _clustered(3000, D, 21), _clustered(32, D, 22)
    ids = np.arange(3000, dtype=np.int64) + 10_000
    store = _small_graph_store(dtype=dtype)
    jstore = JaxStore(dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32,
                      migration_threshold=1024,
                      hnsw_config=JaxConfig(m=8, m_max=16, ef_construction=32, ef_search=64,
                                            insert_batch_size=256))
    for st in (store, jstore):
        for s in range(0, 3000, 500):
            st.put("ds", ids[s:s + 500], data[s:s + 500], {"n": np.arange(s, s + 500) % 100})
            if s == 0:
                assert st.get("ds").index.kind == "flat"
        assert st.get("ds").index.wait_migration() and st.get("ds").index.kind == "hnsw"
        assert st.delete("ds", ids[:40]) == 40
    ds = store.get("ds")
    assert ds.migration_threshold == 1024 and ds.stats()["index_kind"] == "hnsw"
    assert ds.stats()["index_rows"] == 3000 and ds.device_bytes() > 0
    got, _, ok = store.search("ds", q, 10)
    want, wscore, _ = store.search("ds", q, 10, exact=True)
    jgot, _, _ = jstore.search("ds", q, 10)
    rec = np.mean([len(set(g) & set(w)) / 10 for g, w in zip(got, want)])
    jrec = np.mean([len(set(g) & set(w)) / 10 for g, w in zip(jgot, want)])
    assert ok.all() and rec >= 0.9 and rec >= jrec - 0.05, (rec, jrec)
    assert not (set(got.ravel().tolist()) & set(ids[:40].tolist()))
    jwant, jscore, _ = jstore.search("ds", q, 10, exact=True)
    np.testing.assert_allclose(wscore, jscore, rtol=1e-5, atol=1e-4)


def test_selectivity_routing_sends_narrow_filters_to_the_exact_path():
    data, q = _clustered(3000, D, 23), _clustered(8, D, 24)
    store = _small_graph_store(dtype=torch.float32)
    store.put("ds", np.arange(3000), data, {"n": np.arange(3000) % 100})
    ds = store.get("ds")
    assert ds.index.wait_migration()
    calls = []
    real = ds.index.search

    def spy(queries, k, **kw):
        calls.append(kw["exact"])
        return real(queries, k, **kw)

    ds.index.search = spy
    ds.search(q, 5)                                        # no filter: the graph
    wide = [Filter("n", ">=", "1")]                        # 2970 rows < max(4096, cap / 50)
    ds.search(q, 5, filters=wide)
    assert calls == [False, True]
    narrow = [Filter("n", "eq", "7")]                      # 30 rows
    ids, _, ok = ds.search(q, 5, filters=narrow)
    assert calls[-1] is True and ok.all() and all(int(x) % 100 == 7 for x in ids[ok])
    # a mask wide enough stays on the graph (the floor is max(4096, capacity / 50))
    big = torch.ones(ds.index.capacity, dtype=torch.bool)
    ds.filter_cache.get_or_eval_versioned = lambda cols, f: (big if f else None, 0)
    ds.filter_cache.selectivity_count = lambda f, m, v: 5000
    ds.search(q, 5, filters=wide)
    assert calls[-1] is False
    # a flat tier is never rerouted
    flat = VectorStore(device="cpu", dtype=torch.float32)
    flat.put("f", np.arange(100), data[:100], {"n": np.arange(100)})
    fcalls = []
    freal = flat.get("f").index.search
    flat.get("f").index.search = lambda qq, k, **kw: (fcalls.append(kw["exact"]), freal(qq, k, **kw))[1]
    flat.search("f", q, 5, filters=[Filter("n", "<", "10")])
    assert fcalls == [False]


def test_selectivity_count_is_keyed_to_the_version_of_its_mask():
    """A write between a mask's evaluation and its count must not leave
    the stale mask's count cached for the masks that follow."""
    from longbow_tpu_torch.query.filters import ColumnStore, FilterCache

    cols = ColumnStore(16, device="cpu")
    cols.append({"n": np.arange(8)}, 8, 16)
    cache = FilterCache()
    f = [Filter("n", ">", "3")]
    mask, ver = cache.get_or_eval_versioned(cols, f)
    assert int(mask.sum()) == 4
    cols.append({"n": np.full(4, 9)}, 4, 16)  # the write: 4 more rows match
    cache.invalidate()
    assert cache.selectivity_count(f, mask, ver) == 4  # the stale mask's own count
    mask2, ver2 = cache.get_or_eval_versioned(cols, f)
    assert ver2 == ver + 1 and int(mask2.sum()) == 8
    assert cache.selectivity_count(f, mask2, ver2) == 8  # not the 4 of before
    assert cache.selectivity_count(f, None, ver2) == 8   # cached: the mask is not read
    assert cache.get_or_eval_versioned(cols, []) == (None, ver2)
    cache.invalidate()
    assert not cache._counts and not cache._d


def test_parse_ticket_matches_jax():
    ticket = (b'{"name": "ds", "limit": 5, "search": {"vector": [1.0, 2.5], "k": 7,'
              b' "filters": [{"field": "n", "op": ">=", "value": 3},'
              b' {"field": "c", "operator": "in", "value": ["a", "b"], "logic": "or"}],'
              b' "consistency": "quorum"}}')
    want, got = jax_parse_ticket(ticket), parse_ticket(ticket)
    assert (got.name, got.limit) == (want.name, want.limit)
    ws, gs = want.search, got.search
    assert (gs.dataset, gs.k, gs.consistency) == (ws.dataset, ws.k, ws.consistency)
    np.testing.assert_array_equal(np.asarray(gs.query_vectors(), np.float32),
                                  np.asarray(ws.query_vectors(), np.float32))
    assert [(f.field, f.operator, f.value, f.logic) for f in gs.filters] == [
        (f.field, f.operator, f.value, f.logic) for f in ws.filters]
    for bad in (b"[1]", b"{", b'{"search": {"k": 0}}'):
        with pytest.raises(ValueError):
            parse_ticket(bad)


# the Flight binding, the client, and the cluster layer's coordinator and
# replicator (their peers are clients): the only modules that import pyarrow
# (a single node's path imports none of them)
PYARROW_MODULES = ("longbow_tpu_torch/serving/flight_server.py",
                   "longbow_tpu_torch/serving/client.py",
                   "longbow_tpu_torch/distributed/cluster.py",
                   "longbow_tpu_torch/distributed/replicator.py")


OPERATOR_TOOLS = ("ops", "bench_tool", "soak_mixed", "chaos_soak", "start_local_cluster")


def test_port_imports_no_jax_pyarrow_or_reference_package():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "longbow_tpu_torch").rglob("*.py")
        if p.relative_to(REPO).as_posix() not in PYARROW_MODULES
    )
    code = (
        "import sys, importlib\n"
        f"for m in {modules!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pyarrow', 'longbow_tpu', 'prometheus_client')]\n"
        "print(len(sys.modules)); sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(modules) >= 15
    assert {f"longbow_tpu_torch.tools.{t}" for t in OPERATOR_TOOLS} <= set(modules)


@pytest.mark.parametrize("tool", OPERATOR_TOOLS)
def test_tool_imports_no_jax_or_reference_package(tool):
    """Each tool's --help, with the client its commands call, imports
    neither jax nor longbow_tpu."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['{tool}', '--help']\n"
        "try:\n"
        f"    runpy.run_module('longbow_tpu_torch.tools.{tool}', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "import longbow_tpu_torch.serving.client\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'longbow_tpu')]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "usage" in proc.stdout


def test_port_sources_name_no_forbidden_import():
    forbidden = ("import jax", "from jax", "import pyarrow", "from pyarrow",
                 "import longbow_tpu\n", "import longbow_tpu.", "from longbow_tpu.",
                 "from longbow_tpu import", "import prometheus_client",
                 "from prometheus_client")
    files = [*(REPO / "longbow_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    for path in files:
        text = path.read_text()
        rel = path.relative_to(REPO).as_posix()
        lazy = {
            # the Flight bearer middleware's one lazy import, inside its
            # function (no other code path needs pyarrow)
            "longbow_tpu_torch/serving/security.py": ["\n    import pyarrow.flight as flight\n"],
            # phase 13.8's gRPC binding, where pyarrow is installed, and
            # phase 14's cluster transport, which fails the phase without it
            "chip_smoke.py": ["\n        import pyarrow.flight  # noqa: F401\n",
                              "\n    import pyarrow as pa\n",
                              "\n        import pyarrow.flight as flight\n"],
        }.get(rel, [])
        for line in lazy:
            assert text.count(line) == 1, (rel, line)
            text = text.replace(line, "\n")
        allowed = ("import pyarrow", "from pyarrow") if rel in PYARROW_MODULES else ()
        for bad in forbidden:
            assert bad in allowed or bad not in text, f"{path}: {bad.strip()}"


def test_only_the_dataset_writes_its_id_state():
    """No module of the port but store/dataset.py assigns, deletes or
    setattr's a dataset's id state (_id_to_row, _lww, _rows): the others
    go through Dataset's methods."""
    import ast

    fields = {"_id_to_row", "_lww", "_rows"}
    bad = []
    for path in sorted((REPO / "longbow_tpu_torch").rglob("*.py")):
        rel = path.relative_to(REPO).as_posix()
        if rel == "longbow_tpu_torch/store/dataset.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Assign, ast.Delete)):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                  and node.func.id in ("setattr", "delattr") and len(node.args) >= 2
                  and isinstance(node.args[1], ast.Constant)
                  and node.args[1].value in fields):
                bad.append(f"{rel}:{node.lineno}")
                continue
            else:
                continue
            for t in targets:
                for sub in ast.walk(t):
                    if isinstance(sub, ast.Attribute) and sub.attr in fields:
                        bad.append(f"{rel}:{node.lineno}")
    assert not bad, bad


# the quantized kinds of this slice, with the params that reach the index
NEW_KINDS = {
    "pq": {"pq_m": 8},
    "bq": {},
    "ivf": {"n_probe": 6},
    "disk": {"rerank_factor": 8},
}


@pytest.mark.parametrize("kind", sorted(NEW_KINDS))
def test_new_kinds_through_the_store(kind, tmp_path):
    """pq, bq, ivf and disk through VectorStore.get_or_create and the
    same put / delete / filtered-search sequence as longbow_tpu's store.
    bq and disk train nothing random, so their ids equal JAX's wherever
    neighbouring scores differ by more than 1e-4 (and scores to rtol
    1e-5 / atol 1e-4); pq and ivf draw another k-means init, so they are
    held to recall@10 against the store's exact flat twin, no lower than
    JAX's by more than 0.05. Every kind has a recall floor too."""
    params = dict(NEW_KINDS[kind])
    if kind == "disk":
        params["path"] = str(tmp_path / "rows.f32")
    data, q = _clustered(3000, D, 31), _clustered(16, D, 32)
    ids = np.arange(3000, dtype=np.int64) + 500
    cols = {"n": np.arange(3000) % 4}
    out = {}
    for name, st in (("port", VectorStore(device="cpu")), ("jax", JaxStore())):
        ds = st.get_or_create("ds", D, index_kind=kind, index_params=params)
        st.put("ds", ids[:1500], data[:1500], {"n": cols["n"][:1500]})
        st.put("ds", ids[1500:], data[1500:], {"n": cols["n"][1500:]})
        assert st.delete("ds", ids[:3000:10]) == 300
        filt = (Filter if name == "port" else JaxFilter)("n", "eq", "2")
        out[name] = (st.search("ds", q, 10), st.search("ds", q, 10, filters=[filt]), ds)
    (gi, gs, gok), (fi, _, fok), ds = out["port"]
    (wi, ws, wok), _, _ = out["jax"]
    assert ds.index.kind == kind and ds.index_params == params
    stats = ds.stats()
    assert stats["index_kind"] == kind and stats["live_rows"] == 2700 and stats["device_bytes"] > 0
    assert stats["host_bytes"] == (4096 * D * 4 if kind == "disk" else 0)
    assert gok.all() and not (set(gi.ravel().tolist()) & set(ids[:3000:10].tolist()))
    assert fok.any() and all((int(x) - 500) % 4 == 2 for x in fi[fok])
    exact = VectorStore(device="cpu", dtype=torch.float32, default_index_kind="flat")
    exact.put("ds", ids, data)
    exact.delete("ds", ids[:3000:10])
    want = exact.search("ds", q, 10)[0]
    rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(gi, want)])
    jrec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(wi, want)])
    floor = {"bq": 0.5, "disk": 0.95}.get(kind, 0.8)  # bq: 32 sign bits a row
    assert rec >= floor and rec >= jrec - 0.05, (rec, jrec)
    if kind in ("bq", "disk"):
        np.testing.assert_allclose(gs, ws, rtol=1e-5, atol=1e-4)
        gap = np.full(ws.shape, np.inf)
        step = np.diff(ws, axis=1)
        gap[:, 1:] = np.minimum(gap[:, 1:], step)
        gap[:, :-1] = np.minimum(gap[:, :-1], step)
        sure = gap > 1e-3
        np.testing.assert_array_equal(gi[sure], wi[sure])


@pytest.mark.parametrize("kind", ["pq", "bq", "ivf", "disk", "hnsw_pq"])
def test_import_index_reads_jax_states(kind):
    """A state longbow_tpu's factory wrote is served by the port with the
    same answers (ids where scores are apart, distances to rtol 1e-5 /
    atol 1e-3), and the port's export goes back into longbow_tpu."""
    from longbow_tpu.index.factory import import_index as jax_import
    from longbow_tpu.index.factory import make_index as jax_make
    from test_torch_pq import assert_close_results

    real = "hnsw" if kind == "hnsw_pq" else kind
    params = {"storage": "pq", "pq_m": 4} if kind == "hnsw_pq" else {}
    data, q = _clustered(2048, D, 33), _clustered(16, D, 34)
    j = jax_make(real, D, "l2", **params)
    j.add(data)
    j.delete_rows(np.arange(0, 2048, 9))
    t = import_index(j.export_state(), device="cpu")
    assert t.kind == real and len(t) == 2048
    assert_close_results(j.search(q, 10), t.search(q, 10), 10, atol=1e-3)
    back = jax_import(t.export_state())
    assert_close_results(back.search(q, 10), t.search(q, 10), 10, atol=1e-3)


def test_float16_put_keeps_float16_storage_like_jax():
    """A float16 put into a store of the default kind stores float16 in
    both packages (no bounce through the store's bf16): get_vectors
    returns the input exactly, ids are equal and scores agree to rtol
    1e-6 for k = 10 (both score exactly in f32). The graph tier takes the
    float16 rows too: a migration keeps them."""
    rng = np.random.default_rng(5)
    v = (rng.standard_normal((64, 16)) * 3).astype(np.float16)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    out = {}
    for name, st in (("port", VectorStore(device="cpu")), ("jax", JaxStore())):
        st.put("f", np.arange(64), v)
        ds = st.get("f")
        assert str(np.dtype(ds.dtype)) == "float16" if name == "jax" else ds.dtype == torch.float16
        np.testing.assert_array_equal(
            np.asarray(ds.index.get_vectors(np.arange(64)), np.float32), v.astype(np.float32))
        out[name] = st.search("f", q, 10)
    (gi, gs, gok), (wi, ws, wok) = out["port"], out["jax"]
    assert gok.all() and wok.all()
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-6)
    # an explicit kind wins over the hint
    st = VectorStore(device="cpu")
    st.get_or_create("b", 16, index_kind="flat")
    st.put("b", np.arange(64), v)
    assert st.get("b").dtype == torch.bfloat16

    big = (_clustered(3000, 16, 6)).astype(np.float16)
    st = _small_graph_store()
    st.put("g", np.arange(3000), big)
    ds = st.get("g")
    assert ds.dtype == torch.float16 and ds.index.wait_migration(120)
    assert ds.index._graph.state.vectors.dtype == torch.float16
    ids, _, ok = st.search("g", big[:8].astype(np.float32), 10)
    assert ok.all() and list(ids[:, 0]) == list(range(8))
    np.testing.assert_array_equal(ds.index.get_vectors(np.arange(8)), big[:8].astype(np.float32))
