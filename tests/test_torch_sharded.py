"""longbow_tpu_torch's mesh tier (parallel/) on the CPU, on meshes of 8 and 4
CPU shards: the counterparts of tests/test_sharded.py, and the same adds,
deletes, filters and queries through longbow_tpu's sharded indexes on the
conftest's 8 virtual CPU devices.

mesh_flat: public ids are held EQUAL to JAX's; distances within
tests/test_torch_flat_index.py's rtol 1e-5 / atol 1e-4 (both rank the
bf16 rows exactly in f32: the port through the scan's plain version and
the f32 re-rank, the JAX package through its exact scan). mesh_graph:
on integer-valued rows ("lattice": exact f32 arithmetic) adjacency and
results are EQUAL to JAX's at power-of-two batches (the JAX package
pads other batches, and its beam loop stops batch-wide). States and v2
snapshots cross both ways.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.index.hnsw import HNSWConfig as JaxConfig
from longbow_tpu.ops.distance import exact_search as jax_exact
from longbow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from longbow_tpu.parallel.sharded import ShardedFlatIndex as JaxShardedFlat
from longbow_tpu.parallel.sharded_graph import ShardedGraphIndex as JaxShardedGraph
from longbow_tpu_torch.index.factory import import_index, make_index
from longbow_tpu_torch.index.hnsw import HNSWConfig
from longbow_tpu_torch.ops.distance import MASKED, Metric, exact_search
from longbow_tpu_torch.parallel.mesh import Mesh, make_mesh
from longbow_tpu_torch.parallel.sharded import ShardedFlatIndex
from longbow_tpu_torch.parallel.sharded_graph import ShardedGraphIndex
from longbow_tpu_torch.query.parser import Filter
from longbow_tpu_torch.store.vector_store import VectorStore
from test_torch_graph import lattice
from test_torch_hnsw import assert_same

RTOL, ATOL = 1e-5, 1e-4
CFG = dict(m=8, m_max=16, ef_construction=32, ef_search=32, insert_batch_size=256)
# the reference tests' graph knobs; insert batches of 128 rows put a shard
# of 256 rows or more on the bulk build (the CPU's incremental inserts are
# slow, and the reference's 375-row shards are below its 2,048-row bulk
# threshold)
GRAPH = dict(m=16, ef_construction=64, ef_search=64, insert_batch_size=128)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_per_worker():
    """Under pytest-xdist, one intra-op thread for this file's many small
    torch ops: several worker processes share the cores, torch's thread
    pools oversubscribe them, and these ops then slow down tens of times.
    Restored after the file; a lone process keeps every thread."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _vecs(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d), dtype=np.float32)


def _mesh(n=8):
    return make_mesh(n, device="cpu")


def _assert_same(jres, tres):
    """ids equal where JAX found a row; distances to RTOL/ATOL."""
    jd, ji = (np.asarray(x) for x in jres)
    td, ti = (np.asarray(x) for x in tres)
    real = jd < 1e37
    np.testing.assert_array_equal(real, td < 1e37)
    np.testing.assert_array_equal(np.where(real, ji, -1), np.where(real, ti, -1))
    np.testing.assert_allclose(np.where(real, td, 0), np.where(real, jd, 0), rtol=RTOL, atol=ATOL)


def _recall(got, want):
    return np.mean([len(set(g.tolist()) & set(w.tolist())) / len(w) for g, w in zip(got, want)])


# -- the mesh --------------------------------------------------------------

def test_mesh_has_8_devices():
    assert _mesh().size == 8 and make_mesh(4, device="cpu").size == 4
    assert make_mesh(device="cpu").size == 1  # no count: one CPU shard
    assert make_mesh(device="cpu").devices == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        # the card's mesh never falls back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError):
            make_mesh(2, device="cuda")
    with pytest.raises(ValueError):
        Mesh(())


def test_single_controller_logical_shards():
    """One process drives every shard (longbow_tpu's shard_map over
    jax.devices(), one controller): a mesh that repeats one device is 8
    logical shards on it, and serves the answers of the unsharded scan.
    The counterpart of tests/test_sharded.py's two-process DCN dry run,
    which has no analogue in a single-controller mesh."""
    mesh = Mesh(("cpu",) * 8)
    assert mesh == _mesh() and mesh.size == 8
    v, q = _vecs(3000, 16), _vecs(8, 16, seed=1)
    idx = ShardedFlatIndex(16, mesh)
    rows = idx.add(v)
    d, r = idx.search(q, 10)
    ed, er = exact_search(q, v, 10, device="cpu")
    np.testing.assert_allclose(d, ed.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(r, rows[er.numpy()])


# -- ShardedFlatIndex (tests/test_sharded.py's counterparts) -----------------

def test_sharded_matches_single_device_exact():
    v = _vecs(4000, 32)
    idx = ShardedFlatIndex(32, _mesh())
    rows = idx.add(v)
    assert len(idx) == 4000
    q = _vecs(16, 32, seed=1)
    d, r = idx.search(q, 10)
    ed, er = exact_search(q, v, 10, device="cpu")
    np.testing.assert_allclose(d, ed.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(r, rows[er.numpy()])
    jidx = JaxShardedFlat(32, jax_make_mesh())
    np.testing.assert_array_equal(jidx.add(v), rows)
    _assert_same(jidx.search(q, 10), (d, r))


def test_global_rows_map_back_to_vectors():
    v = _vecs(1000, 16)
    idx = ShardedFlatIndex(16, _mesh())
    rows = idx.add(v)
    d, r = idx.search(v[:8], 1)
    np.testing.assert_array_equal(r[:, 0], rows[:8])
    assert (d[:, 0] < 1e-3).all()
    np.testing.assert_array_equal(idx.get_vectors(rows[[5, 0, 999]]), v[[5, 0, 999]])


def test_incremental_adds_across_shards():
    idx = ShardedFlatIndex(16, _mesh())
    jidx = JaxShardedFlat(16, jax_make_mesh())
    v = _vecs(3000, 16)
    all_rows = []
    for off in range(0, 3000, 700):
        rows = idx.add(v[off: off + 700])
        np.testing.assert_array_equal(jidx.add(v[off: off + 700]), rows)
        all_rows.append(rows)
    rows = np.concatenate(all_rows)
    assert len(idx) == 3000 and len(np.unique(rows)) == 3000
    d, r = idx.search(v[1500:1504], 1)
    np.testing.assert_array_equal(r[:, 0], rows[1500:1504])
    np.testing.assert_array_equal(idx._shard_counts, jidx._shard_counts)


def test_sharded_growth():
    idx = ShardedFlatIndex(8, _mesh(), shard_capacity=2048)
    v = _vecs(20_000, 8)
    rows = idx.add(v)
    assert idx.shard_capacity > 2048
    d, r = idx.search(v[:4], 1)
    np.testing.assert_array_equal(r[:, 0], rows[:4])


def test_sharded_tombstones():
    v = _vecs(800, 8)
    idx = ShardedFlatIndex(8, _mesh())
    rows = idx.add(v)
    idx.delete_rows(rows[:10])
    _, r = idx.search(v[:10], 1)
    assert not np.isin(r[:, 0], rows[:10]).any()


def test_sharded_cosine():
    v = _vecs(500, 16)
    idx = ShardedFlatIndex(16, _mesh(), metric=Metric.COSINE)
    rows = idx.add(v)
    d, r = idx.search(v[7] * 5.0, 1)
    assert r[0, 0] == rows[7] and abs(d[0, 0]) < 1e-5


def test_smaller_mesh():
    v = _vecs(400, 8)
    idx = ShardedFlatIndex(8, make_mesh(4, device="cpu"))
    rows = idx.add(v)
    d, r = idx.search(v[:3], 1)
    np.testing.assert_array_equal(r[:, 0], rows[:3])


def test_row_ids_stable_across_capacity_growth():
    """Public ids survive shard-capacity growth: stored rows, searches and
    deletes by an id recorded before it still find the same row."""
    idx = ShardedFlatIndex(8, make_mesh(4, device="cpu"), shard_capacity=2048)
    rng = np.random.default_rng(0)
    v1 = rng.standard_normal((1000, 8)).astype(np.float32)
    rows1 = idx.add(v1)
    got_before = idx.get_vectors(rows1[:5])
    idx.add(rng.standard_normal((9000, 8)).astype(np.float32))
    assert idx.shard_capacity > 2048
    np.testing.assert_array_equal(idx.get_vectors(rows1[:5]), got_before)
    d, r = idx.search(v1[3:4], 1)
    assert int(r[0, 0]) == int(rows1[3])
    idx.delete_rows(rows1[3:4])
    d, r = idx.search(v1[3:4], 1)
    assert int(r[0, 0]) != int(rows1[3])


@pytest.mark.parametrize("n_shards", [8, 4])
@pytest.mark.parametrize("metric,dtype", [("l2", "bfloat16"), ("cosine", "bfloat16"),
                                          ("dot", "bfloat16"), ("l2", "float32")])
def test_sharded_flat_equals_jax(n_shards, metric, dtype):
    """The same adds (growing past the first capacity), deletes and a
    public-order filter mask: the port's ids and distances are JAX's, at
    k = 10 and at k = 100 (the port's exact_search)."""
    jidx = JaxShardedFlat(24, jax_make_mesh(n_shards), metric, dtype=jnp.dtype(dtype))
    tidx = ShardedFlatIndex(24, make_mesh(n_shards, device="cpu"), metric,
                            dtype=getattr(torch, dtype))
    rng = np.random.default_rng(5)
    q = rng.standard_normal((7, 24)).astype(np.float32)
    for n in (1500, 700, 9000):
        v = rng.standard_normal((n, 24)).astype(np.float32)
        np.testing.assert_array_equal(jidx.add(v), tidx.add(v))
    assert tidx.shard_capacity == jidx.shard_capacity
    dead = np.arange(0, 11_000, 7)
    jidx.delete_rows(dead)
    tidx.delete_rows(dead)
    mask = np.zeros(tidx.capacity - 5, bool)  # shorter than the row space
    mask[::3] = True
    for k in (10, 100):
        _assert_same(jidx.search(q, k), tidx.search(q, k))
        _assert_same(jidx.search(q, k, filter_mask=jnp.asarray(mask)),
                     tidx.search(q, k, filter_mask=mask))
    d, r = tidx.search(q, 10, filter_mask=mask)
    assert mask[r].all() and not np.isin(r, dead).any()


@pytest.mark.parametrize("n_shards", [8, 4])
def test_mesh_flat_state_crosses_both_ways(n_shards):
    jidx = JaxShardedFlat(16, jax_make_mesh(n_shards), "l2", dtype=jnp.bfloat16)
    v, q = _vecs(3000, 16), _vecs(4, 16, seed=2)
    jidx.add(v)
    jidx.delete_rows(np.arange(0, 3000, 5))
    tidx = import_index({**jidx.export_state(), "kind": "mesh_flat"}, device="cpu")
    assert tidx.kind == "mesh_flat" and tidx.n_shards == n_shards
    _assert_same(jidx.search(q, 10), tidx.search(q, 10))
    st = tidx.export_state()
    for key, val in jidx.export_state().items():
        np.testing.assert_array_equal(np.asarray(st[key]), np.asarray(val), err_msg=key)
    back = JaxShardedFlat.import_state(st)
    _assert_same(back.search(q, 10), tidx.search(q, 10))


# -- ShardedGraphIndex ---------------------------------------------------------

def test_sharded_graph_index():
    """Per-shard sub-graphs and a merge (reference: sharded_hnsw.go:378-470):
    recall against the exact scan, and corpus rows map back through the
    stripe."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((8000, 32), dtype=np.float32)
    idx = ShardedGraphIndex(32, _mesh(), config=HNSWConfig(**GRAPH))
    idx.add(v)
    idx.build()
    q = rng.standard_normal((16, 32), dtype=np.float32)
    d, rows = idx.search(q, 10)
    _, er = exact_search(q, v, 10, device="cpu")
    assert _recall(rows, er.numpy()) >= 0.9
    d2, rows2 = idx.search(v[:8], 1)
    assert (rows2[:, 0] == np.arange(8)).mean() >= 0.9


@pytest.mark.parametrize("n_shards,metric", [(8, "l2"), (8, "dot")])
def test_sharded_graph_equals_jax_on_lattice(n_shards, metric):
    """Lattice rows: every shard's adjacency and the merged results equal
    JAX's, before and after deletes, with an interim segment and after
    the fold. The dot metric's augmented column sqrt(M^2 - |x|^2) is not
    an integer: there adjacency agrees on 99% of the slots and results
    as tests/test_torch_hnsw.py holds them (rtol 1e-5, ids where
    untied)."""
    exact = metric == "l2"
    data = lattice(520 * n_shards, 16, 40)
    q = lattice(16, 16, 41)
    jidx = JaxShardedGraph(16, jax_make_mesh(n_shards), metric, config=JaxConfig(**CFG))
    tidx = ShardedGraphIndex(16, make_mesh(n_shards, device="cpu"), metric,
                             config=HNSWConfig(**CFG))
    np.testing.assert_array_equal(jidx.add(data), tidx.add(data))
    jidx.build()
    tidx.build()
    assert tidx.shard_rows == jidx.shard_rows and tidx._mips_msq == jidx._mips_msq
    cap = jidx.shard_rows
    for j, shard in enumerate(tidx._built[0]):
        for name in ("nbrs", "nbr_count", "valid"):
            a = getattr(shard.state, name).numpy()
            b = np.asarray(getattr(jidx, name))[j * cap:(j + 1) * cap]
            if exact:
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                assert (a == b).mean() > 0.99, name
    for step in range(3):
        jres, (td, tr) = jidx.search(q, 10), tidx.search(q, 10)
        assert_same(jres, (td, tr.astype(np.int32)), exact=exact)
        if step == 0:  # deletes in the graphs
            dead = np.asarray(tr[:, 0])
            jidx.delete_rows(dead)
            tidx.delete_rows(dead)
        elif step == 1:  # an interim segment, then a delete in it
            extra = lattice(64, 16, 42)
            np.testing.assert_array_equal(jidx.add(extra), tidx.add(extra))
            jidx.delete_rows(np.array([len(data) + 3]))
            tidx.delete_rows(np.array([len(data) + 3]))
    jidx.fold_interim()
    tidx.fold_interim()
    assert tidx._interim is None and tidx.built_count == jidx.built_count
    td, tr = tidx.search(q, 10)
    assert_same(jidx.search(q, 10), (td, tr.astype(np.int32)), exact=exact)


def test_sharded_graph_dot_metric():
    """Dot over shards: one global MIPS bound, augmented queries, -ip
    reported."""
    rng = np.random.default_rng(1)
    v = rng.standard_normal((4000, 16), dtype=np.float32)
    idx = ShardedGraphIndex(16, _mesh(), metric=Metric.DOT,
                            config=HNSWConfig(**dict(GRAPH, ef_search=96)))
    idx.add(v)
    idx.build()
    q = rng.standard_normal((8, 16), dtype=np.float32)
    d, rows = idx.search(q, 10)
    ips = q @ v.T
    want = np.argsort(-ips, axis=1)[:, :10]
    assert _recall(rows, want) >= 0.85
    for i in range(8):
        np.testing.assert_allclose(-d[i, :3], ips[i, rows[i, :3]], rtol=2e-2, atol=1e-2)


def test_sharded_graph_live_ingest():
    """An add after the build serves at once from the interim exact
    segment, with no rebuild; deletes hit both tiers and survive a fold."""
    rng = np.random.default_rng(2)
    v = rng.standard_normal((3000, 16), dtype=np.float32)
    idx = ShardedGraphIndex(16, _mesh(), config=HNSWConfig(**GRAPH))
    idx.add(v)
    idx.build()
    assert idx.built_count == 3000
    extra = rng.standard_normal((50, 16), dtype=np.float32)
    rows2 = idx.add(extra)
    assert idx.built_count == 3000 and len(idx._interim) == 50
    d, r = idx.search(extra[:8], 1)
    assert (r[:, 0] == rows2[:8]).all()
    d, r = idx.search(v[:8], 1)
    assert (r[:, 0] == np.arange(8)).mean() >= 0.9
    extra2 = rng.standard_normal((30, 16), dtype=np.float32)
    rows3 = idx.add(extra2)
    d, r = idx.search(extra2[:5], 1)
    assert (r[:, 0] == rows3[:5]).all()
    idx.delete_rows(np.array([rows2[0], 5]))
    _, r = idx.search(np.vstack([extra[0], v[5]]), 1)
    assert r[0, 0] != rows2[0] and r[1, 0] != 5
    idx.fold_interim()
    assert idx.built_count == 3080 and idx._interim is None
    _, r = idx.search(np.vstack([extra[0], v[5]]), 1)
    assert r[0, 0] != rows2[0] and r[1, 0] != 5
    d, r = idx.search(extra2[:5], 1)
    assert (r[:, 0] == rows3[:5]).mean() >= 0.8


@pytest.mark.parametrize("n_shards", [8, 4])
def test_mesh_graph_state_crosses_both_ways(monkeypatch, n_shards):
    """The state is the rows and the deletes: an import rebuilds. On the
    same mesh size it answers as JAX's own import of the state; every
    live row finds itself first, as in the index that exported it."""
    n = 2400
    data = lattice(n, 16, 43)
    # the knobs a state carries (insert batches at their default)
    cfg = {k: CFG[k] for k in ("m", "m_max", "ef_construction", "ef_search")}
    jidx = JaxShardedGraph(16, jax_make_mesh(n_shards), "l2", config=JaxConfig(**cfg))
    jidx.add(data)
    jidx.delete_rows(np.arange(0, n, 9))
    jidx.build()
    st = {**jidx.export_state(), "kind": "mesh_graph"}
    # the state names no mesh: the import builds on make_mesh's, here made
    # the size of JAX's
    from longbow_tpu_torch.parallel import sharded_graph

    monkeypatch.setattr(sharded_graph, "make_mesh", lambda device=None: _mesh(n_shards))
    tidx = ShardedGraphIndex.import_state(st, device="cpu")
    monkeypatch.undo()
    live = np.setdiff1d(np.arange(0, n, 37), np.arange(0, n, 9))[:16]
    q = data[live]
    td, tr = tidx.search(q, 10)
    np.testing.assert_array_equal(tr[:, 0], live)
    assert_same(jidx.search(q, 10), (td, tr.astype(np.int32)), exact=True)
    mine = tidx.export_state()
    for key, val in jidx.export_state().items():
        np.testing.assert_array_equal(np.asarray(mine[key]), np.asarray(val), err_msg=key)
    # the port's state through import_index (one CPU shard) and back to JAX
    # (whose import rebuilds on all 8 devices: once is enough)
    one = import_index(mine, device="cpu")
    assert one.kind == "mesh_graph" and one.n_shards == 1 and len(one) == n
    if n_shards == 4:
        back = JaxShardedGraph.import_state(one.export_state())
        assert back.count == n and back._deleted == tidx._deleted
        np.testing.assert_array_equal(back.search(q, 1)[1][:, 0], live)


# -- through the factory and the store -------------------------------------------

def test_mesh_flat_through_store():
    vs = VectorStore(device="cpu", default_index_params={"mesh_shards": 8})
    vs.get_or_create("mf", 16, index_kind="mesh_flat")
    v = _vecs(500, 16)
    vs.put("mf", np.arange(500), v, columns={"grp": np.arange(500) % 5})
    assert vs.get("mf").index.n_shards == 8
    ids, scores, ok = vs.search("mf", v[17], 5)
    assert ids[0, 0] == 17 and ok[0, 0]
    ids, scores, ok = vs.search("mf", v[18], 5, filters=[Filter("grp", "=", "3")])
    got = [ids[0, j] for j in range(5) if ok[0, j]]
    assert got and all(int(i) % 5 == 3 for i in got)
    vs.delete("mf", [17])
    ids, scores, ok = vs.search("mf", v[17], 3)
    assert 17 not in [ids[0, j] for j in range(3) if ok[0, j]]


def test_mesh_flat_export_import_roundtrip():
    idx = make_index("mesh_flat", 8, "l2", dtype=torch.bfloat16, device="cpu", mesh_shards=8)
    v = _vecs(300, 8, seed=1)
    idx.add(v)
    idx2 = import_index(idx.export_state(), device="cpu")
    d1, r1 = idx.search(v[:6], 3)
    d2, r2 = idx2.search(v[:6], 3)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(d1, d2)


def test_mesh_graph_through_factory():
    v = _vecs(3000, 16, seed=2)
    idx = make_index("mesh_graph", 16, "l2", dtype=torch.bfloat16, device="cpu", mesh_shards=4,
                     hnsw_config=HNSWConfig(**GRAPH))
    idx.add(v)
    d, r = idx.search(v[:10], 5)
    assert (r[:, 0] == np.arange(10)).mean() >= 0.8
    mask = np.zeros(idx.capacity, dtype=bool)
    mask[:1000] = True
    d, r = idx.search(v[:5], 5, filter_mask=torch.from_numpy(mask))
    assert (r[r >= 0] < 1000).all() and (r >= 0).any()
    idx.add(v[:50] + 0.01)
    d, r = idx.search(v[3] + 0.01, 1)
    assert r[0, 0] in (3, 3000 + 3)
    idx2 = import_index(idx.export_state(), device="cpu")
    assert len(idx2) == 3050
    d2, r2 = idx2.search(v[:10], 5)
    assert (r2[:, 0] == np.arange(10)).mean() >= 0.8


def test_mesh_graph_through_store():
    vs = VectorStore(device="cpu", default_index_params={"mesh_shards": 8},
                     hnsw_config=HNSWConfig(**GRAPH))
    vs.get_or_create("mg", 16, index_kind="mesh_graph")
    v = _vecs(2500, 16, seed=3)
    vs.put("mg", np.arange(2500), v)
    ids, scores, ok = vs.search("mg", v[9], 3)
    assert ids[0, 0] == 9 and ok[0, 0]
    vs.put("mg", np.arange(2500, 2550), v[:50] + 0.01)
    ids, scores, ok = vs.search("mg", v[3] + 0.01, 1)
    assert ids[0, 0] in (3, 2503)
    vs.delete("mg", [9])
    ids, scores, ok = vs.search("mg", v[9], 3)
    assert 9 not in [ids[0, j] for j in range(3) if ok[0, j]]
    # exact=True is the exact scan, which agrees with a brute force
    ids, scores, ok = vs.search("mg", v[100:104], 5, exact=True)
    alive = np.ones(2550, bool)
    alive[9] = False
    ed, er = exact_search(v[100:104], np.concatenate([v, v[:50] + 0.01]), 5,
                          valid=torch.from_numpy(alive), device="cpu")
    np.testing.assert_array_equal(ids.astype(np.int64), er.numpy())


def test_mesh_graph_empty_search_and_exact_fallback():
    idx = make_index("mesh_graph", 8, "l2", dtype=torch.bfloat16, device="cpu", mesh_shards=2)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 8)).astype(np.float32)
    d, r = idx.search(q, 3)  # empty: masked, no crash
    assert (r < 0).all() and (d >= MASKED).all()
    d, r = idx.search(q, 3, exact=True)
    assert (r < 0).all()
    v = rng.standard_normal((300, 8)).astype(np.float32)
    rows = idx.add(v)
    d, r = idx.search(v[5:6], 1, exact=True)
    assert int(r[0, 0]) == int(rows[5])
    assert idx.n_shards == 2


@pytest.mark.parametrize("kind", ["mesh_flat", "mesh_graph"])
def test_mesh_dataset_compaction(kind):
    """A compaction rebuilds a mesh dataset from its live rows (on the mesh
    its params name) and answers as a fresh dataset of those rows."""
    from longbow_tpu_torch.store.compaction import compact_dataset

    vs = VectorStore(device="cpu", default_index_params={"mesh_shards": 4},
                     hnsw_config=HNSWConfig(**GRAPH))
    v = _vecs(3000, 16, seed=6)
    vs.get_or_create("c", 16, index_kind=kind)
    vs.put("c", np.arange(3000), v, columns={"g": np.arange(3000) % 3})
    vs.delete("c", np.arange(0, 3000, 2))
    st = compact_dataset(vs.get("c"))
    assert st["reclaimed_rows"] == 1500 and len(vs.get("c").index) == 1500
    assert vs.get("c").index.n_shards == 4
    fresh = VectorStore(device="cpu", default_index_params={"mesh_shards": 4},
                        hnsw_config=HNSWConfig(**GRAPH))
    fresh.get_or_create("c", 16, index_kind=kind)
    live = np.arange(1, 3000, 2)
    fresh.put("c", live, v[live], columns={"g": live % 3})
    q = v[[1, 3, 10, 999]] + 0.01
    got, want = vs.search("c", q, 5, use_cache=False), fresh.search("c", q, 5, use_cache=False)
    assert got[0].tolist() == want[0].tolist()
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    flt = [Filter("g", "=", "1")]
    assert vs.search("c", q, 5, filters=flt)[0].tolist() == \
        fresh.search("c", q, 5, filters=flt)[0].tolist()


def test_store_counts_shard_metrics():
    from longbow_tpu_torch.metrics import get_registry

    reg = get_registry()
    vs = VectorStore(device="cpu", default_index_params={"mesh_shards": 4})
    vs.get_or_create("sm", 8, index_kind="mesh_flat")
    vs.put("sm", np.arange(10), _vecs(10, 8))
    splits = reg.counter("longbow_hnsw_parallel_search_splits_total", ("dataset",))
    before = splits.labels(dataset="sm").value
    vs.search("sm", _vecs(2, 8), 3, use_cache=False)
    assert splits.labels(dataset="sm").value == before + 4
    size = reg.gauge("longbow_sharded_hnsw_shard_size", ("dataset", "shard"))
    assert [size.labels(dataset="sm", shard=str(j)).value for j in range(4)] == [3, 3, 2, 2]


# -- snapshots ------------------------------------------------------------------

def test_mesh_dataset_snapshot_recover(tmp_path):
    """A mesh-sharded dataset snapshots its sharded state and recovers onto
    the same mesh size with identical results and filters."""
    store = VectorStore(device="cpu", persist_dir=tmp_path, wal_sync="always",
                        default_index_params={"mesh_shards": 8})
    store.get_or_create("mm", 8, index_kind="mesh_flat")
    v = _vecs(200, 8)
    store.put("mm", np.arange(200), v, columns={"g": np.arange(200) % 3})
    ids1, sc1, ok1 = store.search("mm", v[7], 3)
    store.snapshot()
    store.close()
    store2 = VectorStore(device="cpu", persist_dir=tmp_path, wal_sync="always")
    ds = store2.get("mm")
    assert ds.index.kind == "mesh_flat" and ds.index.n_shards == 8
    ids2, sc2, ok2 = store2.search("mm", v[7], 3)
    assert ids2.tolist() == ids1.tolist()
    np.testing.assert_array_equal(sc2, sc1)
    ids3, _, ok3 = store2.search("mm", v[9], 3, filters=[Filter("g", "=", "0")])
    got = [ids3[0, j] for j in range(3) if ok3[0, j]]
    assert got and all(int(i) % 3 == 0 for i in got)
    store2.close()


def test_mesh_snapshot_crosses_packages(tmp_path):
    """A v2 snapshot of a mesh_flat dataset written by longbow_tpu (8
    shards) recovers in the port, and the port's back in longbow_tpu, with
    the same answers. (mesh_graph's state crosses in
    test_mesh_graph_state_crosses_both_ways.)"""
    kind = "mesh_flat"
    from longbow_tpu.store.vector_store import VectorStore as JaxStore

    v = _vecs(3000, 16, seed=4)
    q = v[[3, 50, 999, 2000]] + 0.01
    cols = {"g": np.arange(3000) % 3}
    jstore = JaxStore(persist_dir=tmp_path / "j", wal_sync="always")
    jstore.get_or_create("m", 16, index_kind=kind)
    jstore.put("m", np.arange(3000), v, columns=cols)
    jstore.delete("m", [3, 4])
    want = jstore.search("m", q, 5, use_cache=False)
    wantf = jstore.search("m", q, 5, filters=[Filter("g", "=", "1")], use_cache=False)
    jstore.close()
    tstore = VectorStore(device="cpu", persist_dir=tmp_path / "j", wal_sync="always")
    assert tstore.get("m").index.kind == kind
    got = tstore.search("m", q, 5, use_cache=False)
    gotf = tstore.search("m", q, 5, filters=[Filter("g", "=", "1")], use_cache=False)
    assert tstore.get("m").index.n_shards == 8
    assert got[0].tolist() == want[0].tolist() and gotf[0].tolist() == wantf[0].tolist()
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    assert all(int(i) % 3 == 1 for i in gotf[0][gotf[2]])
    tstore.put("m", np.arange(3000, 3010), v[:10] + 0.5)
    mine = tstore.search("m", q, 5, use_cache=False)
    tstore.close()
    jstore2 = JaxStore(persist_dir=tmp_path / "j", wal_sync="always")
    back = jstore2.search("m", q, 5, use_cache=False)
    assert back[0].tolist() == mine[0].tolist()
    jstore2.close()


@pytest.mark.parametrize("kind", ["mesh_flat", "mesh_graph"])
def test_mesh_tier_full_gate_at_cpu_size(kind, tmp_path):
    """tests/test_sharded.py's 256k gate at a size the CPU suite can hold
    (8,192 clustered rows, 8 shards): recall against the exact oracle,
    filters, deletes, capacity growth and a snapshot round trip."""
    n, d, k = 8_192, 32, 10
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((64, d)).astype(np.float32) * 3.0
    v = centers[rng.integers(0, 64, n)] + rng.standard_normal((n, d)).astype(np.float32)
    store = VectorStore(device="cpu", persist_dir=tmp_path,
                        default_index_params={"mesh_shards": 8},
                        hnsw_config=HNSWConfig(**GRAPH))
    store.get_or_create("m", d, index_kind=kind)
    for off in range(0, n, 2048):
        store.put("m", np.arange(off, off + 2048), v[off:off + 2048],
                  columns={"par": np.arange(off, off + 2048) % 4})
    assert store.get("m").live_count == n
    q = centers[rng.integers(0, 64, 64)] + 0.1 * rng.standard_normal((64, d)).astype(np.float32)
    gt = np.asarray(jax_exact(jnp.asarray(q), jnp.asarray(v), k, exact_precision=True)[1])
    ids, _, ok = store.search("m", q, k, use_cache=False)
    rec = np.mean([len({ids[i, j] for j in range(k) if ok[i, j]} & set(gt[i].tolist())) / k
                   for i in range(64)])
    assert rec >= (0.95 if kind == "mesh_flat" else 0.80), rec
    ids_f, _, ok_f = store.search("m", q[:8], k, filters=[Filter("par", "=", "2")],
                                  use_cache=False)
    got = ids_f[ok_f].tolist()
    assert got and all(g % 4 == 2 for g in got)
    top0 = int(gt[0, 0])
    store.delete("m", [top0])
    ids_d, _, ok_d = store.search("m", q[:1], k, use_cache=False)
    assert top0 not in ids_d[ok_d].tolist()
    ids_b, _, _ = store.search("m", q[:4], k, use_cache=False)
    store.snapshot()
    store.close()
    store2 = VectorStore(device="cpu", persist_dir=tmp_path,
                         hnsw_config=HNSWConfig(m=16, ef_construction=64, ef_search=64))
    assert store2.get("m").live_count == n - 1
    ids_a, _, _ = store2.search("m", q[:4], k, use_cache=False)
    assert ids_a[:, 0].tolist() == ids_b[:, 0].tolist()
    store2.close()
