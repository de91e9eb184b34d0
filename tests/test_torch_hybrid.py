"""longbow_tpu_torch's hybrid search (hybrid/bm25.py, hybrid/fusion.py,
VectorStore.hybrid_search) and GraphRAG edge store (hybrid/graph_store.py,
the store's graph actions) against longbow_tpu's, on the CPU.

BM25 is the same numpy arithmetic in both packages: ids and scores are
EQUAL. Fusion is the same Python: equal. hybrid_search on a flat dataset
of float32 or bf16 rows: ids equal, fused scores (in [0, 1]) to 1e-5
absolute. The dense distances behind them agree to rtol 1e-5: the two
packages add the f32 terms |q|^2 - 2 q.v + |v|^2 in another order (up
to 3.3e-6 relative on these rows), and the port re-ranks a bf16 scan's
pool in f32 where the reference scans the bf16 rows exactly; the
fusion's min-max normalization divides that by the spread of the
candidates' distances. Graph traversals, paths and analytics are
equal.
"""
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.hybrid import bm25 as jax_bm25
from longbow_tpu.hybrid import fusion as jax_fusion
from longbow_tpu.hybrid import graph_store as jax_graph
from longbow_tpu.query.parser import Filter as JaxFilter
from longbow_tpu.store.vector_store import VectorStore as JaxStore
from longbow_tpu_torch.hybrid import bm25, fusion, graph_store
from longbow_tpu_torch.query.parser import Filter
from longbow_tpu_torch.store.dataset import TEXT_COLUMNS
from longbow_tpu_torch.store.vector_store import VectorStore

D = 16
N = 600
VOCAB = 300


def _words(rng, n):
    """n words w<i>, Zipf(1.1) over VOCAB words (draws past it redrawn
    uniformly)."""
    z = rng.zipf(1.1, n)
    over = z > VOCAB
    z[over] = rng.integers(1, VOCAB + 1, int(over.sum()))
    return [f"w{i}" for i in z]


def _corpus(seed=0):
    """Clustered rows with a text of 12 Zipf words plus the row's cluster
    word, a `category` float column and a `kind` string column."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, D)).astype(np.float32) * 3
    cl = rng.integers(0, 8, N)
    v = (centers[cl] + rng.standard_normal((N, D))).astype(np.float32)
    text = np.array([" ".join(_words(rng, 12) + [f"c{c}"]) for c in cl])
    qcl = rng.integers(0, 8, 6)
    q = (centers[qcl] + rng.standard_normal((6, D))).astype(np.float32)
    qtext = [" ".join([f"c{c}"] + _words(rng, 2)) for c in qcl]
    cols = {"text": text, "category": (np.arange(N) % 10).astype(np.float64),
            "kind": np.array(["a", "b", "c"])[np.arange(N) % 3]}
    return v, cols, q, qtext


# -- BM25 ---------------------------------------------------------------

def _bm25_run(mod):
    _, cols, _, qtext = _corpus(1)
    idx = mod.BM25Index()
    for i, t in enumerate(cols["text"]):
        idx.add(int(i), str(t))
    out = [idx.search(t, 20) for t in qtext]
    idx.add(5, "w1 w1 w1 c3 zzz")  # upsert
    for i in range(0, N, 9):
        idx.remove(i)
    idx.remove(99999)  # unknown: a no-op
    out += [idx.search(t, 20) for t in qtext]
    out.append(idx.search("zzz w1", 10))
    out.append(idx.search(qtext[0], 15, allowed=set(range(1, N, 2))))
    out.append(idx.search("", 5))
    return idx, out


def test_bm25_equals_jax_including_upsert_and_delete():
    p_idx, got = _bm25_run(bm25)
    j_idx, want = _bm25_run(jax_bm25)
    assert got == want
    assert len(p_idx) == len(j_idx) == N - len(range(0, N, 9))
    assert got[-3][0][0] == 5  # the upserted text
    assert all(doc % 2 == 1 for doc, _ in got[-2])
    assert got[-1] == []


def test_bm25_state_loads_in_the_other_package():
    p_idx, _ = _bm25_run(bm25)
    j_idx, _ = _bm25_run(jax_bm25)
    _, _, _, qtext = _corpus(1)
    assert p_idx.export_state() == j_idx.export_state()
    # the port's state in JAX's index answers as JAX's state in the port's
    # (an import lays slots out anew, so ties may order differently than in
    # the exporting index: against it, compare the scores)
    in_jax = jax_bm25.BM25Index.import_state(p_idx.export_state())
    in_port = bm25.BM25Index.import_state(j_idx.export_state())
    for t in qtext:
        assert in_port.search(t, 10) == in_jax.search(t, 10)
        assert [s for _, s in in_port.search(t, 10)] == [s for _, s in p_idx.search(t, 10)]


# -- fusion -------------------------------------------------------------

def test_fusion_modes_equal_jax():
    rng = np.random.default_rng(2)
    for _ in range(20):
        dense = [(int(i), float(s)) for i, s in zip(rng.choice(50, 15, replace=False),
                                                     rng.standard_normal(15))]
        sparse = [(int(i), float(s)) for i, s in zip(rng.choice(50, 12, replace=False),
                                                      rng.random(12) * 9)]
        alpha = float(rng.random())
        for k in (5, 10, 40):
            assert fusion.fuse_rrf([dense, sparse], k) == jax_fusion.fuse_rrf([dense, sparse], k)
            assert fusion.fuse_rrf([[d for d, _ in dense]], k, rrf_k=7) == \
                jax_fusion.fuse_rrf([[d for d, _ in dense]], k, rrf_k=7)
            assert fusion.fuse_linear(dense, sparse, alpha, k) == \
                jax_fusion.fuse_linear(dense, sparse, alpha, k)
            assert fusion.fuse_cascade(dense, sparse, alpha, k) == \
                jax_fusion.fuse_cascade(dense, sparse, alpha, k)
    assert fusion.fuse_linear([(1, 2.0)], [], 0.5, 3) == jax_fusion.fuse_linear([(1, 2.0)], [], 0.5, 3)
    assert fusion.fuse_cascade([], [(1, 1.0)], 0.5, 3) == []
    for text in ("", "one", "two words", "a b c d", "a b c d e f g"):
        assert fusion.estimate_alpha(text) == jax_fusion.estimate_alpha(text)


# -- hybrid_search through the store ------------------------------------

def _hybrid_run(store, filt, dtype_kind):
    v, cols, q, qtext = _corpus(0)
    store.get_or_create("h", D, index_kind="flat")
    store.put("h", np.arange(N), v, cols)
    store.delete("h", np.arange(0, N, 11))
    for src in range(0, N, 3):  # an edge to the next row of the same residue
        store.add_edge("h", src, (src + 3) % N, "next", 0.5 + (src % 5) / 10)
    out = []
    for mode in ("linear", "rrf", "cascade"):
        for j in range(len(qtext)):
            out.append(store.hybrid_search("h", q[j:j + 1], 10, text_query=qtext[j],
                                           fusion=mode))
        out.append(store.hybrid_search("h", q[:3], 10, text_query=qtext[0], fusion=mode,
                                       alpha=0.4, filters=[filt("kind", "=", "b")]))
        out.append(store.hybrid_search("h", q[:2], 10, text_query=qtext[1], fusion=mode,
                                       filters=[filt("category", "<", "4")], graph_alpha=0.3))
    out.append(store.hybrid_search("h", None, 10, text_query=qtext[2]))  # sparse only
    out.append(store.hybrid_search("h", q[:2], 10, alpha=1.0))  # dense only
    d = store.search("h", q, 10)
    out.append(store.graph_rerank("h", *d, graph_alpha=0.5))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_search_equals_jax(dtype):
    got = _hybrid_run(VectorStore(device="cpu", dtype=getattr(torch, dtype)), Filter, dtype)
    want = _hybrid_run(JaxStore(dtype=getattr(jnp, dtype)), JaxFilter, dtype)
    for (gi, gs, gok), (wi, ws, wok) in zip(got, want):
        np.testing.assert_array_equal(gok, wok)
        np.testing.assert_array_equal(np.where(gok, gi, None), np.where(wok, wi, None))
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
    # the kind == "b" calls held their filter, and no deleted id came back
    for fid, _, fok in got[6::8][:3]:
        assert fok.any() and all(int(x) % 3 == 1 for x in fid[fok])
    for ids, _, ok in got:
        assert not any(int(x) % 11 == 0 for x in ids[ok])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_half_of_hybrid_search_equals_jax(dtype):
    """The distances behind the fused scores: the store's own search
    on the same dataset agrees with JAX's to rtol 1e-5, ids equal."""
    v, cols, q, _ = _corpus(0)
    out = []
    for store in (VectorStore(device="cpu", dtype=getattr(torch, dtype)),
                  JaxStore(dtype=getattr(jnp, dtype))):
        store.get_or_create("h", D, index_kind="flat")
        store.put("h", np.arange(N), v, cols)
        out.append(store.search("h", q, 30))
    (gi, gs, gok), (wi, ws, wok) = out
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=1e-5)


def test_hybrid_search_counts_and_reranker():
    store = VectorStore(device="cpu", dtype=torch.float32)
    v, cols, q, qtext = _corpus(0)
    store.put("h", np.arange(N), v, cols)
    base = store.hybrid_search("h", q[:1], 5, text_query=qtext[0], fusion="rrf")
    store.reranker = lambda text, ids: [-float(i) for i in ids]  # smallest id first
    ids, _, ok = store.hybrid_search("h", q[:1], 5, text_query=qtext[0], fusion="rrf")
    assert list(ids[0]) == sorted(base[0][0])

    def broken(text, ids):
        raise RuntimeError("reranker down")

    store.reranker = broken  # degrades to the fused order
    again = store.hybrid_search("h", q[:1], 5, text_query=qtext[0], fusion="rrf")
    np.testing.assert_array_equal(again[0], base[0])
    assert "text" in TEXT_COLUMNS and len(store.get("h").bm25) == N


def test_hybrid_search_does_not_swallow_a_failed_dense_search(monkeypatch):
    store = VectorStore(device="cpu")
    v, cols, q, qtext = _corpus(0)
    store.put("h", np.arange(N), v, cols)

    def fail(*a, **kw):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(store.get("h").index, "search", fail)
    with pytest.raises(RuntimeError, match="kernel failed"):
        store.hybrid_search("h", q[:1], 5, text_query=qtext[0])


# -- the graph store ------------------------------------------------------

def _edges(seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(240):
        a, b = (int(x) for x in rng.integers(0, 80, 2))
        out.append((a, b, ["cites", "likes", ""][int(rng.integers(0, 3))],
                    float(np.round(rng.random() * 2 + 0.1, 3))))
    return out


def _graph_run(g):
    for e in _edges():
        g.add_edge(*e)
    h = lambda node, dst: abs(node - dst) / 80.0  # noqa: E731
    out = [g.stats()["edges"], g.neighbors(3)]
    for src, dst in ((0, 40), (5, 77), (12, 12), (3, 79), (60, 2)):
        out += [g.bfs_path(src, dst, 4), g.weighted_path(src, dst, 5),
                g.astar_path(src, dst, 5, h), g.find_path(src, dst, 3, strategy="bfs"),
                g.find_path(src, dst, 3, strategy="weighted"),
                g.find_path(src, dst, 3, strategy="astar", heuristic=h)]
    out += [g.traverse(7, 2), g.parallel_bfs([1, 2, 50], 2), g.traverse_paths(9, 2),
            g.traverse_paths(9, 2, incoming=True, weighted=False, decay=0.1)]
    a = g.analytics(top_hubs=5)
    out.append({k: a[k] for k in ("nodes", "edges", "components", "largest_component",
                                  "max_out_degree", "max_in_degree", "avg_out_degree",
                                  "top_hubs")})
    res = [(i, float(s)) for i, s in zip(range(0, 30, 2), np.linspace(3, 1, 15))]
    out.append(g.rank_with_graph(res, 0.4, hops=2, decay=0.5))
    return out


def test_graph_store_equals_jax():
    assert _graph_run(graph_store.GraphStore()) == _graph_run(jax_graph.GraphStore())


def test_disk_graph_store_equals_jax(tmp_path):
    p = graph_store.DiskGraphStore(tmp_path / "port" / "g.edges")
    j = jax_graph.DiskGraphStore(tmp_path / "jax" / "g.edges")
    assert _graph_run(p) == _graph_run(j)
    assert p.has_edge(*_edges()[0]) and not p.has_edge(0, 1, "never")
    p.close()
    j.close()
    # the log replays itself, and a torn tail is cut off
    with open(tmp_path / "port" / "g.edges", "ab") as f:
        f.write(b'[1, 2, "x"')
    again = graph_store.DiskGraphStore(tmp_path / "port" / "g.edges")
    assert again.stats()["edges"] == len(_edges())
    assert again.export_state()["edges"] == jax_graph.DiskGraphStore(
        tmp_path / "jax" / "g.edges").export_state()["edges"]
    again.close()


def test_graph_state_loads_in_the_other_package():
    p, j = graph_store.GraphStore(), jax_graph.GraphStore()
    for e in _edges():
        p.add_edge(*e)
        j.add_edge(*e)
    for src, dst_cls in ((p, jax_graph.GraphStore), (j, graph_store.GraphStore)):
        back = dst_cls.import_state(src.export_state())
        assert back.export_state() == src.export_state()
        assert back.traverse(7, 3) == src.traverse(7, 3)


def test_store_graph_actions_equal_jax(tmp_path, monkeypatch):
    """add_edge / traverse_graph (bfs, weighted, astar on the stored
    vectors, parallel) / graph_stats / graph_analytics, and graph_disk
    datasets with their edge log under the temp directory."""
    v, cols, _, _ = _corpus(0)
    out = {}
    for name, store in (("port", VectorStore(device="cpu", dtype=torch.float32)),
                        ("jax", JaxStore(dtype=jnp.float32))):
        (tmp_path / name).mkdir()
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / name))
        res = []
        for ds_name, params in (("mem", None), ("disk", {"graph_disk": True})):
            store.get_or_create(ds_name, D, index_kind="flat" if params is None else None,
                                index_params=params)
            store.put(ds_name, np.arange(N), v, {"text": cols["text"]})
            for a, b, ty, w in _edges():
                store.add_edge(ds_name, a, b, ty, w)
            res += [store.traverse_graph(ds_name, 0, max_hops=2),
                    store.traverse_graph(ds_name, [0, 5], max_hops=2, strategy="parallel"),
                    store.traverse_graph(ds_name, 0, 40, max_hops=4),
                    store.traverse_graph(ds_name, 0, 40, max_hops=4, strategy="weighted"),
                    store.traverse_graph(ds_name, 5, 77, max_hops=5, strategy="astar"),
                    store.graph_stats(ds_name)["edges"],
                    store.graph_analytics(ds_name)["components"]]
        out[name] = res
        disk = store.get("disk").graph
        assert str(disk.path).startswith(str(tmp_path))
        disk.close()
    assert out["port"] == out["jax"]
    assert isinstance(VectorStore(device="cpu").get_or_create(
        "d2", D, index_params={"graph_disk": True}).graph, graph_store.DiskGraphStore)
