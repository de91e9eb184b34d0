"""longbow_tpu_torch.index.graph against longbow_tpu.index.graph on the CPU.

The graph states are built by the JAX package (HNSWIndex bulk build and
hand-made PQ states) from seeded numpy inputs and carried over as torch
tensors, so both beam searches walk the same adjacency.

Two kinds of data:
- lattice rows (small integers): every product, norm and distance is an
  exact integer in f32 whatever the summation order, ties are frequent,
  and the results must be EQUAL, ids and distances, which pins the
  stable tie order of every top-k;
- Gaussian rows: distances agree to rtol 1e-5 / atol 1e-5 and ids are
  equal wherever the neighbouring distances differ by more than that.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.index import graph as jgraph
from longbow_tpu.index.hnsw import HNSWConfig as JaxConfig
from longbow_tpu.index.hnsw import HNSWIndex as JaxHNSW
from longbow_tpu_torch.index import graph as tgraph
from longbow_tpu_torch.ops.topk import later_duplicate, stable_topk

RTOL, ATOL = 1e-5, 1e-5
N, D = 2048, 16


def lattice(n, d, seed, lo=-6, hi=7):
    return np.random.default_rng(seed).integers(lo, hi, (n, d)).astype(np.float32)


def gaussian(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, d)).astype(np.float32) * 3.0
    return (centers[rng.integers(0, 16, n)] + rng.standard_normal((n, d))).astype(np.float32)


def to_torch_state(js) -> tgraph.GraphState:
    """A JAX GraphState as a torch one (bf16 travels through f32)."""

    def conv(a):
        if a is None:
            return None
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))

    return tgraph.GraphState(*(conv(a) for a in js))


def assert_same_results(jres, tres, exact):
    jd, ji = (np.asarray(x) for x in jres)
    td, ti = (x.numpy() for x in tres)
    real = jd < 1e37
    np.testing.assert_array_equal(real, td < 1e37)
    np.testing.assert_array_equal(ji[~real], ti[~real])
    if exact:
        np.testing.assert_array_equal(jd, td)
        np.testing.assert_array_equal(ji, ti)
        return
    np.testing.assert_allclose(td[real], jd[real], rtol=RTOL, atol=ATOL)
    # an id may differ only where its distance ties with a neighbour's
    gap = np.full(jd.shape, np.inf)
    gap[:, 1:] = np.minimum(gap[:, 1:], np.abs(jd[:, 1:] - jd[:, :-1]))
    gap[:, :-1] = np.minimum(gap[:, :-1], np.abs(jd[:, 1:] - jd[:, :-1]))
    sure = real & (gap > ATOL + RTOL * np.abs(jd))
    np.testing.assert_array_equal(ji[sure], ti[sure])


@pytest.fixture(scope="module")
def built():
    """name -> (JAX index, its state as torch tensors, queries)."""
    out = {}
    cfg = dict(m=8, m_max=16, ef_construction=32, ef_search=32, insert_batch_size=256)
    for name, data, kw in (
        ("lattice", lattice(N, D, 0), {}),
        ("gauss", gaussian(N, D, 1), {}),
        ("gauss_bf16", gaussian(N, D, 2), dict(dtype=jnp.bfloat16, edge_dtype=jnp.bfloat16)),
        ("gauss_sq8", gaussian(N, D, 3), dict(storage="sq8")),
    ):
        idx = JaxHNSW(D, "l2", JaxConfig(**cfg), **kw)
        idx.add(data)
        idx.delete_rows(np.arange(0, N, 7))
        idx._refresh_sample()
        q = lattice(16, D, 50) if name == "lattice" else gaussian(16, D, 51)
        out[name] = (idx, to_torch_state(idx.state), q)
    return out


def _both(built, name, k, ef, **kw):
    idx, ts, q = built[name]
    jkw = dict(kw)
    if "eligible" in jkw:
        jkw["eligible"] = jnp.asarray(jkw["eligible"])
        kw["eligible"] = torch.from_numpy(kw["eligible"])
    sample = np.asarray(idx._sample_rows)
    jres = jgraph.beam_search(idx.state, jnp.asarray(q), jnp.asarray(sample), k, ef, **jkw)
    stats = {}
    tres = tgraph.beam_search(
        ts, torch.from_numpy(q), torch.from_numpy(sample), k, ef, stats=stats, **kw
    )
    assert 0 < stats["iters"]
    return jres, tres


@pytest.mark.parametrize("name", ["lattice", "gauss", "gauss_bf16", "gauss_sq8"])
@pytest.mark.parametrize("track", [True, False])
def test_beam_search_matches_jax(built, name, track):
    jres, tres = _both(built, name, 10, 32, track_results=track)
    assert_same_results(jres, tres, exact=name == "lattice")
    assert tres[1].dtype == torch.int32


@pytest.mark.parametrize("ex", [1, 4, 8])
@pytest.mark.parametrize("name", ["lattice", "gauss"])
def test_beam_search_expand_per_iter(built, name, ex):
    jres, tres = _both(built, name, 10, 24, expand_per_iter=ex)
    assert_same_results(jres, tres, exact=name == "lattice")


@pytest.mark.parametrize("name", ["lattice", "gauss_sq8"])
def test_beam_search_eligible(built, name):
    elig = np.arange(built[name][0].capacity) % 3 == 1
    jres, tres = _both(built, name, 10, 32, eligible=elig)
    assert_same_results(jres, tres, exact=name == "lattice")
    rows = tres[1].numpy()
    assert (rows[rows >= 0] % 3 == 1).all()
    assert (rows[rows >= 0] % 7 != 0).all()  # tombstones never return


@pytest.mark.parametrize("kw", [
    dict(m_used=8), dict(m_used=8, track_results=False), dict(max_iters=3),
    dict(normalize=True), dict(ring_size=8, expand_per_iter=2),
])
def test_beam_search_options(built, kw):
    for name in ("lattice", "gauss"):
        if "normalize" in kw and name == "lattice":
            continue  # unit-norm queries leave the lattice
        jres, tres = _both(built, name, 10, 32, **kw)
        assert_same_results(jres, tres, exact=name == "lattice")


def _pq_state(seed=4, m=4):
    """A PQ-coded JAX state over the adjacency of a dense lattice build."""
    rng = np.random.default_rng(seed)
    data = gaussian(N, D, seed)
    idx = JaxHNSW(D, "l2", JaxConfig(m=8, m_max=16, ef_search=32))
    idx.add(data)
    idx._refresh_sample()
    books = rng.standard_normal((m, 256, D // m)).astype(np.float32)
    codes = rng.integers(0, 256, (idx.capacity, m)).astype(np.uint8)
    dec = jgraph.pq_decode(jnp.asarray(codes), jnp.asarray(books))
    js = idx.state._replace(
        vectors=jnp.asarray(codes), norms_sq=jnp.sum(dec * dec, axis=1),
        pq_books=jnp.asarray(books),
    )
    return idx, js, codes, books


def test_pq_state_decode_gather_and_search():
    idx, js, codes, books = _pq_state()
    ts = to_torch_state(js)
    np.testing.assert_array_equal(
        np.asarray(jgraph.pq_decode(jnp.asarray(codes[:64]), jnp.asarray(books))),
        tgraph.pq_decode(torch.from_numpy(codes[:64]), torch.from_numpy(books)).numpy(),
    )
    rows = np.array([[3, 9], [100, 7]])
    np.testing.assert_array_equal(
        np.asarray(jgraph.gather_vectors_f32(js, jnp.asarray(rows))),
        tgraph.gather_vectors_f32(ts, torch.from_numpy(rows)).numpy(),
    )
    q = gaussian(8, D, 60)
    sample = np.asarray(idx._sample_rows)
    for track in (True, False):
        jres = jgraph.beam_search(js, jnp.asarray(q), jnp.asarray(sample), 10, 32,
                                  track_results=track)
        tres = tgraph.beam_search(ts, torch.from_numpy(q), torch.from_numpy(sample), 10, 32,
                                  track_results=track)
        assert_same_results(jres, tres, exact=False)


@pytest.mark.parametrize("name", ["gauss", "gauss_sq8"])
def test_gather_dist_and_entry_candidates(built, name):
    idx, ts, q = built[name]
    rows = np.random.default_rng(5).integers(-1, N, (16, 24))
    qn = (q * q).sum(1, keepdims=True)
    jd = jgraph._gather_dist(idx.state, jnp.asarray(q), jnp.asarray(qn), jnp.asarray(rows))
    td = tgraph._gather_dist(ts, torch.from_numpy(q), torch.from_numpy(qn),
                             torch.from_numpy(rows))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=1e-4)
    sample = np.asarray(idx._sample_rows)
    jed, jer = jgraph.entry_candidates(idx.state, jnp.asarray(q), jnp.asarray(qn),
                                       jnp.asarray(sample), 16)
    ted, ter = tgraph.entry_candidates(ts, torch.from_numpy(q), torch.from_numpy(qn),
                                       torch.from_numpy(sample), 16)
    assert_same_results((jed, jer), (ted, ter), exact=False)


def test_graph_init_layout():
    js = jgraph.graph_init(64, 8, 4, jnp.bfloat16, edge_dtype=jnp.bfloat16)
    ts = tgraph.graph_init(64, 8, 4, torch.bfloat16, edge_dtype=torch.bfloat16, device="cpu")
    for name, a, b in zip(js._fields, js, to_torch_state(js)):
        t = getattr(ts, name)
        assert (b is None) == (t is None), name
        if b is not None:
            assert b.dtype == t.dtype and b.shape == t.shape, name
            assert torch.equal(b, t), name
    assert ts.device_bytes() == 64 * (8 * 2 + 4 + 1 + 4 * 4 + 4 * 2 + 4)


@pytest.mark.parametrize("width", [40, 5000])
def test_stable_topk_is_jax_top_k(width):
    """Both routes (one sort; the threshold pass for wide rows) break
    ties like jax.lax.top_k on the negated input."""
    import jax

    x = np.random.default_rng(6).integers(0, 12, (9, width)).astype(np.float32)
    x[0] = 3.0e38
    neg, pos = jax.lax.top_k(-jnp.asarray(x), 17)
    d, i = stable_topk(torch.from_numpy(x), 17)
    np.testing.assert_array_equal(-np.asarray(neg), d.numpy())
    np.testing.assert_array_equal(np.asarray(pos), i.numpy())


def test_later_duplicate_is_the_triangular_compare():
    ids = np.random.default_rng(7).integers(-1, 9, (11, 30))
    eq = ids[:, :, None] == ids[:, None, :]
    want = (eq & np.tril(np.ones((30, 30), bool), k=-1)[None]).any(axis=2)
    np.testing.assert_array_equal(later_duplicate(torch.from_numpy(ids)).numpy(), want)
