"""longbow_tpu_torch.index.pq against longbow_tpu.index.pq on the CPU.

Exactness. On integer-valued rows and codebooks ("lattice") every table
entry and sum is exact in f32, so codes, ADC distances and ids (ties in
row order, as jax.lax.top_k) must be EQUAL. Training differs between the
packages only by the k-means init draw, so the training test hands the
port JAX's init; Lloyd sums in another order there, so books agree to
rtol 1e-4 / atol 1e-5 and the codes of the training rows exactly.
Gaussian rows carry JAX's trained state across (import_state): re-ranked
distances agree to rtol 1e-5 / atol 1e-5, ids wherever neighbouring
distances differ by more than that.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.index.pq import PQIndex as JaxPQ
from longbow_tpu.index.pq import _adc_search as jax_adc
from longbow_tpu.index.pq import _encode as jax_encode
from longbow_tpu.ops.kmeans import kmeans_init as jax_kmeans_init
from longbow_tpu_torch.index import pq as tpq
from longbow_tpu_torch.index.pq import PQIndex, _adc_search, _encode, encode_rows
from longbow_tpu_torch.ops.distance import MASKED

D, M = 16, 4


def lattice(shape, seed, lo=-4, hi=5):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.float32)


def clustered(n, d=D, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((24, d)).astype(np.float32) * 3.0
    return (centers[rng.integers(0, 24, n)] + rng.standard_normal((n, d))).astype(np.float32)


def assert_close_results(jres, tres, k, atol=1e-5):
    """Distances to rtol 1e-5 / atol on the real slots; ids where the
    neighbouring distances are apart by more than the tolerance."""
    jd, ji = (np.asarray(x) for x in jres)
    td, ti = tres
    assert td.shape == (jd.shape[0], k)
    real = jd < 1e37
    np.testing.assert_array_equal(real, td < 1e37)
    np.testing.assert_allclose(td[real], jd[real], rtol=1e-5, atol=atol)
    gap = np.full(jd.shape, np.inf)
    step = np.abs(np.diff(jd, axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    sure = real & (gap > 10 * (atol + 1e-5 * np.abs(jd)))
    np.testing.assert_array_equal(ti[sure], ji[sure])
    assert (ti[~real] == -1).all()


def test_encode_is_bit_identical():
    sub = lattice((M, 3000, D // M), 0)
    books = lattice((M, 256, D // M), 1)
    want = np.asarray(jax_encode(jnp.asarray(sub), jnp.asarray(books)))
    got = _encode(torch.from_numpy(sub), torch.from_numpy(books)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    rows = sub.transpose(1, 0, 2).reshape(3000, D)
    # chunked encoding gives the same codes
    np.testing.assert_array_equal(
        encode_rows(torch.from_numpy(rows), torch.from_numpy(books), chunk=777).numpy(), want)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_adc_search_is_equal_on_lattice_rows(metric):
    """Lattice tables make every ADC sum exact: distances and ids equal
    JAX's, ties included, whatever the chunk."""
    codes = np.random.default_rng(2).integers(0, 256, (5000, M)).astype(np.uint8)
    codes[100:200] = codes[0]  # many equal codes: ties
    books = lattice((M, 256, D // M), 3, -2, 3)
    q = lattice((9, D), 4, -2, 3)
    valid = np.random.default_rng(5).random(5000) > 0.1
    jd, ji = jax_adc(jnp.asarray(codes), jnp.asarray(books), jnp.asarray(q),
                     jnp.asarray(valid), 40, chunk=1024, metric=metric)
    args = (torch.from_numpy(codes), torch.from_numpy(books), torch.from_numpy(q),
            torch.from_numpy(valid), 40, metric)
    for chunk in (None, 999, 5000):
        td, ti = _adc_search(*args, chunk=chunk)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_train_with_jax_init_matches(monkeypatch):
    v = clustered(3000)
    ji = JaxPQ(D, M)
    ji.train(v)
    sub = jnp.asarray(v).reshape(-1, M, D // M).transpose(1, 0, 2)
    init = torch.from_numpy(np.array(jax_kmeans_init(sub, 256, 0)))
    monkeypatch.setattr(tpq, "kmeans_init", lambda data, k, seed=0: init)
    ti = PQIndex(D, M, device="cpu")
    ti.train(v)
    np.testing.assert_allclose(ti.codebooks.numpy(), np.asarray(ji.codebooks),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("rerank", [True, False])
def test_search_on_jax_state(metric, rerank):
    """JAX trains and adds; the port imports its state; both add the same
    rows (codes must be equal) and answer the same searches."""
    v = clustered(3000, seed=1)
    extra = clustered(900, seed=2)
    q = clustered(16, seed=3)
    ji = JaxPQ(D, M, metric, rerank=rerank)
    ji.add(v)
    ti = PQIndex.import_state(ji.export_state(), device="cpu")
    np.testing.assert_array_equal(ji.add(extra), ti.add(extra))
    np.testing.assert_array_equal(ti.codes[: ti.count].numpy(), np.asarray(ji.codes[: ji.count]))
    for k in (1, 10):
        assert_close_results(ji.search(q, k), ti.search(q, k), k)
    dead = np.arange(0, 3900, 3)
    ji.delete_rows(dead)
    ti.delete_rows(dead)
    mask = np.zeros(ji.capacity, bool)
    mask[::2] = True
    jres = ji.search(q, 10, filter_mask=jnp.asarray(mask))
    tres = ti.search(q, 10, filter_mask=mask)
    assert_close_results(jres, tres, 10)
    ids = tres[1][tres[1] >= 0]
    assert (ids % 2 == 0).all() and not np.isin(ids, dead).any()


def test_state_crosses_both_ways():
    v, q = clustered(2000, seed=4), clustered(8, seed=5)
    ti = PQIndex(D, M, device="cpu")
    ti.add(v)
    ti.delete_rows(np.arange(10))
    st = ti.export_state()
    assert st["codes"].dtype == np.uint8 and st["codebooks"].dtype == np.float32
    ji = JaxPQ.import_state(st)
    assert_close_results(ji.search(q, 10), ti.search(q, 10), 10)
    back = PQIndex.import_state(ji.export_state(), device="cpu")
    for a, b in zip(back.search(q, 10), ti.search(q, 10)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back.decode(np.arange(50)), ji.decode(np.arange(50)))
    # get_vectors: the re-rank rows (the adapter's choice in longbow_tpu)
    np.testing.assert_array_equal(back.get_vectors([3, 7]), v[[3, 7]])


def test_small_index_and_padding():
    """Fewer rows than k: real rows first, then (MASKED, -1); an empty
    index answers with masked slots; growth keeps the rows."""
    ti = PQIndex(D, M, device="cpu")
    d, i = ti.search(np.zeros(D, np.float32), 5)
    assert (d == MASKED).all() and (i == -1).all()
    v = clustered(300, seed=6)
    ti.add(v)
    ti.add(clustered(5000, seed=7))  # past MIN_CAPACITY
    assert ti.capacity == 8192 and ti.count == 5300
    np.testing.assert_array_equal(ti.get_vectors(np.arange(300)), v)
    small = PQIndex(D, M, device="cpu")
    small.add(v)
    small.delete_rows(np.arange(297))
    d, i = small.search(v[:2], 8)
    assert (i[:, :3] >= 297).all() and (i[:, 3:] == -1).all() and (d[:, 3:] == MASKED).all()
    with pytest.raises(ValueError):
        PQIndex(10, 4, device="cpu")


def test_pad_k_widens_and_clears_masked_ids():
    """ops/topk.py::pad_k, the padding of the pq, bq and ivf results:
    (MASKED, -1) columns up to k, and -1 under every masked distance."""
    from longbow_tpu_torch.ops.topk import pad_k

    d = torch.tensor([[0.5, MASKED], [1.0, 2.0]])
    i = torch.tensor([[4, 9], [7, 3]])
    pd, pi = pad_k(d, i, 4)
    assert pd.shape == (2, 4) and (pd[:, 2:] == MASKED).all()
    assert pi.tolist() == [[4, -1, -1, -1], [7, 3, -1, -1]]
    same_d, same_i = pad_k(d, i, 2)
    assert torch.equal(same_d, d) and same_i.tolist() == [[4, -1], [7, 3]]
