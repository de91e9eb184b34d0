"""longbow_tpu_torch.index.bq against longbow_tpu.index.bq on the CPU.

Sign codes are compared bit for bit (the port's int32 words exported as
uint32), Hamming distances and their ids (ties in row order) exactly.
The first batch has a power-of-two row count of integer-valued rows, so
its mean and the centered rows are exact in f32 and the codes cannot
differ by rounding. Re-ranked distances agree to rtol 1e-5 / atol 1e-5,
ids wherever neighbouring distances differ by more than that.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.index.bq import BQIndex as JaxBQ
from longbow_tpu.index.bq import _hamming_search as jax_hamming
from longbow_tpu.index.bq import _pack_bits as jax_pack
from longbow_tpu_torch.index.bq import BQIndex, _hamming_search, _pack_bits, popcount32
from longbow_tpu_torch.ops.distance import MASKED
from test_torch_pq import assert_close_results, lattice

D = 40  # not a multiple of 32: the padding bits must cancel


def rows(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.integers(-6, 7, (12, D))
    return (centers[rng.integers(0, 12, n)] + rng.integers(-2, 3, (n, D))).astype(np.float32)


def test_pack_bits_is_bit_identical():
    v = np.random.default_rng(0).standard_normal((500, D)).astype(np.float32)
    v[:, 3] = 0.0  # v >= 0 counts zero as set
    want = np.asarray(jax_pack(jnp.asarray(v)))
    got = _pack_bits(torch.from_numpy(v)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (500, 2)
    np.testing.assert_array_equal(got.view(np.uint32), want)


def test_popcount32():
    x = np.random.default_rng(1).integers(-2**31, 2**31, 4000).astype(np.int32)
    x[:4] = [0, -1, -2**31, 2**31 - 1]
    want = [bin(int(a) & 0xFFFFFFFF).count("1") for a in x]
    np.testing.assert_array_equal(popcount32(torch.from_numpy(x)).numpy(), want)


def test_hamming_search_is_equal():
    v = np.random.default_rng(2).standard_normal((6000, D)).astype(np.float32)
    q = np.random.default_rng(3).standard_normal((7, D)).astype(np.float32)
    codes, qcodes = jax_pack(jnp.asarray(v)), jax_pack(jnp.asarray(q))
    valid = np.random.default_rng(4).random(6000) > 0.2
    jd, ji = jax_hamming(codes, qcodes, jnp.asarray(valid), 300)
    tc = torch.from_numpy(np.array(codes).view(np.int32))
    tq = torch.from_numpy(np.array(qcodes).view(np.int32))
    for chunk in (None, 1000):
        td, ti = _hamming_search(tc, tq, torch.from_numpy(valid), 300, chunk=chunk)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
@pytest.mark.parametrize("rerank", [True, False])
def test_index_matches_jax(metric, rerank):
    first, more, q = rows(256, 5), rows(1700, 6), rows(16, 7) + 0.5
    ji, ti = JaxBQ(D, metric, rerank=rerank), BQIndex(D, metric, rerank=rerank, device="cpu")
    for batch in (first, more):
        np.testing.assert_array_equal(ji.add(batch), ti.add(batch))
    np.testing.assert_array_equal(ti.mean.numpy(), np.asarray(ji.mean))
    st = ti.export_state()
    assert st["codes"].dtype == np.uint32
    np.testing.assert_array_equal(st["codes"], np.asarray(ji.codes[: ji.count]))
    for k in (1, 10):
        jres, tres = ji.search(q, k), ti.search(q, k)
        if rerank:
            assert_close_results(jres, tres, k)
        else:  # Hamming distances: exact, ties in row order
            np.testing.assert_array_equal(tres[0], np.asarray(jres[0]))
            np.testing.assert_array_equal(tres[1], np.asarray(jres[1]))
    dead = np.arange(0, 1956, 4)
    ji.delete_rows(dead)
    ti.delete_rows(dead)
    mask = np.arange(ji.capacity) % 3 != 0
    jres = ji.search(q, 10, filter_mask=jnp.asarray(mask))
    tres = ti.search(q, 10, filter_mask=mask)
    if rerank:
        assert_close_results(jres, tres, 10)
    ids = tres[1][tres[1] >= 0]
    assert (ids % 3 != 0).all() and not np.isin(ids, dead).any()


def test_state_crosses_both_ways():
    v, q = rows(512, 8), rows(8, 9) + 0.25
    ti = BQIndex(D, "l2", device="cpu")
    ti.add(v)
    ti.delete_rows([1, 2, 3])
    ji = JaxBQ.import_state(ti.export_state())
    assert_close_results(ji.search(q, 10), ti.search(q, 10), 10)
    back = BQIndex.import_state(ji.export_state(), device="cpu")
    for a, b in zip(back.search(q, 10), ti.search(q, 10)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back.codes[:512].numpy(), ti.codes[:512].numpy())
    np.testing.assert_array_equal(back.get_vectors([0, 5]), v[[0, 5]])


def test_empty_and_short():
    ti = BQIndex(D, "cosine", device="cpu")
    d, i = ti.search(np.ones(D, np.float32), 4)
    assert (d == MASKED).all() and (i == -1).all()
    ti.add(lattice((3, D), 10))
    d, i = ti.search(np.ones(D, np.float32), 5)
    assert sorted(i[0, :3].tolist()) == [0, 1, 2] and (i[0, 3:] == -1).all()
    assert ti.device_bytes() == 4096 * (2 * 4 + 1 + D * 2) + D * 4
