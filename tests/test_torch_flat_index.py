"""longbow_tpu_torch.index.flat.FlatIndex against longbow_tpu's FlatIndex
on the CPU, fed the same blocks, deletes and filter masks.

Both store bf16 rows and rank them exactly in f32 (the port through the
scan's plain version and the f32 re-rank, the JAX package through its
exact scan), so ids agree and distances within rtol 1e-5 / atol 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.index.flat import FlatIndex as JaxFlat
from longbow_tpu_torch.index.flat import FlatIndex

RTOL, ATOL = 1e-5, 1e-4
D = 48


def _blocks(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((1500, D), dtype=np.float32)
    b = [rng.standard_normal((700, D), dtype=np.float32),
         rng.standard_normal((300, D), dtype=np.float32)]
    q = rng.standard_normal((7, D), dtype=np.float32)
    return a, b, q


def _assert_same(jres, tres):
    jd, ji = (np.asarray(x) for x in jres)
    td, ti = tres
    real = jd < 1e37
    np.testing.assert_array_equal(real, td < 1e37)
    np.testing.assert_array_equal(np.where(real, ji, -1), np.where(real, ti, -1))
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)


def _mask(cap, n_rows):
    m = np.zeros(cap, bool)
    m[:n_rows] = np.arange(n_rows) % 3 != 0
    return m


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_flat_index_matches_jax(metric):
    a, b, q = _blocks()
    ji = JaxFlat(D, metric, jnp.bfloat16)
    ti = FlatIndex(D, metric, torch.bfloat16, device="cpu")
    np.testing.assert_array_equal(ji.add(a), ti.add(a))
    _assert_same(ji.search(q, 10), ti.search(q, 10))
    # a list of blocks stays staged; deletes hit flushed and staged rows
    np.testing.assert_array_equal(ji.add(list(b)), ti.add(list(b)))
    dead = np.array([0, 5, 17, 1499, 1500, 1503, 2499])
    ji.delete_rows(dead)
    ti.delete_rows(dead)
    assert ti._stage_dead  # the staged ones wait for the flush
    for k in (10, 100):  # 100 goes to exact_search in the port
        jr, tr = ji.search(q, k), ti.search(q, k)
        _assert_same(jr, tr)
        assert not np.isin(tr[1], dead).any()
    # k = 64 fills the whole scan pool, so the pool's bf16 ranking decides
    # its last places (as on the TPU, whose pool is 64 too); the JAX
    # package's CPU path is exact: every place is at least as far, and
    # nearly all ids agree
    (jd, jidx), (td, tidx) = ji.search(q, 64), ti.search(q, 64)
    assert (np.asarray(td) >= np.asarray(jd) - ATOL).all()
    overlap = np.mean([len(set(a) & set(b)) / 64 for a, b in zip(tidx, jidx)])
    assert overlap >= 0.95, overlap
    assert not np.isin(tidx, dead).any()
    n = len(ti)
    jm = _mask(ji.capacity, n)
    tm = _mask(ti.capacity, n)
    jr = ji.search(q, 10, filter_mask=jnp.asarray(jm))
    tr = ti.search(q, 10, filter_mask=torch.from_numpy(tm))
    _assert_same(jr, tr)
    assert tm[tr[1]].all()
    np.testing.assert_allclose(ti.get_vectors(np.arange(20)),
                               ji.get_vectors(np.arange(20)), rtol=0, atol=0)


def test_flat_index_device_tensor_add_matches_jax():
    a, b, q = _blocks(1)
    ji = JaxFlat(D, "l2", jnp.bfloat16)
    ti = FlatIndex(D, "l2", torch.bfloat16, device="cpu")
    ji.add(a)
    ti.add(a)
    ji.add(jnp.asarray(b[0]))
    ti.add(torch.from_numpy(b[0]))
    assert len(ti) == len(ji) == 2200
    _assert_same(ji.search(q, 10), ti.search(q, 10))
    _assert_same(ji.search(q, 10), ti.search(q, 10, exact=True))


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_jax_state_imports_into_port(metric):
    a, b, q = _blocks(2)
    ji = JaxFlat(D, metric, jnp.bfloat16)
    ji.add(a)
    ji.delete_rows(np.arange(0, 1500, 7))
    state = ji.export_state()
    assert state["dtype"] == "bfloat16"
    ti = FlatIndex.import_state(state, device="cpu")
    assert ti.dtype == torch.bfloat16 and len(ti) == len(ji)
    _assert_same(ji.search(q, 10), ti.search(q, 10))


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_port_state_imports_into_jax(metric):
    a, b, q = _blocks(3)
    ti = FlatIndex(D, metric, torch.bfloat16, device="cpu")
    ti.add(a)
    ti.add(b)
    ti.delete_rows(np.arange(3, 2500, 11))
    state = ti.export_state()
    ji = JaxFlat.import_state(state)
    assert ji.dtype == jnp.bfloat16 and len(ji) == len(ti)
    _assert_same(ji.search(q, 10), ti.search(q, 10))
    back = FlatIndex.import_state(ti.export_state(), device="cpu")
    np.testing.assert_array_equal(back.export_state()["vectors"], state["vectors"])
    np.testing.assert_array_equal(back.export_state()["valid"], state["valid"])


def test_flat_index_grows_by_doubling():
    ti = FlatIndex(8, "l2", torch.bfloat16, device="cpu")
    assert ti.capacity == 4096
    ti.add(np.ones((5000, 8), np.float32))
    assert ti.capacity == 8192  # the stage counts before its flush
    ti.flush()
    assert ti.vectors.shape[0] == 8192 and ti.valid[:5000].all()
    assert not ti.valid[5000:].any()


def test_flat_index_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: None means the card")
    with pytest.raises(RuntimeError):
        FlatIndex(D, "l2", torch.bfloat16)
