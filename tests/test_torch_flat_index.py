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


# -- the coarse int8 shadow (LONGBOW_FLAT_COARSE=1) ---------------------------


def _coarse_pair(monkeypatch, metric="l2", seed=5):
    """A port FlatIndex with the shadow on, fed a first block (the affine's
    training block) and a second one with deletes, and longbow_tpu's jitted
    train/update run on the port's stored bf16 rows."""
    from longbow_tpu.index import flat as jflat

    monkeypatch.setenv("LONGBOW_FLAT_COARSE", "1")
    a, b, q = _blocks(seed)
    ti = FlatIndex(D, metric, torch.bfloat16, device="cpu")
    ti.add(a)
    ti.flush()
    ti.add(b[0])
    ti.delete_rows(np.arange(0, 2200, 9))
    ti.flush()
    stored = jnp.asarray(ti.vectors.float().numpy()).astype(jnp.bfloat16)
    lo, hi = jflat._coarse_train(stored, 0, 1500)
    cap = stored.shape[0]
    codes, cn = jnp.zeros((cap, D), jnp.int8), jnp.zeros((cap,), jnp.float32)
    codes, cn = jflat._coarse_update(codes, cn, lo, hi, stored, 0, 1500)
    codes, cn = jflat._coarse_update(codes, cn, lo, hi, stored, 1500, 700)
    return ti, (stored, codes, lo, hi, cn), q


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_coarse_shadow_codes_and_search_match_jax(monkeypatch, metric):
    """The shadow's affine, codes (from the stored bf16 rows) and norms
    equal longbow_tpu's; FlatIndex.search runs coarse_flat_search_rerank
    (K2's plain version on the CPU), and both equal longbow_tpu's
    coarse_flat_search_rerank in interpret mode: distances to rtol 1e-5,
    ids where untied."""
    from longbow_tpu.ops.pallas_scan import coarse_flat_search_rerank as jax_coarse
    from longbow_tpu_torch.ops.scan import coarse_flat_search_rerank

    ti, (stored, codes, lo, hi, cn), q = _coarse_pair(monkeypatch, metric)
    np.testing.assert_array_equal(ti._coarse_lo.numpy(), np.asarray(lo))
    np.testing.assert_array_equal(ti._coarse_hi.numpy(), np.asarray(hi))
    np.testing.assert_array_equal(ti._coarse_codes.numpy(), np.asarray(codes))
    np.testing.assert_allclose(ti._coarse_norms.numpy(), np.asarray(cn), rtol=1e-6)
    normalize = metric == "cosine"
    valid = jnp.asarray(ti.valid.numpy())
    for k, mask in ((1, None), (10, None), (10, _mask(ti.capacity, len(ti)))):
        jd, jidx = jax_coarse(
            jnp.asarray(q), stored, codes, lo, hi, cn, valid, k, "l2", pool=64,
            extra_mask=None if mask is None else jnp.asarray(mask), normalize=normalize,
            tile_n=256, interpret=True,
        )
        td, tidx = coarse_flat_search_rerank(
            q, ti.vectors, ti._coarse_codes, ti._coarse_lo, ti._coarse_hi, ti._coarse_norms,
            ti.valid, k, "l2", pool=64, extra_mask=None if mask is None else torch.from_numpy(mask),
            normalize=normalize, device="cpu",
        )
        _assert_same((jd, jidx), (td.numpy(), tidx.numpy()))
        dd, ii = ti.search(q, k, filter_mask=None if mask is None else torch.from_numpy(mask))
        np.testing.assert_array_equal(ii, tidx.numpy())
        want = td.numpy() if not normalize else np.where(td.numpy() < 1e37, 0.5 * td.numpy(),
                                                         td.numpy())
        np.testing.assert_array_equal(dd, want)
        assert not np.isin(ii, np.arange(0, 2200, 9)).any()
        if mask is not None:
            assert mask[ii].all()
    # k = 64 returns the whole pool, whose last places the codes' scores
    # decide among near ties: there the two packages' summation orders may
    # pick other rows, so the lists must overlap and shared ids agree
    jd, jidx = jax_coarse(jnp.asarray(q), stored, codes, lo, hi, cn, valid, 64, "l2", pool=64,
                          normalize=normalize, tile_n=256, interpret=True)
    td, tidx = ti.search(q, 64)
    jd, jidx = np.asarray(jd), np.asarray(jidx)
    if normalize:
        jd = 0.5 * jd
    for row in range(len(q)):
        shared = np.intersect1d(jidx[row], tidx[row])
        assert len(shared) >= 56, len(shared)
        jpos = {r: j for j, r in enumerate(jidx[row])}
        for j, r in enumerate(tidx[row]):
            if r in jpos:
                np.testing.assert_allclose(td[row, j], jd[row, jpos[r]], rtol=RTOL, atol=ATOL)


def test_coarse_shadow_grows_with_capacity_and_serves_like_k1(monkeypatch):
    """Codes grow with the index (rows past the first capacity keep their
    codes); the shadow's answers hold the bf16 path's top-10 (recall 1.0
    on these rows: the pool of 64 contains every true neighbour)."""
    monkeypatch.setenv("LONGBOW_FLAT_COARSE", "1")
    a, b, q = _blocks(6)
    ti = FlatIndex(D, "l2", torch.bfloat16, device="cpu")
    monkeypatch.setenv("LONGBOW_FLAT_COARSE", "0")
    ref = FlatIndex(D, "l2", torch.bfloat16, device="cpu")
    rng = np.random.default_rng(7)
    for blk in (a, rng.standard_normal((5000, D), dtype=np.float32), b[0]):
        ti.add(blk)
        ref.add(blk)
    ti.flush()
    assert ti._coarse_codes.shape[0] == ti.vectors.shape[0] == 8192
    assert ti._coarse_codes[7000:7200].abs().sum() > 0
    assert ref._coarse_codes is None
    (d1, i1), (d2, i2) = ti.search(q, 10), ref.search(q, 10)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)
    assert ti.device_bytes() == ref.device_bytes() + 8192 * (D + 4)


def test_coarse_shadow_is_gated_on_metric(monkeypatch):
    """Reference fault (ADVICE.md, longbow_tpu/index/flat.py:702): the
    shadow is not gated on metric there, so a dot dataset's search raises
    inside coarse_flat_search_rerank. The port builds the shadow for l2 and
    cosine only; a dot index with the variable set is served by K1."""
    from longbow_tpu.ops.pallas_scan import coarse_flat_search_rerank as jax_coarse

    ti, (stored, codes, lo, hi, cn), q = _coarse_pair(monkeypatch, "l2")
    with pytest.raises(ValueError, match="l2/cosine only"):
        jax_coarse(jnp.asarray(q), stored, codes, lo, hi, cn, jnp.asarray(ti.valid.numpy()), 10,
                   "dot", interpret=True)
    a, _, _ = _blocks(8)
    dot = FlatIndex(D, "dot", torch.bfloat16, device="cpu")
    assert not dot._coarse_enabled
    dot.add(a)
    monkeypatch.setenv("LONGBOW_FLAT_COARSE", "0")
    plain = FlatIndex(D, "dot", torch.bfloat16, device="cpu")
    plain.add(a)
    (d1, i1), (d2, i2) = dot.search(q, 10), plain.search(q, 10)
    assert dot._coarse_codes is None
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)


def test_coarse_shadow_failure_raises(monkeypatch):
    """Reference fault (longbow_tpu/index/flat.py:444-447): a failure to
    maintain the shadow turns it off without a word, and searches go on
    through the other path. The port raises from the write."""
    monkeypatch.setenv("LONGBOW_FLAT_COARSE", "1")
    a, b, _ = _blocks(9)
    ji = JaxFlat(D, "l2", jnp.bfloat16)
    ji._coarse_enabled = True  # its gate is _on_tpu(): forced on the CPU
    ji.add(a)
    ji.flush()
    assert ji._coarse_codes is not None
    ji._coarse_lo = jnp.zeros(D + 1)  # a broken affine
    ji.add(b[0])
    ji.flush()
    assert not ji._coarse_enabled and ji._coarse_codes is None  # silently off
    ti = FlatIndex(D, "l2", torch.bfloat16, device="cpu")
    ti.add(a)
    ti.flush()
    ti._coarse_lo = torch.zeros(D + 1)
    ti.add(b[0])
    with pytest.raises(RuntimeError):
        ti.flush()
