"""longbow_tpu_torch.ops.scan (kernel K1's plain version and the re-rank)
against longbow_tpu's fused scan (Pallas, interpret mode) and its f32
exact_search oracle, on the CPU; the CUDA kernel itself against the plain
version on a card.

The cases are those of tests/test_pallas_scan.py. Tolerances: the scan
rounds queries to the corpus dtype, so distances agree to rtol 3e-3 /
atol 2e-2 as in that file; the re-rank is exact f32 on both sides
(rtol 1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.ops.distance import exact_search as jax_exact_search
from longbow_tpu.ops.distance import squared_norms as jax_squared_norms
from longbow_tpu.ops.pallas_scan import fused_flat_search as jax_fused
from longbow_tpu_torch.ops.distance import MASKED, Metric
from longbow_tpu_torch.ops.scan import (
    flat_search_rerank,
    fused_flat_search,
    fused_flat_search_plain,
)


def _data(n=700, d=96, b=5, seed=0):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d), dtype=np.float32)
    queries = rng.standard_normal((b, d), dtype=np.float32)
    return queries, corpus


def _both(q, c, valid, k, metric, corpus_dtype=np.float32):
    """The JAX kernel (interpret mode) and the port's plain version on
    the same inputs."""
    jc = jnp.asarray(c).astype(
        jnp.bfloat16 if corpus_dtype == "bf16" else jnp.float32
    )
    norms = np.array(jax_squared_norms(jc))
    jd, ji = jax_fused(
        jnp.asarray(q), jc, jnp.asarray(norms), jnp.asarray(valid), k, metric,
        tile_n=256, interpret=True,
    )
    tc = torch.from_numpy(c).to(
        torch.bfloat16 if corpus_dtype == "bf16" else torch.float32
    )
    td, ti = fused_flat_search_plain(
        q, tc, torch.from_numpy(norms), torch.from_numpy(valid), k, metric,
        device="cpu",
    )
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())


@pytest.mark.parametrize("corpus_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.DOT])
def test_plain_scan_matches_jax_kernel(metric, corpus_dtype):
    q, c = _data()
    valid = np.ones(c.shape[0], bool)
    (jd, ji), (td, ti) = _both(q, c, valid, 10, metric, corpus_dtype)
    for i in range(q.shape[0]):
        assert set(ti[i].tolist()) == set(ji[i].tolist()), i
    np.testing.assert_allclose(td, jd, rtol=3e-3, atol=2e-2)
    assert (np.diff(td, axis=1) >= -1e-6).all()
    assert ti.dtype == np.int32 and td.dtype == np.float32


def test_plain_scan_tombstones():
    _, c = _data(n=300, d=32, b=3, seed=1)
    q = c[:3].copy()
    valid = np.ones(300, bool)
    valid[:3] = False
    (jd, ji), (td, ti) = _both(q, c, valid, 5, Metric.L2)
    assert not np.isin(ti, [0, 1, 2]).any()
    for i in range(3):
        assert set(ti[i].tolist()) == set(ji[i].tolist())


def test_plain_scan_unaligned_shapes():
    q, c = _data(n=513, d=33, b=3, seed=2)
    valid = np.ones(513, bool)
    (jd, ji), (td, ti) = _both(q, c, valid, 7, Metric.L2)
    for i in range(3):
        assert set(ti[i].tolist()) == set(ji[i].tolist())
    np.testing.assert_allclose(td, jd, rtol=3e-3, atol=2e-2)


def test_scan_k_over_limit_raises():
    q, c = _data(n=256, d=32, b=2)
    norms = np.sum(c * c, axis=1)
    valid = np.ones(256, bool)
    for fn in (fused_flat_search, fused_flat_search_plain):
        with pytest.raises(ValueError):
            fn(q, c, norms, valid, 600, Metric.L2, device="cpu")
    with pytest.raises(ValueError):
        fused_flat_search(q, c, norms, valid, 5, Metric.COSINE, device="cpu")


@pytest.mark.parametrize("metric", [Metric.L2, Metric.DOT])
def test_plain_scan_ghost_rows_exact_masked(metric):
    q, c = _data(n=300, d=32, b=3, seed=3)
    valid = np.zeros(300, bool)
    valid[:4] = True
    (jd, ji), (td, ti) = _both(q, c, valid, 10, metric)
    for b in range(3):
        real = ti[b] >= 0
        assert real.sum() == 4
        assert set(ti[b][real]) == set(ji[b][ji[b] >= 0]) <= {0, 1, 2, 3}
        assert (ti[b][~real] == -1).all()
        assert (td[b][~real] == np.float32(MASKED)).all()
        assert (td[b][real] < 1e37).all()
    np.testing.assert_array_equal(td >= 1e37, jd >= 1e37)


def test_plain_scan_all_masked():
    q, c = _data(n=256, d=32, b=2, seed=4)
    valid = np.zeros(256, bool)
    (jd, ji), (td, ti) = _both(q, c, valid, 5, Metric.L2)
    assert (ti == -1).all() and (ji == -1).all()
    assert (td == np.float32(MASKED)).all()


def test_scan_wrapper_runs_the_plain_version_on_cpu_tensors():
    q, c = _data(n=400, d=40, b=4, seed=5)
    cb = torch.from_numpy(c).to(torch.bfloat16)
    norms = (cb.float() ** 2).sum(dim=1)
    valid = torch.ones(400, dtype=torch.bool)
    extra = torch.arange(400) % 3 == 0
    got = fused_flat_search(q, cb, norms, valid, 9, extra_mask=extra, device="cpu")
    want = fused_flat_search_plain(q, cb, norms, valid, 9, extra_mask=extra,
                                   device="cpu")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[1] % 3 == 0).all()


@pytest.mark.parametrize("metric", [Metric.L2, Metric.DOT, Metric.COSINE])
def test_rerank_matches_jax_oracle_on_rounded_rows(metric):
    rng = np.random.default_rng(6)
    c = rng.standard_normal((2000, 64), dtype=np.float32)
    q = rng.standard_normal((6, 64), dtype=np.float32)
    valid = rng.random(2000) > 0.05
    normalize = metric == Metric.COSINE
    scan_metric = Metric.L2 if normalize else metric
    if normalize:
        c = c / np.linalg.norm(c, axis=1, keepdims=True)
    cb = torch.from_numpy(c).to(torch.bfloat16)
    rounded = cb.float().numpy()
    norms = np.sum(rounded * rounded, axis=1)
    td, ti = flat_search_rerank(
        q, cb, torch.from_numpy(norms), torch.from_numpy(valid), 10,
        scan_metric, normalize=normalize, device="cpu",
    )
    jd, ji = jax_exact_search(
        jnp.asarray(q), jnp.asarray(rounded), 10, scan_metric,
        corpus_norms_sq=jnp.asarray(norms), valid=jnp.asarray(valid),
        normalize=normalize, exact_precision=True,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.L2, Metric.DOT])
def test_cuda_kernel_matches_plain_on_card(metric):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    from longbow_tpu_torch.ops.scan import wgmma_takes

    ran = set()
    for n, d, b, k in ((5000, 128, 3, 10), (4099, 100, 70, 64), (3000, 64, 2, 512),
                       (5043, 128, 70, 64), (40000, 96, 300, 10), (4096, 64, 17, 64)):
        c = torch.randn((n, d), generator=g, device="cuda").to(torch.bfloat16)
        norms = (c.float() ** 2).sum(dim=1)
        valid = torch.rand((n,), generator=g, device="cuda") > 0.1
        q = torch.randn((b, d), generator=g, device="cuda")
        pd, pi = fused_flat_search_plain(q, c, norms, valid, k, metric)
        can = wgmma_takes(b, d, k, c.data_ptr() % 16 == 0)
        for variant in (("mma", "wgmma") if can else ("mma",)):   # both variants where the shape has two
            kd, ki = fused_flat_search(q, c, norms, valid, k, metric, variant=variant)
            torch.cuda.synchronize()
            torch.testing.assert_close(kd, pd, rtol=1e-3, atol=1e-2)
            assert (ki >= 0).all()
            assert valid[ki.long()].all()
            ran.add(variant)
    assert ran == {"mma", "wgmma"}
    with pytest.raises(ValueError):  # the kernel takes bf16 rows only
        fused_flat_search(q, c.float(), norms, valid, 10, metric)
