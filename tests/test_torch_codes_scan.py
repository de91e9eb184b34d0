"""longbow_tpu_torch.ops.scan.fused_codes_search (kernel K2's plain version
on CPU tensors) against longbow_tpu's fused_codes_search (Pallas,
interpret mode, tile_n=256), on the CPU; the CUDA kernel itself against
the plain version on a card.

The cases are those of tests/test_pallas_scan.py (sq8 fold, sq8r group
term in f32 and bf16, tombstones and ghosts, fewer valid rows than k),
plus the dot fold with clamp_zero=False and an extra mask. The JAX
kernel keeps `depth` candidates per lane and residue class mod 128, so it
drops neighbours when more of them share a class; it runs here with
depth = ceil(N / 128), which keeps every row, so that its selection is
exact, as the port's is.

Tolerance. Both sides round the query side to bf16 and add the same
terms in f32, in another order, so distances agree to rtol 1e-3 /
atol 1e-2. On top of that the JAX wrapper adds a positivity bias before
its bitcast packing, rounds the packed score up to the id field (one
ulp at tile_n=256) and subtracts the bias again: that costs a few ulps
of (bias + |score|), bounded here by 8 * eps32 * (bias + |score|). Ids
must agree on every slot whose distance lies below the k-th by more
than that tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.ops.pallas_scan import fused_codes_search as jax_codes
from longbow_tpu_torch.ops.distance import MASKED, MASKED_GUARD
from longbow_tpu_torch.ops.scan import fused_codes_search, fused_codes_search_plain

RTOL, ATOL = 1e-3, 1e-2
EPS32 = float(np.finfo(np.float32).eps)


def _sq8_setup(n=768, d=64, b=6, seed=5):
    """Global-affine SQ8 codes (u8 - 128) with the shift folded into
    lo_eff, and the dequantized rows."""
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((b, d)).astype(np.float32)
    lo, hi = corpus.min(axis=0), corpus.max(axis=0)
    scale = np.maximum(hi - lo, 1e-12) / 255.0
    codes = (np.clip(np.round((corpus - lo) / scale), 0, 255) - 128).astype(np.int8)
    lo_eff = lo + 128.0 * scale
    deq = codes.astype(np.float32) * scale + lo_eff
    return queries, codes, deq, lo_eff, scale


def _sq8r_setup(seed=7, n_groups=6, d=64, b=4):
    """Cluster-grouped residual codes: each 128-row group one cluster, and
    the -2 q.center[cid] group term."""
    rng = np.random.default_rng(seed)
    n = n_groups * 128
    centers = rng.standard_normal((3, d)).astype(np.float32) * 3.0
    gcid = rng.integers(0, 3, n_groups)
    rows_c = centers[np.repeat(gcid, 128)]
    corpus = rows_c + rng.standard_normal((n, d)).astype(np.float32)
    queries = centers[rng.integers(0, 3, b)] + rng.standard_normal((b, d)).astype(np.float32)
    res = corpus - rows_c
    lo, hi = res.min(axis=0), res.max(axis=0)
    scale = np.maximum(hi - lo, 1e-12) / 255.0
    codes = (np.clip(np.round((res - lo) / scale), 0, 255) - 128).astype(np.int8)
    lo_eff = lo + 128.0 * scale
    deq = codes.astype(np.float32) * scale + lo_eff + rows_c
    qs = queries * scale[None, :]
    qn_eff = np.sum(queries * queries, axis=1) - 2.0 * (queries @ lo_eff)
    gt = (-2.0 * (queries @ centers.T)[:, gcid]).astype(np.float32)
    return qs, qn_eff, codes, np.sum(deq * deq, axis=1), gt


def _both(qs, qn_eff, codes, vn, valid, k, *, gt=None, gt_bf16=False, extra=None,
          neg_slack=0.0, clamp_zero=True):
    jgt = None if gt is None else jnp.asarray(gt)
    tgt = None if gt is None else torch.from_numpy(gt)
    if gt_bf16:
        jgt, tgt = jgt.astype(jnp.bfloat16), tgt.to(torch.bfloat16)
    jd, ji = jax_codes(
        jnp.asarray(qs), jnp.asarray(qn_eff), jnp.asarray(codes), jnp.asarray(vn),
        jnp.asarray(valid), k, group_term=jgt,
        extra_mask=None if extra is None else jnp.asarray(extra),
        neg_slack=neg_slack, clamp_zero=clamp_zero, tile_n=256,
        depth=-(-codes.shape[0] // 128), interpret=True,
    )
    td, ti = fused_codes_search(
        qs, qn_eff, torch.from_numpy(codes), vn, torch.from_numpy(valid), k,
        group_term=tgt, extra_mask=None if extra is None else torch.from_numpy(extra),
        neg_slack=neg_slack, clamp_zero=clamp_zero, device="cpu",
    )
    # the JAX wrapper's bias (pallas_scan.py:576-582), for its packing noise
    bias = 1.0 + 0.25 * (np.abs(qn_eff).max() + np.abs(np.where(valid, vn, 0)).max())
    bias += abs(neg_slack) + (0.0 if gt is None else 0.25 * np.abs(gt).max())
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy()), bias


def _check(j, t, bias):
    (jd, ji), (td, ti) = j, t
    assert td.dtype == np.float32 and ti.dtype == np.int32
    real = jd < MASKED_GUARD
    np.testing.assert_array_equal(td < MASKED_GUARD, real)
    assert (ti[~real] == -1).all() and (td[~real] == np.float32(MASKED)).all()
    tol = ATOL + RTOL * np.abs(jd) + 8 * EPS32 * (bias + np.abs(jd))
    assert (np.abs(td - jd)[real] <= tol[real]).all()
    assert (np.diff(td, axis=1) >= 0).all()
    for b in range(jd.shape[0]):
        r = real[b]
        if not r.any():
            continue
        kth = jd[b][r].max()
        sure = r & (jd[b] < kth - tol[b])
        assert set(ji[b][sure]) <= set(ti[b][ti[b] >= 0]), b


@pytest.mark.parametrize("k", [10, 64, 200])
def test_sq8_fold_matches_jax(k):
    q, codes, deq, lo_eff, scale = _sq8_setup()
    qs = q * scale[None, :]
    qn_eff = np.sum(q * q, axis=1) - 2.0 * (q @ lo_eff)
    vn = np.sum(deq * deq, axis=1)
    valid = np.ones(codes.shape[0], bool)
    _check(*_both(qs, qn_eff, codes, vn, valid, k))


@pytest.mark.parametrize("gt_bf16", [False, True])
def test_sq8r_group_term_matches_jax(gt_bf16):
    qs, qn_eff, codes, vn, gt = _sq8r_setup()
    valid = np.ones(codes.shape[0], bool)
    _check(*_both(qs, qn_eff, codes, vn, valid, 8, gt=gt, gt_bf16=gt_bf16))


def test_sq8r_group_term_with_tombstones():
    qs, qn_eff, codes, vn, gt = _sq8r_setup(seed=8)
    valid = np.random.default_rng(1).random(codes.shape[0]) > 0.2
    j, t, bias = _both(qs, qn_eff, codes, vn, valid, 16, gt=gt, gt_bf16=True)
    _check(j, t, bias)
    assert valid[t[1][t[1] >= 0]].all()


def test_tombstones_and_ghosts_fewer_valid_than_k():
    q, codes, deq, lo_eff, scale = _sq8_setup(n=512, d=32, b=3, seed=9)
    qs = q * scale[None, :]
    qn_eff = np.sum(q * q, axis=1) - 2.0 * (q @ lo_eff)
    valid = np.zeros(512, bool)
    valid[:4] = True
    j, t, bias = _both(qs, qn_eff, codes, np.sum(deq * deq, axis=1), valid, 10)
    _check(j, t, bias)
    td, ti = t
    for r in range(3):
        real = ti[r] >= 0
        assert real.sum() == 4 and set(ti[r][real]) <= {0, 1, 2, 3}


def test_all_masked():
    q, codes, deq, lo_eff, scale = _sq8_setup(n=256, d=32, b=2, seed=4)
    qs = q * scale[None, :]
    qn_eff = np.sum(q * q, axis=1) - 2.0 * (q @ lo_eff)
    j, (td, ti), _ = _both(qs, qn_eff, codes, np.sum(deq * deq, axis=1),
                           np.zeros(256, bool), 5)
    assert (ti == -1).all() and (j[1] == -1).all()
    assert (td == np.float32(MASKED)).all()


def test_dot_fold_with_extra_mask_matches_jax():
    """sq8's dot fold: qs = q * scale / 2, qn_eff = -q.lo_eff, no row
    term, clamp_zero=False: scores are -q.v_deq and go negative."""
    q, codes, deq, lo_eff, scale = _sq8_setup(seed=11)
    qs = q * scale[None, :] * 0.5
    qn_eff = -(q @ lo_eff)
    n = codes.shape[0]
    valid = np.ones(n, bool)
    extra = np.arange(n) % 3 != 1
    mq = np.sqrt(np.max(np.sum(q * q, axis=1)))
    mv = np.sqrt(np.max(np.sum(deq * deq, axis=1)))
    j, t, bias = _both(qs, qn_eff, codes, np.zeros(n, np.float32), valid, 12,
                       extra=extra, neg_slack=2.0 * mq * mv + 1.0, clamp_zero=False)
    _check(j, t, bias)
    td, ti = t
    assert (td < 0).any()
    assert (ti % 3 != 1).all()
    # the scores are -q.v_deq from the bf16-rounded query side
    qs16 = torch.from_numpy(qs).to(torch.bfloat16).double().numpy()
    want = qn_eff[:, None] - 2.0 * (qs16 @ codes.T.astype(np.float64))
    np.testing.assert_allclose(td, np.take_along_axis(want, ti.astype(np.int64), 1),
                               rtol=1e-5, atol=1e-4)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    qs, qn_eff, codes, vn, gt = _sq8r_setup(seed=3)
    args = (qs, qn_eff, torch.from_numpy(codes), vn, torch.ones(codes.shape[0], dtype=torch.bool), 9)
    got = fused_codes_search(*args, group_term=torch.from_numpy(gt), device="cpu")
    want = fused_codes_search_plain(*args, group_term=torch.from_numpy(gt), device="cpu")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_invalid_arguments_raise():
    qs, qn_eff, codes, vn, gt = _sq8r_setup(seed=2)
    valid = np.ones(codes.shape[0], bool)
    for fn in (fused_codes_search, fused_codes_search_plain):
        with pytest.raises(ValueError):  # k past the limit
            fn(qs, qn_eff, codes, vn, valid, 513, device="cpu")
        with pytest.raises(ValueError):  # not int8 codes
            fn(qs, qn_eff, codes.astype(np.float32), vn, valid, 5, device="cpu")
        with pytest.raises(ValueError):  # group term of the wrong shape
            fn(qs, qn_eff, codes, vn, valid, 5, group_term=gt[:, :-1], device="cpu")
        with pytest.raises(ValueError):  # group term with N % 128 != 0
            fn(qs, qn_eff, codes[:-1], vn[:-1], valid[:-1], 5, group_term=gt, device="cpu")


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """A changed header rebuilds every source that includes it."""
    from longbow_tpu_torch.ops import _kernels

    assert [p.name for p in _kernels.source_closure(_kernels.FUSED_CODES_SCAN.path)] == [
        "fused_codes_scan.cu", "scan_common.cuh", "scan_wgmma.cuh",
    ]
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text('#include "inner.cuh"\nint main() {}\n')
    (tmp_path / "csrc" / "inner.cuh").write_text('#include "leaf.cuh"\n')
    (tmp_path / "csrc" / "leaf.cuh").write_text("constexpr int kA = 1;\n")
    monkeypatch.setattr(_kernels, "_PKG", tmp_path)
    kern = _kernels.Kernel("k", "csrc/k.cu", lambda lib: None)
    before = kern.library_path()
    assert kern.library_path() == before
    (tmp_path / "csrc" / "leaf.cuh").write_text("constexpr int kA = 2;\n")
    assert kern.library_path() != before


@pytest.mark.cuda
@pytest.mark.parametrize("gt_kind", [None, torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_on_card(gt_kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    from longbow_tpu_torch.ops.scan import wgmma_takes

    ran = set()
    for n, d, b, k in ((5120, 96, 3, 10), (4096, 128, 70, 64), (3072, 64, 2, 512),
                       (4096, 100, 17, 64), (40960, 96, 300, 64), (4096, 64, 17, 10)):
        codes = torch.randint(-128, 128, (n, d), generator=g, device="cuda",
                              dtype=torch.int8)
        vn = (codes.float() ** 2).sum(dim=1) * 1e-3
        valid = torch.rand((n,), generator=g, device="cuda") > 0.1
        qs = torch.randn((b, d), generator=g, device="cuda") * 0.03
        qn = (qs * qs).sum(dim=1)
        gt = None if gt_kind is None else torch.randn(
            (b, n // 128), generator=g, device="cuda").to(gt_kind)
        pd, pi = fused_codes_search_plain(qs, qn, codes, vn, valid, k, group_term=gt)
        can = wgmma_takes(b, d, k, codes.data_ptr() % 16 == 0)
        for variant in (("mma", "wgmma") if can else ("mma",)):   # both variants where the shape has two
            kd, ki = fused_codes_search(qs, qn, codes, vn, valid, k, group_term=gt,
                                        variant=variant)
            torch.cuda.synchronize()
            torch.testing.assert_close(kd, pd, rtol=RTOL, atol=ATOL)
            assert valid[ki[ki >= 0].long()].all()
            ran.add(variant)
    assert ran == {"mma", "wgmma"}
