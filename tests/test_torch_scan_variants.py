"""The two variants of the fused scans (mma.sync and wgmma): which shape
goes to which, the host-side layout steps of the wgmma wrappers, and the
inputs that aim at the wgmma main loop (a ragged last tile, rows in
adversarial order) through the port's wrappers on the CPU against
longbow_tpu's Pallas kernels in interpret mode.

Tolerance against JAX: both sides round the query side to bf16 and add
the same terms in f32 in another order, so distances agree to rtol 1e-3 /
atol 1e-2, plus the JAX wrapper's packing noise of a few ulps of
(bias + |score|) (tests/test_torch_codes_scan.py). Ids must agree on
every slot whose distance lies below the k-th by more than that.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.ops.pallas_scan import fused_codes_search as jax_codes
from longbow_tpu.ops.pallas_scan import fused_flat_search as jax_flat
from longbow_tpu_torch.ops.distance import MASKED, MASKED_GUARD, Metric
from longbow_tpu_torch.ops.scan import (
    WGMMA_MIN_WORK,
    WGMMA_TILE,
    fused_codes_search,
    fused_flat_search,
    pad_row_term,
    scan_variant,
    wgmma_k_order,
    wgmma_plan,
    wgmma_takes,
)

RTOL, ATOL = 1e-3, 1e-2
EPS32 = float(np.finfo(np.float32).eps)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("d", [64, 96, 100, 128, 256])
@pytest.mark.parametrize("k", [10, 64, 65, 512])
@pytest.mark.parametrize("b", [1, 16, 17, 1000])
def test_variant_is_a_pure_function_of_the_shape(b, k, d, aligned):
    takes = b > 16 and k <= 64 and d in (64, 96, 128) and aligned
    assert wgmma_takes(b, d, k, aligned) == takes
    for n in (1_000, 1_048_576, 10_240_000):
        want = "wgmma" if takes and b * n > WGMMA_MIN_WORK else "mma"
        assert scan_variant(b, n, d, k, aligned) == want
    # small scans stay on the mma.sync kernel
    assert scan_variant(128, 1_048_576, 128, 64, True) == "mma"
    assert scan_variant(129, 1_048_576, 128, 64, True) == "wgmma"
    assert scan_variant(130, 128_000, 128, 64, True) == "mma"
    assert scan_variant(17, 10_240_000, 96, 64, True) == "wgmma"
    # the served shapes of both kernels take the new variant
    assert scan_variant(1000, 10_240_000, 96, 64, True) == "wgmma"
    assert scan_variant(1000, 1_048_576, 128, 64, True) == "wgmma"


def _fragment_order(d, elem_bytes):
    """wgmma_k_order written down from the kernel's loads: a lane t reads
    `width` bytes of its row at a time; 32-bit word w of a load of an
    int8 row holds dims (lower pair, upper pair) of k-step w, and words
    2 w, 2 w + 1 of a bf16 row those of k-step w; the lower pair is the
    fragment's positions 2 t, 2 t + 1, the upper pair 2 t + 8, 2 t + 9."""
    order = [None] * d
    done_steps, at = 0, 0
    steps = d // 16
    for load_bytes in (16, 8, 4):
        steps_per_load = load_bytes // 4 if elem_bytes == 1 else load_bytes // 8
        if steps_per_load == 0:
            continue
        while steps - done_steps >= steps_per_load:
            dims_per_load = load_bytes // elem_bytes
            for t in range(4):
                first = at + dims_per_load * t
                for s in range(steps_per_load):
                    four = [first + 4 * s + i for i in range(4)]
                    ks = done_steps + s
                    order[16 * ks + 2 * t], order[16 * ks + 2 * t + 1] = four[0], four[1]
                    order[16 * ks + 8 + 2 * t], order[16 * ks + 9 + 2 * t] = four[2], four[3]
            at += 4 * dims_per_load
            done_steps += steps_per_load
    return order


@pytest.mark.parametrize("elem_bytes", [1, 2])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128, 256])
def test_k_order_leaves_every_dot_product_unchanged(d, elem_bytes):
    order = wgmma_k_order(d, elem_bytes)
    assert sorted(order) == list(range(d))
    assert order == _fragment_order(d, elem_bytes)
    rng = np.random.default_rng(d)
    q = rng.integers(-8, 8, (5, d)).astype(np.float32)
    v = rng.integers(-128, 128, (7, d)).astype(np.float32)
    # small integers: the sums are exact in any order
    np.testing.assert_array_equal(q[:, order] @ v[:, order].T, q @ v.T)
    tq = torch.from_numpy(q).index_select(1, torch.tensor(order))
    np.testing.assert_array_equal(tq.numpy(), q[:, order])


def test_k_order_rejects_other_widths():
    with pytest.raises(ValueError):
        wgmma_k_order(100, 1)
    with pytest.raises(ValueError):
        wgmma_k_order(64, 4)


@pytest.mark.parametrize("multiple", [1, 8])
@pytest.mark.parametrize("b", [17, 128, 129, 1000, 2048, 20000])
@pytest.mark.parametrize("n", [1, 127, 5043, 1_048_576 - 77, 10_240_000])
def test_plan_covers_the_corpus_in_one_wave(b, n, multiple):
    sms = 132
    s, rows = wgmma_plan(b, n, sms, multiple)
    qblocks = -(-b // 128)
    assert rows % (WGMMA_TILE * multiple) == 0 and s >= 1
    assert s * rows >= n > (s - 1) * rows        # covered, and no split is empty
    assert qblocks * s <= max(sms, qblocks)      # one block per SM where the batch allows


@pytest.mark.parametrize("n", [1, 128, 129, 5043])
def test_row_term_is_padded_with_masked(n):
    vn = torch.arange(n, dtype=torch.float32)
    out = pad_row_term(vn)
    assert out.shape[0] % WGMMA_TILE == 0 and 0 <= out.shape[0] - n < WGMMA_TILE
    assert torch.equal(out[:n], vn)
    assert (out[n:] == MASKED).all()


def _check(jd, ji, td, ti, bias):
    real = jd < MASKED_GUARD
    np.testing.assert_array_equal(td < MASKED_GUARD, real)
    assert (ti[~real] == -1).all() and (td[~real] == np.float32(MASKED)).all()
    tol = ATOL + RTOL * np.abs(jd) + 8 * EPS32 * (bias + np.abs(jd))
    assert (np.abs(td - jd)[real] <= tol[real]).all()
    assert (np.diff(td, axis=1) >= 0).all()
    for b in range(jd.shape[0]):
        kth = jd[b][real[b]].max()
        sure = real[b] & (jd[b] < kth - tol[b])
        assert set(ji[b][sure]) <= set(ti[b][ti[b] >= 0]), b


def _rows(n, d, b, order, seed):
    """Clustered rows and queries near their common centre; "adversarial"
    sorts the rows by decreasing distance to that centre, so that nearly
    every tile holds a row better than all before it."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((n, d)).astype(np.float32) * 2.0
    queries = rng.standard_normal((b, d)).astype(np.float32) * 0.1
    if order == "adversarial":
        rows = rows[np.argsort(-np.sum(rows * rows, axis=1))]
    return rows, queries


CASES = [("ragged", 5120 - 77), ("adversarial", 5120), ("adversarial", 5120 - 77)]


@pytest.mark.parametrize("order,n", CASES)
def test_codes_scan_inputs_of_the_wgmma_cases_match_jax(order, n):
    d, b, k = 32, 17, 64
    rows, queries = _rows(n, d, b, order, seed=11)
    lo, hi = rows.min(axis=0), rows.max(axis=0)
    scale = np.maximum(hi - lo, 1e-12) / 255.0
    codes = (np.clip(np.round((rows - lo) / scale), 0, 255) - 128).astype(np.int8)
    lo_eff = lo + 128.0 * scale
    deq = codes.astype(np.float32) * scale + lo_eff
    qs = queries * scale[None, :]
    qn = np.sum(queries * queries, axis=1) - 2.0 * (queries @ lo_eff)
    vn = np.sum(deq * deq, axis=1)
    valid = np.random.default_rng(12).random(n) > 0.01
    jd, ji = jax_codes(
        jnp.asarray(qs), jnp.asarray(qn), jnp.asarray(codes), jnp.asarray(vn),
        jnp.asarray(valid), k, tile_n=256, depth=-(-n // 128), interpret=True,
    )
    td, ti = fused_codes_search(qs, qn, torch.from_numpy(codes), vn,
                                torch.from_numpy(valid), k, device="cpu")
    bias = 1.0 + 0.25 * (np.abs(qn).max() + np.abs(np.where(valid, vn, 0)).max())
    _check(np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy(), bias)
    assert not np.isin(ti.numpy(), np.nonzero(~valid)[0]).any()


@pytest.mark.parametrize("metric", [Metric.L2, Metric.DOT])
@pytest.mark.parametrize("order,n", CASES)
def test_flat_scan_inputs_of_the_wgmma_cases_match_jax(order, n, metric):
    d, b, k = 32, 17, 64
    rows, queries = _rows(n, d, b, order, seed=13)
    if metric == Metric.DOT:   # the centre of a dot search: the largest rows last
        rows = rows[::-1].copy() if order == "adversarial" else rows
        queries = queries + rows[-1] * 0.5
    jc = jnp.asarray(rows).astype(jnp.bfloat16)
    tc = torch.from_numpy(rows).to(torch.bfloat16)
    norms = (tc.float() ** 2).sum(dim=1).numpy()
    valid = np.random.default_rng(14).random(n) > 0.01
    jd, ji = jax_flat(jnp.asarray(queries), jc, jnp.asarray(norms), jnp.asarray(valid), k,
                      metric, tile_n=256, depth=-(-n // 128), interpret=True)
    td, ti = fused_flat_search(queries, tc, torch.from_numpy(norms),
                               torch.from_numpy(valid), k, metric, device="cpu")
    qb = torch.from_numpy(queries).to(torch.bfloat16).float().numpy()
    bias = 1.0 + 0.25 * (np.sum(qb * qb, axis=1).max() + np.abs(norms).max())
    _check(np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy(), bias)
    assert not np.isin(ti.numpy(), np.nonzero(~valid)[0]).any()


def test_variant_argument_is_checked_before_any_launch():
    from longbow_tpu_torch.ops.scan import _pick_variant

    assert _pick_variant(None, 1000, 10_240_000, 96, 64, True) == "wgmma"
    assert _pick_variant("mma", 1000, 10_240_000, 96, 64, True) == "mma"
    assert _pick_variant(None, 1, 10_240_000, 96, 64, True) == "mma"
    assert _pick_variant("wgmma", 17, 4096, 96, 64, True) == "wgmma"   # small, but it can
    with pytest.raises(ValueError):   # a shape the wgmma variant does not take
        _pick_variant("wgmma", 1, 10_240_000, 96, 64, True)
    with pytest.raises(ValueError):
        _pick_variant("ring", 1000, 10_240_000, 96, 64, True)


@pytest.mark.parametrize("k,splits,rows", [(64, 16, 500), (64, 132, 70), (10, 3, 40), (64, 1, 300)])
def test_bound_shared_between_splits_never_cuts_a_true_neighbour(k, splits, rows):
    """The wgmma kernels lower a query's threshold to the largest of the
    splits' r-th best scores, r = ceil(k / splits): at least k rows score
    at or below it, so the k-th best of the whole corpus does too, at any
    point of the scan (prefixes of the splits)."""
    rng = np.random.default_rng(k * splits)
    scores = rng.standard_normal((splits, rows)).astype(np.float32)
    r = -(-k // splits)
    for seen in (r, rows // 2, rows):
        part = np.sort(scores[:, :max(seen, r)], axis=1)
        bound = part[:, r - 1].max()
        kth = np.sort(part.ravel())[k - 1] if part.size >= k else np.inf
        assert (part <= bound).sum() >= k
        assert kth <= bound
