"""The two variants of the fused scans (mma.sync and wgmma): which shape
goes to which, the query-block widths of the wgmma variant, the host-side
layout steps of the wgmma wrappers, and the inputs that aim at the wgmma
main loop (a ragged last tile, rows in adversarial order, the narrow
blocks of B <= 16) through the port's wrappers on the CPU against
longbow_tpu's Pallas kernels in interpret mode. The tests marked `cuda`
run each width on a card and skip without one.

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
from longbow_tpu_torch.ops import scan
from longbow_tpu_torch.ops.scan import (
    WGMMA_TILE,
    WGMMA_WIDTHS,
    fused_codes_search,
    fused_codes_search_plain,
    fused_flat_search,
    fused_flat_search_plain,
    pad_row_term,
    scan_variant,
    wgmma_k_order,
    wgmma_operands,
    wgmma_plan,
    wgmma_takes,
    wgmma_width,
)

RTOL, ATOL = 1e-3, 1e-2
EPS32 = float(np.finfo(np.float32).eps)


def _ring_measured_faster(kernel: str, b: int, n: int, k: int = 64, d: int = 128) -> bool:
    """The sizes where the wgmma ring measured faster than mma.sync
    (ops/scan.py's WGMMA_FROM and WGMMA_SMALL_K for the whole-tile widths,
    WGMMA_FROM_WIDE for the chunked loop's, written out)."""
    if d not in (64, 96, 128):
        return n >= 131_072 or (n >= 32_768 and b >= 256)
    if k <= 16 and 65 <= b <= 128:
        return False
    if kernel == "fused_scan":
        return n >= 262_144 or (n >= 131_072 and b >= 129)
    return n >= 524_288 or (n >= 262_144 and b >= 8) or (n >= 131_072 and b >= 129)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("d", [64, 96, 100, 128, 256])
@pytest.mark.parametrize("k", [10, 64, 65, 512])
@pytest.mark.parametrize("b", [1, 5, 16, 17, 48, 128, 1000])
def test_variant_is_a_pure_function_of_the_shape(b, k, d, aligned):
    # whole tiles at D = 64, 96, 128; the chunked loop at other multiples of 16
    takes = k <= 64 and d % 16 == 0 and 64 <= d <= 1024 and aligned
    assert wgmma_takes(b, d, k, aligned) == takes
    for kernel in ("fused_scan", "fused_codes_scan"):
        for n in (32_768, 131_072, 262_144, 1_048_576, 10_240_000):
            want = "wgmma" if takes and _ring_measured_faster(kernel, b, n, k, d) else "mma"
            assert scan_variant(b, n, d, k, aligned, kernel) == want
            assert scan_variant(b, n, d, k, aligned, kernel) == want   # the same again
    # the served small shapes take the wgmma ring: one query, the
    # coalescer's and Flight's groups, a mesh shard and K2's Flight group
    for b_, n_, d_, kernel in ((1, 1_048_576, 128, "fused_scan"), (48, 1_048_576, 128, "fused_scan"),
                               (57, 1_048_576, 128, "fused_scan"),
                               (1000, 131_072, 128, "fused_scan"),
                               (1000, 131_072, 128, "fused_codes_scan"),
                               (1, 10_240_000, 96, "fused_codes_scan")):
        assert scan_variant(b_, n_, d_, 64, True, kernel) == "wgmma"
    # small corpora at small batches stay on mma.sync, and so do 65 to 128
    # queries at k <= 16
    assert scan_variant(1, 131_072, 128, 64, True) == "mma"
    assert scan_variant(128, 1_048_576, 128, 10, True) == "mma"
    assert scan_variant(129, 1_048_576, 128, 10, True) == "wgmma"
    assert scan_variant(1000, 32_768, 128, 64, True) == "mma"
    with pytest.raises(ValueError):
        scan_variant(1, 1000, 128, 10, True, "fused_graph")


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
    assert _pick_variant(None, 1, 10_240_000, 96, 65, True) == "mma"
    assert _pick_variant(None, 1, 4096, 96, 64, True) == "mma"         # small: mma.sync
    assert _pick_variant("wgmma", 1, 4096, 96, 64, True) == "wgmma"   # small, but it can
    for shape in ((1, 10_240_000, 96, 65, True), (1, 10_240_000, 100, 64, True),
                  (1000, 10_240_000, 96, 64, False)):
        with pytest.raises(ValueError):   # a shape the wgmma variant does not take
            _pick_variant("wgmma", *shape)
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


@pytest.mark.parametrize("b", [1, 2, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 1000])
def test_width_is_the_narrowest_block_that_holds_the_batch(b):
    w = wgmma_width(b)
    assert w in WGMMA_WIDTHS
    if b <= WGMMA_WIDTHS[-1]:
        assert w >= b and all(x < b for x in WGMMA_WIDTHS if x < w)
    else:
        assert w == WGMMA_WIDTHS[-1]


@pytest.mark.parametrize("multiple", [1, 8])
@pytest.mark.parametrize("n", [1, 127, 5043, 32_768, 131_072, 1_048_576 - 77, 10_240_000])
@pytest.mark.parametrize("nq", WGMMA_WIDTHS)
def test_plan_of_every_width_is_one_wave_of_whole_tiles(nq, n, multiple):
    """Each width's plan: whole tiles (a multiple of `multiple`), every
    row in exactly one split, at most one block an SM where the batch
    allows, and as many splits as that leaves."""
    sms = 132
    for b in sorted({1, max(1, nq // 2), nq, nq + 1, 1000}):
        s, rows = wgmma_plan(b, n, sms, multiple, nq=nq)
        qblocks = -(-b // nq)
        assert rows % (WGMMA_TILE * multiple) == 0 and s >= 1
        starts = np.arange(s) * rows
        covered = np.minimum(starts + rows, n) - starts
        assert covered.sum() == n and (covered > 0).all()   # each row once, no split empty
        assert qblocks * s <= max(sms, qblocks)
        ntiles = -(-n // WGMMA_TILE)
        if qblocks < sms and ntiles >= sms // qblocks * multiple:
            assert qblocks * s > sms // 2   # the wave is not left half empty


def test_plan_refuses_a_width_that_is_not_built():
    with pytest.raises(ValueError):
        wgmma_plan(10, 4096, 132, nq=48)
    assert wgmma_plan(10, 4096, 132) == wgmma_plan(10, 4096, 132, nq=16)


@pytest.mark.parametrize("elem_bytes", [1, 2])
@pytest.mark.parametrize("d", [64, 96, 128])
def test_k_order_is_the_same_at_every_width(d, elem_bytes):
    """A query's permuted columns and the padded row term do not depend on
    the block width its batch gets (16 at B = 1 or 5, 32 at 17, 64 at 48,
    128 at 1,000): the k order is fixed by the rows' loads alone."""
    rng = np.random.default_rng(d + elem_bytes)
    q = torch.from_numpy(rng.standard_normal((1000, d)).astype(np.float32))
    vn = torch.from_numpy(rng.random(5043).astype(np.float32))
    full_q, full_vn = wgmma_operands(q, vn, elem_bytes)
    for b in (1, 5, 16, 17, 48, 1000):
        qp, vp = wgmma_operands(q[:b], vn, elem_bytes)
        assert torch.equal(qp, full_q[:b]) and torch.equal(vp, full_vn)
        assert torch.equal(qp, q[:b][:, wgmma_k_order(d, elem_bytes)])


def _padded_rows(rows: np.ndarray, order: list, n_padded: int) -> np.ndarray:
    """The rows as the kernel reads them against the permuted queries:
    columns in `order`, zero rows past N up to the padded row term (the
    kernel sets those products to 0; their row term is MASKED)."""
    out = np.zeros((n_padded, rows.shape[1]), dtype=rows.dtype)
    out[:rows.shape[0]] = rows[:, order]
    return out


@pytest.mark.parametrize("metric", [Metric.L2, Metric.DOT])
@pytest.mark.parametrize("b", [1, 5, 16])
def test_flat_narrow_block_inputs_match_jax(b, metric):
    """K1 at the widths of B <= 16: the plain scan over the wrapper's
    host-side wgmma inputs (permuted queries, padded row term, the rows
    permuted alike) gives the JAX kernel's answers in interpret mode."""
    n, d, k = 5120 - 77, 32, 64
    rows, queries = _rows(n, d, b, "adversarial", seed=20 + b)
    if metric == Metric.DOT:
        rows = rows[::-1].copy()
        queries = queries + rows[-1] * 0.5
    jc = jnp.asarray(rows).astype(jnp.bfloat16)
    tc = torch.from_numpy(rows).to(torch.bfloat16)
    norms = (tc.float() ** 2).sum(dim=1).numpy()
    valid = np.random.default_rng(21).random(n) > 0.01
    jd, ji = jax_flat(jnp.asarray(queries), jc, jnp.asarray(norms), jnp.asarray(valid), k,
                      metric, tile_n=256, depth=-(-n // 128), interpret=True)
    corpus, qc, qn, vn, l2 = scan._prepare(queries, tc, torch.from_numpy(norms),
                                           torch.from_numpy(valid), k, metric, None, False,
                                           "cpu")
    qp, vp = wgmma_operands(qc, vn, 2)
    assert qp.shape == (b, d) and vp.shape[0] % WGMMA_TILE == 0
    cp = torch.from_numpy(_padded_rows(corpus.float().numpy(), wgmma_k_order(d, 2),
                                       vp.shape[0])).to(torch.bfloat16)
    td, ti = scan._plain_scan(cp, qp, qn, vp, k, l2)
    qb = torch.from_numpy(queries).to(torch.bfloat16).float().numpy()
    bias = 1.0 + 0.25 * (np.sum(qb * qb, axis=1).max() + np.abs(norms).max())
    _check(np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy(), bias)
    assert not np.isin(ti.numpy(), np.nonzero(~valid)[0]).any() and ti.numpy().max() < n


@pytest.mark.parametrize("b", [1, 5, 16])
def test_codes_narrow_block_inputs_match_jax(b):
    """K2 at the widths of B <= 16, as for K1, with int8 codes."""
    n, d, k = 5120 - 77, 32, 64
    rows, queries = _rows(n, d, b, "adversarial", seed=30 + b)
    lo, hi = rows.min(axis=0), rows.max(axis=0)
    scale = np.maximum(hi - lo, 1e-12) / 255.0
    codes = (np.clip(np.round((rows - lo) / scale), 0, 255) - 128).astype(np.int8)
    lo_eff = lo + 128.0 * scale
    deq = codes.astype(np.float32) * scale + lo_eff
    qs = queries * scale[None, :]
    qn = np.sum(queries * queries, axis=1) - 2.0 * (queries @ lo_eff)
    vn = np.sum(deq * deq, axis=1)
    valid = np.random.default_rng(31).random(n) > 0.01
    jd, ji = jax_codes(
        jnp.asarray(qs), jnp.asarray(qn), jnp.asarray(codes), jnp.asarray(vn),
        jnp.asarray(valid), k, tile_n=256, depth=-(-n // 128), interpret=True,
    )
    tcodes, tqs, tqn, tvn, _ = scan._prepare_codes(qs, qn, torch.from_numpy(codes), vn,
                                                   torch.from_numpy(valid), k, None, None, "cpu")
    qp, vp = wgmma_operands(tqs, tvn, 1)
    cp = torch.from_numpy(_padded_rows(codes, wgmma_k_order(d, 1), vp.shape[0]))
    td, ti = scan._plain_scan(cp, qp, tqn, vp, k, True)
    bias = 1.0 + 0.25 * (np.abs(qn).max() + np.abs(np.where(valid, vn, 0)).max())
    _check(np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy(), bias)
    assert not np.isin(ti.numpy(), np.nonzero(~valid)[0]).any() and ti.numpy().max() < n


@pytest.mark.cuda
@pytest.mark.parametrize("nq", WGMMA_WIDTHS)
def test_every_width_matches_plain_on_card(nq):
    """Both kernels' wgmma variant at each query-block width (the batch
    sizes that pick it) against the plain versions, on a ragged corpus."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(nq)
    n, d = 40_000 - 77, 128
    for b in sorted({1, nq // 2 + 1, nq} if nq > 16 else {1, 5, 16}):
        assert wgmma_width(b) == nq
        c = torch.randn((n, d), generator=g, device="cuda").to(torch.bfloat16)
        norms = (c.float() ** 2).sum(dim=1)
        valid = torch.rand((n,), generator=g, device="cuda") > 0.1
        q = torch.randn((b, d), generator=g, device="cuda")
        for metric in (Metric.L2, Metric.DOT):
            kd, ki = fused_flat_search(q, c, norms, valid, 64, metric, variant="wgmma")
            pd, _ = fused_flat_search_plain(q, c, norms, valid, 64, metric)
            torch.testing.assert_close(kd, pd, rtol=1e-3, atol=1e-2)
            assert valid[ki.long()].all()
        codes = torch.randint(-128, 128, (n + 77, d), generator=g, device="cuda",
                              dtype=torch.int8)
        vn = torch.rand((n + 77,), generator=g, device="cuda") * 100.0
        ok = torch.rand((n + 77,), generator=g, device="cuda") > 0.1
        gt = torch.randn((b, (n + 77) // 128), generator=g, device="cuda").to(torch.bfloat16)
        qs, qn = q * 0.01, torch.rand((b,), generator=g, device="cuda")
        kd, ki = fused_codes_search(qs, qn, codes, vn, ok, 64, group_term=gt, variant="wgmma")
        pd, _ = fused_codes_search_plain(qs, qn, codes, vn, ok, 64, group_term=gt)
        torch.testing.assert_close(kd, pd, rtol=1e-3, atol=1e-2)
        assert ok[ki.long()].all()


def _ordered(x: np.ndarray) -> np.ndarray:
    """scan_wgmma.cuh's ordered_bits: float32 bits in an order that
    unsigned comparison keeps."""
    u = x.astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _mth_smallest(values: np.ndarray, m: int) -> np.float32:
    """scan_wgmma.cuh's mth_smallest: the bits of the m-th smallest built
    from the top, a bit kept while fewer than m values lie below."""
    v = _ordered(values)
    x = 0
    for bit in range(31, -1, -1):
        t = x | (1 << bit)
        if int((v < t).sum()) < m:
            x = t
    u = np.uint32(x)
    back = (u & np.uint32(0x7FFFFFFF)) if u & np.uint32(0x80000000) else ~u
    return np.array([back], dtype=np.uint32).view(np.float32)[0]


def test_ordered_bits_match_the_kernels_order():
    """ops/scan.py::ordered_bits (the shared bound's initial value) is the
    kernel's ordered_bits, and unsigned order is float order."""
    x = np.array([-3e38, -1e37, -2.5, -0.0, 0.0, 1e-30, 1.0, 7.5, 1e37, 3e38], np.float32)
    bits = _ordered(x)
    assert (np.diff(bits.astype(np.int64)) >= 0).all()
    assert all(np.uint32(scan.ordered_bits(float(v)) & 0xFFFFFFFF) == b for v, b in zip(x, bits))
    assert -(1 << 31) <= scan.ordered_bits(float(MASKED_GUARD)) < 1 << 31


@pytest.mark.parametrize("k,splits", [(64, 131), (64, 132), (10, 256), (64, 16), (64, 40), (1, 7)])
def test_order_statistic_bound_never_cuts_a_true_neighbour(k, splits):
    """The wgmma kernels lower a query's threshold to the m-th smallest of
    the splits' published r-th best scores, r = ceil(k / splits) and
    m = ceil(k / r), with splits that have not published yet at the guard:
    the search finds that value exactly, and at least k rows score at or
    below it at any point of the scan, so the k-th best of the corpus does
    too."""
    rng = np.random.default_rng(k * splits)
    scores = (rng.standard_normal((splits, 300)) - 0.5).astype(np.float32)  # some negative
    scores[:, 7] = scores[0, 3]   # ties across splits
    r = -(-k // splits)
    m = -(-k // r)
    assert m <= splits
    for seen in (1, r, 50, 300):
        part = np.sort(scores[:, :seen], axis=1)
        published = np.where(np.arange(splits) % 3 == 0, np.float32(MASKED_GUARD),
                             part[:, r - 1] if seen >= r else np.float32(MASKED_GUARD))
        bound = _mth_smallest(published, m)
        assert bound == np.sort(published)[m - 1]
        if bound < MASKED_GUARD:
            assert (part <= bound).sum() >= k
            assert np.sort(part.ravel())[k - 1] <= bound


@pytest.mark.parametrize("k,splits,tile", [(64, 131, 128), (10, 16, 128), (1, 1, 128),
                                           (64, 64, 32), (64, 256, 128)])
def test_warm_start_keeps_every_true_neighbour(k, splits, tile):
    """The wgmma kernels' warm start (splits >= k): each split publishes
    one ulp above the best score of its first tile, the threshold falls to
    the k-th smallest published value at once, and the splits keep what
    scores below it (the first tile again at the end). On integer scores
    with many ties, the merged k best are the corpus's k best scores."""
    rng = np.random.default_rng(k + splits)
    scores = rng.integers(-50, 50, (splits, 6 * tile)).astype(np.float32)
    published = np.nextafter(scores[:, :tile].min(axis=1), np.float32(np.inf))
    bound = _mth_smallest(published, k)
    kept = [np.sort(row[row < bound])[:k] for row in scores]
    merged = np.sort(np.concatenate(kept))[:k]
    np.testing.assert_array_equal(merged, np.sort(scores.ravel())[:k])
