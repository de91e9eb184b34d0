"""The wide path of the fused scans (D past 128: GIST-1M's 960, text
embeddings' 768, a dot graph's 129 padded to 144) on the CPU: the plain
K1 and K2, and the plain scan over the wgmma ring's chunked query layout,
against longbow_tpu's Pallas kernels in interpret mode; the layout chunk
by chunk; which widths the ring takes and with how many queries a block;
the flat store and SQ8Index at those widths against longbow_tpu's; the
dot graph's column padding. The tests marked `cuda` hold the kernels to
their plain versions on a card and skip without one.

The JAX kernels run with one candidate depth a 128-row group (`depth`),
which makes them exact. Tolerance against JAX: both sides round the query
side to bf16 and add the same terms in f32 in another order, so distances
agree to rtol 1e-3 / atol 1e-2, plus the JAX wrapper's packing noise of a few ulps of
(bias + |score|) (tests/test_torch_codes_scan.py). Ids must agree on
every slot whose distance lies below the k-th by more than that. The
index comparisons re-rank exactly in f32 on both sides: rtol 1e-5 /
atol 1e-3 (sums of 768 to 960 products of order 10).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.index.flat import FlatIndex as JaxFlat
from longbow_tpu.index.sq8 import SQ8Index as JaxSQ8
from longbow_tpu.ops.pallas_scan import fused_codes_search as jax_codes
from longbow_tpu.ops.pallas_scan import fused_flat_search as jax_flat
from longbow_tpu_torch.index.flat import FlatIndex
from longbow_tpu_torch.index.graph_build import _chunked_self_knn, pad_columns
from longbow_tpu_torch.index.sq8 import SQ8Index
from longbow_tpu_torch.ops import scan
from longbow_tpu_torch.ops.distance import MASKED, MASKED_GUARD, Metric
from longbow_tpu_torch.ops.scan import (
    WGMMA_CHUNK_BYTES,
    WGMMA_DIMS,
    WGMMA_MAX_DIM,
    WGMMA_SMEM,
    WGMMA_WIDTHS,
    _wgmma_smem,
    fused_codes_search,
    fused_codes_search_plain,
    fused_flat_search,
    fused_flat_search_plain,
    scan_variant,
    wgmma_chunked,
    wgmma_k_order,
    wgmma_layout,
    wgmma_max_width,
    wgmma_operands,
    wgmma_padded_dim,
    wgmma_takes,
    wgmma_width,
)

RTOL, ATOL = 1e-3, 1e-2
EPS32 = float(np.finfo(np.float32).eps)
WIDE = (144, 768, 960)


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


def _as_read(rows: np.ndarray, d: int, elem_bytes: int, n_padded: int) -> np.ndarray:
    """The rows as the ring's chunked loop reads them against the laid-out
    queries: zero columns up to wgmma_padded_dim, columns in
    wgmma_layout, zero rows past N up to the padded row term."""
    dp = wgmma_padded_dim(d, elem_bytes)
    out = np.zeros((n_padded, dp), dtype=rows.dtype)
    out[:rows.shape[0], :d] = rows
    return out[:, wgmma_layout(d, elem_bytes)]


@pytest.mark.parametrize("metric", [Metric.L2, Metric.DOT])
@pytest.mark.parametrize("d", WIDE)
def test_wide_flat_scan_and_its_layout_match_jax(d, metric):
    """K1's plain version, and the plain scan over the wgmma wrapper's
    host-side inputs at a chunked width (queries padded and laid out chunk
    by chunk, the row term padded, the rows read alike), give the JAX
    kernel's answers in interpret mode."""
    n, b, k = 512 - 77, 5, 64
    rng = np.random.default_rng(d)
    rows = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((b, d)).astype(np.float32)
    if metric == Metric.DOT:
        queries = queries + rows[:b] * 0.5
    tc = torch.from_numpy(rows).to(torch.bfloat16)
    norms = (tc.float() ** 2).sum(dim=1).numpy()
    valid = rng.random(n) > 0.05
    jd, ji = jax_flat(jnp.asarray(queries), jnp.asarray(rows).astype(jnp.bfloat16),
                      jnp.asarray(norms), jnp.asarray(valid), k, metric, tile_n=256,
                      depth=-(-n // 128), interpret=True)
    jd, ji = np.asarray(jd), np.asarray(ji)
    qb = torch.from_numpy(queries).to(torch.bfloat16).float().numpy()
    bias = 1.0 + 0.25 * (np.sum(qb * qb, axis=1).max() + np.abs(norms).max())
    td, ti = fused_flat_search(queries, tc, torch.from_numpy(norms), torch.from_numpy(valid), k,
                               metric, device="cpu")
    _check(jd, ji, td.numpy(), ti.numpy(), bias)
    corpus, qc, qn, vn, l2 = scan._prepare(queries, tc, torch.from_numpy(norms),
                                           torch.from_numpy(valid), k, metric, None, False, "cpu")
    qp, vp = wgmma_operands(qc, vn, 2)
    assert qp.shape == (b, wgmma_padded_dim(d, 2)) and vp.shape[0] % 128 == 0
    cp = torch.from_numpy(_as_read(corpus.float().numpy(), d, 2, vp.shape[0])).to(torch.bfloat16)
    ld, li = scan._plain_scan(cp, qp, qn, vp, k, l2)
    _check(jd, ji, ld.numpy(), li.numpy(), bias)
    assert not np.isin(li.numpy(), np.nonzero(~valid)[0]).any() and li.numpy().max() < n


@pytest.mark.parametrize("group_term", [False, True])
@pytest.mark.parametrize("d", WIDE)
def test_wide_codes_scan_and_its_layout_match_jax(d, group_term):
    """K2 as K1 above, over int8 codes (128 dims a chunk), with and
    without a group term."""
    n, b, k = (512 if group_term else 512 - 77), 4, 64
    rng = np.random.default_rng(d + 1)
    codes = rng.integers(-128, 128, (n, d)).astype(np.int8)
    qs = (rng.standard_normal((b, d)) * 0.03).astype(np.float32)
    qn = rng.random(b).astype(np.float32)
    vn = (rng.random(n) * 100.0).astype(np.float32)
    valid = rng.random(n) > 0.05
    gt = (rng.standard_normal((b, n // 128)).astype(np.float32) if group_term else None)
    jd, ji = jax_codes(jnp.asarray(qs), jnp.asarray(qn), jnp.asarray(codes), jnp.asarray(vn),
                       jnp.asarray(valid), k, group_term=None if gt is None else jnp.asarray(gt),
                       tile_n=256, depth=-(-n // 128), interpret=True)
    jd, ji = np.asarray(jd), np.asarray(ji)
    bias = 1.0 + 0.25 * (np.abs(qn).max() + np.abs(vn).max()
                         + (0.0 if gt is None else np.abs(gt).max()))
    td, ti = fused_codes_search(qs, qn, torch.from_numpy(codes), vn, torch.from_numpy(valid), k,
                                group_term=gt, device="cpu")
    _check(jd, ji, td.numpy(), ti.numpy(), bias)
    tcodes, tqs, tqn, tvn, tgt = scan._prepare_codes(qs, qn, torch.from_numpy(codes), vn,
                                                     torch.from_numpy(valid), k, gt, None, "cpu")
    qp, vp = wgmma_operands(tqs, tvn, 1)
    assert qp.shape == (b, wgmma_padded_dim(d, 1))
    cp = torch.from_numpy(_as_read(codes, d, 1, vp.shape[0]))
    ld, li = scan._plain_scan(cp, qp, tqn, vp, k, True, group_term=tgt)
    _check(jd, ji, ld.numpy(), li.numpy(), bias)


@pytest.mark.parametrize("elem_bytes", [1, 2])
@pytest.mark.parametrize("d", [64, 80, 96, 112, 128, 144, 256, 768, 960, 1024])
def test_layout_is_the_k_order_chunk_by_chunk(d, elem_bytes):
    """The whole-tile widths keep wgmma_k_order; every other width pads to
    whole chunks of 128 bytes of a row and takes a chunk's k order in each
    chunk, so a dot product over the padded, laid-out columns is the dot
    product of the rows."""
    layout = wgmma_layout(d, elem_bytes)
    dp = wgmma_padded_dim(d, elem_bytes)
    assert sorted(layout) == list(range(dp))
    if d in WGMMA_DIMS:
        assert not wgmma_chunked(d) and layout == wgmma_k_order(d, elem_bytes) and dp == d
    else:
        chunk = WGMMA_CHUNK_BYTES // elem_bytes
        assert wgmma_chunked(d) and dp % chunk == 0 and 0 <= dp - d < chunk
        one = wgmma_k_order(chunk, elem_bytes)
        for c in range(dp // chunk):
            assert layout[c * chunk:(c + 1) * chunk] == [c * chunk + j for j in one]
    rng = np.random.default_rng(d * elem_bytes)
    q = np.zeros((3, dp), np.float32)
    v = np.zeros((5, dp), np.float32)
    q[:, :d] = rng.integers(-8, 8, (3, d))
    v[:, :d] = rng.integers(-128, 128, (5, d))
    np.testing.assert_array_equal(q[:, layout] @ v[:, layout].T, q[:, :d] @ v[:, :d].T)


@pytest.mark.parametrize("d", [48, 64, 80, 100, 112, 129, 144, 320, 336, 768, 960, 1024, 1040])
def test_ring_takes_the_wide_widths(d):
    """The ring takes every multiple of 16 from 64 to WGMMA_MAX_DIM, any
    batch, k <= 64, aligned rows; its query block is the narrowest that
    holds the batch up to the widest whose resident queries fit (128 up to
    D = 320, then 64); a shape it takes at its measured sizes goes to it."""
    takes = d % 16 == 0 and 64 <= d <= WGMMA_MAX_DIM
    for b in (1, 48, 1000):
        assert wgmma_takes(b, d, 64, True) == takes
        assert not wgmma_takes(b, d, 65, True) and not wgmma_takes(b, d, 64, False)
        for kernel in ("fused_scan", "fused_codes_scan"):
            if takes:
                assert scan_variant(b, 1_048_576, d, 64, True, kernel) == "wgmma"
            else:
                assert scan_variant(b, 1_048_576, d, 64, True, kernel) == "mma"
    if not takes:
        return
    for elem_bytes in (1, 2):
        most = wgmma_max_width(d, elem_bytes)
        assert most == (128 if wgmma_padded_dim(d, elem_bytes) <= 320 else 64)
        assert wgmma_width(1, d, elem_bytes) == 16 and wgmma_width(48, d, elem_bytes) == 64
        assert wgmma_width(1000, d, elem_bytes) == most
        assert wgmma_width(100, d, elem_bytes) == most


@pytest.mark.parametrize("elem_bytes", [1, 2])
def test_widest_block_is_the_widest_that_fits(elem_bytes):
    """wgmma_max_width leaves the chunked loop three ring stages and
    WGMMA_MAX_K + 16 slots a query in an H100 block's shared memory, and
    the next width up would not."""
    for d in range(80, WGMMA_MAX_DIM + 1, 16):
        if not wgmma_chunked(d):
            continue
        dp, most = wgmma_padded_dim(d, elem_bytes), wgmma_max_width(d, elem_bytes)
        assert _wgmma_smem(most, dp) <= WGMMA_SMEM
        if most < WGMMA_WIDTHS[-1]:
            assert _wgmma_smem(most * 2, dp) > WGMMA_SMEM


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_flat_index_at_gist_width_matches_jax(metric):
    """The flat tier at D = 960 (GIST-1M's width) against longbow_tpu's,
    with deletes and a filter."""
    d = 960
    rng = np.random.default_rng(7)
    a = rng.standard_normal((700, d)).astype(np.float32)
    q = rng.standard_normal((6, d)).astype(np.float32)
    ji = JaxFlat(d, metric, jnp.bfloat16)
    ti = FlatIndex(d, metric, torch.bfloat16, device="cpu")
    np.testing.assert_array_equal(ji.add(a), ti.add(a))
    dead = np.arange(0, 700, 7)
    ji.delete_rows(dead)
    ti.delete_rows(dead)
    mask = np.zeros(ti.capacity, bool)
    mask[:700] = np.arange(700) % 3 != 0
    for kw_j, kw_t in (({}, {}), ({"filter_mask": jnp.asarray(mask[:ji.capacity])},
                                  {"filter_mask": torch.from_numpy(mask)})):
        jd, jidx = (np.asarray(x) for x in ji.search(q, 10, **kw_j))
        td, tidx = ti.search(q, 10, **kw_t)
        np.testing.assert_array_equal(tidx, jidx)
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-3)
        assert not np.isin(tidx, dead).any()


def test_sq8_index_at_embedding_width_matches_jax():
    """SQ8Index (K2's path) at D = 768 against longbow_tpu's: the same
    codes, and answers equal to an exact search over the dequantized rows."""
    d = 768
    rng = np.random.default_rng(8)
    v = rng.standard_normal((800, d)).astype(np.float32)
    q = rng.standard_normal((6, d)).astype(np.float32)
    jidx = JaxSQ8(d)
    jidx.add(v)
    jidx.delete_rows(np.arange(0, 800, 5))
    st = jidx.export_state()
    tidx = SQ8Index.import_state(st, device="cpu")
    np.testing.assert_array_equal(np.asarray(tidx.export_state()["codes"]),
                                  np.asarray(st["codes"]))
    deq = np.asarray(jidx._dequant(jidx.codes), np.float64)[:800]
    td, ti = tidx.search(q, 10)
    q64 = q.astype(np.float64)
    dist = (q64 * q64).sum(1)[:, None] - 2 * q64 @ deq.T + (deq * deq).sum(1)[None, :]
    dist = np.where(np.asarray(st["valid"])[:800][None, :], np.maximum(dist, 0.0), np.inf)
    oi = np.argsort(dist, axis=1, kind="stable")[:, :10]
    od = np.take_along_axis(dist, oi, 1)
    np.testing.assert_allclose(td, od, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(ti, oi)


@pytest.mark.parametrize("d", [129, 136, 144])
def test_padded_columns_leave_the_self_knn_unchanged(d):
    """The dot graph's self-kNN on a card scans its rows padded with zero
    columns to a multiple of 16 (pad_columns): on integer rows, where every
    sum is exact, the scan of the padded rows gives the same neighbours and
    distances as the rows themselves, and the plain build's self-kNN
    agrees with both."""
    n, k = 700, 16
    rng = np.random.default_rng(d)
    rows = torch.from_numpy(rng.integers(-4, 5, (n, d)).astype(np.float32)).to(torch.bfloat16)
    padded = pad_columns(rows)
    assert padded.shape == (n, -(-d // 16) * 16)
    assert torch.equal(padded[:, :d], rows) and not padded[:, d:].any()
    norms = (rows.float() ** 2).sum(dim=1)
    valid = torch.from_numpy(rng.random(n) > 0.05)
    want = fused_flat_search_plain(rows[:64], rows, norms, valid, k + 1, device="cpu")
    got = fused_flat_search_plain(padded[:64], padded, norms, valid, k + 1, device="cpu")
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    kd, ki = _chunked_self_knn(rows, norms, valid, 64, k, chunk_b=64)
    pd, pi = _chunked_self_knn(padded, norms, valid, 64, k, chunk_b=64)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 144, 768, 960, 1024])
def test_wide_kernels_match_plain_on_card(d):
    """Both kernels' wgmma variant at a chunked width, at every query-block
    width it takes, against the plain versions on a ragged corpus."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(d)
    n = 40_000 - 77
    c = torch.randn((n, d), generator=g, device="cuda").to(torch.bfloat16)
    norms = (c.float() ** 2).sum(dim=1)
    valid = torch.rand((n,), generator=g, device="cuda") > 0.1
    codes = torch.randint(-128, 128, (n, d), generator=g, device="cuda", dtype=torch.int8)
    vn = torch.rand((n,), generator=g, device="cuda") * 100.0
    for b in (1, 17, 48, 200):
        q = torch.randn((b, d), generator=g, device="cuda")
        for metric in (Metric.L2, Metric.DOT):
            kd, ki = fused_flat_search(q, c, norms, valid, 64, metric, variant="wgmma")
            pd, _ = fused_flat_search_plain(q, c, norms, valid, 64, metric)
            torch.testing.assert_close(kd, pd, rtol=1e-3, atol=1e-2)
            assert valid[ki.long()].all()
        qs, qn = q * 0.03, torch.rand((b,), generator=g, device="cuda")
        kd, _ = fused_codes_search(qs, qn, codes, vn, valid, 64, variant="wgmma")
        pd, _ = fused_codes_search_plain(qs, qn, codes, vn, valid, 64)
        torch.testing.assert_close(kd, pd, rtol=1e-3, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("group_term", [None, "f32", "bf16"])
def test_wide_codes_scan_between_query_blocks_on_card(group_term):
    """K2's ring at D = 768 at B = 65, 100 and 200 (two to four blocks of
    64 queries), over three query draws and three launches each: every
    returned row's score equals its exact f32 score, and the answers the
    plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    d, n = 768, 313 * 128
    g = torch.Generator(device="cuda").manual_seed(768)
    codes = torch.randint(-128, 128, (n, d), generator=g, device="cuda", dtype=torch.int8)
    vn = torch.rand((n,), generator=g, device="cuda") * 100.0
    valid = torch.rand((n,), generator=g, device="cuda") > 0.05
    for _, b in ((s, b) for s in range(3) for b in (65, 100, 200)):
        qs = (torch.randn((b, d), generator=g, device="cuda") * 0.03).to(torch.bfloat16).float()
        qn = torch.full((b,), 1e4, device="cuda")
        gt = None
        if group_term:
            gt = torch.randn((b, n // 128), generator=g, device="cuda") * 5.0
            gt = gt.to(torch.bfloat16) if group_term == "bf16" else gt
        pd, _ = fused_codes_search_plain(qs, qn, codes, vn, valid, 64, group_term=gt)
        for _ in range(3):
            kd, ki = fused_codes_search(qs, qn, codes, vn, valid, 64, group_term=gt,
                                        variant="wgmma")
            rows = ki.long()
            exact = qn[:, None] - 2.0 * (codes[rows].float() @ qs[:, :, None])[..., 0] + vn[rows]
            if gt is not None:
                exact = exact + gt.float().gather(1, rows // 128)
            torch.testing.assert_close(kd, exact, rtol=1e-5, atol=0.05)
            torch.testing.assert_close(kd, pd, rtol=1e-3, atol=1e-2)
            assert valid[rows].all()


@pytest.mark.parametrize("elem_bytes", [1, 2])
@pytest.mark.parametrize("d", [64, 96, 128])
def test_chunked_layout_at_the_whole_tile_widths(d, elem_bytes):
    """tools/probe_scan_variants.py --chunked-narrow lays the queries of a
    whole-tile width out as the chunked loop reads them (_chunked_layout):
    padded to whole chunks and ordered chunk by chunk, so the plain scan
    over those queries and the rows read alike gives the rows' answers;
    outside the block the layout is the whole-tile one again."""
    from longbow_tpu_torch.tools.probe_scan_variants import _chunked_layout

    n, b, k = 300, 3, 16
    rng = np.random.default_rng(d + elem_bytes)
    rows = rng.integers(-8, 8, (n, d)).astype(np.float32)
    q = torch.from_numpy(rng.integers(-4, 5, (b, d)).astype(np.float32))
    vn = torch.from_numpy(rng.random(n).astype(np.float32) * 10.0)
    want = scan._plain_scan(torch.from_numpy(rows), q, torch.zeros(b), vn, k, True)
    with _chunked_layout():
        dp = wgmma_padded_dim(d, elem_bytes)
        chunk = WGMMA_CHUNK_BYTES // elem_bytes
        assert scan.wgmma_chunked(d) and dp % chunk == 0 and 0 <= dp - d < chunk
        qp, vp = wgmma_operands(q, vn, elem_bytes)
        cp = torch.from_numpy(_as_read(rows, d, elem_bytes, vp.shape[0]))
        got = scan._plain_scan(cp, qp, torch.zeros(b), vp, k, True)
    assert not wgmma_chunked(d) and wgmma_layout(d, elem_bytes) == wgmma_k_order(d, elem_bytes)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
