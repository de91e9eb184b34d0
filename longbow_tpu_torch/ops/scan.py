"""Fused flat scan (kernel K1), the exact re-rank of its pool, and the
fused scan over int8 codes (kernel K2).

Counterpart of longbow_tpu/ops/pallas_scan.py::fused_flat_search,
::flat_search_rerank, ::fused_codes_search and ::coarse_flat_search_rerank
(the flat tier's int8 shadow: K2 for the pool, the same re-rank). On a CUDA tensor
`fused_flat_search` and `fused_codes_search` launch the hand-written
Hopper kernels `csrc/fused_scan.cu` and `csrc/fused_codes_scan.cu` (or
raise: they never fall back); on a CPU tensor they run
`fused_flat_search_plain` and `fused_codes_search_plain`, the plain
PyTorch versions of the same arithmetic that the tests compare with the
JAX kernels and `chip_smoke.py` compares with the CUDA kernels.

Metric modes: "l2" (dist = |q|^2 - 2 q.v + |v|^2) and "ip"
(dist = -q.v, from Metric.DOT). Cosine is normalize=True + l2 at the
index level, never a mode here.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import torch

from longbow_tpu_torch.device import resolve_device
from longbow_tpu_torch.ops._kernels import FUSED_CODES_SCAN, FUSED_SCAN, KernelError
from longbow_tpu_torch.ops.distance import (
    MASKED,
    MASKED_GUARD,
    Metric,
    full_f32_matmul,
    normalize_rows,
)

MAX_K = 512
GROUP = 128  # rows per entry of K2's group term
WGMMA_WIDTHS = (16, 32, 64, 128)  # queries per block the wgmma variants are built for
WGMMA_QUERIES = WGMMA_WIDTHS[-1]  # the widest block, which larger batches are cut into
WGMMA_TILE = 128     # corpus rows per tile (and per padded row-term block)
WGMMA_MAX_K = 64
WGMMA_MAX_SPLITS = 256  # splits of a query whose shared bound the kernel keeps
WGMMA_DIMS = (64, 96, 128)  # the widths whose tiles the wgmma ring stages whole
# every other multiple of 16 from 64 to WGMMA_MAX_DIM runs its chunked loop:
# a ring stage is 128 rows x WGMMA_CHUNK_BYTES of them (64 bf16 or 128 int8
# dims), the queries zero-padded to whole chunks (wgmma_layout)
WGMMA_MAX_DIM = 1024
WGMMA_CHUNK_BYTES = 128
WGMMA_SMEM = 232_448  # shared memory an H100 block may use (the widths that fit: wgmma_max_width)
KERNEL_NAMES = ("fused_scan", "fused_codes_scan")  # K1, K2
# Where the wgmma variant takes over, by kernel: (rows, queries) pairs, the
# variant serving a shape with at least that many rows and queries for some
# pair. Read off the kernel times (20 launches back to back, their mean) of
# tools/probe_scan_variants.py --grid on an NVIDIA H100 80GB HBM3 at 700 W:
# the ring won every batch from 262,144 rows (K1) and 524,288 (K2; from 8
# queries at 262,144), and at 131,072 rows from 129 queries on (1,000: 0.91
# against 1.29 ms); below, its start (the warm start's wait, a block a SM)
# costs more than its loop saves (K1 at 131,072 x 1: 0.087 against 0.040
# ms; 32,768 x 1,000: 0.60 against 0.56). Between the measured rows it is
# mma.sync.
WGMMA_FROM = {
    "fused_scan": ((262_144, 1), (131_072, 129)),
    "fused_codes_scan": ((524_288, 1), (262_144, 8), (131_072, 129)),
}
# ... but at k <= 16 the mma.sync kernel's smaller candidate buffers tie
# with the ring's 128-query blocks at 65 to 128 queries (1M x 128, k = 10,
# B = 128: 0.654 against 0.665 ms, kernels alone, the same card): mma.sync.
WGMMA_SMALL_K, WGMMA_SMALL_K_BATCHES = 16, (65, 128)
# The chunked loop's crossovers (the widths past WGMMA_DIMS), in the same
# form, read off tools/probe_scan_variants.py --dims --grid (kernels alone,
# median of 20) on an NVIDIA H100 80GB HBM3 at 700 W: K1 at D = 144 and 960
# and K2 at D = 768 took the ring at every batch from 131,072 rows (K1 960,
# B = 1: 0.107 against 0.149 ms; D = 144, B = 64: 0.307 against 0.308) and
# at 32,768 rows from B = 256 (K1 960: 0.361 against 0.590), where below it
# mma.sync's smaller blocks won (K1 960 at B = 64: 0.214 against 0.331).
WGMMA_FROM_WIDE = {
    "fused_scan": ((131_072, 1), (32_768, 256)),
    "fused_codes_scan": ((131_072, 1), (32_768, 256)),
}


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def ordered_bits(x: float) -> int:
    """csrc/scan_wgmma.cuh's ordered_bits as a signed 32-bit integer: the
    float32's bits in an order that unsigned comparison keeps."""
    u = struct.unpack("<I", struct.pack("<f", x))[0]
    o = (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000
    return o - (1 << 32) if o >= 1 << 31 else o


def wgmma_takes(b: int, d: int, k: int, aligned: bool) -> bool:
    """Whether the wgmma variants can run a shape at all: any batch,
    K <= 64, D a multiple of 16 from 64 to WGMMA_MAX_DIM and 16-byte
    aligned rows."""
    return (b >= 1 and k <= WGMMA_MAX_K and d % 16 == 0
            and WGMMA_DIMS[0] <= d <= WGMMA_MAX_DIM and aligned)


def wgmma_chunked(d: int) -> bool:
    """Whether the wgmma ring runs width `d` by its chunked loop (every
    width past 64 but the whole-tile ones, WGMMA_DIMS)."""
    return d > WGMMA_DIMS[0] and d not in WGMMA_DIMS


def wgmma_padded_dim(d: int, elem_bytes: int) -> int:
    """The query operand's width: D, or for the chunked loop D padded to
    whole chunks of WGMMA_CHUNK_BYTES of a row (64 bf16 or 128 int8 dims)."""
    if not wgmma_chunked(d):
        return d
    chunk = WGMMA_CHUNK_BYTES // elem_bytes
    return _ceil_div(d, chunk) * chunk


def _wgmma_smem(nq: int, dp: int, stages: int = 3, cap: int = WGMMA_MAX_K + 16) -> int:
    """csrc/scan_wgmma.cuh's wscan_smem for a chunked launch of `nq`
    queries of width `dp`, with a group term (the largest it can be)."""
    return (1024 + dp // 64 * nq * 128 + stages * (WGMMA_TILE * WGMMA_CHUNK_BYTES + WGMMA_TILE * 4)
            + 2 * 8 * nq * 4 + nq * cap * 8 + nq * 24 + 8 + (2 * 8 + 4) * 8)


def wgmma_max_width(d: int, elem_bytes: int = 2) -> int:
    """The widest query block of a wgmma launch at width `d`: any for the
    whole-tile widths; for the chunked loop, whose queries stay resident in
    shared memory, the widest that leaves a ring of three stages and
    WGMMA_MAX_K + 16 candidate slots a query (128 up to D = 320, 64 up to
    1,024)."""
    if not wgmma_chunked(d):
        return WGMMA_QUERIES
    dp = wgmma_padded_dim(d, elem_bytes)
    fits = [w for w in WGMMA_WIDTHS if _wgmma_smem(w, dp) <= WGMMA_SMEM]
    if not fits:
        raise ValueError(f"no wgmma query block fits D={d}")
    return fits[-1]


def wgmma_width(b: int, d: int = 128, elem_bytes: int = 2) -> int:
    """Queries per block of a wgmma launch: the narrowest width that holds
    the batch, else blocks of the widest one that fits width `d`
    (wgmma_max_width)."""
    most = wgmma_max_width(d, elem_bytes)
    return next((w for w in WGMMA_WIDTHS if w >= b and w <= most), most)


def scan_variant(b: int, n: int, d: int, k: int, aligned: bool,
                 kernel: str = "fused_scan") -> str:
    """Which variant of a fused scan serves a call: "wgmma" (the
    producer/consumer ring of csrc/scan_wgmma.cuh, wgmma_width(B, D)
    queries a block) for the shapes it takes (wgmma_takes) at the sizes
    where it measured faster (WGMMA_FROM and WGMMA_SMALL_K for the
    whole-tile widths, WGMMA_FROM_WIDE for the chunked loop), else "mma"
    (the mma.sync kernel, which takes every shape: k up to 512, any D,
    unaligned rows). A pure
    function of the shape, the alignment and the kernel ("fused_scan",
    K1, or "fused_codes_scan", K2)."""
    if kernel not in KERNEL_NAMES:
        raise ValueError(f"kernel must be one of {KERNEL_NAMES}, got {kernel!r}")
    if not wgmma_takes(b, d, k, aligned):
        return "mma"
    if wgmma_chunked(d):
        sizes = WGMMA_FROM_WIDE[kernel]
    else:
        lo, hi = WGMMA_SMALL_K_BATCHES
        if k <= WGMMA_SMALL_K and lo <= b <= hi:
            return "mma"
        sizes = WGMMA_FROM[kernel]
    return "wgmma" if any(n >= rows and b >= queries for rows, queries in sizes) else "mma"


def wgmma_k_order(d: int, elem_bytes: int) -> list[int]:
    """Column order of the query operand of the wgmma variants: position
    j of the permuted queries holds dim order[j].

    A lane of the kernel reads its rows 16 bytes at a time, which hold
    L = 4 (int8) or 2 (bf16) k-steps' worth of its fragment: within a
    segment of L k-steps starting at dim `base`, position
    16 s + 8 half + 2 t + e of k-step s (t < 4 the lane, half and e < 2)
    is dim base + 4 L t + 4 s + 2 half + e. The remainder of D / 16 runs
    through shorter loads (L = 2, then 1). Queries and rows are permuted
    alike, so every dot product is unchanged."""
    if d % 16 or elem_bytes not in (1, 2):
        raise ValueError("wgmma_k_order: D must be a multiple of 16, elements 1 or 2 bytes")
    order: list[int] = []
    base, left, seg = 0, d // 16, 4 // elem_bytes
    while left:
        while seg > left:
            seg //= 2
        for s_ in range(seg):
            for pos in range(16):
                half, t, e = pos // 8, (pos % 8) // 2, pos % 2
                order.append(base + 4 * seg * t + 4 * s_ + 2 * half + e)
        base += 16 * seg
        left -= seg
    return order



def wgmma_layout(d: int, elem_bytes: int) -> list[int]:
    """Column order of the query operand of a wgmma launch at width `d`:
    position j of the operand holds column order[j] of the queries
    zero-padded to wgmma_padded_dim(d). The whole-tile widths take
    wgmma_k_order(d) (the rows' loads run over the whole row); the
    chunked loop reads each chunk of a row with the loads of a
    WGMMA_CHUNK_BYTES-byte row, so each chunk takes that order, shifted
    to the chunk."""
    if not wgmma_chunked(d):
        return wgmma_k_order(d, elem_bytes)
    chunk = WGMMA_CHUNK_BYTES // elem_bytes
    one = wgmma_k_order(chunk, elem_bytes)
    return [c + j for c in range(0, wgmma_padded_dim(d, elem_bytes), chunk) for j in one]


def wgmma_plan(b: int, n: int, sms: int, tile_multiple: int = 1,
               nq: int | None = None) -> tuple[int, int]:
    """(S, rows_per_split) of a wgmma launch with `nq` queries a block
    (by default wgmma_width(b)): query blocks x S splits fill the card's
    `sms` SMs in one wave, one block per SM, and S is at most
    WGMMA_MAX_SPLITS; a split is a whole number of tiles, and a multiple
    of `tile_multiple` of them (8 with a group term, which the kernel then
    reads 16 bytes at a time)."""
    nq = wgmma_width(b) if nq is None else nq
    if nq not in WGMMA_WIDTHS:
        raise ValueError(f"nq must be one of {WGMMA_WIDTHS}, got {nq}")
    qblocks = _ceil_div(b, nq)
    ntiles = max(1, _ceil_div(n, WGMMA_TILE))
    s = max(1, min(sms // qblocks, ntiles, WGMMA_MAX_SPLITS))
    tiles_per_split = _ceil_div(_ceil_div(ntiles, s), tile_multiple) * tile_multiple
    return _ceil_div(ntiles, tiles_per_split), tiles_per_split * WGMMA_TILE


def pad_row_term(vn: torch.Tensor) -> torch.Tensor:
    """The row term padded with MASKED to a whole number of tiles, so
    that the kernel copies 128 of them per tile and the rows of a ragged
    last tile never enter (the row term itself when N is a whole number
    of tiles already)."""
    pad = -vn.shape[0] % WGMMA_TILE
    return torch.nn.functional.pad(vn, (0, pad), value=MASKED) if pad else vn


def wgmma_operands(q: torch.Tensor, vn: torch.Tensor, elem_bytes: int) -> tuple:
    """The host-side inputs of a wgmma launch, the same for every query
    block width: the queries [B, D] zero-padded to wgmma_padded_dim and
    their columns in wgmma_layout, and the row term padded with MASKED to
    whole tiles."""
    d = q.shape[1]
    pad = wgmma_padded_dim(d, elem_bytes) - d
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
    return q.index_select(1, _k_order_on(d, elem_bytes, q.device)), pad_row_term(vn)


def _merge_splits(out_d, out_i, k, clamp_zero):
    """The S*k per-split candidates -> the k best (the JAX wrapper's
    top_k over the kernel's candidate registers)."""
    b = out_d.shape[0]
    d_all, pos = torch.topk(out_d.view(b, -1), k, dim=1, largest=False)
    i_all = torch.gather(out_i.view(b, -1), 1, pos)
    return _finish(d_all, i_all, clamp_zero)


_K_ORDER: dict = {}  # (D, element bytes, device) -> wgmma_layout as a device tensor


def _k_order_on(d: int, elem_bytes: int, device: torch.device) -> torch.Tensor:
    key = (d, elem_bytes, device)
    if key not in _K_ORDER:
        _K_ORDER[key] = torch.tensor(wgmma_layout(d, elem_bytes), device=device)
    return _K_ORDER[key]


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _prepare(queries, corpus, corpus_norms_sq, valid, k, metric, extra_mask,
             normalize, device):
    """Shared front of both versions: validation, the mask fold into
    the norm row, and the queries rounded to the corpus dtype BEFORE
    |q|^2 is taken (the scan's products use the rounded queries)."""
    metric = Metric.validate(metric)
    if metric in (Metric.COSINE, Metric.HAMMING):
        raise ValueError(
            "fused_flat_search: l2 or dot only (pre-normalize and use l2 "
            "for cosine)"
        )
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused_flat_search supports 1 <= k <= {MAX_K}, got {k}")
    dev = resolve_device(device)
    corpus = torch.as_tensor(corpus, device=dev)
    q = torch.as_tensor(queries, device=dev).float()
    if q.ndim == 1:
        q = q[None, :]
    if q.shape[1] != corpus.shape[1]:
        raise ValueError(f"query dim {q.shape[1]} != corpus dim {corpus.shape[1]}")
    if normalize:
        q = normalize_rows(q)
    valid = torch.as_tensor(valid, device=dev).bool()
    if extra_mask is not None:
        valid = valid & torch.as_tensor(extra_mask, device=dev).bool()
    l2 = metric == Metric.L2
    base = (
        torch.as_tensor(corpus_norms_sq, device=dev).float()
        if l2
        else torch.zeros(corpus.shape[0], device=dev)
    )
    vn = torch.where(valid, base, MASKED)
    qc = q.to(corpus.dtype)
    qf = qc.float()
    qn = (qf * qf).sum(dim=1) if l2 else torch.zeros(q.shape[0], device=dev)
    return corpus, qc, qn, vn, l2


def _finish(d, i, l2):
    """Canonical masked slots (exactly (MASKED, -1)) and l2 clamped at 0."""
    ghost = d >= MASKED_GUARD
    d = torch.where(ghost, MASKED, d)
    i = torch.where(ghost, -1, i)
    if l2:
        d = torch.clamp_min(d, 0.0)
    return d, i


def fused_flat_search_plain(
    queries, corpus, corpus_norms_sq, valid, k, metric=Metric.L2, *,
    extra_mask=None, normalize=False, chunk_rows=131072, device=None,
):
    """Plain PyTorch version of K1: the same scores from the queries
    rounded to the corpus dtype and upcast to f32 (products of bf16
    values are exact in f32), a chunked matmul and torch.topk. Takes a
    bf16 or f32 corpus. Returns (dist [B, k] f32, idx [B, k] int32)."""
    corpus, qc, qn, vn, l2 = _prepare(
        queries, corpus, corpus_norms_sq, valid, k, metric, extra_mask,
        normalize, device,
    )
    return _plain_scan(corpus, qc, qn, vn, k, l2, chunk_rows)


def _plain_scan(corpus, qc, qn, vn, k, l2, chunk_rows=131072, group_term=None,
                clamp_zero=None):
    """Scores in f32 from the rounded queries, chunk by chunk, with a
    running top-k. l2 picks the score form (qn - 2 q.v + vn, else
    vn - q.v); group_term [B, N / GROUP] is added per row group; the
    result is clamped at 0 when clamp_zero (by default: when l2)."""
    full_f32_matmul()
    qf = qc.float()
    n, b = corpus.shape[0], qf.shape[0]
    best_d = torch.full((b, 0), MASKED, device=qf.device)
    best_i = torch.full((b, 0), -1, dtype=torch.int64, device=qf.device)
    for start in range(0, n, chunk_rows):
        end = min(start + chunk_rows, n)
        ip = qf @ corpus[start:end].float().T
        s = (qn[:, None] - 2.0 * ip if l2 else -ip) + vn[None, start:end]
        if group_term is not None:
            groups = torch.arange(start, end, device=qf.device) // GROUP
            s = s + group_term[:, groups].float()
        d, i = torch.topk(s, min(k, end - start), dim=1, largest=False)
        d = torch.cat([best_d, d], dim=1)
        i = torch.cat([best_i, i + start], dim=1)
        d, pos = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
        best_d, best_i = d, torch.gather(i, 1, pos)
    if best_d.shape[1] < k:  # fewer rows than k: ghost slots
        pad = k - best_d.shape[1]
        best_d = torch.cat([best_d, torch.full((b, pad), MASKED, device=qf.device)], 1)
        best_i = torch.cat(
            [best_i, torch.full((b, pad), -1, dtype=torch.int64, device=qf.device)], 1
        )
    return _finish(best_d, best_i.int(), l2 if clamp_zero is None else clamp_zero)


@functools.lru_cache(maxsize=4096)
def mma_plan(kernel, entry: str, dev: int, b: int, n: int, d: int, k: int) -> tuple:
    """The mma.sync launch plan (tiling, S, rows per split, CAP, shared
    memory bytes) of one shape from `kernel`'s library function `entry`
    (choose_plan in csrc/scan_common.cuh), asked once a shape."""
    plan = (ctypes.c_int * 5)()
    err = getattr(kernel.lib(), entry)(dev, b, n, d, k, plan)
    if err != 0:
        raise KernelError(
            f"{kernel.name}: no tiling fits shared memory for D={d}, k={k} (code {err})"
        )
    return tuple(plan)


def _split_best(b: int, s: int, nq: int, device) -> torch.Tensor:
    """Room for where the S splits of a wgmma launch tell each other how
    good their rows are ([B, S] bounds), then a count a query block of the
    splits that have published their first slot; go() fills it with
    ordered_bits(MASKED_GUARD) before each launch."""
    return torch.empty((b * s + _ceil_div(b, nq),), dtype=torch.int32, device=device)


def _go(entry, args: tuple, keep: tuple, what: str, split_best=None):
    """A launch of `entry` on `args` (pointers into `keep`'s tensors, held
    here), re-arming `split_best` first."""
    guard = ordered_bits(MASKED_GUARD)

    def go():
        if split_best is not None:
            split_best.fill_(guard)
        err = entry(*args)
        if err != 0:
            raise KernelError(f"{what} launch failed: code {err}")
        return keep
    return go


def flat_launcher(kernel, variant, corpus, qc, qn, vn, k, l2):
    """K1's launch of `variant` ("mma" or "wgmma") from `kernel`'s library
    on contiguous CUDA tensors, in two: the host-side set-up, done here
    once (for wgmma: the queries' columns into wgmma_k_order, the row term
    padded to whole tiles, wgmma_plan's split in blocks of wgmma_width(B)
    queries; for mma: mma_plan), and go(), which launches the kernel on
    it, so that a timing can launch the kernel alone.
    -> (go, out_d [B, S, k] f32, out_i [B, S, k] int32). Counts nothing."""
    n, d = corpus.shape
    b = qc.shape[0]
    lib = kernel.lib()
    dev = _device_index(corpus)
    stream = torch.cuda.current_stream(corpus.device).cuda_stream
    if variant == "mma":
        cfg, s, rows_per_split, cap, smem = mma_plan(kernel, "longbow_fused_scan_plan", dev, b,
                                                     n, d, k)
        out_d = torch.empty((b, s, k), dtype=torch.float32, device=corpus.device)
        out_i = torch.empty((b, s, k), dtype=torch.int32, device=corpus.device)
        args = (dev, qc.data_ptr(), qn.data_ptr(), corpus.data_ptr(), vn.data_ptr(),
                b, n, d, k, int(l2), cfg, s, rows_per_split, cap, smem,
                out_d.data_ptr(), out_i.data_ptr(), stream)
        keep = (corpus, qc, qn, vn, out_d, out_i)
        return _go(lib.longbow_fused_scan, args, keep, "fused_scan"), out_d, out_i
    qp, vnp = wgmma_operands(qc, vn, 2)
    nq = wgmma_width(b, d, 2)
    s, rows_per_split = wgmma_plan(b, n, _sm_count(corpus.device), nq=nq)
    out_d = torch.empty((b, s, k), dtype=torch.float32, device=corpus.device)
    out_i = torch.empty((b, s, k), dtype=torch.int32, device=corpus.device)
    split_best = _split_best(b, s, nq, corpus.device)
    args = (dev, qp.data_ptr(), qn.data_ptr(), corpus.data_ptr(), vnp.data_ptr(), b, n, d, k,
            int(l2), nq, s, rows_per_split, split_best.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), stream)
    keep = (corpus, qp, qn, vnp, split_best, out_d, out_i)
    go = _go(lib.longbow_fused_scan_wgmma, args, keep,
             f"fused_scan (wgmma) for D={d}, k={k}, nq={nq}", split_best)
    return go, out_d, out_i


def launch_flat_mma(kernel, corpus, qc, qn, vn, k, l2):
    """Launch the mma.sync variant of K1 (flat_launcher).
    -> (out_d [B, S, k] f32, out_i [B, S, k] int32). Counts nothing."""
    go, out_d, out_i = flat_launcher(kernel, "mma", corpus, qc, qn, vn, k, l2)
    go()
    return out_d, out_i


def launch_flat_wgmma(kernel, corpus, qc, qn, vn, k, l2):
    """Launch the wgmma variant of K1 (flat_launcher). Same returns as
    launch_flat_mma."""
    go, out_d, out_i = flat_launcher(kernel, "wgmma", corpus, qc, qn, vn, k, l2)
    go()
    return out_d, out_i


def _pick_variant(variant, b, n, d, k, aligned, kernel="fused_scan"):
    chosen = scan_variant(b, n, d, k, aligned, kernel)
    if variant is None:
        return chosen
    if variant not in ("mma", "wgmma"):
        raise ValueError(f"variant must be 'mma', 'wgmma' or None, got {variant!r}")
    if variant == "wgmma" and not wgmma_takes(b, d, k, aligned):
        raise ValueError(f"the wgmma variant does not take B={b}, D={d}, k={k}, aligned={aligned}")
    return variant


def _fused_flat_search_cuda(corpus, qc, qn, vn, k, l2, variant=None):
    if corpus.dtype != torch.bfloat16:
        raise ValueError(
            "the CUDA fused scan takes a bfloat16 corpus (f32 storage is "
            "served by exact_search)"
        )
    if corpus.ndim != 2 or not corpus.is_contiguous():
        raise ValueError("the CUDA fused scan needs a contiguous [N, D] corpus")
    n, d = corpus.shape
    b = qc.shape[0]
    if max(n, b) >= 2**30:  # row and split arithmetic is 32-bit in the kernel
        raise ValueError("the CUDA fused scan takes fewer than 2**30 rows and queries")
    if vn.shape != (n,):
        raise ValueError(f"norms/valid must have shape [{n}], got {tuple(vn.shape)}")
    qc, qn, vn = qc.contiguous(), qn.contiguous(), vn.contiguous()
    if vn.data_ptr() % 16:  # the kernel copies the norm row 16 bytes at a time
        vn = vn.clone()
    variant = _pick_variant(variant, b, n, d, k, corpus.data_ptr() % 16 == 0)
    launch = launch_flat_wgmma if variant == "wgmma" else launch_flat_mma
    out_d, out_i = launch(FUSED_SCAN, corpus, qc, qn, vn, k, l2)
    FUSED_SCAN.count_launch(variant)
    return _merge_splits(out_d, out_i, k, l2)


def fused_flat_search(
    queries, corpus, corpus_norms_sq, valid, k, metric=Metric.L2, *,
    extra_mask=None, normalize=False, device=None, variant=None,
):
    """Flat k-NN through the fused scan.

    queries [B, D] (f32 or bf16; cast to the corpus dtype), corpus
    [N, D], corpus_norms_sq [N] f32 |v|^2 of the stored rows (read for
    l2 only), valid [N] bool (False rows are never returned),
    extra_mask [N] bool (a filter folded into valid).
    Returns (dist [B, k] f32, idx [B, k] int32), ascending; unfilled or
    masked slots are exactly (MASKED, -1); l2 distances are >= 0.
    k <= 512. CUDA tensors run the kernel (bf16 corpus only), in the
    variant scan_variant names for the shape; variant="mma" or "wgmma"
    asks for one (wgmma raises on a shape it does not take). CPU tensors
    run fused_flat_search_plain.
    """
    corpus_t, qc, qn, vn, l2 = _prepare(
        queries, corpus, corpus_norms_sq, valid, k, metric, extra_mask,
        normalize, device,
    )
    if corpus_t.device.type == "cuda":
        return _fused_flat_search_cuda(corpus_t, qc, qn, vn, k, l2, variant)
    if corpus_t.device.type != "cpu":
        raise ValueError(f"fused_flat_search: unsupported device {corpus_t.device}")
    return _plain_scan(corpus_t, qc, qn, vn, k, l2)


def _prepare_codes(qs, qn_eff, codes, vn_row, valid, k, group_term, extra_mask,
                   device):
    """Shared front of both K2 versions: validation, the mask fold into
    the row term, and the query side rounded to bf16."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused_codes_search supports 1 <= k <= {MAX_K}, got {k}")
    dev = resolve_device(device)
    codes = torch.as_tensor(codes, device=dev)
    if codes.dtype != torch.int8 or codes.ndim != 2:
        raise ValueError("fused_codes_search: codes must be [N, D] int8 (stored u8 - 128)")
    n = codes.shape[0]
    qs = torch.as_tensor(qs, device=dev)
    if qs.ndim == 1:
        qs = qs[None, :]
    if qs.shape[1] != codes.shape[1]:
        raise ValueError(f"query dim {qs.shape[1]} != code dim {codes.shape[1]}")
    b = qs.shape[0]
    qn = torch.as_tensor(qn_eff, device=dev).float().reshape(b)
    valid = torch.as_tensor(valid, device=dev).bool()
    if extra_mask is not None:
        valid = valid & torch.as_tensor(extra_mask, device=dev).bool()
    base = torch.as_tensor(vn_row, device=dev).float()
    vn = torch.where(valid, base, MASKED)
    gt = None
    if group_term is not None:
        gt = torch.as_tensor(group_term, device=dev)
        if n % GROUP or tuple(gt.shape) != (b, n // GROUP):
            raise ValueError(
                f"group_term requires N % {GROUP} == 0 and shape [B, N // {GROUP}] "
                f"(got N={n}, gt={tuple(gt.shape)})"
            )
        if gt.dtype not in (torch.float32, torch.bfloat16):
            gt = gt.float()
    return codes, qs.to(torch.bfloat16), qn, vn, gt


def fused_codes_search_plain(
    qs, qn_eff, codes, vn_row, valid, k, *, group_term=None, extra_mask=None,
    neg_slack=0.0, clamp_zero=True, chunk_rows=131072, device=None,
):
    """Plain PyTorch version of K2: the bf16-rounded query side and the
    codes upcast to f32 (their products are exact), a chunked matmul and
    torch.topk, with the same masks, group term, clamp and ghost rules.
    Returns (score [B, k] f32, row [B, k] int32)."""
    codes, qs, qn, vn, gt = _prepare_codes(
        qs, qn_eff, codes, vn_row, valid, k, group_term, extra_mask, device,
    )
    return _plain_scan(codes, qs, qn, vn, k, True, chunk_rows, gt, clamp_zero)


def codes_launcher(kernel, variant, codes, qs, qn, vn, gt, k):
    """K2's launch of `variant` from `kernel`'s library on contiguous CUDA
    tensors, in two as flat_launcher's (the group term gt [B, N / 128] f32
    or bf16, or None). -> (go, out_d [B, S, k] f32, out_i [B, S, k] int32).
    Counts nothing."""
    n, d = codes.shape
    b = qs.shape[0]
    lib = kernel.lib()
    dev = _device_index(codes)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    gt_kind, gt_ptr = 0, None
    if gt is not None:
        gt_kind, gt_ptr = (1 if gt.dtype == torch.float32 else 2), gt.data_ptr()
    if variant == "mma":
        cfg, s, rows_per_split, cap, smem = mma_plan(kernel, "longbow_fused_codes_scan_plan",
                                                     dev, b, n, d, k)
        out_d = torch.empty((b, s, k), dtype=torch.float32, device=codes.device)
        out_i = torch.empty((b, s, k), dtype=torch.int32, device=codes.device)
        args = (dev, qs.data_ptr(), qn.data_ptr(), codes.data_ptr(), vn.data_ptr(),
                gt_ptr, gt_kind, n // GROUP, b, n, d, k, cfg, s, rows_per_split, cap,
                smem, out_d.data_ptr(), out_i.data_ptr(), stream)
        keep = (codes, qs, qn, vn, gt, out_d, out_i)
        return _go(lib.longbow_fused_codes_scan, args, keep, "fused_codes_scan"), out_d, out_i
    qp, vnp = wgmma_operands(qs, vn, 1)
    nq = wgmma_width(b, d, 1)
    s, rows_per_split = wgmma_plan(b, n, _sm_count(codes.device), 8 if gt is not None else 1,
                                   nq=nq)
    out_d = torch.empty((b, s, k), dtype=torch.float32, device=codes.device)
    out_i = torch.empty((b, s, k), dtype=torch.int32, device=codes.device)
    split_best = _split_best(b, s, nq, codes.device)
    args = (dev, qp.data_ptr(), qn.data_ptr(), codes.data_ptr(), vnp.data_ptr(), gt_ptr,
            gt_kind, n // GROUP, b, n, d, k, nq, s, rows_per_split, split_best.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), stream)
    keep = (codes, qp, qn, vnp, gt, split_best, out_d, out_i)
    go = _go(lib.longbow_fused_codes_scan_wgmma, args, keep,
             f"fused_codes_scan (wgmma) for D={d}, k={k}, nq={nq}", split_best)
    return go, out_d, out_i


def launch_codes_mma(kernel, codes, qs, qn, vn, gt, k):
    """Launch the mma.sync variant of K2 (codes_launcher).
    -> (out_d [B, S, k] f32, out_i [B, S, k] int32). Counts nothing."""
    go, out_d, out_i = codes_launcher(kernel, "mma", codes, qs, qn, vn, gt, k)
    go()
    return out_d, out_i


def launch_codes_wgmma(kernel, codes, qs, qn, vn, gt, k):
    """Launch the wgmma variant of K2 (codes_launcher). Same returns as
    launch_codes_mma."""
    go, out_d, out_i = codes_launcher(kernel, "wgmma", codes, qs, qn, vn, gt, k)
    go()
    return out_d, out_i


def _fused_codes_search_cuda(codes, qs, qn, vn, gt, k, clamp_zero, variant=None):
    if not codes.is_contiguous():
        raise ValueError("the CUDA codes scan needs contiguous [N, D] codes")
    n, d = codes.shape
    b = qs.shape[0]
    if max(n, b) >= 2**30:  # row and split arithmetic is 32-bit in the kernel
        raise ValueError("the CUDA codes scan takes fewer than 2**30 rows and queries")
    qs, qn, vn = qs.contiguous(), qn.contiguous(), vn.contiguous()
    if vn.data_ptr() % 16:  # the kernel copies the row term 16 bytes at a time
        vn = vn.clone()
    if gt is not None:
        gt = gt.contiguous()
    variant = _pick_variant(variant, b, n, d, k, codes.data_ptr() % 16 == 0, "fused_codes_scan")
    launch = launch_codes_wgmma if variant == "wgmma" else launch_codes_mma
    out_d, out_i = launch(FUSED_CODES_SCAN, codes, qs, qn, vn, gt, k)
    FUSED_CODES_SCAN.count_launch(variant)
    return _merge_splits(out_d, out_i, k, clamp_zero)


def fused_codes_search(
    qs, qn_eff, codes, vn_row, valid, k, *, group_term=None, extra_mask=None,
    neg_slack=0.0, clamp_zero=True, device=None, variant=None,
):
    """k-NN over int8 quantized codes through the fused codes scan.

    The caller folds its dequantization into the query side; the scan
    scores
        score[b, n] = qn_eff[b] - 2 qs[b].codes[n] + vn_row[n]
                      (+ group_term[b, n // 128] when given)
    qs [B, D] (rounded to bf16), qn_eff [B] f32, codes [N, D] int8
    (stored u8 - 128), vn_row [N] f32, valid [N] bool, extra_mask [N]
    bool (folded into valid), group_term [B, N // 128] f32 or bf16
    (N % 128 == 0). Returns (score [B, k] f32 including every term,
    row [B, k] int32), ascending; masked or unfilled slots are exactly
    (MASKED, -1); clamp_zero=True clamps the scores at 0 (the l2 folds).
    k <= 512. neg_slack is accepted for the JAX signature and has no
    effect: scores are compared as floats, with no positivity bias.
    CUDA tensors run the kernel, in the variant scan_variant names for
    the shape; variant="mma" or "wgmma" asks for one (wgmma raises on a
    shape it does not take). CPU tensors run fused_codes_search_plain.
    """
    codes_t, qs_t, qn, vn, gt = _prepare_codes(
        qs, qn_eff, codes, vn_row, valid, k, group_term, extra_mask, device,
    )
    if codes_t.device.type == "cuda":
        return _fused_codes_search_cuda(codes_t, qs_t, qn, vn, gt, k, clamp_zero, variant)
    if codes_t.device.type != "cpu":
        raise ValueError(f"fused_codes_search: unsupported device {codes_t.device}")
    return _plain_scan(codes_t, qs_t, qn, vn, k, True, group_term=gt, clamp_zero=clamp_zero)


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order (zero-padded to a
    power of two), by elementwise adds only: a row's sum is the same bits
    whatever batch it is computed in, where a reduction kernel's or a
    matmul's order depends on the tensor's shape."""
    w = x.shape[-1]
    p = 1 << max(w - 1, 0).bit_length()
    if p != w:
        x = torch.nn.functional.pad(x, (0, p - w))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def rerank_distances(qf: torch.Tensor, cand: torch.Tensor, l2: bool) -> torch.Tensor:
    """Exact f32 distances of queries [B, D] to their candidates [B, P, D]:
    l2 as the sum of squared differences, else -q.v, summed by row_sum.
    A query's distances are then the same bits alone and inside a
    coalesced batch; |q|^2 - 2 q.v + |v|^2 through einsum (the
    reference's form) differed by 8e-6 relative between the two on an
    H100, its rounding magnified by the cancellation
    (tools/probe_rerank.py)."""
    if l2:
        diff = qf[:, None, :] - cand
        return row_sum(diff * diff)
    return -row_sum(qf[:, None, :] * cand)


def flat_search_rerank(
    queries, corpus, corpus_norms_sq, valid, k, metric=Metric.L2, *,
    pool: int = 64, extra_mask=None, normalize=False, device=None,
):
    """Fused scan for a pool of max(pool, k) candidates, then an exact
    float32 re-rank of the pool against the stored rows. The re-rank
    removes the bf16 query rounding of the scan; what remains is the bf16
    rounding of the stored rows. A query's distances do not depend on
    the batch it came in (rerank_distances)."""
    pool = max(pool, k)
    dev = resolve_device(device)
    corpus = torch.as_tensor(corpus, device=dev)
    d, i = fused_flat_search(
        queries, corpus, corpus_norms_sq, valid, pool, metric,
        extra_mask=extra_mask, normalize=normalize, device=dev,
    )
    cand = corpus[i.clamp_min(0).long()].float()  # [B, pool, D]
    qf = torch.as_tensor(queries, device=dev).float()
    if qf.ndim == 1:
        qf = qf[None, :]
    if normalize:
        qf = normalize_rows(qf)
    ed = rerank_distances(qf, cand, Metric.validate(metric) == Metric.L2)
    ed = torch.where(d < MASKED_GUARD, ed, torch.full_like(ed, MASKED))
    vals, pos = torch.topk(ed, k, dim=1, largest=False)
    return vals, torch.gather(i, 1, pos)


def coarse_flat_search_rerank(
    queries, corpus, codes, lo, hi, coarse_norms_sq, valid, k, metric=Metric.L2, *,
    pool: int = 64, extra_mask=None, normalize=False, device=None,
):
    """The flat tier's coarse int8 shadow: K2 (fused_codes_search) picks a
    pool of max(pool, k) rows from the int8 codes under the query-side
    fold of the codes' affine, then the pool is re-ranked exactly in f32
    against the bf16 rows, by the same fixed-order sums as
    flat_search_rerank (rerank_distances).

    codes [N, D] int8 (stored u8 - 128) of the stored rows under the
    per-dimension affine lo, hi [D]; coarse_norms_sq [N] the norms of the
    dequantized codes. l2 and cosine only (cosine is normalize=True and
    l2); dot raises ValueError. Returns (dist [B, k] f32, row [B, k]
    int32), ascending, masked slots (MASKED, -1)."""
    metric = Metric.validate(metric)
    if metric == Metric.DOT:
        raise ValueError("coarse_flat_search_rerank: l2/cosine only")
    dev = resolve_device(device)
    q = torch.as_tensor(queries, device=dev).float()
    if q.ndim == 1:
        q = q[None, :]
    if normalize:
        q = normalize_rows(q)
    pool = max(pool, k)
    full_f32_matmul()
    lo = torch.as_tensor(lo, device=dev).float()
    hi = torch.as_tensor(hi, device=dev).float()
    # the affine folded into the query side: v ~ codes * scale + lo_eff
    scale = torch.clamp_min(hi - lo, 1e-12) / 255.0
    lo_eff = lo + 128.0 * scale
    qs = q * scale[None, :]
    qn_eff = (q * q).sum(dim=1) - 2.0 * (q @ lo_eff)
    d, i = fused_codes_search(
        qs, qn_eff, codes, coarse_norms_sq, valid, pool, extra_mask=extra_mask, device=dev,
    )
    corpus = torch.as_tensor(corpus, device=dev)
    cand = corpus[i.clamp_min(0).long()].float()  # [B, pool, D]
    ed = rerank_distances(q, cand, True)
    ed = torch.where(d < MASKED_GUARD, ed, torch.full_like(ed, MASKED))
    vals, pos = torch.topk(ed, k, dim=1, largest=False)
    idx = torch.gather(i, 1, pos)
    idx = torch.where(vals < MASKED_GUARD, idx, torch.full_like(idx, -1))
    return vals, idx
