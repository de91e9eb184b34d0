"""Fused flat scan (kernel K1), the exact re-rank of its pool, and the
fused scan over int8 codes (kernel K2).

Counterpart of longbow_tpu/ops/pallas_scan.py::fused_flat_search,
::flat_search_rerank and ::fused_codes_search. On a CUDA tensor
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

import torch

from longbow_tpu_torch.device import resolve_device
from longbow_tpu_torch.ops._kernels import FUSED_CODES_SCAN, FUSED_SCAN
from longbow_tpu_torch.ops.distance import (
    MASKED,
    MASKED_GUARD,
    Metric,
    full_f32_matmul,
    normalize_rows,
)

MAX_K = 512
GROUP = 128  # rows per entry of K2's group term


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
    vn = torch.where(valid, base, torch.full_like(base, MASKED))
    qc = q.to(corpus.dtype)
    qf = qc.float()
    qn = (qf * qf).sum(dim=1) if l2 else torch.zeros(q.shape[0], device=dev)
    return corpus, qc, qn, vn, l2


def _finish(d, i, l2):
    """Canonical masked slots (exactly (MASKED, -1)) and l2 clamped at 0."""
    ghost = d >= MASKED_GUARD
    d = torch.where(ghost, torch.full_like(d, MASKED), d)
    i = torch.where(ghost, torch.full_like(i, -1), i)
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


def _fused_flat_search_cuda(corpus, qc, qn, vn, k, l2):
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
    lib = FUSED_SCAN.lib()
    dev = corpus.device.index if corpus.device.index is not None else torch.cuda.current_device()
    plan = (ctypes.c_int * 5)()
    err = lib.longbow_fused_scan_plan(dev, b, n, d, k, plan)
    if err != 0:
        raise RuntimeError(
            f"fused_scan: no tiling fits shared memory for D={d}, k={k} (code {err})"
        )
    cfg, s, rows_per_split, cap, smem = list(plan)
    out_d = torch.empty((b, s, k), dtype=torch.float32, device=corpus.device)
    out_i = torch.empty((b, s, k), dtype=torch.int32, device=corpus.device)
    stream = torch.cuda.current_stream(corpus.device).cuda_stream
    err = lib.longbow_fused_scan(
        dev, qc.data_ptr(), qn.data_ptr(), corpus.data_ptr(), vn.data_ptr(),
        b, n, d, k, int(l2), cfg, s, rows_per_split, cap, smem,
        out_d.data_ptr(), out_i.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_scan launch failed: cudaError {err}")
    FUSED_SCAN.count_launch()
    # the S*K per-split candidates -> the k best (the JAX wrapper's
    # top_k over the kernel's candidate registers)
    d_all, pos = torch.topk(out_d.view(b, s * k), k, dim=1, largest=False)
    i_all = torch.gather(out_i.view(b, s * k), 1, pos)
    return _finish(d_all, i_all, l2)


def fused_flat_search(
    queries, corpus, corpus_norms_sq, valid, k, metric=Metric.L2, *,
    extra_mask=None, normalize=False, device=None,
):
    """Flat k-NN through the fused scan.

    queries [B, D] (f32 or bf16; cast to the corpus dtype), corpus
    [N, D], corpus_norms_sq [N] f32 |v|^2 of the stored rows (read for
    l2 only), valid [N] bool (False rows are never returned),
    extra_mask [N] bool (a filter folded into valid).
    Returns (dist [B, k] f32, idx [B, k] int32), ascending; unfilled or
    masked slots are exactly (MASKED, -1); l2 distances are >= 0.
    k <= 512. CUDA tensors run the kernel (bf16 corpus only); CPU
    tensors run fused_flat_search_plain.
    """
    corpus_t, qc, qn, vn, l2 = _prepare(
        queries, corpus, corpus_norms_sq, valid, k, metric, extra_mask,
        normalize, device,
    )
    if corpus_t.device.type == "cuda":
        return _fused_flat_search_cuda(corpus_t, qc, qn, vn, k, l2)
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
    vn = torch.where(valid, base, torch.full_like(base, MASKED))
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


def _fused_codes_search_cuda(codes, qs, qn, vn, gt, k, clamp_zero):
    if not codes.is_contiguous():
        raise ValueError("the CUDA codes scan needs contiguous [N, D] codes")
    n, d = codes.shape
    b = qs.shape[0]
    if max(n, b) >= 2**30:  # row and split arithmetic is 32-bit in the kernel
        raise ValueError("the CUDA codes scan takes fewer than 2**30 rows and queries")
    qs, qn, vn = qs.contiguous(), qn.contiguous(), vn.contiguous()
    if vn.data_ptr() % 16:  # the kernel copies the row term 16 bytes at a time
        vn = vn.clone()
    gt_kind, gt_ptr = 0, None
    if gt is not None:
        gt = gt.contiguous()
        gt_kind, gt_ptr = (1 if gt.dtype == torch.float32 else 2), gt.data_ptr()
    lib = FUSED_CODES_SCAN.lib()
    dev = codes.device.index if codes.device.index is not None else torch.cuda.current_device()
    plan = (ctypes.c_int * 5)()
    err = lib.longbow_fused_codes_scan_plan(dev, b, n, d, k, plan)
    if err != 0:
        raise RuntimeError(
            f"fused_codes_scan: no tiling fits shared memory for D={d}, k={k} (code {err})"
        )
    cfg, s, rows_per_split, cap, smem = list(plan)
    out_d = torch.empty((b, s, k), dtype=torch.float32, device=codes.device)
    out_i = torch.empty((b, s, k), dtype=torch.int32, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = lib.longbow_fused_codes_scan(
        dev, qs.data_ptr(), qn.data_ptr(), codes.data_ptr(), vn.data_ptr(),
        gt_ptr, gt_kind, n // GROUP, b, n, d, k, cfg, s, rows_per_split, cap,
        smem, out_d.data_ptr(), out_i.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_codes_scan launch failed: cudaError {err}")
    FUSED_CODES_SCAN.count_launch()
    d_all, pos = torch.topk(out_d.view(b, s * k), k, dim=1, largest=False)
    i_all = torch.gather(out_i.view(b, s * k), 1, pos)
    return _finish(d_all, i_all, clamp_zero)


def fused_codes_search(
    qs, qn_eff, codes, vn_row, valid, k, *, group_term=None, extra_mask=None,
    neg_slack=0.0, clamp_zero=True, device=None,
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
    CUDA tensors run the kernel; CPU tensors run
    fused_codes_search_plain.
    """
    codes_t, qs_t, qn, vn, gt = _prepare_codes(
        qs, qn_eff, codes, vn_row, valid, k, group_term, extra_mask, device,
    )
    if codes_t.device.type == "cuda":
        return _fused_codes_search_cuda(codes_t, qs_t, qn, vn, gt, k, clamp_zero)
    if codes_t.device.type != "cpu":
        raise ValueError(f"fused_codes_search: unsupported device {codes_t.device}")
    return _plain_scan(codes_t, qs_t, qn, vn, k, True, group_term=gt, clamp_zero=clamp_zero)


def flat_search_rerank(
    queries, corpus, corpus_norms_sq, valid, k, metric=Metric.L2, *,
    pool: int = 64, extra_mask=None, normalize=False, device=None,
):
    """Fused scan for a pool of max(pool, k) candidates, then an exact
    float32 re-rank of the pool against the stored rows (TF32 off). The
    re-rank removes the bf16 query rounding of the scan; what remains is
    the bf16 rounding of the stored rows."""
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
    full_f32_matmul()
    ip = torch.einsum("bd,bkd->bk", qf, cand)
    if Metric.validate(metric) == Metric.L2:
        qn = (qf * qf).sum(dim=1, keepdim=True)
        cn = (cand * cand).sum(dim=2)
        ed = torch.clamp_min(qn - 2.0 * ip + cn, 0.0)
    else:
        ed = -ip
    ed = torch.where(d < MASKED_GUARD, ed, torch.full_like(ed, MASKED))
    vals, pos = torch.topk(ed, k, dim=1, largest=False)
    return vals, torch.gather(i, 1, pos)
