"""Distances and the exact k-NN oracle on torch tensors.

Counterpart of longbow_tpu/ops/distance.py. All three metrics are
*distances* (smaller is better), so one top-k path serves them:

    l2sq(q, v)    = |q|^2 - 2 q.v + |v|^2
    cosine_d(q,v) = 1 - q.v / (|q||v|)
    dot_d(q, v)   = -q.v

Everything here is plain PyTorch. `exact_search` is the ground truth for
every recall number: it computes in full float32, with TF32 switched off
explicitly on every call (see `full_f32_matmul`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from longbow_tpu_torch.device import resolve_device


class Metric:
    """Distance metric names (the `longbow.metric` schema metadata values)."""

    L2 = "l2"
    COSINE = "cosine"
    DOT = "dot"
    HAMMING = "hamming"

    ALL = (L2, COSINE, DOT, HAMMING)

    @staticmethod
    def validate(metric: str) -> str:
        m = (metric or Metric.L2).lower()
        if m in ("euclidean", "l2sq", "squared_l2"):
            m = Metric.L2
        if m in ("ip", "inner_product", "dotproduct", "dot_product"):
            m = Metric.DOT
        if m not in Metric.ALL:
            raise ValueError(f"unknown metric {metric!r}; want one of {Metric.ALL}")
        return m


# A big-but-finite sentinel for masked-out distances: +inf breaks tie
# handling and NaN propagation in reductions, so masked slots carry a
# large finite value well above any real distance.
MASKED = 3.0e38
# "Is this a real result?" threshold: real distances are below 1e30 by
# many orders of magnitude, and a masked score that absorbed an additive
# term is still far above this.
MASKED_GUARD = 1.0e37


def full_f32_matmul() -> None:
    """Float32 products in full float32. The oracle and the re-rank call
    this before every matmul: with TF32 a float32 product keeps about
    three decimal digits, which reorders near neighbours."""
    torch.backends.cuda.matmul.allow_tf32 = False


def cosine_report(d):
    """Internal l2^2-on-unit-vectors distances -> the declared cosine
    distance 1-cos (= l2^2/2 on unit vectors), leaving masked sentinels
    (>= MASKED_GUARD) intact. Every index kind reports cosine through
    this one helper. numpy in -> numpy out; tensors stay tensors."""
    if isinstance(d, np.ndarray):
        return np.where(d < np.float32(MASKED_GUARD), np.float32(0.5) * d, d)
    return torch.where(d < MASKED_GUARD, 0.5 * d, d)


def complex_as_real(v: torch.Tensor) -> torch.Tensor:
    """Complex [.., D] -> real [.., 2D] by concatenating (real, imag).

    For z, w in C^D: Re(z . conj(w)) = zr.wr + zi.wi, the real dot product
    of the concatenated views, and |z|^2 = |view|^2. So complex l2, cosine
    and (real-part) dot distances are the real ones on the widened view."""
    return torch.cat([v.real, v.imag], dim=-1)


def _canon_dtype(v) -> torch.Tensor:
    """Any supported input as its compute form: complex -> the widened real
    view, float64 -> float32 (as the JAX package computes with x64 off, its
    default). Numpy arrays become tensors on the CPU."""
    v = torch.as_tensor(v)
    if v.is_complex():
        v = complex_as_real(v)
    if v.dtype == torch.float64:
        v = v.float()
    return v


def pad_to(n: int, multiple: int) -> int:
    """Round n up to a multiple."""
    if n <= 0:
        return multiple
    return -(-n // multiple) * multiple


def bucket_queries(q: np.ndarray, cap: int = 4096):
    """Pad a [B, ...] host query batch to the next power-of-two rows
    (batches past `cap` rows are left as they are). Returns
    (padded, original_rows)."""
    b = q.shape[0]
    if b <= 0 or b > cap:
        return q, b
    nb = 1 << (b - 1).bit_length()
    if nb == b:
        return q, b
    out = np.zeros((nb,) + q.shape[1:], q.dtype)
    out[:b] = q
    return out, b


def tombstone_rows(valid: torch.Tensor, rows) -> torch.Tensor:
    """valid[rows] = False, in place; returns `valid`. Rows past the end
    are ignored."""
    rows = torch.as_tensor(np.asarray(rows, np.int64), device=valid.device)
    rows = rows[(rows >= 0) & (rows < valid.shape[0])]
    valid[rows] = False
    return valid


def fit_mask(mask, cap: int, device) -> Optional[torch.Tensor]:
    """A filter mask as a bool tensor on `device`, cut or padded (False)
    to cap rows; None stays None."""
    if mask is None:
        return None
    m = torch.as_tensor(mask, device=device).bool()[:cap]
    if m.shape[0] < cap:
        m = torch.cat([m, torch.zeros(cap - m.shape[0], dtype=torch.bool, device=device)])
    return m


def as_rows(x, device, dim: int) -> torch.Tensor:
    """Rows (a tensor, an array, or one vector) as f32 [n, dim] on
    `device`; another width raises ValueError."""
    if isinstance(x, torch.Tensor):
        v = x.to(device, torch.float32)
    else:
        v = torch.from_numpy(np.ascontiguousarray(np.asarray(x), np.float32)).to(device)
    if v.ndim == 1:
        v = v[None, :]
    if v.ndim != 2 or v.shape[1] != dim:
        raise ValueError(f"expected [n, {dim}] vectors, got {tuple(v.shape)}")
    return v


def squared_norms(v) -> torch.Tensor:
    """Row-wise |v|^2 in float32 (complex rows: |z|^2 through the widened
    real view)."""
    vf = _canon_dtype(v).float()
    return (vf * vf).sum(dim=-1)


def distance_matrix(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    metric: str = Metric.L2,
    *,
    corpus_norms_sq: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """All-pairs distances: queries [B, D] x corpus [N, D] -> [B, N] f32.

    Invalid corpus rows (padding, tombstones, filtered) get MASKED so
    they never survive top-k. corpus_norms_sq: optional precomputed
    |v|^2 [N]; valid: optional bool [N]."""
    metric = Metric.validate(metric)
    if metric == Metric.HAMMING:
        raise ValueError(
            "hamming distance is served by the 'bq' index kind, not "
            "the dense kernels"
        )
    full_f32_matmul()
    q = _canon_dtype(queries).float()
    c = _canon_dtype(corpus).to(q.device).float()
    ip = q @ c.T
    if metric in (Metric.L2, Metric.COSINE):
        vn2 = (
            torch.as_tensor(corpus_norms_sq, device=q.device).float()
            if corpus_norms_sq is not None
            else squared_norms(c)
        )
    if metric == Metric.L2:
        dist = torch.clamp_min(squared_norms(q)[:, None] - 2.0 * ip + vn2[None, :], 0.0)
    elif metric == Metric.COSINE:
        denom = torch.clamp_min(
            torch.sqrt(squared_norms(q))[:, None] * torch.sqrt(vn2)[None, :], 1e-30
        )
        dist = 1.0 - ip / denom
    else:  # DOT
        dist = -ip
    if valid is not None:
        valid = torch.as_tensor(valid, device=q.device).bool()
        dist = torch.where(valid[None, :], dist, torch.full_like(dist, MASKED))
    return dist


def pairwise_distance(a, b, metric: str = Metric.L2) -> torch.Tensor:
    """Distance between row-aligned batches a, b [B, D] -> [B]."""
    metric = Metric.validate(metric)
    if metric == Metric.HAMMING:
        raise ValueError(
            "hamming distance is served by the 'bq' index kind, not "
            "the dense kernels"
        )
    af = _canon_dtype(a).float()
    bf = _canon_dtype(b).to(af.device).float()
    ip = (af * bf).sum(-1)
    if metric == Metric.L2:
        return torch.clamp_min((af * af).sum(-1) - 2 * ip + (bf * bf).sum(-1), 0.0)
    if metric == Metric.COSINE:
        na = torch.sqrt((af * af).sum(-1))
        nb = torch.sqrt((bf * bf).sum(-1))
        return 1.0 - ip / torch.clamp_min(na * nb, 1e-30)
    return -ip


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Unit-norm rows in float32 (zero rows stay zero)."""
    x = x.float()
    return x / torch.clamp_min(torch.linalg.norm(x, dim=1, keepdim=True), 1e-30)


def exact_search(
    queries,
    corpus,
    k: int,
    metric: str = Metric.L2,
    *,
    corpus_norms_sq=None,
    valid=None,
    extra_mask=None,
    normalize: bool = False,
    chunk_rows: int = 131072,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN: queries [B, D] vs corpus [N, D] -> (dist [B, k] f32,
    idx [B, k] int32), ascending; k is cut to N.

    The ground-truth oracle. Scans the corpus in chunks of `chunk_rows`
    with a per-chunk top-k merged into the running best, so peak memory
    is O(B * chunk_rows), not O(B * N). Full float32 (TF32 off)."""
    dev = resolve_device(device)
    # complex corpora ride the real path on a widened view; f64 becomes f32
    q = _canon_dtype(queries).to(dev).float()
    if q.ndim == 1:
        q = q[None, :]
    c = _canon_dtype(corpus).to(dev)
    if normalize:
        q = normalize_rows(q)
    if valid is not None:
        valid = torch.as_tensor(valid, device=dev).bool()
    if extra_mask is not None:
        extra_mask = torch.as_tensor(extra_mask, device=dev).bool()
        valid = extra_mask if valid is None else valid & extra_mask
    norms = (
        torch.as_tensor(corpus_norms_sq, device=dev).float()
        if corpus_norms_sq is not None
        else None
    )
    n = c.shape[0]
    k = min(k, n)
    best_d = best_i = None
    for start in range(0, n, chunk_rows):
        end = min(start + chunk_rows, n)
        dist = distance_matrix(
            q, c[start:end], metric,
            corpus_norms_sq=None if norms is None else norms[start:end],
            valid=None if valid is None else valid[start:end],
        )
        d, i = torch.topk(dist, min(k, end - start), dim=1, largest=False)
        i = i + start
        if best_d is not None:
            d = torch.cat([best_d, d], dim=1)
            i = torch.cat([best_i, i], dim=1)
            d, pos = torch.topk(d, k, dim=1, largest=False)
            i = torch.gather(i, 1, pos)
        best_d, best_i = d, i
    if best_d is None:  # empty corpus
        empty = torch.empty((q.shape[0], 0), device=dev)
        return empty, empty.int()
    return best_d, best_i.int()
