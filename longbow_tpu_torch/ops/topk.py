"""Top-k selection and merge primitives on torch tensors.

Counterpart of longbow_tpu/ops/topk.py. All functions take *distances*
(smaller is better).
"""
from __future__ import annotations

import torch

from longbow_tpu_torch.ops.distance import MASKED, MASKED_GUARD


def topk_smallest(dist: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k along the last axis -> (dist [..., k], idx [..., k]),
    ascending."""
    return torch.topk(dist, k, dim=-1, largest=False, sorted=True)


def masked_topk(
    dist: torch.Tensor, mask: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis where mask is True; masked slots get MASKED."""
    dist = torch.where(mask, dist, torch.full_like(dist, MASKED))
    return topk_smallest(dist, k)


def merge_topk(
    d1: torch.Tensor,
    i1: torch.Tensor,
    d2: torch.Tensor,
    i2: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two sorted-or-unsorted top-k sets -> best k of the union.
    Works on any leading batch dims."""
    d = torch.cat([d1, d2], dim=-1)
    i = torch.cat([i1, i2], dim=-1)
    vals, pos = topk_smallest(d, k)
    return vals, torch.gather(i, -1, pos)


def dedup_distances(dist: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Mask duplicate indices along the last axis (keep the first
    occurrence): later duplicates get MASKED. O(k^2) compares."""
    k = idx.shape[-1]
    eq = idx[..., :, None] == idx[..., None, :]  # [..., k, k]
    earlier = torch.tril(torch.ones((k, k), dtype=torch.bool, device=idx.device), diagonal=-1)
    is_dup = (eq & earlier).any(dim=-1)
    return torch.where(is_dup, torch.full_like(dist, MASKED), dist)


def sort_by_distance(
    dist: torch.Tensor, idx: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort (dist, idx) pairs ascending by distance along the last axis."""
    order = torch.argsort(dist, dim=-1, stable=True)
    return torch.gather(dist, -1, order), torch.gather(idx, -1, order)


# widths up to this are selected by one stable sort; wider rows by a
# threshold pass (see stable_topk)
_SORT_WIDTH = 2048


def stable_topk(dist: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k along the last axis, ascending, with ties in index
    order (the lower column first) - what jax.lax.top_k gives on the
    negated input, and what torch.topk does not promise. The graph code
    depends on it: MASKED padding and repeated ids tie all the time.

    Narrow rows: one stable sort. Wide rows: the k-th value from
    torch.topk (values are unambiguous, indices are not), then every
    column below it plus the first columns equal to it, and a stable
    sort of those k. -> (dist [..., k], idx [..., k] int64)."""
    w = dist.shape[-1]
    if k > w:
        raise ValueError(f"stable_topk: k={k} exceeds the width {w}")
    if w <= _SORT_WIDTH:
        vals, idx = torch.sort(dist, dim=-1, stable=True)
        return vals[..., :k], idx[..., :k]
    lead = dist.shape[:-1]
    x = dist.reshape(-1, w)
    kth = torch.topk(x, k, dim=1, largest=False).values[:, -1:]
    below = x < kth
    equal = x == kth
    need = k - below.sum(dim=1, keepdim=True)
    keep = below | (equal & (equal.cumsum(dim=1, dtype=torch.int32) <= need))
    cols = keep.nonzero()[:, 1].view(x.shape[0], k)  # ascending per row
    vals, order = torch.sort(x.gather(1, cols), dim=1, stable=True)
    return vals.view(*lead, k), cols.gather(1, order).view(*lead, k)


def later_duplicate(ids: torch.Tensor) -> torch.Tensor:
    """[R, W] ids -> bool [R, W]: True where the same id stands in an
    earlier column of the row (every occurrence but the first). A stable
    sort and a compare of neighbours instead of the W x W compare."""
    s, order = torch.sort(ids, dim=1, stable=True)
    rep = torch.zeros_like(s, dtype=torch.bool)
    rep[:, 1:] = s[:, 1:] == s[:, :-1]
    return torch.zeros_like(rep).scatter_(1, order, rep)


def pad_k(d: torch.Tensor, i: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(d, i) [B, <= k] widened to k columns with (MASKED, -1), and every
    masked slot's id set to -1."""
    if d.shape[1] < k:
        pad = k - d.shape[1]
        d = torch.cat([d, torch.full((d.shape[0], pad), MASKED, device=d.device)], dim=1)
        i = torch.cat([i, torch.full((i.shape[0], pad), -1, dtype=i.dtype, device=i.device)], dim=1)
    return d, torch.where(d < MASKED_GUARD, i, torch.full_like(i, -1))
