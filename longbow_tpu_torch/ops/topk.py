"""Top-k selection and merge primitives on torch tensors.

Counterpart of longbow_tpu/ops/topk.py. All functions take *distances*
(smaller is better).
"""
from __future__ import annotations

import torch

from longbow_tpu_torch.ops.distance import MASKED


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
