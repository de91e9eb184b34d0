"""Batched k-means (Lloyd iterations) on torch tensors.

Counterpart of longbow_tpu/ops/kmeans.py: G independent problems in one
batch, assignment by a distance matmul and argmin, the update as a sum
per cluster. Products run in full float32 (TF32 off): a rounded distance
moves rows across Voronoi boundaries.
"""
from __future__ import annotations

import torch

from longbow_tpu_torch.ops.distance import full_f32_matmul


def _assign(data: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """[G, N, D] x [G, K, D] -> nearest-centroid ids [G, N]."""
    ip = torch.bmm(data, cent.transpose(1, 2))
    dn = (data * data).sum(dim=2)[:, :, None]
    cn = (cent * cent).sum(dim=2)[:, None, :]
    return torch.argmin(dn - 2.0 * ip + cn, dim=2)


def lloyd(
    data: torch.Tensor,  # [G, N, D] G independent k-means problems
    init: torch.Tensor,  # [G, K, D] initial centroids
    n_iters: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (centroids [G, K, D] f32, assignments [G, N] int64). An empty
    cluster keeps its centroid."""
    full_f32_matmul()
    data = data.float()
    cent = init.float().to(data.device)
    g, n, d = data.shape
    k = cent.shape[1]
    # cluster ids offset per problem, so one index_add_ updates all G
    offset = (torch.arange(g, device=data.device) * k)[:, None]
    flat_data = data.reshape(g * n, d)
    for _ in range(n_iters):
        assign = _assign(data, cent)
        flat = (assign + offset).reshape(-1)
        sums = torch.zeros((g * k, d), device=data.device).index_add_(0, flat, flat_data)
        counts = torch.bincount(flat, minlength=g * k).float()
        new = sums / counts.clamp_min(1.0)[:, None]
        cent = torch.where(counts[:, None] > 0, new, cent.reshape(g * k, d)).reshape(g, k, d)
    return cent, _assign(data, cent)


def kmeans_init(data: torch.Tensor, k: int, seed: int = 0) -> torch.Tensor:
    """Random-subset init for [G, N, D] -> [G, K, D]: k distinct rows,
    the same for every problem, drawn by a torch.Generator seeded with
    `seed`. The rows differ from longbow_tpu's, whose jax.random.choice
    draws from another generator; tests hand both the same init."""
    n = data.shape[1]
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randperm(n, generator=gen)[:k].to(data.device)
    return data[:, idx]
