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
    if k > n:  # as jax.random.choice without replacement
        raise ValueError(f"kmeans_init: cannot take {k} distinct rows of {n}")
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randperm(n, generator=gen)[:k].to(data.device)
    return data[:, idx]


def nearest_center(v: torch.Tensor, centers: torch.Tensor, chunk: int = 65536) -> torch.Tensor:
    """Nearest-center ids [n] (int64) of rows v [n, D] by argmin of
    |c|^2 - 2 v.c, chunked over rows so that the [chunk, C] distance
    block stays bounded (ties go to the lower id)."""
    full_f32_matmul()
    cn = (centers * centers).sum(dim=1)
    out = [
        torch.argmin(cn[None, :] - 2.0 * (v[s:s + chunk] @ centers.T), dim=1)
        for s in range(0, v.shape[0], chunk)
    ]
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64, device=v.device)
