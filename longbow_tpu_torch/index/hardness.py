"""Distance-concentration probe: is this corpus graph-navigable?

Counterpart of longbow_tpu/index/hardness.py. Graph search collapses on
distance-concentrated data (high intrinsic dimensionality): when the
10-NN distance approaches the mean distance, greedy descent has no
gradient to follow and no edge selection fixes it, while the exact scan
keeps its recall. AdaptiveIndex therefore probes *relative contrast*

    RC = E[d(q, X)] / E[d_k(q)]        (d = squared L2, k = 10)

on a sample of up to 65,536 rows before migrating flat -> graph and stays
on the exact scan when RC is below the threshold. Uniform Gaussian data
at D = 128 sits near 1.5, clustered corpora an order of magnitude above;
2.0 separates them.
"""
from __future__ import annotations

import numpy as np
import torch

from longbow_tpu_torch.ops.distance import full_f32_matmul

# below this relative contrast the flat exact scan beats any graph
# configuration in recall
DEFAULT_MIN_CONTRAST = 2.0


def _rc_kernel(db: torch.Tensor, q: torch.Tensor, k: int) -> torch.Tensor:
    """[S, D], [NQ, D] f32 -> scalar relative contrast."""
    full_f32_matmul()
    qn = (q * q).sum(dim=1, keepdim=True)
    dn = (db * db).sum(dim=1)
    d = qn - 2.0 * (q @ db.T) + dn[None, :]
    mean_d = d.mean()
    # queries are sampled from the corpus: exclude self/duplicate rows
    # from the NN side (they would fake contrast on concentrated data)
    d = torch.where(d < 1e-9 * mean_d.abs(), torch.full_like(d, float("inf")), d)
    # the k-th smallest VALUE does not depend on how ties are ordered
    nn_k = torch.topk(d, k, dim=1, largest=False).values[:, k - 1]
    return mean_d / nn_k.mean().clamp_min(1e-30)


def relative_contrast(
    vectors: torch.Tensor,
    count: int,
    *,
    n_queries: int = 256,
    max_db: int = 65536,
    k: int = 10,
) -> float:
    """Relative contrast of rows [0, count) of a (possibly padded) device
    vector tensor."""
    sampled = sample_for_contrast(vectors, count, n_queries=n_queries, max_db=max_db)
    if sampled is None:
        return float("inf")  # too small to judge; graphs are fine small
    db, q = sampled
    return relative_contrast_from_sample(db, q, k=k)


def sample_for_contrast(
    vectors: torch.Tensor,
    count: int,
    *,
    n_queries: int = 256,
    max_db: int = 65536,
):
    """Extract the (db, q) probe sample from the corpus block: the only
    part that reads `vectors`. The returned tensors are copies, so the
    caller takes them under the index's dispatch lock and runs the probe
    outside it."""
    count = int(count)
    if count < 4 * n_queries:
        return None
    db_n = min(max_db, count - n_queries)
    # the sample size decides the result: a power of two, as the reference
    db_n = 1 << (db_n.bit_length() - 1)
    # strided samples decorrelate from insertion order; queries come from
    # a different stride offset than the db rows
    db_idx = np.linspace(0, count - 1, db_n, dtype=np.int64)
    q_idx = np.linspace(1, count - 2, n_queries, dtype=np.int64)
    dev = vectors.device
    db = vectors[torch.from_numpy(db_idx).to(dev)].float()
    q = vectors[torch.from_numpy(q_idx).to(dev)].float()
    return db, q


def relative_contrast_from_sample(db, q, *, k: int = 10) -> float:
    return float(_rc_kernel(db, q, k))
