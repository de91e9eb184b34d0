"""Batched graph-traversal search over a fixed-fanout navigable graph.

Counterpart of longbow_tpu/index/graph.py, in plain PyTorch:

- No pointer hierarchy. A strided sample of the corpus is scanned with
  one matmul per query batch to find the entry points.
- One flat graph: `nbrs [N_cap, M2] int32` padded with -1, plus stored
  edge distances.
- Batched beam search: B queries advance in lockstep through a Python
  loop; each iteration expands `expand_per_iter` nodes per query (gather
  neighbours -> batched distance -> merge into the beam). The loop ends
  when NO query of the batch is active any more, so queries that have
  converged keep expanding while another is active: the iteration count
  is part of the result and is kept exactly as the reference has it. The
  condition is one host read per iteration.
- Filtered search keeps traversal unfiltered and feeds a separate result
  set only with eligible rows.
- Spans (utils/tracing.py): `longbow.hnsw.entry` (the entry scan),
  `longbow.hnsw.beam` (the loop; B, ef, iterations) and
  `longbow.hnsw.extract` (deferred extraction). `stats` takes the loop's
  counts; `count_searches` writes them to the registry once the caller
  has its answer on the host.

Every top-k here is `stable_topk` (ties in index order): MASKED padding
and ids gathered twice tie constantly, and the order among ties reaches
the result.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from longbow_tpu_torch.metrics.registry import get_registry
from longbow_tpu_torch.ops.distance import MASKED
from longbow_tpu_torch.ops.topk import later_duplicate, stable_topk
from longbow_tpu_torch.utils import tracing

INVALID = -1


class GraphState(NamedTuple):
    """Graph index state on one device (all tensors padded to N_cap rows).

    The tuple is immutable, the tensors are not: the build functions write into
    `nbrs`, `nbr_dists` and `nbr_count` in place and return a state that
    shares them, so a caller that needs a consistent view holds the
    owning index's lock (HNSWIndex._mu) while it reads.

    With `scale`/`offset` set, `vectors` holds SQ8 codes (uint8) and the
    effective vector is `codes * scale + offset`; distances fold the
    affine into the query. With `pq_books` set, `vectors` holds PQ codes
    ([N_cap, M] uint8) and distances come from a per-query lookup table.
    """

    vectors: torch.Tensor    # [N_cap, D] storage dtype (f32/bf16/u8 codes)
    norms_sq: torch.Tensor   # [N_cap] f32 (of the *effective* vectors)
    valid: torch.Tensor      # [N_cap] bool (allocated and not tombstoned)
    nbrs: torch.Tensor       # [N_cap, M2] int32, -1 padded
    nbr_dists: torch.Tensor  # [N_cap, M2] f32/bf16, MASKED padded
    nbr_count: torch.Tensor  # [N_cap] int32
    scale: Optional[torch.Tensor] = None     # [D] f32 (SQ8 dequant scale)
    offset: Optional[torch.Tensor] = None    # [D] f32 (SQ8 dequant offset)
    pq_books: Optional[torch.Tensor] = None  # [M, 256, dsub] f32 codebooks

    def device_bytes(self) -> int:
        return sum(
            t.numel() * t.element_size() for t in self if isinstance(t, torch.Tensor)
        )


def graph_init(
    capacity: int, dim: int, m2: int, dtype=torch.float32,
    edge_dtype=torch.float32, *, device,
) -> GraphState:
    """An empty state. edge_dtype=torch.bfloat16 halves the footprint of
    the edge distances, which only steer insert-time eviction."""
    return GraphState(
        vectors=torch.zeros((capacity, dim), dtype=dtype, device=device),
        norms_sq=torch.zeros((capacity,), dtype=torch.float32, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        nbrs=torch.full((capacity, m2), INVALID, dtype=torch.int32, device=device),
        nbr_dists=torch.full((capacity, m2), MASKED, dtype=edge_dtype, device=device),
        nbr_count=torch.zeros((capacity,), dtype=torch.int32, device=device),
    )


def pq_decode(codes: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """codes [..., M] u8 + books [M, 256, dsub] -> [..., M*dsub] f32."""
    m, _, dsub = books.shape
    flat_books = books.reshape(m * 256, dsub)
    gidx = torch.arange(m, device=codes.device) * 256 + codes.long()  # [..., M]
    return flat_books[gidx].reshape(*codes.shape[:-1], m * dsub)


def gather_vectors_f32(state: GraphState, rows: torch.Tensor) -> torch.Tensor:
    """Gather rows as effective f32 vectors (dequantized when the state
    is SQ8- or PQ-coded). rows [...]-shaped -> [..., D] f32."""
    v = state.vectors[rows.long()]
    if state.scale is not None:
        return v.float() * state.scale + state.offset
    if state.pq_books is not None:
        return pq_decode(v, state.pq_books)
    return v.float()


def _gather_dist(
    state: GraphState, queries_f32: torch.Tensor, qn: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """Distances from each query to its gathered rows.

    queries_f32 [B, D], qn [B, 1] = |q|^2, rows [B, R] -> [B, R] f32
    (L2 squared; -1 rows get the distance of row 0 - mask outside).

    SQ8 states fold the dequant affine into the query:
    q.(c*s + o) = (q*s).c + q.o. PQ states read per-subspace inner
    products from a per-query table: q.v_hat = sum_m lut[b, m, code];
    |v_hat|^2 comes from norms_sq."""
    safe = rows.clamp_min(0).long()
    vecs = state.vectors[safe]  # [B, R, D] storage dtype
    vn = state.norms_sq[safe]   # [B, R]
    if state.scale is not None:
        qs = queries_f32 * state.scale[None, :]
        ip = torch.bmm(vecs.float(), qs[:, :, None])[:, :, 0] + (
            queries_f32 @ state.offset
        )[:, None]
    elif state.pq_books is not None:
        books = state.pq_books
        m, _, dsub = books.shape
        b, r = rows.shape
        lut = torch.einsum(
            "bmd,mkd->bmk", queries_f32.reshape(b, m, dsub), books
        ).reshape(b, m * 256)
        gidx = torch.arange(m, device=rows.device)[None, None, :] * 256 + vecs.long()
        ip = lut.gather(1, gidx.reshape(b, r * m)).reshape(b, r, m).sum(dim=2)
    else:
        ip = torch.bmm(vecs.float(), queries_f32[:, :, None])[:, :, 0]
    return (qn - 2.0 * ip + vn).clamp_min(0.0)


def entry_candidates(
    state: GraphState,
    queries_f32: torch.Tensor,
    qn: torch.Tensor,
    sample_rows: torch.Tensor,
    n_entry: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan a fixed row sample with one matmul -> per-query best rows.
    Returns (dist [B, n_entry], rows [B, n_entry] int64)."""
    sample_rows = sample_rows.long()
    svecs = state.vectors[sample_rows]
    svn = state.norms_sq[sample_rows]
    svalid = state.valid[sample_rows]
    q_eff, bias = queries_f32, 0.0
    if state.scale is not None:
        q_eff = queries_f32 * state.scale[None, :]
        bias = (queries_f32 @ state.offset)[:, None]
    elif state.pq_books is not None:
        svecs = pq_decode(svecs, state.pq_books)
    ip = q_eff @ svecs.float().T + bias
    dist = (qn - 2.0 * ip + svn[None, :]).clamp_min(0.0)
    dist = torch.where(svalid[None, :], dist, torch.full_like(dist, MASKED))
    d, pos = stable_topk(dist, n_entry)
    return d, sample_rows[pos]


def beam_search(
    state: GraphState,
    queries: torch.Tensor,
    sample_rows: torch.Tensor,
    k: int,
    ef: int,
    *,
    eligible: Optional[torch.Tensor] = None,
    normalize: bool = False,
    max_iters: int = 0,
    ring_size: int = 128,
    expand_per_iter: int = 4,
    track_results: bool = True,
    m_used: int = 0,
    stats: Optional[dict] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched best-first graph search.

    queries [B, D]; sample_rows [S] entry-scan sample; eligible:
    optional [N_cap] bool - rows allowed in *results* (traversal ignores
    it; tombstoned rows route but never return).
    Returns (dist [B, k] f32, rows [B, k] int32) ascending; empty slots
    have dist >= MASKED and row -1.

    track_results=False defers result extraction to after the loop: the
    beam is the ef-wide working set, so top-k of the validity-filtered
    final beam equals the tracked result set whenever the beam holds
    >= k valid rows. m_used > 0 traverses only each node's first m_used
    edges (a column slice: a view, no copy). stats, when given, receives
    {"iters": loop iterations run, "distances": a device scalar, the
    neighbour distances the loop computed for real (its nbr_ok slots),
    summed without a host read}."""
    nbrs = state.nbrs
    if 0 < m_used < nbrs.shape[1]:
        nbrs = nbrs[:, :m_used]
    b = queries.shape[0]
    m2 = nbrs.shape[1]
    ex = max(1, expand_per_iter)
    if k > ef:  # deferred extraction needs the beam to cover k
        track_results = True
    if max_iters <= 0:
        # each iteration expands up to `ex` nodes per query; the budget is
        # the total expansions of single-node search (~2*ef)
        max_iters = (2 * ef) // ex + 32
    e = ef
    dev = queries.device

    qf = queries.float()
    if normalize:
        qf = qf / torch.linalg.norm(qf, dim=1, keepdim=True).clamp_min(1e-30)
    qn = (qf * qf).sum(dim=1, keepdim=True)

    res_mask = state.valid if eligible is None else (state.valid & eligible)

    def masked_d(d):
        return torch.full_like(d, MASKED)

    # ---- init beam from the entry scan ----
    with tracing.span("longbow.hnsw.entry"):
        n_entry = min(e, sample_rows.shape[0])
        ed, er = entry_candidates(state, qf, qn, sample_rows, n_entry)
        pad = e - n_entry
        beam_d = torch.cat([ed, torch.full((b, pad), MASKED, device=dev)], dim=1)
        beam_i = torch.cat([er, torch.full((b, pad), -1, dtype=torch.int64, device=dev)], dim=1)
        expanded = torch.zeros((b, e), dtype=torch.bool, device=dev)

        if track_results:
            # result set: entries eligible for return. Taken from the padded
            # beam, so a sample smaller than k still gives k slots.
            short = max(k - e, 0)
            bd0 = torch.cat([beam_d, torch.full((b, short), MASKED, device=dev)], dim=1)
            bi0 = torch.cat([beam_i, torch.full((b, short), -1, dtype=torch.int64, device=dev)],
                            dim=1)
            ok0 = res_mask[bi0.clamp_min(0)] & (bi0 >= 0)
            res_d, pos = stable_topk(torch.where(ok0, bd0, masked_d(bd0)), k)
            res_i = torch.where(res_d < MASKED, bi0.gather(1, pos), -1)

    # each iteration's real neighbour slots, counted by one reduction after
    # the loop: no launch inside it
    real_slots = [] if stats is not None else None
    t_beam = time.perf_counter_ns() if tracing.recording() else 0
    visited = torch.full((b, ring_size), -1, dtype=torch.int64, device=dev)
    cols = torch.arange(e, device=dev)[None, :]
    it = 0
    while it < max_iters:
        frontier = torch.where(expanded | (beam_d >= MASKED), masked_d(beam_d), beam_d)
        # classic ef semantics: explore while the best unexpanded node
        # beats the worst beam entry, not the k-th result
        active = frontier.min(dim=1).values < beam_d[:, -1].clamp_max(MASKED)
        if not bool(active.any()):  # the batch-wide stop: one host read
            break

        # -- pick the `ex` best unexpanded beam entries per query --
        pick_d, pick = stable_topk(frontier, ex)  # [B, ex]
        real = pick_d < MASKED  # only picks that are real frontier entries
        hit = (cols[:, None, :] == pick[:, :, None]) & real[:, :, None]
        expanded = expanded | hit.any(dim=1)
        exp_row = torch.where(real, beam_i.gather(1, pick), -1)  # [B, ex]

        # -- gather neighbours of the expanded nodes --
        nbr = nbrs[exp_row.clamp_min(0)].long().reshape(b, ex * m2)
        nbr = torch.where(real.repeat_interleave(m2, dim=1), nbr, -1)
        # dedup vs beam and recent-visit ring
        dup_beam = (nbr[:, :, None] == beam_i[:, None, :]).any(dim=2)
        dup_ring = (nbr[:, :, None] == visited[:, None, :]).any(dim=2)
        nbr_ok = (nbr >= 0) & ~dup_beam & ~dup_ring
        if real_slots is not None:
            real_slots.append(nbr_ok)

        nd = _gather_dist(state, qf, qn, nbr)
        nd = torch.where(nbr_ok, nd, masked_d(nd))

        if track_results:
            # -- fold eligible neighbours into the result set --
            ok_res = res_mask[nbr.clamp_min(0)] & nbr_ok
            # a node can be found again after it fell out of the beam and
            # the ring; without this mask it re-enters as a duplicate
            dup_res = (nbr[:, :, None] == res_i[:, None, :]).any(dim=2)
            # the same id twice within one gather: keep the first
            dup_in = later_duplicate(nbr) & nbr_ok
            cd = torch.where(ok_res & ~dup_res & ~dup_in, nd, masked_d(nd))
            all_d = torch.cat([res_d, cd], dim=1)
            all_i = torch.cat([res_i, nbr], dim=1)
            res_d, pos = stable_topk(all_d, k)
            res_i = torch.where(res_d < MASKED, all_i.gather(1, pos), -1)

        # -- merge neighbours into the beam (keep best e) --
        md = torch.cat([beam_d, nd], dim=1)
        mi = torch.cat([beam_i, torch.where(nbr_ok, nbr, -1)], dim=1)
        mx = torch.cat(
            [expanded, torch.zeros((b, ex * m2), dtype=torch.bool, device=dev)], dim=1
        )
        beam_d, pos = stable_topk(md, e)
        beam_i = mi.gather(1, pos)
        expanded = mx.gather(1, pos)
        # anything that fell out of the beam may re-enter later; the ring
        # (a shift register) guards the recently expanded
        visited = torch.cat([visited[:, ex:], exp_row], dim=1)
        it += 1

    if t_beam:
        tracing.interval("longbow.hnsw.beam", t_beam, time.perf_counter_ns(),
                         B=b, ef=e, iterations=it)
    if stats is not None:
        stats["iters"] = it
        stats["distances"] = (torch.stack(real_slots).sum() if real_slots
                              else torch.zeros((), dtype=torch.int64, device=dev))
    if track_results:
        return res_d, res_i.int()

    # deferred extraction: top-k of the validity-filtered final beam.
    # Duplicates from one gather can survive in the beam (the loop dedups
    # neighbours against beam and ring, not within a gather): drop all but
    # the first occurrence.
    with tracing.span("longbow.hnsw.extract"):
        ok = res_mask[beam_i.clamp_min(0)] & (beam_i >= 0)
        fd = torch.where(ok & ~later_duplicate(beam_i), beam_d, masked_d(beam_d))
        res_d, pos = stable_topk(fd, k)
        res_i = torch.where(res_d < MASKED, beam_i.gather(1, pos), -1)
    return res_d, res_i.int()


def count_searches(calls: list, queries: int) -> None:
    """Write the loop counts of one search's beam_search calls (their
    `stats` dicts: the first call and each ef retry) of `queries` queries
    each: longbow_hnsw_searches_total (a call), _queries_total,
    _beam_iterations_total and _distance_calculations_total. Called once
    the answer is on the host, so reading the device's count waits for
    nothing; a metric never fails the search."""
    distances = sum(int(s["distances"]) for s in calls)
    try:
        reg = get_registry()
        reg.inc("longbow_hnsw_searches_total", len(calls))
        reg.inc("longbow_hnsw_queries_total", queries * len(calls))
        reg.inc("longbow_hnsw_beam_iterations_total", sum(s["iters"] for s in calls))
        reg.inc("longbow_hnsw_distance_calculations_total", distances)
    except Exception:
        pass
