"""Batched graph construction in plain PyTorch.

Counterpart of longbow_tpu/index/graph_build.py. Insertion is a batched
function over the graph tensors:

  1. search the current graph for each new node's neighbourhood (batched
     beam search + exact intra-batch kNN so batch members can link to
     each other like sequential inserts would),
  2. select M diverse neighbours per node with the keep-pruned-connections
     heuristic, vectorized over the batch,
  3. write forward edges (new rows are unique - conflict-free),
  4. add reverse edges in R conflict-free passes: each pass picks at most
     one incoming edge per target via scatter-min arbitration, appends or
     replaces that target's worst edge, and retires the edge. Leftovers
     beyond R per target in one batch are dropped.

Bulk builds make a kNN graph first (exact, cluster-blocked, or by
random-projection blocks with an NN-descent polish), prune it with the
same heuristic and symmetrize it by edge-list sorts.

The build functions write the adjacency of the state they are given in place
and return a state that shares its tensors. Row chunks are arguments
sized by memory (`_rows_for`): every row is processed on its own, so no
result depends on a chunk size. Distances are full float32 (TF32 is off
by PyTorch's default and nothing here turns it on).
"""
from __future__ import annotations

import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from longbow_tpu_torch.index.graph import (
    GraphState,
    beam_search,
    gather_vectors_f32,
    pq_decode,
)
from longbow_tpu_torch.ops.distance import MASKED, distance_matrix
from longbow_tpu_torch.ops.kmeans import kmeans_init, lloyd
from longbow_tpu_torch.ops.scan import fused_flat_search
from longbow_tpu_torch.ops.topk import later_duplicate, stable_topk

_BIG = 3.0e38
_BIG_I = 2**30
# working arrays of the bulk builds are padded to this many rows
PAD_ROWS = 1024
# transient bytes a chunked stage may hold at once
CHUNK_BYTES = 1 << 30
# queries per launch of the fused self-kNN, and the largest k it is asked for
SELF_KNN_QUERIES = 4096
SELF_KNN_MAX_K = 64

# (tag, n, label, seconds) of every stage timed while LONGBOW_BUILD_DEBUG=1
stage_log: list = []


def _rows_for(bytes_per_row: int, budget: int = CHUNK_BYTES) -> int:
    """Rows of a chunk whose transients stay within `budget` bytes."""
    return max(256, budget // max(int(bytes_per_row), 1))


def build_stage_timer(n: int, tag: str = "build"):
    """Stage-timing hook for bulk builds, active under
    LONGBOW_BUILD_DEBUG=1: each call waits for the device
    (torch.cuda.synchronize when the given tensors are on a card), prints
    the elapsed stage time to stderr and appends it to `stage_log`.
    No-op otherwise."""
    if os.environ.get("LONGBOW_BUILD_DEBUG") != "1":
        return lambda label, *tensors: None
    state = {"t": time.time()}

    def stage(label, *tensors):
        for t in tensors:
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
        now = time.time()
        stage_log.append((tag, n, label, now - state["t"]))
        print(f"[{tag} {n}] {label}: {now - state['t']:.1f}s", file=sys.stderr, flush=True)
        state["t"] = now

    return stage


def _masked(d: torch.Tensor) -> torch.Tensor:
    return torch.full_like(d, MASKED)


def _pairwise_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[Bi, C, D] x [Bi, S, D] -> [Bi, C, S] squared L2."""
    ip = torch.bmm(a, b.transpose(1, 2))
    an = (a * a).sum(dim=2)[:, :, None]
    bn = (b * b).sum(dim=2)[:, None, :]
    return (an - 2.0 * ip + bn).clamp_min(0.0)


def select_neighbors_heuristic(
    cand_rows: torch.Tensor,   # [Bi, C] int (-1 = empty)
    cand_dist: torch.Tensor,   # [Bi, C] f32 dist(candidate, q)
    cand_vecs: torch.Tensor,   # [Bi, C, D] f32
    m: int,
    *,
    protected=None,            # [Bi, C] bool: picked first, never pruned
    fill: bool = False,        # keepPrunedConnections: top up to m slots
) -> tuple[torch.Tensor, torch.Tensor]:
    """Vectorized keep-pruned-connections heuristic.

    Greedily picks the closest remaining candidate; after each pick,
    candidates closer to the picked node than to the query are pruned.
    Returns (rows [Bi, m] int64, dists [Bi, m] f32) padded with -1 /
    MASKED.

    protected: candidates that must survive (picked ahead of everything
    else and exempt from pruning). fill: after the greedy pass, remaining
    slots are topped up with the closest PRUNED candidates so nodes keep
    full degree."""
    bi, c, _ = cand_vecs.shape
    dev = cand_vecs.device
    cand_rows = cand_rows.long()
    pair = _pairwise_l2(cand_vecs, cand_vecs)  # [Bi, C, C]
    avail = (cand_rows >= 0) & (cand_dist < MASKED)
    avail0 = avail
    if protected is None:
        protected = torch.zeros_like(avail)
    # pick ordering: protected first, then by true distance
    order_d = torch.where(protected, cand_dist - 1.0e9, cand_dist)
    ccols = torch.arange(c, device=dev)[None, :]
    rows_b = torch.arange(bi, device=dev)

    sel_rows = torch.full((bi, m), -1, dtype=torch.int64, device=dev)
    sel_dists = torch.full((bi, m), MASKED, dtype=torch.float32, device=dev)
    for j in range(m):
        dd = torch.where(avail, order_d, torch.full_like(order_d, _BIG))
        pick = dd.argmin(dim=1)  # [Bi], the first of equal minima
        has = dd[rows_b, pick] < _BIG
        sel_rows[:, j] = torch.where(has, cand_rows[rows_b, pick], -1)
        sel_dists[:, j] = torch.where(
            has, cand_dist[rows_b, pick], torch.full_like(cand_dist[:, 0], MASKED)
        )
        # prune: drop candidates closer to the pick than to the query
        d_to_pick = pair[rows_b, :, pick]  # [Bi, C]
        prune = (d_to_pick < cand_dist) & ~protected
        avail = avail & ~prune & (ccols != pick[:, None]) & has[:, None]

    if fill:
        # top up trailing empty slots with the closest candidates the
        # diversity rule pruned (selected entries rank first via the -1e9
        # bias; a candidate is either selected or not)
        in_sel = (
            (cand_rows[:, :, None] == sel_rows[:, None, :]) & (sel_rows[:, None, :] >= 0)
        ).any(dim=2)
        fill_d = torch.where(avail0 & ~in_sel, cand_dist, _masked(cand_dist))
        md = torch.cat(
            [torch.where(sel_dists < MASKED, sel_dists - 1.0e9, _masked(sel_dists)), fill_d],
            dim=1,
        )
        mr = torch.cat([sel_rows, cand_rows], dim=1)
        mt = torch.cat([sel_dists, cand_dist], dim=1)  # true distances
        top, pos = stable_topk(md, m)
        sel_rows = torch.where(top < MASKED, mr.gather(1, pos), -1)
        sel_dists = torch.where(top < MASKED, mt.gather(1, pos), _masked(top))
    return sel_rows, sel_dists


def insert_batch(
    state: GraphState,
    new_rows: torch.Tensor,      # [Bi] int rows already holding vectors
    sample_rows: torch.Tensor,   # [S] entry-scan sample
    *,
    ef_construction: int = 100,
    m: int = 32,
    cand_cap: int = 64,
    reverse_passes: int = 8,
    expand_per_iter: int = 1,  # 1 = quality-first construction beam
) -> GraphState:
    """Link a batch of already-stored vectors into the graph, in place."""
    new_rows = new_rows.long()
    bi = new_rows.shape[0]
    n_cap, m2 = state.nbrs.shape
    dev = new_rows.device
    nbrs, nbr_dists, nbr_count = state.nbrs, state.nbr_dists, state.nbr_count

    q = gather_vectors_f32(state, new_rows)

    # -- 1. candidates from the existing graph --
    gd, gi = beam_search(
        state, q, sample_rows, k=cand_cap, ef=ef_construction,
        max_iters=(ef_construction // max(expand_per_iter, 1)) + 16,
        expand_per_iter=expand_per_iter,
    )
    gi = gi.long()
    # exclude self-matches (the row id itself must not self-link)
    self_hit = gi == new_rows[:, None]
    gd = torch.where(self_hit, _masked(gd), gd)
    gi = torch.where(self_hit, -1, gi)

    # -- intra-batch exact kNN so batch members can link to each other --
    qn = (q * q).sum(dim=1)
    bd = (qn[:, None] - 2.0 * (q @ q.T) + qn[None, :]).clamp_min(0.0)
    bd.fill_diagonal_(MASKED)
    kb = min(cand_cap, bi)
    bd_k, pb = stable_topk(bd, kb)
    bi_k = torch.where(bd_k < MASKED, new_rows[pb], -1)
    # self-exclusion for row ids that stand twice in the batch (a tail
    # batch padded by repeating its last row): the diagonal covers only
    # the copy itself
    self_b = bi_k == new_rows[:, None]
    bd_k = torch.where(self_b, _masked(bd_k), bd_k)
    bi_k = torch.where(self_b, -1, bi_k)

    cand_d, pos = stable_topk(torch.cat([gd, bd_k], dim=1), cand_cap)
    cand_i = torch.cat([gi, bi_k], dim=1).gather(1, pos)
    cand_vecs = gather_vectors_f32(state, cand_i.clamp_min(0))

    # -- 2. diverse neighbour selection --
    sel_rows, sel_dists = select_neighbors_heuristic(cand_i, cand_d, cand_vecs, m)

    # -- 3. forward edges (copies of one row write the same values) --
    fwd_rows = torch.full((bi, m2), -1, dtype=torch.int32, device=dev)
    fwd_rows[:, :m] = sel_rows.int()
    fwd_dists = torch.full((bi, m2), MASKED, dtype=nbr_dists.dtype, device=dev)
    fwd_dists[:, :m] = sel_dists.to(nbr_dists.dtype)
    nbrs[new_rows] = fwd_rows
    nbr_dists[new_rows] = fwd_dists
    nbr_count[new_rows] = (sel_rows >= 0).sum(dim=1).int()

    # -- 4. reverse edges in conflict-free passes --
    tgt = sel_rows.reshape(-1)               # [E] target of the reverse edge
    src = new_rows.repeat_interleave(m)      # [E] the new node
    edist = sel_dists.reshape(-1)            # [E]
    alive = tgt >= 0
    eidx = torch.arange(tgt.shape[0], device=dev)
    for _ in range(reverse_passes):
        # arbitration: per target keep the single lowest-distance edge
        key = torch.where(alive, edist, torch.full_like(edist, _BIG))
        tgt_safe = torch.where(alive, tgt, n_cap - 1)
        best = torch.full((n_cap,), _BIG, device=dev).scatter_reduce_(
            0, tgt_safe, key, "amin"
        )
        is_best = alive & (key == best[tgt_safe]) & (key < _BIG)
        # first-of-equal wins: mask later edges to the same target
        first = torch.full((n_cap,), _BIG_I, dtype=torch.int64, device=dev).scatter_reduce_(
            0, tgt_safe, torch.where(is_best, eidx, _BIG_I), "amin"
        )
        chosen = is_best & (eidx == first[tgt_safe])
        alive = alive & ~chosen
        # the edges that lost are left out (one host read of their number)
        idx = chosen.nonzero()[:, 0]
        if idx.numel() == 0:
            break  # no edge is alive any more
        t, s, ed = tgt[idx], src[idx], edist[idx]  # t holds each target once
        cnt = nbr_count[t].long()
        row_d = nbr_dists[t]                      # [E', M2]
        worst_col = row_d.argmax(dim=1)
        worst_val = row_d.gather(1, worst_col[:, None])[:, 0].float()
        has_space = cnt < m2
        slot = torch.where(has_space, cnt, worst_col)
        do = has_space | (ed < worst_val)
        nbrs[t, slot] = torch.where(do, s.int(), nbrs[t, slot])
        nbr_dists[t, slot] = torch.where(do, ed.to(nbr_dists.dtype), nbr_dists[t, slot])
        nbr_count[t] = torch.where(do & has_space, cnt + 1, cnt).int()
    return state


# ---------------------------------------------------------------------------
# Bulk construction: exact kNN graph -> heuristic prune -> symmetrize.
# ---------------------------------------------------------------------------


def pad_columns(vectors: torch.Tensor, multiple: int = 16) -> torch.Tensor:
    """The rows with zero columns up to the next multiple of `multiple`
    (the rows themselves when D is one already): no dot product and no
    norm changes. A dot graph's MIPS column makes D = 129, which the
    wgmma ring of K1 does not take; at 144 it does."""
    pad = -vectors.shape[1] % multiple
    return torch.nn.functional.pad(vectors, (0, pad)) if pad else vectors


def _chunked_self_knn(
    vectors: torch.Tensor,
    norms_sq: torch.Tensor,
    valid: torch.Tensor,
    n: int,
    k: int,
    chunk_b: int = PAD_ROWS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of each of the first n rows against all valid rows,
    excluding self. Returns (dists [n_pad, k], rows [n_pad, k] int64)
    where n_pad rounds n up to chunk_b (rows past n repeat row n - 1).

    A bf16 block on a CUDA device with k + 1 <= 64 goes through the fused
    scan (kernel K1, SELF_KNN_QUERIES queries per launch, on the rows
    padded by pad_columns; the kernel raises if it cannot run, there is
    no way back to the plain path). Everything else is a chunked distance
    matrix and a stable top-k."""
    use_fused = (
        vectors.device.type == "cuda"
        and vectors.dtype == torch.bfloat16
        and k + 1 <= SELF_KNN_MAX_K
    )
    if use_fused:
        vectors = pad_columns(vectors)
    n_pad = -(-n // chunk_b) * chunk_b
    dev = vectors.device
    cap = vectors.shape[0]
    kk = min(k + 1, cap)
    if use_fused:
        step = SELF_KNN_QUERIES
    else:
        vf = vectors.float()
        step = min(chunk_b, _rows_for(cap * 16))
    out_d, out_i = [], []
    for off in range(0, n_pad, step):
        rows = torch.arange(off, min(off + step, n_pad), device=dev).clamp_max(n - 1)
        if use_fused:
            d, i = fused_flat_search(
                vectors[rows], vectors, norms_sq, valid, kk, device=dev
            )
            i = i.long()
        else:
            dist = distance_matrix(vf[rows], vf, corpus_norms_sq=norms_sq, valid=valid)
            d, i = stable_topk(dist, kk)
        self_hit = i == rows[:, None]
        d = torch.where(self_hit, _masked(d), d)
        i = torch.where(self_hit, -1, i)
        # sort again so the masked self-slot falls to the end, keep k
        d, pos = stable_topk(d, min(k, kk))
        out_d.append(d)
        out_i.append(i.gather(1, pos))
    return torch.cat(out_d), torch.cat(out_i)


def _prune_forward_all(state, knn_d, knn_i, m: int, chunk: Optional[int] = None):
    """The heuristic over every row's candidate list, `chunk` rows at a
    time (sized by memory when None): the candidate-vector gather is
    [chunk, K, D] f32. -> (rows [R, m] int64, dists [R, m] f32)."""
    n_pad, kk = knn_d.shape
    d = state.vectors.shape[1] if state.pq_books is None else (
        state.pq_books.shape[0] * state.pq_books.shape[2]
    )
    chunk = chunk or _rows_for(4 * kk * (2 * d + 3 * kk))
    out_r, out_d = [], []
    for off in range(0, n_pad, chunk):
        ci = knn_i[off:off + chunk]
        cv = gather_vectors_f32(state, ci.clamp_min(0))
        sr, sd = select_neighbors_heuristic(ci, knn_d[off:off + chunk], cv, m)
        out_r.append(sr)
        out_d.append(sd)
    return torch.cat(out_r), torch.cat(out_d)


def _is_quantized(state: GraphState) -> bool:
    return state.scale is not None or state.pq_books is not None


def _densified(state: GraphState) -> GraphState:
    """SQ8/PQ-coded state -> transient bf16 dense state for bulk builds
    (2 bytes/dim/row for the duration of the build)."""
    if state.scale is not None:
        dense = (state.vectors.float() * state.scale + state.offset).to(torch.bfloat16)
    elif state.pq_books is not None:
        dense = pq_decode(state.vectors, state.pq_books).to(torch.bfloat16)
    else:
        return state
    return state._replace(vectors=dense, scale=None, offset=None, pq_books=None)


def _reattach_codes(orig: GraphState, built: GraphState) -> GraphState:
    """Put the original SQ8/PQ codes back on the built state."""
    return built._replace(
        vectors=orig.vectors, scale=orig.scale, offset=orig.offset,
        pq_books=orig.pq_books,
    )


def bulk_build_edges(
    state: GraphState,
    n: int,
    *,
    m: int,
    m_max: int,
    knn_k: int = 64,
    chunk_b: int = PAD_ROWS,
    prune_chunk: Optional[int] = None,
) -> GraphState:
    """Build the whole adjacency for rows [0, n) from scratch.

    1. exact kNN graph (chunked flat scans; kernel K1 on a card)
    2. keep-pruned-connections heuristic -> m forward edges per node
    3. symmetrize: a stable two-key sort of the edge list groups incoming
       edges by target; each node keeps the best m_max of (forward +
       incoming)."""
    if _is_quantized(state):
        return _reattach_codes(
            state,
            bulk_build_edges(
                _densified(state), n, m=m, m_max=m_max, knn_k=knn_k,
                chunk_b=chunk_b, prune_chunk=prune_chunk,
            ),
        )
    knn_d, knn_i = _chunked_self_knn(
        state.vectors, state.norms_sq, state.valid, n, knn_k, chunk_b
    )
    fwd_rows, fwd_dists = _prune_forward_all(state, knn_d, knn_i, m, prune_chunk)
    del knn_d, knn_i
    # full padded arrays: dead rows are -1/MASKED
    return _symmetrize_and_store(state, fwd_rows, fwd_dists, n, m_max=m_max)


def _symm_edges(fwd_rows: torch.Tensor, fwd_dists: torch.Tensor, n_live: int, *, m_max: int):
    """Edge-list sorts -> per-node incoming candidates [R, m_max].

    Works on the caller's padded arrays; n_live masks padded-row sources
    and targets (dead rows are zero vectors whose kNN lists hold real
    ids, so without the mask they inject dead-row edges into live nodes).
    Reverse candidates come from the top m_rev forward ranks only. Each
    source's rank-0 reverse edge is protected: without it, anti-hub nodes
    lose every in-edge at the prune and become unreachable except through
    the entry sample. Returns (inc_src int64, inc_d f32, inc_prot bool)."""
    n, m = fwd_rows.shape
    dev = fwd_rows.device
    m_rev = min(m, 16)
    e = n * m_rev
    src = torch.arange(n, device=dev).repeat_interleave(m_rev)  # [E]
    dst = fwd_rows[:, :m_rev].reshape(-1).long()
    d = fwd_dists[:, :m_rev].reshape(-1)
    ok = (dst >= 0) & (src < n_live) & (dst < n_live)
    dst_s = torch.where(ok, dst, n)  # invalid -> sentinel bucket n

    rank_in_src = torch.arange(m_rev, device=dev).repeat(n)
    protected = ok & (rank_in_src == 0)
    d_eff = torch.where(protected, d - 1.0e9, d)

    # stable two-key sort: by effective priority first, then by target -
    # within a target group edges end up best-first, protected leading
    o1 = torch.sort(d_eff, stable=True).indices
    dst1, src1, d1, de1 = dst_s[o1], src[o1], d[o1], d_eff[o1]
    o2 = torch.sort(dst1, stable=True).indices
    dst2, src2, d2, de2 = dst1[o2], src1[o2], d1[o2], de1[o2]

    ar = torch.arange(n, device=dev)
    starts = torch.searchsorted(dst2, ar)
    counts = torch.searchsorted(dst2, ar, right=True) - starts  # incoming degree

    r_slots = m_max  # incoming candidates kept per node
    slot = torch.arange(r_slots, device=dev)[None, :]
    pos = (starts[:, None] + slot).clamp_max(e - 1)
    inc_ok = slot < counts.clamp_max(r_slots)[:, None]
    d2p = d2[pos]
    inc_src = torch.where(inc_ok, src2[pos], -1)  # [n, R]
    inc_d = torch.where(inc_ok, d2p, _masked(d2p))
    inc_prot = inc_ok & (de2[pos] < d2p - 1.0e8)
    return inc_src, inc_d, inc_prot


def _symm_select_seg(
    state: GraphState,
    fwd_rows, fwd_dists, inc_src, inc_d, inc_prot, off: int,
    *, seg_rows: int, m_max: int, diversify: bool,
    prune_chunk: Optional[int] = None,
):
    """Merge forward + incoming for the row segment [off, off + seg_rows),
    dedup, keep the best m_max by priority. Duplicates only occur BETWEEN
    the lists (each is internally unique), so the dedup mask is
    [seg, R, m]. -> (sel_i int64, sel_d f32, cnt int32)."""
    sl = slice(off, off + seg_rows)
    fwd_r = fwd_rows[sl].long()
    fwd_d = fwd_dists[sl]
    inc_s, inc_dd, inc_p = inc_src[sl], inc_d[sl], inc_prot[sl]
    # effective priority: protected reverse edges sort first
    inc_de = torch.where(inc_p, inc_dd - 1.0e9, inc_dd)
    dup = ((inc_s[:, :, None] == fwd_r[:, None, :]) & (fwd_r[:, None, :] >= 0)).any(dim=2)
    inc_dd = torch.where(dup, _masked(inc_dd), inc_dd)
    inc_de = torch.where(dup, _masked(inc_de), inc_de)
    all_i = torch.cat([fwd_r, inc_s], dim=1)
    all_d = torch.cat([fwd_d, inc_dd], dim=1)
    all_de = torch.cat([fwd_d, inc_de], dim=1)
    all_d = torch.where(all_i >= 0, all_d, _masked(all_d))
    all_de = torch.where(all_i >= 0, all_de, _masked(all_de))

    if diversify:
        # selectNeighbors on overflow instead of plain closest-m_max:
        # diversity-prune the merged list with keepPruned fill so degree
        # stays m_max; protected reverse edges survive through the
        # heuristic's protected lane
        nseg, w = all_i.shape
        d = state.vectors.shape[1]
        chunk = prune_chunk or _rows_for(4 * w * (2 * d + 3 * w))
        out_i, out_d = [], []
        for c0 in range(0, nseg, chunk):
            ci, cd = all_i[c0:c0 + chunk], all_d[c0:c0 + chunk]
            cv = gather_vectors_f32(state, ci.clamp_min(0))
            prot = all_de[c0:c0 + chunk] < cd - 1.0e8
            si, sd = select_neighbors_heuristic(ci, cd, cv, m_max, protected=prot, fill=True)
            out_i.append(si)
            out_d.append(sd)
        sel_i, sel_d = torch.cat(out_i), torch.cat(out_d)
    else:
        top, ppos = stable_topk(all_de, m_max)
        sel_d = torch.where(top < MASKED, all_d.gather(1, ppos), _masked(top))
        sel_i = torch.where(sel_d < MASKED, all_i.gather(1, ppos), -1)
    cnt = (sel_i >= 0).sum(dim=1).int()
    return sel_i, sel_d, cnt


def long_range_targets(rows: torch.Tensor, n: int, j: int) -> torch.Tensor:
    """The j-th pseudo-random long-range target of each row:
    (row * (2654435761 + 40503 j) + 12345 + j) mod 2^32 mod n in unsigned
    32-bit arithmetic, moved on by one where it hits the row itself."""
    rows = rows.long()
    tgt = ((rows * (2654435761 + j * 40503) + (12345 + j)) & 0xFFFFFFFF) % n
    return torch.where(tgt == rows, (tgt + 1) % n, tgt)


def _symm_store(state: GraphState, sel_i, sel_d, cnt, n: int, *, m_max: int) -> GraphState:
    """Long-range edges + one write into the state's adjacency."""
    # selections may arrive at the padded row count (rows past n are dead)
    sel_i, sel_d, cnt = sel_i[:n], sel_d[:n], cnt[:n]
    # pad to the adjacency width actually allocated in the state (a
    # build may use a smaller m_max than the index was created with)
    m2 = state.nbrs.shape[1]
    dev = sel_i.device
    out_i = torch.full((n, m2), -1, dtype=torch.int32, device=dev)
    out_d = torch.full((n, m2), MASKED, dtype=state.nbr_dists.dtype, device=dev)
    out_i[:, :m_max] = sel_i.int()
    out_d[:, :m_max] = sel_d.to(out_d.dtype)

    # Kleinberg-style long-range edges: the last 2 adjacency slots get
    # deterministic pseudo-random targets so clustered corpora stay
    # navigable across clusters. Edge distances are never read by search,
    # so MASKED is fine there.
    rows = torch.arange(n, device=dev)
    for j in range(min(2, m2)):
        col = m2 - 1 - j
        out_i[:, col] = long_range_targets(rows, n, j).int()
        out_d[:, col] = MASKED
    state.nbrs[:n] = out_i
    state.nbr_dists[:n] = out_d
    state.nbr_count[:n] = cnt
    return state


def _symmetrize_and_store(
    state: GraphState,
    fwd_rows: torch.Tensor,   # [R, m], R >= n; dead rows -1 / MASKED
    fwd_dists: torch.Tensor,  # [R, m]
    n: int,
    *,
    m_max: int,
    diversify: bool = False,
    seg_rows: Optional[int] = None,
) -> GraphState:
    """Edge sorts, row-segmented dedup/select, one store. seg_rows (sized
    by memory when None) bounds the [seg, R, m] dedup mask."""
    r, m = fwd_rows.shape
    inc_src, inc_d, inc_prot = _symm_edges(fwd_rows, fwd_dists, n, m_max=m_max)
    seg = seg_rows or _rows_for(m_max * m + 40 * (m + m_max))
    parts = [
        _symm_select_seg(
            state, fwd_rows, fwd_dists, inc_src, inc_d, inc_prot, off,
            seg_rows=min(seg, r - off), m_max=m_max, diversify=diversify,
        )
        for off in range(0, r, seg)
    ]
    sel_i, sel_d, cnt = (torch.cat(p) for p in zip(*parts))
    return _symm_store(state, sel_i, sel_d, cnt, n, m_max=m_max)


# ---------------------------------------------------------------------------
# Clustered bulk build: k-means cells + per-cell kNN against the T nearest
# cells. Replaces the O(N^2) exact kNN graph with O(N * T * N/C).
# ---------------------------------------------------------------------------


def _assign_clusters(
    vectors: torch.Tensor, norms: torch.Tensor, cent: torch.Tensor, n: int,
    chunk: int = 65536,
) -> torch.Tensor:
    """Row -> nearest centroid id (int64) for rows [0, n)."""
    cn = (cent * cent).sum(dim=1)
    out = []
    for off in range(0, n, chunk):
        end = min(off + chunk, n)
        ip = vectors[off:end].float() @ cent.T
        out.append((norms[off:end, None] - 2.0 * ip + cn[None, :]).argmin(dim=1))
    return torch.cat(out)


def bulk_build_clustered(
    state: GraphState,
    n: int,
    *,
    m: int,
    m_max: int,
    knn_k: int = 64,
    n_clusters: int = 0,
    probes: int = 4,
    train_sample: int = 65536,
    prune_chunk: Optional[int] = None,
    nn_descent_rounds: int = 2,
) -> GraphState:
    """Cluster-blocked kNN-graph build for large corpora."""
    if _is_quantized(state):
        return _reattach_codes(
            state,
            bulk_build_clustered(
                _densified(state), n, m=m, m_max=m_max, knn_k=knn_k,
                n_clusters=n_clusters, probes=probes,
                train_sample=train_sample, prune_chunk=prune_chunk,
                nn_descent_rounds=nn_descent_rounds,
            ),
        )
    if n_clusters <= 0:
        n_clusters = max(64, min(4096, n // 1024))
    dev = state.vectors.device
    vecs, norms = state.vectors, state.norms_sq
    _timer = build_stage_timer(n)

    def _stage(label):
        _timer(label, vecs)

    # -- 1. centroids on a strided sample --
    s = min(train_sample, n)
    srows = torch.from_numpy(np.linspace(0, n - 1, s, dtype=np.int64)).to(dev)
    sample = vecs[srows].float()
    cent, _ = lloyd(sample[None], kmeans_init(sample[None], n_clusters, 0), n_iters=8)
    cent = cent[0]  # [C, D]
    _stage("kmeans")

    # -- 2. assign + bucket --
    cid = _assign_clusters(vecs, norms, cent, n)
    cid_sorted, order = torch.sort(cid, stable=True)
    counts = torch.bincount(cid_sorted, minlength=n_clusters)
    cap = int(counts.max())
    # guard against pathological skew: fall back to the exact build
    if cap > max(8 * n // n_clusters, 4096):
        return bulk_build_edges(state, n, m=m, m_max=m_max, knn_k=knn_k)
    starts = torch.cumsum(counts, 0) - counts
    bucket_rows = torch.full((n_clusters, cap), -1, dtype=torch.int64, device=dev)
    bucket_rows[cid_sorted, torch.arange(n, device=dev) - starts[cid_sorted]] = order
    _stage("assign+bucket")

    # -- 3. T nearest clusters per cluster (centroid space) --
    cc = (cent * cent).sum(dim=1)
    cd = cc[:, None] - 2.0 * (cent @ cent.T) + cc[None, :]
    nbr_c = stable_topk(cd, probes)[1]  # [C, T] includes self
    cand_rows = bucket_rows[nbr_c].reshape(n_clusters, probes * cap)  # [C, T*cap]

    # -- 4. per-cluster kNN, a group of clusters per step --
    group = max(1, CHUNK_BYTES // max(1, 24 * cap * probes * cap + 8 * probes * cap * vecs.shape[1]))
    kd_parts, ki_parts = [], []
    for c0 in range(0, n_clusters, group):
        rows_c = bucket_rows[c0:c0 + group]   # [g, cap]
        cands_c = cand_rows[c0:c0 + group]    # [g, T*cap]
        safe_r, safe_c = rows_c.clamp_min(0), cands_c.clamp_min(0)
        ip = torch.bmm(vecs[safe_r].float(), vecs[safe_c].float().transpose(1, 2))
        dist = norms[safe_r][:, :, None] - 2.0 * ip + norms[safe_c][:, None, :]
        bad = (cands_c[:, None, :] < 0) | (cands_c[:, None, :] == rows_c[:, :, None])
        dist = torch.where(bad, _masked(dist), dist)
        gd, pos = stable_topk(dist, knn_k)
        gi = cands_c[:, None, :].expand(-1, cap, -1).gather(2, pos)
        kd_parts.append(gd)
        ki_parts.append(torch.where(gd < MASKED, gi, -1))
    kd, ki = torch.cat(kd_parts), torch.cat(ki_parts)  # [C, cap, kk]
    _stage("per-cell knn")

    # -- 5. scatter per-row candidate lists back to row order --
    flat_rows = bucket_rows.reshape(-1)
    keep = flat_rows >= 0
    n_pad = -(-n // PAD_ROWS) * PAD_ROWS
    knn_d = torch.full((n_pad, knn_k), MASKED, dtype=torch.float32, device=dev)
    knn_i = torch.full((n_pad, knn_k), -1, dtype=torch.int64, device=dev)
    knn_d[flat_rows[keep]] = kd.reshape(-1, knn_k)[keep]
    knn_i[flat_rows[keep]] = ki.reshape(-1, knn_k)[keep]
    _stage("scatter-back")

    # -- 5b. NN-descent repair of cell-coverage holes --
    knn_d, knn_i = nn_descent_refine(state, knn_d, knn_i, n, rounds=nn_descent_rounds)
    _stage("nn-descent")

    # -- 6. prune + symmetrize (same tail as the exact build) --
    fwd_rows, fwd_dists = _prune_forward_all(state, knn_d, knn_i, m, prune_chunk)
    del knn_d, knn_i
    _stage("prune")
    out = _symmetrize_and_store(state, fwd_rows, fwd_dists, n, m_max=m_max)
    _stage("symmetrize")
    return out


def _reverse_lists(
    knn_i: torch.Tensor, knn_d: torch.Tensor, n_pad: int, r_slots: int = 32
) -> torch.Tensor:
    """Per-node incoming-edge lists [n_pad, R] from the forward kNN lists
    (the NN-descent reverse join), best-first via the same stable two-key
    sort the symmetrizer uses."""
    kk = knn_i.shape[1]
    dev = knn_i.device
    src = torch.arange(n_pad, device=dev).repeat_interleave(kk)
    dst = knn_i.reshape(-1).long()
    d = knn_d.reshape(-1)
    dst_s = torch.where(dst >= 0, dst, n_pad)
    o1 = torch.sort(d, stable=True).indices
    dst1, src1 = dst_s[o1], src[o1]
    o2 = torch.sort(dst1, stable=True).indices
    dst2, src2 = dst1[o2], src1[o2]
    ar = torch.arange(n_pad, device=dev)
    starts = torch.searchsorted(dst2, ar)
    counts = torch.searchsorted(dst2, ar, right=True) - starts
    slot = torch.arange(r_slots, device=dev)[None, :]
    pos = (starts[:, None] + slot).clamp_max(n_pad * kk - 1)
    ok = slot < counts.clamp_max(r_slots)[:, None]
    return torch.where(ok, src2[pos], -1)


def descent_head_draws(gen: torch.Generator, rows: int, kk: int, expand: int,
                       rev_slots: int, device):
    """The random head columns of one sampled NN-descent round:
    (fcols [rows, expand] in [0, kk), rcols [rows, max(expand // 2, 2)] in
    [0, rev_slots))."""
    nr = max(expand // 2, 2)
    fcols = torch.randint(0, kk, (rows, expand), generator=gen, device=device)
    rcols = torch.randint(0, rev_slots, (rows, nr), generator=gen, device=device)
    return fcols, rcols


def nn_descent_refine(
    state: GraphState,
    knn_d: torch.Tensor,   # [n_pad, K]
    knn_i: torch.Tensor,   # [n_pad, K]
    n: int,
    *,
    rounds: int = 2,
    expand: int = 6,
    rev_slots: int = 32,
    chunk: Optional[int] = None,
    seed: int = 987_654_321,
) -> tuple[torch.Tensor, torch.Tensor]:
    """NN-descent refinement of a kNN-graph estimate: `rounds` sampled
    rounds of `_nn_descent_round`, their head columns drawn here from a
    torch.Generator seeded with `seed`."""
    dev = knn_d.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(rounds):
        fcols, rcols = descent_head_draws(
            gen, knn_d.shape[0], knn_d.shape[1], expand, rev_slots, dev
        )
        knn_d, knn_i = _nn_descent_round(
            state.vectors, state.norms_sq, state.valid, knn_d, knn_i, n,
            fcols, rcols, expand=expand, rev_slots=rev_slots, chunk=chunk,
        )
    return knn_d, knn_i


# ---------------------------------------------------------------------------
# Random-projection blocked build: the large-corpus bulk path.
#
# Sorting by a random projection puts near neighbours into the same
# contiguous block with useful probability; R rounds with fresh directions
# + a reverse-join NN-descent polish converge to a high-recall kNN graph.
# Every stage stays on the device: a sort, one [block, block] matmul per
# block, and a merge into the running top-k.
# ---------------------------------------------------------------------------


def _rp_order(vectors, valid, dirs: torch.Tensor, n: int, *, n_pad: int) -> torch.Tensor:
    """Random-projection sort along `dirs` [D] (drawn by the caller):
    the row permutation [n_pad] int64, dead rows last."""
    rowid = torch.arange(n_pad, device=vectors.device)
    live = (rowid < n) & valid[:n_pad]
    proj = vectors[:n_pad].float() @ dirs
    proj = torch.where(live, proj, torch.full_like(proj, 3.4e38))
    return torch.sort(proj, stable=True).indices


def _rp_block_seg(vectors, norms_sq, valid, orb, n: int, *, block: int, kb: int):
    """Per-block kNN over a segment of sorted blocks. orb: [nbs, block]
    sorted row ids; rows are gathered per block. The rows are multiplied
    as float32 copies: products of bf16 values are exact in f32 and the
    sums are f32, where a bf16 matmul would round its result to bf16.
    -> (dd [nbs, block, kb] f32, rows [nbs, block, kb] int64)."""
    vb = vectors[orb].float()      # [nbs, block, D]
    nbq = norms_sq[orb]            # [nbs, block]
    lv = (orb < n) & valid[orb]
    ip = torch.bmm(vb, vb.transpose(1, 2))
    dist = (nbq[:, :, None] - 2.0 * ip + nbq[:, None, :]).clamp_min(0.0)
    eye = torch.eye(block, dtype=torch.bool, device=vectors.device)
    dist = torch.where(eye[None] | ~lv[:, None, :], _masked(dist), dist)
    dd, pos = stable_topk(dist, kb)
    rows = orb[:, None, :].expand(-1, block, -1).gather(2, pos)
    rows = torch.where(dd < MASKED, rows, -1)
    dd = torch.where(lv[:, :, None], dd, _masked(dd))  # dead query rows
    return dd, rows


def _rp_merge_seg(kd_s, ki_s, bd, bi, off: int, *, block: int):
    """Merge one segment's block results into the running top-K in the
    sorted domain, in place. -> (kd_s, ki_s)."""
    k_run = kd_s.shape[1]
    nbs, _, kb = bd.shape
    rows = nbs * block
    kd_c, ki_c = kd_s[off:off + rows], ki_s[off:off + rows]
    nd_c, ni_c = bd.reshape(rows, kb), bi.reshape(rows, kb)
    dup = (ni_c[:, :, None] == ki_c[:, None, :]).any(dim=2) & (ni_c >= 0)
    nd_c = torch.where(dup, _masked(nd_c), nd_c)
    kd2, pos = stable_topk(torch.cat([kd_c, nd_c], dim=1), k_run)
    ki2 = torch.where(kd2 < MASKED, torch.cat([ki_c, ni_c], dim=1).gather(1, pos), -1)
    kd_s[off:off + rows] = kd2
    ki_s[off:off + rows] = ki2
    return kd_s, ki_s


def _rp_round(
    vectors, norms_sq, valid, kd, ki, dirs, n: int, block: int, kb: int,
    blocks_per_step: Optional[int] = None,
):
    """One random-projection round: sort along `dirs`, per-block kNN and
    merge, `blocks_per_step` blocks at a time (sized by memory when
    None)."""
    n_pad = kd.shape[0]
    order = _rp_order(vectors, valid, dirs, n, n_pad=n_pad)
    nb = n_pad // block
    orb = order.view(nb, block)
    kd_s, ki_s = kd[order], ki[order]
    step = blocks_per_step or max(1, CHUNK_BYTES // (16 * block * block))
    for s0 in range(0, nb, step):
        bd, bi = _rp_block_seg(
            vectors, norms_sq, valid, orb[s0:s0 + step], n, block=block, kb=kb
        )
        _rp_merge_seg(kd_s, ki_s, bd, bi, s0 * block, block=block)
    kd, ki = torch.empty_like(kd_s), torch.empty_like(ki_s)
    kd[order] = kd_s  # order is a permutation: every row is written
    ki[order] = ki_s
    return kd, ki


def _nd_segment(
    vectors, norms_sq, valid, knn_d, knn_i, rev_i, fcols, rcols, off0: int, n: int,
    *, seg: int, ext_k: int,
):
    """NN-descent join for rows [off0, off0 + seg): each row considers
    its neighbours, its reverse neighbours and the forward lists of the
    heads that fcols / rcols pick from both. Keeps the best K."""
    kk = knn_d.shape[1]
    dev = knn_d.device
    sl = slice(off0, off0 + seg)
    rows_c = torch.arange(off0, off0 + seg, device=dev).clamp_max(n - 1)
    ki_c, rv_c = knn_i[sl], rev_i[sl]
    heads = torch.cat([ki_c.gather(1, fcols[sl]), rv_c.gather(1, rcols[sl])], dim=1)
    ext = knn_i[heads.clamp_min(0)]  # [seg, heads, kk]
    if ext_k:  # cap the per-head join width
        ext = ext[:, :, :ext_k]
    ext = torch.where(heads[:, :, None] >= 0, ext, -1)
    cand = torch.cat([ki_c, rv_c, ext.reshape(seg, -1)], dim=1)
    safe = cand.clamp_min(0)
    q = vectors[rows_c].float()
    ip = torch.bmm(vectors[safe].float(), q[:, :, None])[:, :, 0]
    dist = norms_sq[rows_c][:, None] - 2.0 * ip + norms_sq[safe]
    bad = (cand < 0) | (cand == rows_c[:, None]) | ~valid[safe] | later_duplicate(cand)
    dist = torch.where(bad, _masked(dist), dist)
    nd, pos = stable_topk(dist, kk)
    return nd, torch.where(nd < MASKED, cand.gather(1, pos), -1)


def _nn_descent_round(
    vectors, norms_sq, valid, knn_d, knn_i, n: int,
    fcols: Optional[torch.Tensor] = None, rcols: Optional[torch.Tensor] = None,
    *, expand: int = 4, rev_slots: int = 32, chunk: Optional[int] = None,
    ext_k: int = 0,
):
    """One NN-descent round over all n_pad rows, `chunk` rows at a time
    (sized by memory when None).

    fcols [n_pad, expand], rcols [n_pad, max(expand // 2, 2)]: when
    given, the expansion heads are those (random) columns of the forward
    and reverse lists instead of always the best few - deterministic
    heads explore the same candidates every round and convergence
    stalls."""
    n_pad, kk = knn_d.shape
    dev = knn_d.device
    # reverse join over the best 16 forward edges only: the influential
    # reverse edges come from the top of the forward lists
    kk_rev = min(kk, 16)
    rev_i = _reverse_lists(knn_i[:, :kk_rev], knn_d[:, :kk_rev], n_pad, rev_slots)
    nf, nr = expand, max(expand // 2, 2)
    if fcols is None:
        fcols = torch.arange(nf, device=dev).expand(n_pad, nf)
        rcols = torch.arange(nr, device=dev).expand(n_pad, nr)
    w = kk + rev_slots + (nf + nr) * (ext_k or kk)
    chunk = chunk or _rows_for(w * (6 * vectors.shape[1] + 64))
    out_d, out_i = [], []
    for off in range(0, n_pad, chunk):
        nd, ni = _nd_segment(
            vectors, norms_sq, valid, knn_d, knn_i, rev_i, fcols, rcols, off, n,
            seg=min(chunk, n_pad - off), ext_k=ext_k,
        )
        out_d.append(nd)
        out_i.append(ni)
    return torch.cat(out_d), torch.cat(out_i)


def bulk_build_rp(
    state: GraphState,
    n: int,
    *,
    m: int,
    m_max: int,
    knn_k: int = 32,
    rounds: int = 8,
    block: int = 2048,
    nn_rounds: int = 2,
    prune_chunk: Optional[int] = None,
    seed: int = 0,
    diversify: bool = False,
) -> GraphState:
    """Random-projection blocked kNN-graph build (the large-n route on a
    card). O(N * block * D) flops per round against the exact build's
    O(N^2 * D). The directions and the descent's head columns are drawn
    from a torch.Generator seeded with `seed`."""
    if _is_quantized(state):
        return _reattach_codes(
            state,
            bulk_build_rp(
                _densified(state), n, m=m, m_max=m_max, knn_k=knn_k,
                rounds=rounds, block=block, nn_rounds=nn_rounds,
                prune_chunk=prune_chunk, seed=seed, diversify=diversify,
            ),
        )
    pad_to_rows = max(block, PAD_ROWS)
    n_pad = -(-n // pad_to_rows) * pad_to_rows
    # the capacity can be smaller than n_pad at block granularity: pad
    # transient working views up to n_pad (dead rows are valid=False)
    vecs, norms, valid = state.vectors, state.norms_sq, state.valid
    dev = vecs.device
    cap = vecs.shape[0]
    if cap < n_pad:
        extra = n_pad - cap
        vecs = torch.cat([vecs, torch.zeros((extra, vecs.shape[1]), dtype=vecs.dtype, device=dev)])
        norms = torch.cat([norms, torch.zeros((extra,), dtype=norms.dtype, device=dev)])
        valid = torch.cat([valid, torch.zeros((extra,), dtype=torch.bool, device=dev)])
    kb = min(knn_k, 32)
    kd = torch.full((n_pad, knn_k), MASKED, dtype=torch.float32, device=dev)
    ki = torch.full((n_pad, knn_k), -1, dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    _stage = build_stage_timer(n, tag="rp-build")

    for r in range(rounds):
        dirs = torch.randn((vecs.shape[1],), generator=gen, device=dev)
        kd, ki = _rp_round(vecs, norms, valid, kd, ki, dirs, n, block, kb)
        _stage(f"rp round {r}", kd)
    for r in range(nn_rounds):
        fcols, rcols = descent_head_draws(gen, n_pad, knn_k, 4, 32, dev)
        kd, ki = _nn_descent_round(vecs, norms, valid, kd, ki, n, fcols, rcols)
        _stage(f"nn-descent round {r}", kd)
    fwd_rows, fwd_dists = _prune_forward_all(state, kd, ki, m, prune_chunk)
    _stage("prune", fwd_rows)
    # release the kNN working set before the symmetrize sorts
    del kd, ki
    out = _symmetrize_and_store(
        state, fwd_rows, fwd_dists, n, m_max=m_max, diversify=diversify
    )
    _stage("symmetrize", out.nbrs)
    return out
