"""SQ8 scalar quantization: per-dim affine int8 storage, and its residual
variant sq8r.

Counterpart of longbow_tpu/index/sq8.py. Codes are recentered signed
bytes (the u8 grid value minus 128) with the shift folded into the
affine (lo_eff = lo + 128 * scale), so archives move between the two
packages unchanged. Identity ingest of int8 data stores the input bytes
1:1 (uint8 stores value - 128).

Search: with k <= 64 (and, for sq8r, an l2 or cosine metric) the codes
go through kernel K2 (ops/scan.py::fused_codes_search) for a pool of 64
candidates, which is then re-ranked exactly in f32 against the
dequantized rows; otherwise a chunked scan in plain torch ops serves
the query. The gate holds on any device: on the CPU K2's plain version
stands in for the kernel.

SQ8ResidualIndex ("sq8r") stores v - center(cluster(v)) under one global
affine, plus a cluster id per row, in two regions: a MAIN region grouped
by cluster, where each 128-row group holds one cluster so that the
-2 q.center term rides K2 as a per-group input, and an append-order
DELTA region, merged. A fused search scans the delta with K2 too,
through a cluster-grouped view of its live rows built at the first such
search after an add (a delta whose view would be mostly padding, dot
and k > 64 scan it in plain torch ops). A relayout on the device folds
the delta into main once it passes a quarter of main. External row ids
stay stable across relayouts through a host slot map.
"""
from __future__ import annotations

import math
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from longbow_tpu_torch.device import resolve_device
from longbow_tpu_torch.metrics.registry import count, count_dispatch
from longbow_tpu_torch.ops.distance import (
    MASKED,
    MASKED_GUARD,
    Metric,
    cosine_report,
    fit_mask,
    full_f32_matmul,
    normalize_rows,
    pad_to,
    tombstone_rows,
)
from longbow_tpu_torch.ops.kmeans import kmeans_init, lloyd, nearest_center
from longbow_tpu_torch.ops.scan import GROUP, fused_codes_search
from longbow_tpu_torch.utils.launch import launched
from longbow_tpu_torch.utils.tracing import span

MIN_CAPACITY = 4096
# sq8r main-region capacity quantum (longbow_tpu's kernel tile multiple,
# kept so that both packages lay the same rows out alike)
SQ8R_TILE = 16384
# the fused scan serves k up to this, for a pool of POOL candidates
FUSED_MAX_K = 64
POOL = 64
# queries per search dispatch and rows per chunk of the plain scans:
# bound the [B, pool, D] re-rank block and the [B, chunk] score block
QUERY_CHUNK = 4096
SCAN_CHUNK = 131072
# A fused search scans sq8r's delta with K2 over its view when the view
# holds at most DELTA_VIEW_MAX times the rows of the delta's capacity,
# which the plain chunked scan reads whole. The view pads each cluster to
# 128 rows, so the clusters the delta touches set its size, not its rows
# (4,096 rows in 1,024 clusters: 116,736). A view row costs K2 a small
# part of what a capacity row costs the plain scan, and K2 carries
# 0.2-1 ms more of fixed work. Read off tools/probe_sq8r_delta.py (D = 96,
# 1% deleted; device ms of a search with no main region, the view built
# beforehand; 112 points at 1,024, 4,096 and 16,384 clusters, 1 to 2,000
# queries) on an NVIDIA H100 80GB HBM3 at 700 W: at 15.8 times or less K2
# lost no search by more than 0.5 ms and won from 1,000 queries by up to
# 46 ms (16,384 clusters, 524,288 rows, 4.0 times, 2,000 queries: 6.59
# against 52.85 ms); from 28.5 times the plain scan won every search of
# 64 queries or fewer and lost by at most 1.4 ms above. A put between
# searches also costs K2 the view's build (1.2-2.7 ms to 1,048,576 rows,
# 11.7 at 2,500,000), which the rule leaves out.
DELTA_VIEW_MAX = 16


def _quantize(vecs: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """f32 -> recentered int8 codes (u8 grid minus 128), in longbow_tpu's
    order of operations so that the codes are bit-identical; torch.round
    rounds half to even, as jnp.round does."""
    scale = torch.clamp_min(hi - lo, 1e-12)
    q = torch.round((vecs - lo) / scale * 255.0)
    return (torch.clamp(q, 0.0, 255.0) - 128.0).to(torch.int8)


def _affine(lo: torch.Tensor, hi: torch.Tensor):
    """(scale, lo_eff): a code c dequantizes to c * scale + lo_eff."""
    scale = torch.clamp_min(hi - lo, 1e-12) / 255.0
    return scale, lo + 128.0 * scale


def _sq8_append(codes, norms, valid, new_codes, new_norms, row: int):
    """Write a block at [row, row + n) in place."""
    n = new_codes.shape[0]
    codes[row:row + n] = new_codes
    norms[row:row + n] = new_norms
    valid[row:row + n] = True


def _grown(t: Optional[torch.Tensor], cap: int, shape_tail=(), dtype=None, fill=0, device=None):
    """A [cap, *shape_tail] tensor holding t's rows first and `fill` after."""
    if t is None:
        return torch.full((cap, *shape_tail), fill, dtype=dtype, device=device)
    out = torch.full((cap, *t.shape[1:]), fill, dtype=t.dtype, device=t.device)
    out[: t.shape[0]] = t
    return out


def _tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _masked_result(b: int, k: int):
    return (np.full((b, k), MASKED, np.float32), np.full((b, k), -1, np.int64))


def _queue_to_host(*ts: torch.Tensor):
    """Queues the copies of `ts` to the host and returns a function that
    waits for them -> [numpy arrays]. On a card: copies without a wait
    into pinned memory and an event after them, so that the caller can
    let the next search launch before it waits (an event's wait lets go
    of the interpreter lock); on the CPU the arrays at once."""
    if not ts[0].is_cuda:
        out = [t.cpu().numpy() for t in ts]
        return lambda: out
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
            for t in ts]
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(ts[0].device))

    def wait():
        done.synchronize()
        # copied out, so that the answer holds no pinned memory
        return [h.numpy().copy() for h in host]
    return wait


def _chunked_topk(score_chunk, n: int, k: int, chunk: int):
    """Concatenated per-chunk top-k of score_chunk(start, end) -> [B, m]
    scores and the rows they came from."""
    ds, ix = [], []
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        s = score_chunk(start, end)
        d, i = torch.topk(s, min(k, end - start), dim=1, largest=False)
        ds.append(d)
        ix.append(i + start)
    return torch.cat(ds, dim=1), torch.cat(ix, dim=1)


def _best(d, i, k: int):
    """The k smallest of (d, i) per row, ascending; masked or missing
    slots exactly (MASKED, -1)."""
    if d.shape[1] < k:
        pad = k - d.shape[1]
        d = torch.cat([d, torch.full((d.shape[0], pad), MASKED, device=d.device)], 1)
        i = torch.cat([i, torch.full((i.shape[0], pad), -1, dtype=i.dtype, device=i.device)], 1)
    vals, pos = torch.topk(d, k, dim=1, largest=False)
    ids = torch.gather(i, 1, pos)
    real = vals < MASKED_GUARD
    return torch.where(real, vals, torch.full_like(vals, MASKED)), torch.where(
        real, ids, torch.full_like(ids, -1)
    )


def _sq8_fused(q, codes, lo, hi, norms_sq, valid, k, metric, extra_mask, device):
    """K2 for a pool of POOL candidates, then an exact f32 re-rank of the
    pool against the dequantized rows (longbow_tpu's _sq8_fused_packed,
    without the int32 packing). q is f32, already normalized for
    cosine."""
    full_f32_matmul()
    scale, lo_eff = _affine(lo, hi)
    pool = max(POOL, k)
    if metric == Metric.DOT:
        # score = -(q.codes * scale + q.lo_eff) in the l2-form kernel:
        # the query side halved, no row term, no clamp
        d, i = fused_codes_search(
            q * scale * 0.5, -(q @ lo_eff), codes, torch.zeros_like(norms_sq),
            valid, pool, extra_mask=extra_mask, clamp_zero=False, device=device,
        )
    else:  # l2 (cosine rides l2 on normalized rows)
        d, i = fused_codes_search(
            q * scale, (q * q).sum(dim=1) - 2.0 * (q @ lo_eff), codes, norms_sq,
            valid, pool, extra_mask=extra_mask, device=device,
        )
    cand = codes[i.clamp_min(0).long()].float() * scale + lo_eff  # [B, pool, D]
    ip = torch.einsum("bd,bkd->bk", q, cand)
    if metric == Metric.DOT:
        ed = -ip
    else:
        qn = (q * q).sum(dim=1, keepdim=True)
        ed = torch.clamp_min(qn - 2.0 * ip + (cand * cand).sum(dim=2), 0.0)
    ed = torch.where(d < MASKED_GUARD, ed, torch.full_like(ed, MASKED))
    return _best(ed, i.long(), k)


def _sq8_scan(codes, lo, hi, norms_sq, q, valid, k, metric):
    """Chunked affine-folded scan (k > 64): q.v = (q * scale).codes +
    q.lo_eff keeps the int8 codes the only big operand; the query side
    is rounded to bf16 as in longbow_tpu."""
    full_f32_matmul()
    scale, lo_eff = _affine(lo, hi)
    qs = (q * scale).to(torch.bfloat16).float()
    q_lo = (q * lo_eff).sum(dim=1, keepdim=True)
    qn = (q * q).sum(dim=1, keepdim=True)

    def score(start, end):
        ip = qs @ codes[start:end].float().T + q_lo
        dist = -ip if metric == Metric.DOT else torch.clamp_min(
            qn - 2.0 * ip + norms_sq[None, start:end], 0.0
        )
        return torch.where(valid[None, start:end], dist, torch.full_like(dist, MASKED))

    d, i = _chunked_topk(score, codes.shape[0], k, SCAN_CHUNK)
    return _best(d, i, k)


class _AffineCodes:
    """What SQ8Index and SQ8ResidualIndex share: the global per-dim affine
    (lo, hi), the row count, the lock, input conversion and archive code
    decoding. It holds no row storage. device: where the tensors live;
    None means the CUDA card (and raises without one)."""

    def __init__(self, dim: int, metric: str = Metric.L2, *, device=None):
        self.device = resolve_device(device)
        self.dim = dim
        self.metric = Metric.validate(metric)
        self.lo: Optional[torch.Tensor] = None
        self.hi: Optional[torch.Tensor] = None
        self.count = 0
        self._mu = threading.RLock()

    @property
    def is_trained(self) -> bool:
        return self.lo is not None

    def _prep(self, vecs) -> torch.Tensor:
        """f32 rows on the device, normalized for cosine."""
        if isinstance(vecs, torch.Tensor):
            v = vecs.to(self.device, torch.float32)
        else:
            v = torch.from_numpy(np.ascontiguousarray(vecs, np.float32)).to(self.device)
        if v.ndim != 2 or v.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}] vectors, got {tuple(v.shape)}")
        if self.metric == Metric.COSINE:
            v = normalize_rows(v)
        return v

    def _query(self, queries) -> torch.Tensor:
        if isinstance(queries, torch.Tensor):
            q = queries.to(self.device, torch.float32)
        else:
            q = torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32))).to(self.device)
        return q[None, :] if q.ndim == 1 else q

    def warm(self) -> None:
        """One search of a single query, which builds K2 on a card."""
        self.search(np.zeros((1, self.dim), np.float32), 10)

    @staticmethod
    def _import_codes(st: dict) -> np.ndarray:
        """Archive codes -> recentered int8 (legacy archives stored raw
        uint8; newer ones store int8 with codes_centered)."""
        codes = np.asarray(st["codes"])
        if st.get("codes_centered"):
            return codes.astype(np.int8)
        return (codes.astype(np.int16) - 128).astype(np.int8)


class SQ8Index(_AffineCodes):
    """int8-quantized flat index with the fused codes scan.

    Tensors are padded to a power-of-two capacity that doubles on
    demand; appends write in place."""

    def __init__(self, dim: int, metric: str = Metric.L2, *, device=None):
        super().__init__(dim, metric, device=device)
        self.codes: Optional[torch.Tensor] = None
        self.norms_sq: Optional[torch.Tensor] = None
        self.valid: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return 0 if self.codes is None else self.codes.shape[0]

    def train(self, vecs) -> None:
        """Per-dim min/max. int8/uint8 input trains an identity affine
        (lo/hi = the dtype's full range): the stored codes are then the
        ingested bytes 1:1 for int8 (uint8 recenters by -128, exactly
        invertible)."""
        if not isinstance(vecs, torch.Tensor):
            vecs_np = np.asarray(vecs)
            if self.metric == Metric.COSINE:
                vecs_np = vecs_np.astype(np.float32)  # codes store normalized rows
            if vecs_np.dtype in (np.int8, np.uint8):
                lo, hi = (-128.0, 127.0) if vecs_np.dtype == np.int8 else (0.0, 255.0)
                self.lo = torch.full((self.dim,), lo, device=self.device)
                self.hi = torch.full((self.dim,), hi, device=self.device)
                return
        v = self._prep(vecs)
        self.lo = v.min(dim=0).values
        self.hi = v.max(dim=0).values

    def _grow_to(self, need: int) -> None:
        cap = max(self.capacity, MIN_CAPACITY)
        while cap < need:
            cap *= 2
        if cap > self.capacity:
            self.codes = _grown(self.codes, cap, (self.dim,), torch.int8, device=self.device)
            self.norms_sq = _grown(self.norms_sq, cap, (), torch.float32, device=self.device)
            self.valid = _grown(self.valid, cap, (), torch.bool, False, device=self.device)

    def add(self, vecs) -> np.ndarray:
        if not self.is_trained:
            self.train(vecs)
        v = self._prep(vecs)
        codes = _quantize(v, self.lo, self.hi)
        deq = self._dequant(codes)
        norms = (deq * deq).sum(dim=1)
        n = codes.shape[0]
        with self._mu:
            self._grow_to(self.count + n)
            _sq8_append(self.codes, self.norms_sq, self.valid, codes, norms, self.count)
            rows = np.arange(self.count, self.count + n, dtype=np.int64)
            self.count += n
        return rows

    def _dequant(self, codes: torch.Tensor) -> torch.Tensor:
        scale, lo_eff = _affine(self.lo, self.hi)
        return codes.float() * scale + lo_eff

    def delete_rows(self, rows) -> None:
        if len(rows) and self.valid is not None:
            with self._mu:
                tombstone_rows(self.valid, rows)

    def get_vectors(self, rows) -> np.ndarray:
        """Dequantized f32 host copies of the stored rows."""
        return self.get_vectors_device(rows).cpu().numpy()

    def get_vectors_device(self, rows) -> torch.Tensor:
        """The dequantized f32 rows, left on the device."""
        idx = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        with self._mu:
            return self._dequant(self.codes[idx])

    def device_bytes(self) -> int:
        return _tensor_bytes(self.codes, self.norms_sq, self.valid, self.lo, self.hi)

    def search(self, queries, k: int, *, filter_mask=None):
        """-> (dist [B, k] f32, rows [B, k] int64) as numpy; masked or
        missing slots are (MASKED, -1). filter_mask: [capacity] bool of
        allowed rows."""
        q = self._query(queries)
        fused = k <= FUSED_MAX_K and self.codes is not None
        if not fused:
            count_dispatch("xla")
        if self.codes is None:
            return _masked_result(q.shape[0], k)
        normalize = self.metric == Metric.COSINE
        metric = Metric.L2 if normalize else self.metric
        if normalize:
            q = normalize_rows(q)
        outs = []
        with self._mu:
            mask = fit_mask(filter_mask, self.capacity, self.device)
            for off in range(0, q.shape[0], QUERY_CHUNK):
                qc = q[off:off + QUERY_CHUNK]
                if fused:
                    outs.append(_sq8_fused(
                        qc, self.codes, self.lo, self.hi, self.norms_sq, self.valid,
                        k, metric, mask, self.device,
                    ))
                else:
                    valid = self.valid if mask is None else self.valid & mask
                    outs.append(_sq8_scan(
                        self.codes, self.lo, self.hi, self.norms_sq, qc, valid, k, metric,
                    ))
        if fused:
            count_dispatch("pallas_sq8_fused", self.codes.is_cuda)
        d = torch.cat([o[0] for o in outs]).cpu().numpy()
        i = torch.cat([o[1] for o in outs]).cpu().numpy()
        if normalize:
            d = cosine_report(d)
        return d, i

    def export_state(self) -> dict:
        """longbow_tpu's SQ8Index.export_state layout."""
        with self._mu:
            n = self.count
            return {
                "kind": "sq8",
                "dim": self.dim,
                "metric": self.metric,
                "count": n,
                "lo": self.lo.cpu().numpy(),
                "hi": self.hi.cpu().numpy(),
                "codes": self.codes[:n].cpu().numpy(),
                "codes_centered": True,
                "valid": self.valid[:n].cpu().numpy(),
            }

    @classmethod
    def import_state(cls, st: dict, *, device=None) -> "SQ8Index":
        """Rebuild from export_state() output, this package's or
        longbow_tpu's (same keys)."""
        idx = cls(int(st["dim"]), st["metric"], device=device)
        idx.lo = torch.tensor(np.asarray(st["lo"], np.float32), device=idx.device)
        idx.hi = torch.tensor(np.asarray(st["hi"], np.float32), device=idx.device)
        n = int(st["count"])
        idx._grow_to(n)
        if n:
            codes = torch.from_numpy(cls._import_codes(st)).to(idx.device)
            deq = idx._dequant(codes)
            _sq8_append(idx.codes, idx.norms_sq, idx.valid, codes, (deq * deq).sum(dim=1), 0)
            idx.valid[:n] = torch.tensor(np.asarray(st["valid"], bool), device=idx.device)
        idx.count = n
        return idx


# ---------------------------------------------------------------------------
# sq8r: residual (mean-centered) SQ8 with the cluster-grouped layout
# ---------------------------------------------------------------------------


def _cluster_padded_total(m_gcid, m_valid, d_cid, d_valid, n_clusters: int) -> int:
    """Row total of a relayout, each cluster padded to a GROUP multiple."""
    m_cid = m_gcid[torch.arange(m_valid.shape[0], device=m_valid.device) // GROUP]
    cid_all = torch.cat([m_cid, d_cid])
    valid_all = torch.cat([m_valid, d_valid])
    cid_s = torch.where(valid_all, cid_all, torch.full_like(cid_all, n_clusters))
    counts = torch.bincount(cid_s, minlength=n_clusters + 1)[:n_clusters]
    return int(((counts + GROUP - 1) // GROUP * GROUP).sum())


def interleave_stride(g_total: int) -> int:
    """longbow_tpu's golden-ratio group stride: coprime with g_total (so
    the group permutation is a bijection) and capped so that
    group * stride stays inside int32 there."""
    max_stride = max((2**31 - 1) // max(g_total, 1) - 1, 1)
    stride = min(max(1, int(g_total * 0.6180339887)), max_stride) | 1
    while stride > 1 and math.gcd(stride, g_total) != 1:
        stride -= 2
    return stride


def _relayout(
    m_codes, m_gcid, m_norms, m_valid, m_ext,
    d_codes, d_cid, d_norms, d_valid, d_ext,
    n_clusters: int, new_cap: int, ext_cap: int,
):
    """Merge main and delta into a fresh main region grouped by cluster,
    each cluster padded to a GROUP multiple so that every 128-row group
    holds one cluster (K2's group-term precondition). Invalid rows are
    dropped. Returns the new region plus an ext -> slot inverse for the
    host map. Index arithmetic is int64.

    The groups are then permuted by a golden-ratio stride: with clusters
    laid out one after another, a query's true neighbours crowd into few
    consecutive groups; longbow_tpu measured a recall loss from that on
    its TPU kernel, and the port keeps the same layout so that both
    packages place every row alike."""
    C = n_clusters
    dev = m_codes.device
    m_cap = m_codes.shape[0]
    m_cid = m_gcid[torch.arange(m_cap, device=dev) // GROUP]
    codes_all = torch.cat([m_codes, d_codes])
    cid_all = torch.cat([m_cid, d_cid])
    norms_all = torch.cat([m_norms, d_norms])
    valid_all = torch.cat([m_valid, d_valid])
    ext_all = torch.cat([m_ext, d_ext])

    cid_s = torch.where(valid_all, cid_all, torch.full_like(cid_all, C))
    sc, perm = torch.sort(cid_s, stable=True)
    counts = torch.bincount(cid_s, minlength=C + 1)
    cvalid = counts[:C]
    padded = (cvalid + GROUP - 1) // GROUP * GROUP
    off_pad = torch.cumsum(padded, 0) - padded        # cluster start (padded)
    off_unpad = torch.cumsum(cvalid, 0) - cvalid      # rank offset (unpadded)
    pos = torch.arange(sc.shape[0], device=dev)
    scc = torch.clamp_max(sc, C - 1)
    real = sc < C
    dest = off_pad[scc] + pos - off_unpad[scc]
    g_total = new_cap // GROUP
    stride = interleave_stride(g_total)
    dest = (dest // GROUP * stride) % g_total * GROUP + dest % GROUP
    # rows that are dropped go to a spare row at new_cap, sliced off below
    # (a torch scatter does not drop out-of-range indices)
    dest = torch.where(real, dest, torch.full_like(dest, new_cap))

    def scat(fill, sorted_vals):
        """sorted_vals (in the sorted order of `perm`) at `dest`."""
        out = torch.full((new_cap + 1, *sorted_vals.shape[1:]), fill, dtype=sorted_vals.dtype,
                         device=dev)
        out[dest] = sorted_vals
        return out[:new_cap]

    new_codes = scat(0, codes_all[perm])
    new_norms = scat(0, norms_all[perm])
    new_valid = scat(False, real)
    new_ext = scat(-1, torch.where(valid_all, ext_all, torch.full_like(ext_all, -1))[perm])
    new_gcid = scat(0, torch.clamp_max(cid_all, C - 1)[perm])[::GROUP].clone()
    inv_idx = torch.where(new_ext >= 0, new_ext, torch.full_like(new_ext, ext_cap))
    inv = torch.full((ext_cap + 1,), -1, dtype=torch.int64, device=dev)
    inv[inv_idx] = torch.arange(new_cap, device=dev)
    return new_codes, new_gcid, new_norms, new_valid, new_ext, inv[:ext_cap]


def _delta_append(codes, norms, valid, cids, exts, nc, nn, ncid, next_, row: int):
    """Write a block into the delta region at [row, row + n), in place."""
    n = nc.shape[0]
    _sq8_append(codes, norms, valid, nc, nn, row)
    cids[row:row + n] = ncid
    exts[row:row + n] = next_


def _region_scores(codes, cid, norms, valid, qs16, q_lo, qc, qn, metric, pool, chunk):
    """Per-chunk top candidates of one region's exact-layout scores,
    concatenated: [B, m] distances and region rows. Each chunk keeps
    min(pool, chunk) rows, so a pool of any size survives (longbow_tpu
    keeps 64 per chunk, which drops neighbours at k > 64)."""
    cap = codes.shape[0]
    chunk = min(cap, chunk)
    qf16 = qs16.float()

    def score(start, end):
        ip = qf16 @ codes[start:end].float().T + q_lo + qc[:, cid[start:end]]
        dist = -ip if metric == Metric.DOT else torch.clamp_min(
            qn - 2.0 * ip + norms[None, start:end], 0.0
        )
        return torch.where(valid[None, start:end], dist, torch.full_like(dist, MASKED))

    return _chunked_topk(score, cap, min(pool, chunk), chunk)


class DeltaView(NamedTuple):
    """The delta region's live rows laid out as the main region is, for
    K2: each cluster padded to a GROUP multiple, so that every 128-row
    group holds one cluster. slot: each position's delta slot (-1 on
    padding)."""

    codes: torch.Tensor  # [G * GROUP, D] int8
    norms: torch.Tensor  # [G * GROUP] f32
    gcid: torch.Tensor   # [G] int64, the cluster of each group
    slot: torch.Tensor   # [G * GROUP] int64


def delta_view_rows(d_cid, d_valid, n_clusters: int) -> int:
    """Rows of the delta's view: each cluster's live rows padded to a
    GROUP multiple, the groups to a multiple of 8, so that K2 reads each
    query's f32 group term 16 bytes at a time."""
    none = d_cid[:0]
    total = _cluster_padded_total(none, d_valid[:0], d_cid, d_valid, n_clusters)
    return pad_to(max(total, GROUP), 8 * GROUP)


def delta_view(d_codes, d_cid, d_norms, d_valid, n_clusters: int, rows: int) -> DeltaView:
    """_relayout of the delta with an empty main region and the delta's
    slots in place of external ids, into `rows` rows (delta_view_rows).
    Rows deleted before the build are left out; a later delete reaches
    the view through its slots."""
    dev = d_codes.device
    cap = d_codes.shape[0]
    none = torch.zeros((0,), dtype=torch.int64, device=dev)
    codes, gcid, norms, _, slot, _ = _relayout(
        d_codes[:0], none, d_norms[:0], d_valid[:0], none,
        d_codes, d_cid, d_norms, d_valid, torch.arange(cap, device=dev),
        n_clusters, rows, cap,
    )
    return DeltaView(codes, norms, gcid, slot)


class QueryTerms(NamedTuple):
    """A query batch's terms in an sq8r search, all f32: the affine
    (a code c dequantizes to c * scale + lo_eff), the queries (normalized
    for cosine), q.centers [B, C], |q|^2 [B, 1] and q.lo_eff [B, 1]."""

    scale: torch.Tensor
    lo_eff: torch.Tensor
    qf: torch.Tensor
    qc: torch.Tensor
    qn: torch.Tensor
    q_lo: torch.Tensor


def query_terms(q, centers, lo, hi, normalize: bool) -> QueryTerms:
    scale, lo_eff = _affine(lo, hi)
    qf = normalize_rows(q) if normalize else q.float()
    qc = qf @ centers.T                      # [B, C], f32: feeds the exact re-rank
    return QueryTerms(scale, lo_eff, qf, qc, (qf * qf).sum(dim=1, keepdim=True),
                      qf @ lo_eff[:, None])


def delta_pool(t: QueryTerms, view: Optional[DeltaView], d_codes, d_cid, d_norms, dv,
               metric: str, pool: int, device):
    """The delta region's candidates: (coarse distances [B, pool], delta
    slots [B, pool]), masked ones (MASKED, any slot). With a view (l2, pool
    <= 64): K2 over it, its f32 group term the plain scan's cluster term,
    so that only the order of the f32 sum differs (the main region's term
    is bf16); else the plain chunked scan over the delta's capacity. dv:
    the delta's validity with the filter folded in."""
    if view is not None:
        vv = dv[view.slot.clamp_min(0)] & (view.slot >= 0)
        dd, pos = fused_codes_search(
            t.qf * t.scale, t.qn[:, 0] - 2.0 * t.q_lo[:, 0], view.codes, view.norms, vv, pool,
            group_term=-2.0 * t.qc[:, view.gcid], device=device,
        )
        return dd, view.slot[pos.clamp_min(0).long()]
    ad, ai = _region_scores(
        d_codes, d_cid, d_norms, dv, (t.qf * t.scale).to(torch.bfloat16), t.q_lo, t.qc, t.qn,
        metric, pool, SCAN_CHUNK,
    )
    dd, pos = torch.topk(ad, min(pool, ad.shape[1]), dim=1, largest=False)
    return dd, torch.gather(ai, 1, pos)


def group_term(qc: torch.Tensor, m_gcid: torch.Tensor) -> torch.Tensor:
    """K2's per-group cluster term -2 q.center(group), [B, groups] bf16,
    from qc = q @ centers.T [B, C]."""
    return (-2.0 * qc[:, m_gcid]).to(torch.bfloat16)


def _sq8r_search(
    q,
    m_codes, m_gcid, m_norms, m_valid, m_ext,
    d_codes, d_cid, d_norms, d_valid, d_ext,
    centers, lo, hi, ext_mask,
    k: int, metric: str, normalize: bool, fused: bool, has_delta: bool, device,
    view: Optional[DeltaView] = None,
):
    """Main-region scan (K2 with the per-group cluster term, or the plain
    chunked scan), delta-region scan (K2 over `view` with an f32 group
    term when given, else the plain chunked scan), an exact dequantized
    re-rank per region, and the merge into external ids (longbow_tpu's
    _sq8r_packed, without the int32 packing). -> (dist [B, k], ext ids
    [B, k])."""
    full_f32_matmul()
    with span("longbow.sq8r.prep"):
        terms = query_terms(q, centers, lo, hi, normalize)
    scale, lo_eff, qf, qc, qn, q_lo = terms
    pool = max(POOL, k)

    def region_mask(ext, valid):
        if ext_mask is None:
            return valid
        # the mask is indexed by EXTERNAL row; ext ids past its end (a
        # stale mask during growth) are excluded rather than read
        n_mask = ext_mask.shape[0]
        m = ext_mask[ext.clamp(0, n_mask - 1)]
        return valid & m & (ext >= 0) & (ext < n_mask)

    def rerank(coarse_d, idx, codes, norms, cid_of, ext_of):
        i_safe = idx.clamp_min(0).long()
        ext_c = ext_of[i_safe]
        vec = codes[i_safe].float() * scale + lo_eff + centers[cid_of(i_safe)]
        ip = torch.einsum("bd,bkd->bk", qf, vec)
        if metric == Metric.DOT:
            ed = -ip
        else:
            ed = torch.clamp_min(qn - 2.0 * ip + norms[i_safe], 0.0)
        ed = torch.where((coarse_d < MASKED_GUARD) & (ext_c >= 0), ed, torch.full_like(ed, MASKED))
        return ed, ext_c

    parts_d, parts_e = [], []
    m_cap = m_codes.shape[0]
    if m_cap:
        with span("longbow.sq8r.main"):
            mv = region_mask(m_ext, m_valid)
            if fused:
                gt = group_term(qc, m_gcid)
                dm, im = fused_codes_search(
                    qf * scale, qn[:, 0] - 2.0 * q_lo[:, 0], m_codes, m_norms, mv, pool,
                    group_term=gt, device=device,
                )
            else:
                m_cid = m_gcid[torch.arange(m_cap, device=m_codes.device) // GROUP]
                ad, ai = _region_scores(
                    m_codes, m_cid, m_norms, mv, (qf * scale).to(torch.bfloat16), q_lo, qc, qn,
                    metric, pool, SCAN_CHUNK,
                )
                dm, pos = torch.topk(ad, min(pool, ad.shape[1]), dim=1, largest=False)
                im = torch.gather(ai, 1, pos)
            ed, ec = rerank(dm, im, m_codes, m_norms, lambda i: m_gcid[i // GROUP], m_ext)
        parts_d.append(ed)
        parts_e.append(ec)
    if has_delta and d_codes.shape[0]:
        with span("longbow.sq8r.delta"):
            dd, di = delta_pool(terms, view, d_codes, d_cid, d_norms,
                                region_mask(d_ext, d_valid), metric, pool, device)
            ed, ec = rerank(dd, di, d_codes, d_norms, lambda i: d_cid[i], d_ext)
        count("longbow_sq8r_delta_scans_total", route="plain" if view is None else "k2")
        parts_d.append(ed)
        parts_e.append(ec)
    with span("longbow.sq8r.merge"):
        return _best(torch.cat(parts_d, dim=1), torch.cat(parts_e, dim=1), k)


class SQ8ResidualIndex(_AffineCodes):
    """SQ8 with k-means mean-centering (index kind "sq8r").

    Codes store v - center(cluster(v)) under a global per-dim affine over
    the residuals, plus one cluster id per row. On clustered corpora the
    residual range is the spread inside a cluster, not across the corpus,
    so the quantization step shrinks by that ratio at about one byte per
    dim and row."""

    N_CLUSTERS = 1024
    TRAIN_SAMPLE = 131_072
    DELTA_MIN = 4096

    def __init__(self, dim: int, metric: str = Metric.L2, n_clusters: int = 0, *,
                 device=None):
        super().__init__(dim, metric, device=device)
        self.n_clusters = n_clusters or self.N_CLUSTERS
        self.centers: Optional[torch.Tensor] = None  # [C, D] f32
        dev = self.device
        # main region
        self.m_codes = torch.zeros((0, dim), dtype=torch.int8, device=dev)
        self.m_gcid = torch.zeros((0,), dtype=torch.int64, device=dev)
        self.m_norms = torch.zeros((0,), dtype=torch.float32, device=dev)
        self.m_valid = torch.zeros((0,), dtype=torch.bool, device=dev)
        self.m_ext = torch.zeros((0,), dtype=torch.int64, device=dev)
        # delta region
        self.d_codes: Optional[torch.Tensor] = None
        self.d_cid: Optional[torch.Tensor] = None
        self.d_norms: Optional[torch.Tensor] = None
        self.d_valid: Optional[torch.Tensor] = None
        self.d_ext: Optional[torch.Tensor] = None
        self.d_count = 0
        # the delta's route for fused searches: decided, and its DeltaView
        # built where K2 takes it, at the first such search after an add;
        # undone by the add that changes the delta and by a fold
        self._d_routed = False
        self._d_view: Optional[DeltaView] = None
        self.m_live = 0
        # delta folds into main past max(rebuild_min, m_live / 4)
        # (tests lower rebuild_min to exercise relayouts at toy sizes)
        self.rebuild_min = SQ8R_TILE
        # host slot map: ext -> main slot (>= 0) | delta (-2 - slot) | -1
        self._slot = np.empty(0, np.int64)

    # -- geometry -----------------------------------------------------

    @property
    def capacity(self) -> int:
        """EXTERNAL row capacity (the Dataset sizes columns and masks by
        it)."""
        cap = MIN_CAPACITY
        while cap < self.count:
            cap *= 2
        return cap

    def _ext_grow(self, need: int) -> None:
        if len(self._slot) < need:
            cap = max(MIN_CAPACITY, len(self._slot))
            while cap < need:
                cap *= 2
            ns = np.full(cap, -1, np.int64)
            ns[: len(self._slot)] = self._slot
            self._slot = ns

    def _delta_grow(self, need: int) -> None:
        cur = 0 if self.d_codes is None else self.d_codes.shape[0]
        cap = cur or self.DELTA_MIN
        while cap < need:
            cap *= 2
        if cap > cur:
            dev = self.device
            self.d_codes = _grown(self.d_codes, cap, (self.dim,), torch.int8, device=dev)
            self.d_cid = _grown(self.d_cid, cap, (), torch.int64, device=dev)
            self.d_norms = _grown(self.d_norms, cap, (), torch.float32, device=dev)
            self.d_valid = _grown(self.d_valid, cap, (), torch.bool, False, device=dev)
            self.d_ext = _grown(self.d_ext, cap, (), torch.int64, -1, device=dev)

    def device_bytes(self) -> int:
        return _tensor_bytes(
            self.m_codes, self.m_gcid, self.m_norms, self.m_valid, self.m_ext,
            self.d_codes, self.d_cid, self.d_norms, self.d_valid, self.d_ext,
            self.centers, self.lo, self.hi, *(self._d_view or ()),
        )

    # -- training -----------------------------------------------------

    def train(self, vecs) -> None:
        """k-means on the first TRAIN_SAMPLE rows (10 Lloyd iterations
        from a seeded subset), then the affine of the residuals."""
        v = self._prep(vecs)
        c = min(self.n_clusters, max(v.shape[0] // 8, 1))
        self.n_clusters = c
        sample = v[: self.TRAIN_SAMPLE]
        cent, _ = lloyd(sample[None], kmeans_init(sample[None], c, 0), 10)
        self.centers = cent[0]
        res = sample - self.centers[self._assign(sample)]
        self.lo = res.min(dim=0).values
        self.hi = res.max(dim=0).values

    def _assign(self, v: torch.Tensor) -> torch.Tensor:
        return nearest_center(v, self.centers)

    # -- mutation -----------------------------------------------------

    def add(self, vecs) -> np.ndarray:
        if not self.is_trained:
            self.train(vecs)
        v = self._prep(vecs)
        cid = self._assign(v)
        codes = _quantize(v - self.centers[cid], self.lo, self.hi)
        deq = self._dequant_rows(codes, cid)
        norms = (deq * deq).sum(dim=1)
        n = codes.shape[0]
        with self._mu:
            ext = np.arange(self.count, self.count + n, dtype=np.int64)
            self._ext_grow(self.count + n)
            self._delta_grow(self.d_count + n)
            _delta_append(
                self.d_codes, self.d_norms, self.d_valid, self.d_cid, self.d_ext,
                codes, norms, cid, torch.from_numpy(ext).to(self.device), self.d_count,
            )
            self._slot[ext] = -2 - (self.d_count + np.arange(n))
            self.d_count += n
            self._d_routed, self._d_view = False, None
            self.count += n
            if self.d_count >= max(self.rebuild_min, self.m_live // 4):
                self._rebuild_layout()
        return ext

    def _rebuild_layout(self) -> None:
        """Fold the delta into a fresh cluster-grouped main region."""
        ext_cap = len(self._slot) or MIN_CAPACITY
        total = _cluster_padded_total(
            self.m_gcid, self.m_valid, self.d_cid, self.d_valid, self.n_clusters
        )
        new_cap = pad_to(max(total, GROUP), SQ8R_TILE)
        (self.m_codes, self.m_gcid, self.m_norms, self.m_valid,
         self.m_ext, inv) = _relayout(
            self.m_codes, self.m_gcid, self.m_norms, self.m_valid, self.m_ext,
            self.d_codes, self.d_cid, self.d_norms, self.d_valid, self.d_ext,
            self.n_clusters, new_cap, ext_cap,
        )
        inv_np = inv.cpu().numpy()
        slot = np.full(len(self._slot), -1, np.int64)
        slot[: len(inv_np)] = inv_np
        self._slot = slot
        self.m_live = int((inv_np >= 0).sum())
        self.d_codes = self.d_cid = self.d_norms = self.d_valid = self.d_ext = None
        self.d_count = 0
        self._d_routed, self._d_view = False, None
        self._delta_grow(1)

    def delete_rows(self, rows) -> None:
        if not len(rows):
            return
        rows = np.asarray(rows, np.int64)
        with self._mu:
            sl = self._slot[rows]
            main = sl[sl >= 0]
            delta = -2 - sl[sl <= -2]
            if len(main):
                tombstone_rows(self.m_valid, main)
                self.m_live -= len(main)
            if len(delta):
                tombstone_rows(self.d_valid, delta)
            self._slot[rows] = -1

    # -- search -------------------------------------------------------

    def search(self, queries, k: int, *, filter_mask=None):
        """-> (dist [B, k] f32, external rows [B, k] int64) as numpy.
        filter_mask: bool over EXTERNAL rows (bounds-checked). Calls
        utils/launch.py's launched() once, when the search's work and its
        answer's copies are queued."""
        return self._search(queries, k, filter_mask, has_delta=self.d_count > 0)

    def _query(self, queries) -> torch.Tensor:
        """_AffineCodes._query; a host array goes to a card through pinned
        memory without a wait, so that the upload queues behind the card's
        earlier work where a pageable copy would wait for it to finish."""
        if isinstance(queries, torch.Tensor) or self.device.type != "cuda":
            return super()._query(queries)
        a = np.atleast_2d(np.asarray(queries, np.float32))
        host = torch.empty(a.shape, dtype=torch.float32, pin_memory=True)
        host.numpy()[...] = a
        return host.to(self.device, non_blocking=True)

    def _search(self, queries, k: int, filter_mask, *, has_delta: bool):
        """search, with the delta region's scan on or off (off times the
        main region alone)."""
        q = self._query(queries)
        if self.m_codes.shape[0] == 0 and self.d_count == 0:
            launched()
            return _masked_result(q.shape[0], k)
        normalize = self.metric == Metric.COSINE
        metric = Metric.L2 if normalize else self.metric
        fused = metric != Metric.DOT and k <= FUSED_MAX_K
        mask = None
        if filter_mask is not None:
            mask = torch.as_tensor(filter_mask, device=self.device).bool()
        outs = []
        with self._mu:
            has_delta = has_delta and self.d_count > 0
            view = self._delta_view() if fused and has_delta else None
            for off in range(0, q.shape[0], QUERY_CHUNK):
                outs.append(_sq8r_search(
                    q[off:off + QUERY_CHUNK],
                    self.m_codes, self.m_gcid, self.m_norms, self.m_valid, self.m_ext,
                    self.d_codes, self.d_cid, self.d_norms, self.d_valid, self.d_ext,
                    self.centers, self.lo, self.hi, mask,
                    k, metric, normalize, fused, has_delta, self.device, view,
                ))
        count_dispatch("pallas_sq8r_fused" if fused else "xla", fused and self.m_codes.is_cuda)
        with span("longbow.index.to_host"):
            answer = _queue_to_host(torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))
            launched()  # the next search may queue behind this one's copies
            d, i = answer()
        if normalize:
            d = cosine_report(d)
        return d, i

    def _delta_view(self) -> Optional[DeltaView]:
        """The delta's DeltaView for a fused search, or None where the
        plain chunked scan serves it (DELTA_VIEW_MAX): decided, and the
        view built, at the first fused search after an add changed the
        delta. The caller holds self._mu."""
        if not self._d_routed:
            with span("longbow.sq8r.delta_view"):
                rows = delta_view_rows(self.d_cid, self.d_valid, self.n_clusters)
                if rows <= DELTA_VIEW_MAX * self.d_codes.shape[0]:
                    self._d_view = delta_view(self.d_codes, self.d_cid, self.d_norms,
                                              self.d_valid, self.n_clusters, rows)
                    count("longbow_sq8r_delta_views_total")
            self._d_routed = True
        return self._d_view

    # -- reads --------------------------------------------------------

    def _dequant_rows(self, codes: torch.Tensor, cid: torch.Tensor) -> torch.Tensor:
        scale, lo_eff = _affine(self.lo, self.hi)
        return codes.float() * scale + lo_eff + self.centers[cid]

    def _gather(self, rows):
        """(codes, cluster ids, found) of external rows, from either
        region; rows that are deleted or unknown are not found."""
        sl = self._slot[np.asarray(rows, np.int64)]
        n = len(sl)
        codes = torch.zeros((n, self.dim), dtype=torch.int8, device=self.device)
        cids = torch.zeros((n,), dtype=torch.int64, device=self.device)
        for sel, slots, region_codes, cid_of in (
            (sl >= 0, sl, self.m_codes, lambda s: self.m_gcid[s // GROUP]),
            (sl <= -2, -2 - sl, self.d_codes, lambda s: self.d_cid[s]),
        ):
            if sel.any():
                at = torch.from_numpy(np.nonzero(sel)[0]).to(self.device)
                s = torch.from_numpy(slots[sel]).to(self.device)
                codes[at] = region_codes[s]
                cids[at] = cid_of(s)
        return codes, cids, (sl >= 0) | (sl <= -2)

    def get_vectors(self, rows) -> np.ndarray:
        """Dequantized f32 host copies of external rows (zeros for rows
        that are deleted)."""
        with self._mu:
            codes, cids, found = self._gather(rows)
            out = self._dequant_rows(codes, cids).cpu().numpy()
        out[~found] = 0.0
        return out

    # -- persistence --------------------------------------------------

    def export_state(self) -> dict:
        """longbow_tpu's SQ8ResidualIndex.export_state layout: codes,
        cluster ids and validity by external row."""
        with self._mu:
            n = self.count
            codes, cids, found = self._gather(np.arange(n))
            return {
                "kind": "sq8r",
                "dim": self.dim,
                "metric": self.metric,
                "count": n,
                "lo": self.lo.cpu().numpy(),
                "hi": self.hi.cpu().numpy(),
                "centers": self.centers.cpu().numpy(),
                "codes": codes.cpu().numpy(),
                "codes_centered": True,
                "cluster_ids": cids.cpu().numpy().astype(np.int32),
                "valid": found,
            }

    @classmethod
    def import_state(cls, st: dict, *, device=None) -> "SQ8ResidualIndex":
        """Rebuild from export_state() output, this package's or
        longbow_tpu's: all rows enter the delta, deleted ones are
        tombstoned, then one relayout."""
        idx = cls(int(st["dim"]), st["metric"], device=device)
        dev = idx.device
        idx.centers = torch.tensor(np.asarray(st["centers"], np.float32), device=dev)
        idx.n_clusters = idx.centers.shape[0]
        idx.lo = torch.tensor(np.asarray(st["lo"], np.float32), device=dev)
        idx.hi = torch.tensor(np.asarray(st["hi"], np.float32), device=dev)
        n = int(st["count"])
        if n:
            codes = torch.from_numpy(cls._import_codes(st)).to(dev)
            cid = torch.tensor(np.asarray(st["cluster_ids"], np.int64), device=dev)
            deq = idx._dequant_rows(codes, cid)
            ext = np.arange(n, dtype=np.int64)
            idx._ext_grow(n)
            idx._delta_grow(n)
            _delta_append(
                idx.d_codes, idx.d_norms, idx.d_valid, idx.d_cid, idx.d_ext,
                codes, (deq * deq).sum(dim=1), cid, torch.from_numpy(ext).to(dev), 0,
            )
            idx._slot[ext] = -2 - ext
            idx.d_count = n
            idx.count = n
            dead = ext[~np.asarray(st["valid"], bool)]
            if len(dead):
                idx.delete_rows(dead)
            idx._rebuild_layout()
        return idx
