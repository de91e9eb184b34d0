"""IVF (inverted-file) index: k-means cells + multi-probe scan.

Counterpart of longbow_tpu/index/ivf.py, in plain PyTorch. Cells are rows
of one padded [C, cap, D] tensor (bf16 by default), so a probe is a
gather of whole cell blocks and one batched product. A search ranks the
centroids, gathers the n_probe best cells per query (in query chunks, so
the [B, n_probe * cap, D] block stays bounded), takes a stable top-k,
and merges the exact scan of the spill segment.

Cells are sized on the FIRST add (cap = 2 x its mean occupancy), as in
the reference; rows past a cell's cap go to the spill segment, a
FlatIndex (index/flat.py), which a card serves through kernel K1. A
store fed in batches therefore spills a large share of its rows.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from longbow_tpu_torch.device import resolve_device
from longbow_tpu_torch.index.flat import FlatIndex, storage_dtype
from longbow_tpu_torch.ops.distance import (
    MASKED,
    Metric,
    as_rows,
    cosine_report,
    fit_mask,
    full_f32_matmul,
    normalize_rows,
)
from longbow_tpu_torch.ops.kmeans import kmeans_init, lloyd, nearest_center
from longbow_tpu_torch.ops.topk import pad_k, stable_topk

TRAIN_SAMPLE = 131_072
# bytes of one f32 [queries, n_probe * cap, D] gather block of a search
PROBE_BLOCK_BYTES = 1 << 29


def _ivf_search(cells, cell_norms, cell_rows, valid, centroids, cent_norms, queries,
                k: int, n_probe: int):
    """Probe the n_probe nearest cells of each query -> (dist [B, k] f32,
    global row [B, k] int64), ascending, ties in slot order; empty slots
    (MASKED, -1)."""
    full_f32_matmul()
    b, d = queries.shape
    c, cap, _ = cells.shape
    qn = (queries * queries).sum(dim=1, keepdim=True)
    cd = qn - 2.0 * (queries @ centroids.T) + cent_norms[None, :]
    _, probes = stable_topk(cd, n_probe)  # [B, P]
    pc = cells[probes].reshape(b, n_probe * cap, d)
    pn = cell_norms[probes].reshape(b, n_probe * cap)
    pr = cell_rows[probes].reshape(b, n_probe * cap).long()
    ip = torch.bmm(pc.float(), queries[:, :, None])[:, :, 0]
    dist = torch.clamp_min(qn - 2.0 * ip + pn, 0.0)
    ok = (pr >= 0) & valid[pr.clamp_min(0)]
    dist = torch.where(ok, dist, torch.full_like(dist, MASKED))
    dd, pos = stable_topk(dist, min(k, n_probe * cap))
    return pad_k(dd, pr.gather(1, pos), k)


class IVFIndex:
    """Multi-probe IVF over k-means cells.

    n_cells=0 picks about 2 sqrt(n) cells at train time; n_probe sets the
    recall/latency trade. l2 and cosine only (cosine rides l2 on
    normalized rows). device: None means the CUDA card (and raises
    without one)."""

    def __init__(
        self,
        dim: int,
        metric: str = Metric.L2,
        *,
        n_cells: int = 0,
        n_probe: int = 8,
        dtype=torch.bfloat16,
        train_iters: int = 8,
        device=None,
    ):
        self.device = resolve_device(device)
        self.dim = dim
        self.metric = Metric.validate(metric)
        if self.metric == Metric.DOT:
            raise ValueError("IVF serves l2/cosine; use flat/pq for dot (MIPS)")
        self.n_cells = n_cells
        self.n_probe = n_probe
        self.dtype = storage_dtype(dtype)
        self.train_iters = train_iters
        self.centroids: Optional[torch.Tensor] = None   # [C, D] f32
        self.cent_norms: Optional[torch.Tensor] = None  # [C]
        self.cells: Optional[torch.Tensor] = None       # [C, cap, D]
        self.cell_norms: Optional[torch.Tensor] = None  # [C, cap] f32
        self.cell_rows: Optional[torch.Tensor] = None   # [C, cap] int32, -1 empty
        self.cell_fill: Optional[np.ndarray] = None     # [C] host fill counts
        self.valid: Optional[torch.Tensor] = None       # [N_cap] by global row
        # overflow residual: an exact flat segment merged at search
        self._spill: Optional[FlatIndex] = None
        self._spill_rows = np.zeros((0,), np.int64)
        self._spill_rows_dev: Optional[torch.Tensor] = None  # device copy of the row map
        self.count = 0
        self._mu = threading.RLock()

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None

    @property
    def capacity(self) -> int:
        return 0 if self.valid is None else self.valid.shape[0]

    @property
    def spill_rows(self) -> int:
        return len(self._spill_rows)

    def __len__(self) -> int:
        return self.count

    def _prep(self, vecs) -> torch.Tensor:
        """f32 rows on the device, normalized for cosine."""
        v = as_rows(vecs, self.device, self.dim)
        return normalize_rows(v) if self.metric == Metric.COSINE else v

    def train(self, v: torch.Tensor) -> None:
        """k-means (train_iters Lloyd iterations from a seeded subset) on
        an evenly strided sample of at most TRAIN_SAMPLE rows; v is
        already prepared."""
        n = v.shape[0]
        if self.n_cells <= 0:
            self.n_cells = max(16, min(4096, int(np.sqrt(n) * 2)))
        pick = np.linspace(0, n - 1, min(n, TRAIN_SAMPLE), dtype=np.int64)
        sample = v[torch.from_numpy(pick).to(self.device)][None]
        cent, _ = lloyd(sample, kmeans_init(sample, self.n_cells, 0), self.train_iters)
        self.centroids = cent[0].float()
        self.cent_norms = (self.centroids * self.centroids).sum(dim=1)

    def add(self, vecs) -> np.ndarray:
        with self._mu:
            return self._add_locked(self._prep(vecs))

    def _add_locked(self, v: torch.Tensor) -> np.ndarray:
        n = v.shape[0]
        if not self.is_trained:
            self.train(v)
        asn = nearest_center(v, self.centroids).cpu().numpy()
        rows = np.arange(self.count, self.count + n, dtype=np.int64)
        dev = self.device
        if self.cells is None:
            # cap = 2x the FIRST add's mean occupancy (the reference's rule)
            cap = max(16, int(2 * (n // self.n_cells + 1)))
            self.cells = torch.zeros((self.n_cells, cap, self.dim), dtype=self.dtype, device=dev)
            self.cell_norms = torch.full((self.n_cells, cap), MASKED, device=dev)
            self.cell_rows = torch.full((self.n_cells, cap), -1, dtype=torch.int32, device=dev)
            self.cell_fill = np.zeros(self.n_cells, np.int64)
        cap = self.cells.shape[1]
        # slot of each row: the cell's fill plus its rank among this
        # batch's rows of the same cell (a stable sort by cell)
        order = np.argsort(asn, kind="stable")
        asn_sorted = asn[order]
        run_start = np.searchsorted(asn_sorted, asn_sorted)
        pos = np.empty(n, np.int64)
        pos[order] = np.arange(n) - run_start
        slots = self.cell_fill[asn] + pos
        spill = slots >= cap
        keep = ~spill
        self.cell_fill += np.bincount(asn[keep], minlength=self.n_cells)
        stored = v.to(self.dtype)
        # norms of the STORED (rounded) rows, summed in f64 as the reference
        norms = (stored.double() ** 2).sum(dim=1).float()
        if keep.any():
            kt = torch.from_numpy(keep).to(dev)
            ci = torch.from_numpy(asn[keep]).to(dev)
            si = torch.from_numpy(slots[keep]).to(dev)
            self.cells[ci, si] = stored[kt]
            self.cell_norms[ci, si] = norms[kt]
            self.cell_rows[ci, si] = torch.from_numpy(rows[keep].astype(np.int32)).to(dev)
        if spill.any():
            if self._spill is None:
                self._spill = FlatIndex(self.dim, Metric.L2, self.dtype, device=dev)
            self._spill.add(v[torch.from_numpy(spill).to(dev)])
            self._spill_rows = np.concatenate([self._spill_rows, rows[spill]])
            self._spill_rows_dev = None
        need = self.count + n
        if self.valid is None or self.valid.shape[0] < need:
            new_cap = max(4096, 1 << int(np.ceil(np.log2(need))))
            valid = torch.zeros((new_cap,), dtype=torch.bool, device=dev)
            if self.valid is not None:
                valid[: self.valid.shape[0]] = self.valid
            self.valid = valid
        self.valid[self.count:need] = True
        self.count = need
        return rows

    def delete_rows(self, rows) -> None:
        if len(rows) and self.valid is not None:
            with self._mu:
                idx = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
                self.valid[idx] = False

    def search(self, queries, k: int, *, filter_mask=None):
        """-> (dist [B, k] f32, global rows [B, k] int32) as numpy; empty
        slots (MASKED, -1). filter_mask: bool by global row."""
        q = self._prep(queries)
        b = q.shape[0]
        if self.cells is None or self.count == 0:
            # an empty or untrained index: an empty result, not an error
            return np.full((b, k), MASKED, np.float32), np.full((b, k), -1, np.int32)
        with self._mu:
            valid = self.valid
            mask = fit_mask(filter_mask, valid.shape[0], self.device)
            if mask is not None:
                valid = valid & mask
            n_probe = min(self.n_probe, self.n_cells)
            cap = self.cells.shape[1]
            step = max(1, PROBE_BLOCK_BYTES // (n_probe * cap * self.dim * 4))
            parts = [
                _ivf_search(self.cells, self.cell_norms, self.cell_rows, valid,
                            self.centroids, self.cent_norms, q[s:s + step], k, n_probe)
                for s in range(0, b, step)
            ]
            d = torch.cat([p[0] for p in parts])
            r = torch.cat([p[1] for p in parts])
            if self._spill is not None and len(self._spill):
                d, r = self._merge_spill(q, d, r, k, valid)
        d = d.cpu().numpy()
        if self.metric == Metric.COSINE:  # l2^2 on unit rows -> 1 - cos
            d = cosine_report(d)
        return d, r.int().cpu().numpy()

    def _merge_spill(self, q, d, r, k: int, valid):
        """Merge the spill segment's exact scan into (d, r): the global
        validity is mapped onto spill-local rows through the row map."""
        if self._spill_rows_dev is None:
            rj = np.zeros(self._spill.capacity, np.int64)
            rj[: len(self._spill_rows)] = self._spill_rows
            self._spill_rows_dev = torch.from_numpy(rj).to(self.device)
        rmap = self._spill_rows_dev
        sd, sr = self._spill.search(q, min(k, len(self._spill)), filter_mask=valid[rmap])
        sd = torch.from_numpy(sd).to(self.device)
        sr = torch.from_numpy(sr).to(self.device).long()
        sg = torch.where(sr >= 0, rmap[sr.clamp_min(0)], torch.full_like(sr, -1))
        d_all = torch.cat([d, sd], dim=1)
        r_all = torch.cat([r, sg], dim=1)
        d, pos = stable_topk(d_all, k)
        return d, torch.where(d < MASKED, r_all.gather(1, pos), torch.full_like(pos, -1))

    def get_vectors(self, rows) -> np.ndarray:
        """f32 host copies of the stored rows, from their cells or the
        spill segment (one inversion of cell_rows on the device)."""
        rows = np.asarray(rows, np.int64)
        with self._mu:
            flat_rows = self.cell_rows.reshape(-1).long()
            slot_of = torch.full((self.count,), -1, dtype=torch.int64, device=self.device)
            live = flat_rows >= 0
            slot_of[flat_rows[live]] = torch.nonzero(live)[:, 0]
            rt = torch.from_numpy(rows).to(self.device)
            slot = slot_of[rt]
            out = self.cells.reshape(-1, self.dim)[slot.clamp_min(0)].float()
            in_spill = (slot < 0).cpu().numpy()
            if in_spill.any():
                spill_of = np.full(self.count, -1, np.int64)
                spill_of[self._spill_rows] = np.arange(len(self._spill_rows))
                local = spill_of[rows[in_spill]]
                if (local < 0).any():
                    raise KeyError(f"rows {rows[in_spill][local < 0].tolist()} are not stored")
                out[torch.from_numpy(in_spill).to(self.device)] = torch.from_numpy(
                    self._spill.get_vectors(local)).to(self.device)
        return out.cpu().numpy()

    def device_bytes(self) -> int:
        own = sum(t.numel() * t.element_size()
                  for t in (self.cells, self.cell_norms, self.cell_rows, self.valid,
                            self.centroids, self.cent_norms)
                  if t is not None)
        return own + (self._spill.device_bytes() if self._spill is not None else 0)

    def warm(self) -> None:
        if self.count:
            self.search(np.zeros((1, self.dim), np.float32), 10)

    # -- persistence --------------------------------------------------

    def export_state(self) -> dict:
        """longbow_tpu's IVFIndex.export_state layout."""
        with self._mu:
            sp = (
                self._spill.get_vectors(np.arange(len(self._spill)))
                if self._spill is not None
                else np.zeros((0, self.dim), np.float32)
            )
            return {
                "kind": "ivf",
                "dim": self.dim,
                "metric": self.metric,
                "n_cells": self.n_cells,
                "n_probe": self.n_probe,
                "count": self.count,
                "centroids": self.centroids.cpu().numpy(),
                "cells": self.cells.float().cpu().numpy(),
                "cell_norms": self.cell_norms.cpu().numpy(),
                "cell_rows": self.cell_rows.cpu().numpy(),
                "cell_fill": self.cell_fill.copy(),
                "valid": self.valid[: max(self.count, 1)].cpu().numpy(),
                "spill_rows": self._spill_rows.copy(),
                "spill_vectors": sp,
            }

    @classmethod
    def import_state(cls, st: dict, *, dtype=torch.bfloat16, device=None) -> "IVFIndex":
        """Rebuild from export_state() output, this package's or
        longbow_tpu's (same keys)."""
        idx = cls(int(st["dim"]), st["metric"], n_cells=int(st["n_cells"]),
                  n_probe=int(st["n_probe"]), dtype=dtype, device=device)
        dev = idx.device
        idx.centroids = torch.tensor(np.asarray(st["centroids"], np.float32), device=dev)
        idx.cent_norms = (idx.centroids * idx.centroids).sum(dim=1)
        idx.cells = torch.tensor(np.asarray(st["cells"], np.float32), device=dev).to(idx.dtype)
        idx.cell_norms = torch.tensor(np.asarray(st["cell_norms"], np.float32), device=dev)
        idx.cell_rows = torch.tensor(np.asarray(st["cell_rows"], np.int32), device=dev)
        idx.cell_fill = np.asarray(st["cell_fill"], np.int64).copy()
        n = int(st["count"])
        cap = max(4096, 1 << int(np.ceil(np.log2(max(n, 1)))))
        valid = np.zeros((cap,), bool)
        valid[: len(st["valid"])] = st["valid"]
        idx.valid = torch.from_numpy(valid).to(dev)
        idx.count = n
        sp = np.asarray(st.get("spill_vectors", np.zeros((0, idx.dim))), np.float32)
        if len(sp):
            idx._spill = FlatIndex(idx.dim, Metric.L2, idx.dtype, device=dev)
            idx._spill.add(sp)
            idx._spill_rows = np.asarray(st["spill_rows"], np.int64)
        return idx
