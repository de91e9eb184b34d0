"""Tiered index ("disk"): int8 codes on the device, full-precision rows on
the host.

Counterpart of longbow_tpu/index/tiered.py. The search operand (SQ8
codes, one byte per dimension, with norms and validity) lives in device
memory and is scanned by index/sq8.py's SQ8Index, hence kernel K2 on a
card; the re-rank operand (f32 rows) lives in host RAM or in an
np.memmap file on disk. A query takes a pool of candidates from the
device scan and re-ranks only those rows exactly, in numpy on the host.

The pool: for k <= 64 it is min(k * rerank_factor, 64, count), the
reference's clamp, where K2 serves the scan; for k > 64 it is
min(k * rerank_factor, count). (The reference clamps at 64 for every k,
which returns fewer than k rows past k = 64.)
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from longbow_tpu_torch.index.sq8 import FUSED_MAX_K, SQ8Index
from longbow_tpu_torch.ops.distance import MASKED, Metric

MIN_CAPACITY = 4096


class HostVectorStore:
    """Append-only [N, D] f32 rows in host RAM or an mmap-backed file;
    the capacity doubles on demand."""

    def __init__(self, dim: int, path: Optional[str] = None, capacity: int = MIN_CAPACITY):
        self.dim = dim
        self.path = Path(path) if path else None
        self.count = 0
        self._buf = self._alloc(capacity)

    def _alloc(self, rows: int) -> np.ndarray:
        if self.path is None:
            return np.zeros((rows, self.dim), np.float32)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a+b") as f:
            f.truncate(rows * self.dim * 4)
        return np.memmap(self.path, dtype=np.float32, mode="r+", shape=(rows, self.dim))

    @property
    def capacity(self) -> int:
        return self._buf.shape[0]

    def nbytes(self) -> int:
        return self.capacity * self.dim * 4

    def _grow_to(self, need: int) -> None:
        cap = self.capacity
        while cap < need:
            cap *= 2
        if cap == self.capacity:
            return
        if self.path is None:
            new = np.zeros((cap, self.dim), np.float32)
            new[: self.count] = self._buf[: self.count]
            self._buf = new
        else:
            self._buf.flush()
            del self._buf  # release the map before the file grows
            self._buf = self._alloc(cap)

    def append(self, vecs: np.ndarray) -> None:
        n = len(vecs)
        self._grow_to(self.count + n)
        self._buf[self.count:self.count + n] = vecs
        self.count += n

    def get(self, rows) -> np.ndarray:
        return np.asarray(self._buf[rows], np.float32)

    def flush(self) -> None:
        if self.path is not None:
            self._buf.flush()


class TieredIndex:
    """SQ8 device scan + exact host re-rank ("disk" kind). path=None
    keeps the cold tier in host RAM; a path keeps it in an mmap file.
    device: where the codes live; None means the CUDA card."""

    def __init__(
        self,
        dim: int,
        metric: str = Metric.L2,
        *,
        path: Optional[str] = None,
        rerank_factor: int = 8,
        device=None,
    ):
        self.dim = dim
        self.metric = Metric.validate(metric)
        self.rerank_factor = rerank_factor
        self._scan = SQ8Index(dim, metric, device=device)
        self.device = self._scan.device
        self.host = HostVectorStore(dim, path)
        self.count = 0

    @property
    def capacity(self) -> int:
        return max(self._scan.capacity, 1)

    @property
    def valid(self):
        return self._scan.valid

    def __len__(self) -> int:
        return self.count

    def add(self, vecs) -> np.ndarray:
        vecs = np.ascontiguousarray(np.atleast_2d(np.asarray(vecs)), np.float32)
        rows = self._scan.add(vecs)
        if self.metric == Metric.COSINE:
            vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-30)
        self.host.append(vecs)
        self.count = self._scan.count
        return rows

    def delete_rows(self, rows) -> None:
        self._scan.delete_rows(rows)

    def pool(self, k: int) -> int:
        """Candidates taken from the device scan for a top-k."""
        if k <= FUSED_MAX_K:
            return max(min(max(k * self.rerank_factor, k), FUSED_MAX_K, self.count), k)
        return max(min(k * self.rerank_factor, self.count), k)

    def search(self, queries, k: int, *, filter_mask=None):
        """-> (dist [B, k] f32, rows [B, k] int32) as numpy; the device
        scan's pool re-ranked exactly against the host rows."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if self.metric == Metric.COSINE:
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
        b = q.shape[0]
        out_d = np.full((b, k), MASKED, np.float32)
        out_i = np.full((b, k), -1, np.int32)
        if self.count == 0:
            return out_d, out_i
        d, i = self._scan.search(q, self.pool(k), filter_mask=filter_mask)
        ok = d < MASKED
        vecs = self.host.get(np.where(ok, i, 0).reshape(-1)).reshape(b, -1, self.dim)
        if self.metric == Metric.L2:
            ed = np.sum((vecs - q[:, None, :]) ** 2, axis=2)
        else:
            ip = np.einsum("bd,bkd->bk", q, vecs, dtype=np.float32)
            # cosine: the host rows are normalized f32, so 1 - cos; dot: -ip
            ed = 1.0 - ip if self.metric == Metric.COSINE else -ip
        ed = np.where(ok, ed, np.float32(MASKED)).astype(np.float32)
        top = np.argsort(ed, axis=1, kind="stable")[:, :k]
        kk = top.shape[1]
        out_d[:, :kk] = np.take_along_axis(ed, top, axis=1)
        ids = np.take_along_axis(i, top, axis=1)
        out_i[:, :kk] = np.where(out_d[:, :kk] < MASKED, ids, -1)
        return out_d, out_i

    def get_vectors(self, rows) -> np.ndarray:
        return self.host.get(np.asarray(rows, np.int64))

    def device_bytes(self) -> int:
        """The device tier: codes, norms and validity (the affine is a few
        hundred bytes)."""
        s = self._scan
        return sum(t.numel() * t.element_size() for t in (s.codes, s.norms_sq, s.valid)
                   if t is not None)

    def host_bytes(self) -> int:
        return self.host.nbytes()

    def warm(self) -> None:
        self._scan.warm()

    def flush(self) -> None:
        self.host.flush()

    # -- persistence --------------------------------------------------

    def export_state(self) -> dict:
        """longbow_tpu's TieredIndex.export_state layout: the sq8 state
        plus the host rows and the pool factor."""
        st = self._scan.export_state()
        st["kind"] = "disk"
        st["host_vectors"] = self.host.get(np.arange(self.count))
        st["rerank_factor"] = self.rerank_factor
        return st

    @classmethod
    def import_state(cls, st: dict, path: Optional[str] = None, *, device=None) -> "TieredIndex":
        idx = cls(int(st["dim"]), st["metric"], path=path,
                  rerank_factor=int(st.get("rerank_factor", 8)), device=device)
        idx._scan = SQ8Index.import_state(dict(st, kind="sq8"), device=device)
        idx.host.append(np.asarray(st["host_vectors"], np.float32))
        idx.count = idx._scan.count
        return idx
