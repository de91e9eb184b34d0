"""Flat (brute-force exact) index over one preallocated device block.

Counterpart of longbow_tpu/index/flat.py::FlatIndex. The corpus lives
on the device as one [capacity, D] tensor in the storage dtype, with the
norms |v|^2 of the stored (rounded) rows and a validity mask beside it.
Capacity doubles from MIN_CAPACITY; appends write in place.

Search: bf16 storage with k <= 64 goes through the fused scan for a pool
of 64 and an exact f32 re-rank (ops/scan.py::flat_search_rerank);
anything else, and exact=True, goes through the f32 oracle exact_search.
Cosine rides the l2 path on normalized rows and is reported as 1 - cos.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from longbow_tpu_torch.device import resolve_device
from longbow_tpu_torch.metrics.registry import count_dispatch
from longbow_tpu_torch.ops.distance import (
    Metric,
    cosine_report,
    exact_search,
    fit_mask,
    normalize_rows,
    tombstone_rows,
)
from longbow_tpu_torch.ops.scan import flat_search_rerank

MIN_CAPACITY = 4096
# host rows are uploaded in blocks of at least this many rows
STAGE_FLUSH_ROWS = 65536
# the fused scan serves k up to this; larger k goes to exact_search
FUSED_MAX_K = 64
POOL = 64

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def storage_dtype(dtype) -> torch.dtype:
    """A torch dtype, or its name as export_state writes it ("bfloat16",
    "float32", "float16"; a "torch." prefix is accepted)."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _DTYPES.values():
            raise ValueError(f"unsupported storage dtype {dtype}")
        return dtype
    name = str(dtype).replace("torch.", "")
    if name not in _DTYPES:
        raise ValueError(f"unsupported storage dtype {dtype!r}")
    return _DTYPES[name]


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class FlatIndex:
    """Exact k-NN index: one padded device block + validity mask.

    dtype: storage dtype (torch.float32, torch.bfloat16 or its name).
    device: where the block lives; None means the CUDA card (and raises
    without one).

    Concurrency: `_mu` serializes dispatch. Appends and tombstones write
    into the tensors in place, which is safe for a search dispatched
    before them: all work is queued on one CUDA stream and runs in
    dispatch order. Growth allocates new tensors, and a reader that took
    the old ones keeps them alive.
    """

    # add() takes a list of [n, dim] np blocks without an up-front
    # concatenate (the staging-buffer fill is the merge point)
    accepts_blocks = True

    def __init__(
        self,
        dim: int,
        metric: str = Metric.L2,
        dtype=torch.float32,
        capacity: int = MIN_CAPACITY,
        *,
        device=None,
    ):
        self.device = resolve_device(device)
        self.dim = dim
        self.metric = Metric.validate(metric)
        self.dtype = storage_dtype(dtype)
        self.count = 0
        cap = MIN_CAPACITY
        while cap < capacity:
            cap *= 2
        self.vectors = torch.zeros((cap, dim), dtype=self.dtype, device=self.device)
        self.norms_sq = torch.zeros((cap,), dtype=torch.float32, device=self.device)
        self.valid = torch.zeros((cap,), dtype=torch.bool, device=self.device)
        # host staging: numpy appends accumulate here and are uploaded in
        # blocks; rows past _device_count live only in the stage
        self._device_count = 0
        self._stage_buf: Optional[np.ndarray] = None
        self._stage_rows = 0
        self._stage_dead: list[int] = []
        self._mu = threading.RLock()

    # -- properties ---------------------------------------------------

    @property
    def capacity(self) -> int:
        """Row capacity AFTER the pending stage flushes — masks and
        metadata columns sized against this stay consistent across the
        flush that the next search triggers."""
        needed = self._device_count + self._stage_rows
        cap = self.vectors.shape[0]
        while cap < needed:
            cap *= 2
        return cap

    def __len__(self) -> int:
        return self.count

    # -- mutation -----------------------------------------------------

    def _grow_to(self, need: int) -> None:
        cur = self.vectors.shape[0]
        new_cap = cur
        while new_cap < need:
            new_cap *= 2
        if new_cap == cur:
            return
        vectors = torch.zeros((new_cap, self.dim), dtype=self.dtype, device=self.device)
        norms = torch.zeros((new_cap,), dtype=torch.float32, device=self.device)
        valid = torch.zeros((new_cap,), dtype=torch.bool, device=self.device)
        vectors[:cur] = self.vectors
        norms[:cur] = self.norms_sq
        valid[:cur] = self.valid
        self.vectors, self.norms_sq, self.valid = vectors, norms, valid

    def _ingest_block(self, block: torch.Tensor, row: int) -> None:
        """Normalize (cosine), round to the storage dtype, take |v|^2 of
        the ROUNDED rows and write all three in place at `row`. Norms of
        the f32 originals paired with bf16 products would bias every
        distance by 2 v.dv."""
        x = block.to(self.device, torch.float32)
        if self.metric == Metric.COSINE:
            x = normalize_rows(x)
        stored = x.to(self.dtype)
        sf = stored.float()
        n = x.shape[0]
        self.vectors[row:row + n] = stored
        self.norms_sq[row:row + n] = (sf * sf).sum(dim=1)
        self.valid[row:row + n] = True

    def add(self, vecs) -> np.ndarray:
        """Append vectors; returns the assigned internal row ids.

        numpy input (an array or a list of blocks): rows land in the host
        stage and are uploaded in blocks by flush(). Tensor input: written
        straight into the device block (bulk loads; no host round trip).
        """
        with self._mu:
            return self._add_locked(vecs)

    def _add_locked(self, vecs) -> np.ndarray:
        if isinstance(vecs, torch.Tensor):
            if vecs.ndim != 2 or vecs.shape[1] != self.dim:
                raise ValueError(
                    f"expected [n, {self.dim}] vectors, got {tuple(vecs.shape)}"
                )
            self._flush_locked()
            n = vecs.shape[0]
            self._grow_to(self.count + n)
            self._ingest_block(vecs, self.count)
            rows = np.arange(self.count, self.count + n, dtype=np.int64)
            self.count += n
            self._device_count = self.count
            return rows
        blocks = vecs if isinstance(vecs, list) else [vecs]
        blocks = [np.ascontiguousarray(b, dtype=np.float32) for b in blocks]
        for b in blocks:
            if b.ndim != 2 or b.shape[1] != self.dim:
                raise ValueError(
                    f"expected [n, {self.dim}] vectors, got {b.shape}"
                )
        n = sum(b.shape[0] for b in blocks)
        rows = np.arange(self.count, self.count + n, dtype=np.int64)
        need = self._stage_rows + n
        buf = self._stage_buf
        if buf is None or buf.shape[0] < need:
            old_rows = buf.shape[0] if buf is not None else 0
            new = np.empty((max(need, 2 * old_rows, 16384), self.dim), np.float32)
            if self._stage_rows:
                new[: self._stage_rows] = buf[: self._stage_rows]
            self._stage_buf = buf = new
        off = self._stage_rows
        for b in blocks:
            buf[off : off + b.shape[0]] = b
            off += b.shape[0]
        self._stage_rows = need
        self.count += n
        if self._stage_rows >= STAGE_FLUSH_ROWS:
            self._flush_locked()
        return rows

    def flush(self) -> None:
        """Upload staged host rows to the device block; tombstones
        recorded while the rows were staged apply after."""
        with self._mu:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._stage_rows:
            return
        n = self._stage_rows
        self._grow_to(self._device_count + n)
        # the upload copies out of the stage (a pageable host buffer), so
        # the buffer is free for the next fill when this returns
        self._ingest_block(torch.from_numpy(self._stage_buf[:n]), self._device_count)
        self._device_count += n
        self._stage_rows = 0
        if self._stage_dead:
            tombstone_rows(self.valid, self._stage_dead)
            self._stage_dead = []

    def delete_rows(self, rows) -> None:
        """Tombstone internal rows. Rows stay allocated; rows still in
        the host stage are tombstoned at flush."""
        if len(rows) == 0:
            return
        rows = np.asarray(rows, np.int64)
        with self._mu:
            if self._stage_rows:
                staged = rows >= self._device_count
                if staged.any():
                    self._stage_dead.extend(rows[staged].tolist())
                    rows = rows[~staged]
                if len(rows) == 0:
                    return
            tombstone_rows(self.valid, rows)

    def get_vectors(self, rows) -> np.ndarray:
        """f32 host copies of the stored rows (a device gather)."""
        return self.get_vectors_device(rows).cpu().numpy()

    def get_vectors_device(self, rows) -> torch.Tensor:
        """The stored rows as f32, left on the device (compaction feeds
        them to the new index without a host round trip)."""
        with self._mu:
            self._flush_locked()
            idx = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
            return self.vectors[idx].float()

    # -- search -------------------------------------------------------

    def search(
        self,
        queries,
        k: int,
        *,
        filter_mask=None,
        exact: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched k-NN -> (dist [B, k] f32, rows [B, k] int32) as numpy.

        filter_mask: optional [capacity] bool of rows allowed by metadata
        predicates, combined with validity. exact=True: the f32 oracle.
        """
        if isinstance(queries, torch.Tensor):
            q = queries.to(self.device, torch.float32)
        else:
            q = torch.from_numpy(np.atleast_2d(np.asarray(queries, dtype=np.float32)))
            q = q.to(self.device)
        if q.ndim == 1:
            q = q[None, :]
        # cosine rides the l2 path, NOT dot-on-normalized: ranking by -q.v
        # against normalized-but-rounded storage takes the |v_hat| wobble
        # of bf16 un-attenuated into every score, while the l2 form
        # cancels it through the stored-norm term. Distances are
        # converted to the declared 1 - cos before returning.
        normalize = self.metric == Metric.COSINE
        metric = Metric.L2 if normalize else self.metric
        with self._mu:  # dispatch under the lock, fetch outside
            self._flush_locked()
            cap = self.vectors.shape[0]
            mask = fit_mask(filter_mask, cap, self.device)
            fused = not exact and self.dtype == torch.bfloat16 and k <= FUSED_MAX_K
            if fused:
                d, i = flat_search_rerank(
                    q, self.vectors, self.norms_sq, self.valid, k, metric,
                    pool=POOL, extra_mask=mask, normalize=normalize,
                    device=self.device,
                )
                count_dispatch("pallas_fused", self.vectors.is_cuda)
            else:
                count_dispatch("xla")
                d, i = exact_search(
                    q, self.vectors, k, metric,
                    corpus_norms_sq=self.norms_sq, valid=self.valid,
                    extra_mask=mask, normalize=normalize, device=self.device,
                )
        d = d.cpu().numpy()
        if normalize:
            d = cosine_report(d)
        return d, i.cpu().numpy()

    def device_bytes(self) -> int:
        """Bytes of the device block (rows, norms, validity) after the
        pending flush."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return self.capacity * (self.dim * itemsize + 4 + 1)

    def warm(self) -> None:
        """Build the scan kernel and run one search, off the query path."""
        self.search(np.zeros((1, self.dim), np.float32), 10)

    # -- state export -------------------------------------------------

    def export_state(self) -> dict:
        """The layout of longbow_tpu's FlatIndex.export_state: stored rows
        as f32 numpy (bf16 arrays do not survive np.save) and validity."""
        with self._mu:
            self._flush_locked()
            return {
                "kind": "flat",
                "dim": self.dim,
                "metric": self.metric,
                "dtype": dtype_name(self.dtype),
                "count": self.count,
                "vectors": self.vectors[: self.count].float().cpu().numpy(),
                "valid": self.valid[: self.count].cpu().numpy(),
            }

    @classmethod
    def import_state(cls, state: dict, *, device=None) -> "FlatIndex":
        """Rebuild from export_state() output — this package's or
        longbow_tpu's (same keys; dtype names map without JAX)."""
        idx = cls(
            int(state["dim"]),
            state["metric"],
            storage_dtype(state["dtype"]),
            capacity=max(MIN_CAPACITY, int(state["count"])),
            device=device,
        )
        if state["count"]:
            idx.add(np.asarray(state["vectors"], dtype=np.float32))
            dead = np.nonzero(~np.asarray(state["valid"], dtype=bool))[0]
            idx.delete_rows(dead)
        return idx
