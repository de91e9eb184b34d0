"""Flat (brute-force exact) index over one preallocated device block.

Counterpart of longbow_tpu/index/flat.py::FlatIndex. The corpus lives
on the device as one [capacity, D] tensor in the storage dtype, with the
norms |v|^2 of the stored (rounded) rows and a validity mask beside it.
Capacity doubles from MIN_CAPACITY; appends write in place.

Search: bf16 storage with k <= 64 goes through the fused scan for a pool
of 64 and an exact f32 re-rank (ops/scan.py::flat_search_rerank);
anything else, and exact=True, goes through the f32 oracle exact_search.
Cosine rides the l2 path on normalized rows and is reported as 1 - cos.

Coarse int8 shadow (LONGBOW_FLAT_COARSE=1 when the index is made; bf16
storage, l2 or cosine): int8 codes of the stored rows beside them, under a
per-dimension affine trained on the first block (widened 5% each side),
with the norms of the dequantized codes. A search with k <= 64 then runs
kernel K2 over the codes for its pool and re-ranks it exactly against the
bf16 rows (ops/scan.py::coarse_flat_search_rerank); a dot index keeps K1.
A failure to maintain the shadow raises.

Host scan mirror: rows that reach the index from the host are also kept
in host RAM, in the stored precision (bf16 as its bits in uint16, f16,
f32), so that get_vectors and the Flight edge's table scans read RAM
instead of gathering from the card. Mirror reads are bit for bit the
device's stored rows. Rows that arrive as a device tensor disable it
(feeding it would cost the fetch it exists to avoid), and so does
LONGBOW_SCAN_MIRROR=0 (half the host RAM).
"""
from __future__ import annotations

import os
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
from longbow_tpu_torch.ops.scan import coarse_flat_search_rerank, flat_search_rerank
from longbow_tpu_torch.storage.native import bf16_bits_to_f32, f32_to_bf16_bits

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


# the host mirror's representation of each storage dtype
_MIRROR_DTYPES = {
    torch.bfloat16: np.dtype(np.uint16),  # bf16 bits
    torch.float16: np.dtype(np.float16),
    torch.float32: np.dtype(np.float32),
}


def coarse_opted_in() -> bool:
    return os.environ.get("LONGBOW_FLAT_COARSE", "0") == "1"


def mirror_opted_out() -> bool:
    return os.environ.get("LONGBOW_SCAN_MIRROR", "1") == "0"


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
        # host scan mirror [capacity, dim] in _mirror_np_dtype; None until
        # the first flush
        self._mirror_enabled = not mirror_opted_out()
        self._mirror_np_dtype = _MIRROR_DTYPES[self.dtype]
        self._host_mirror: Optional[np.ndarray] = None
        # the coarse int8 shadow: codes [capacity, dim], the norms of their
        # dequantized rows, and the affine (None until the first block).
        # Gated on metric where the reference's is not: its dot search
        # raises inside the coarse scan (index/flat.py:702)
        self._coarse_enabled = (
            self.dtype == torch.bfloat16 and self.metric in (Metric.L2, Metric.COSINE)
            and coarse_opted_in()
        )
        self._coarse_codes: Optional[torch.Tensor] = None
        self._coarse_norms: Optional[torch.Tensor] = None
        self._coarse_lo: Optional[torch.Tensor] = None
        self._coarse_hi: Optional[torch.Tensor] = None
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
        if self._coarse_enabled and n:
            self._coarse_after(row, n)

    def _coarse_after(self, row: int, n: int) -> None:
        """Quantize the stored rows [row, row + n) into the coarse shadow,
        in place: codes from the STORED bf16 rows (so that they
        approximate exactly what the re-rank reads), norms of the
        dequantized codes; the affine comes from the first block."""
        stored = self.vectors[row:row + n].float()
        if self._coarse_lo is None:
            lo = stored.min(dim=0).values
            hi = stored.max(dim=0).values
            span = torch.clamp_min(hi - lo, 1e-6)
            self._coarse_lo, self._coarse_hi = lo - 0.05 * span, hi + 0.05 * span
        cap = self.vectors.shape[0]
        codes = self._coarse_codes
        if codes is None or codes.shape[0] < cap:
            new_codes = torch.zeros((cap, self.dim), dtype=torch.int8, device=self.device)
            new_norms = torch.zeros((cap,), dtype=torch.float32, device=self.device)
            if codes is not None:
                new_codes[: codes.shape[0]] = codes
                new_norms[: codes.shape[0]] = self._coarse_norms
            self._coarse_codes, self._coarse_norms = new_codes, new_norms
        lo, hi = self._coarse_lo, self._coarse_hi
        scale = torch.clamp_min(hi - lo, 1e-12)
        qv = torch.round((stored - lo) / scale * 255.0)
        s8 = (torch.clamp(qv, 0.0, 255.0) - 128.0).to(torch.int8)
        s255 = scale / 255.0
        deq = s8.float() * s255[None, :] + (lo + 128.0 * s255)[None, :]
        self._coarse_codes[row:row + n] = s8
        self._coarse_norms[row:row + n] = (deq * deq).sum(dim=1)

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
            # device-origin rows never pass through host RAM
            self._mirror_enabled = False
            self._host_mirror = None
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
        if self._mirror_enabled:
            self._mirror_put(self._device_count, n)
        self._device_count += n
        self._stage_rows = 0
        if self._stage_dead:
            tombstone_rows(self.valid, self._stage_dead)
            self._stage_dead = []

    def _mirror_put(self, row: int, n: int) -> None:
        """Mirror the n rows just stored at `row`. l2 and dot round the
        staged f32 rows on the host exactly as the card's cast does (bf16:
        the native round-to-nearest-even); cosine copies the stored rows
        back, since the normalization's rounding is the card's own."""
        cap = self.vectors.shape[0]
        m = self._host_mirror
        if m is None or m.shape[0] < cap:
            nm = np.zeros((cap, self.dim), self._mirror_np_dtype)
            if m is not None:
                nm[: m.shape[0]] = m
            self._host_mirror = m = nm
        dst = m[row: row + n]
        if self.metric == Metric.COSINE:
            stored = self.vectors[row: row + n]
            if self.dtype == torch.bfloat16:
                stored = stored.view(torch.int16)
            dst[:] = stored.cpu().numpy().view(self._mirror_np_dtype)
        elif self.dtype == torch.bfloat16:
            f32_to_bf16_bits(self._stage_buf[:n], out=dst)
        else:
            dst[:] = self._stage_buf[:n]  # f16: numpy's cast rounds to nearest even

    def adopt_mirror(self, rows_m: np.ndarray) -> None:
        """Install a mirror block for rows [0, len(rows_m)) in the
        representation mirror_rows returns (a compaction carries the old
        index's mirror into the rebuilt one). A block of another dtype, or
        LONGBOW_SCAN_MIRROR=0, leaves scans on the device path."""
        if mirror_opted_out() or rows_m.dtype != self._mirror_np_dtype:
            return
        with self._mu:
            self._flush_locked()
            nm = np.zeros((self.vectors.shape[0], self.dim), self._mirror_np_dtype)
            nm[: len(rows_m)] = rows_m
            self._host_mirror = nm
            self._mirror_enabled = True

    def mirror_rows(self, rows) -> Optional[np.ndarray]:
        """The mirror's copy of internal rows (bf16 bits in uint16, f16 or
        f32 by the storage dtype), or None when there is no mirror
        (device-origin rows, or opted out)."""
        with self._mu:
            self._flush_locked()
            if not self._mirror_enabled or (self._host_mirror is None and self._device_count):
                return None
            if self._host_mirror is None:  # an empty index
                return np.zeros((len(rows), self.dim), self._mirror_np_dtype)
            r = np.asarray(rows, np.int64)
            # a full scan asks for [off, off + n) in order: a view, no copy.
            # Mirror rows are append-only within an index (upserts append
            # and tombstone; a compaction swaps the whole index)
            if r.size > 1024 and r[-1] - r[0] == r.size - 1 and np.array_equal(
                r, np.arange(r[0], r[0] + r.size, dtype=np.int64)
            ):
                return self._host_mirror[r[0]: r[0] + r.size]
            return self._host_mirror[r]

    @staticmethod
    def mirror_to_f32(m: np.ndarray) -> np.ndarray:
        """A mirror block as float32."""
        if m.dtype == np.uint16:
            return bf16_bits_to_f32(m)
        return m if m.dtype == np.float32 else m.astype(np.float32)

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
        """f32 host copies of the stored rows: from the host mirror where
        there is one, else a device gather."""
        m = self.mirror_rows(rows)
        if m is not None:
            return self.mirror_to_f32(m)
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
            if fused and self._coarse_codes is not None:
                d, i = coarse_flat_search_rerank(
                    q, self.vectors, self._coarse_codes, self._coarse_lo, self._coarse_hi,
                    self._coarse_norms, self.valid, k, metric, pool=POOL, extra_mask=mask,
                    normalize=normalize, device=self.device,
                )
                count_dispatch("pallas_coarse_i8", self.vectors.is_cuda)
            elif fused:
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
        if self._coarse_enabled:
            itemsize += 1  # the int8 code beside each element, and its norm
            return self.capacity * (self.dim * itemsize + 4 + 4 + 1)
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
            idx.flush()  # the rows are on the device before the first search
        return idx
