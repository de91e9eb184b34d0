"""Binary quantization: 1-bit sign codes + Hamming-distance scan.

Counterpart of longbow_tpu/index/bq.py, in plain PyTorch. Rows are
centered on the mean of the first batch and packed into 32-bit words of
sign bits (bit j of word w is dimension 32 w + j; padding dimensions
count as negative on both sides, so they cancel in the XOR). The scan is
an XOR and a population count per word, chunk by chunk, with a stable
top-k (Hamming distances are small integers, so ties are everywhere);
an exact f32 re-rank of the top `rerank_factor * k` candidates against
bf16 copies of the rows follows.

Torch has no population count and few uint32 ops, so the words are kept
as int32 bit patterns and counted with a SWAR popcount in int64;
export_state writes them as uint32, bit for bit longbow_tpu's codes.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from longbow_tpu_torch.device import resolve_device
from longbow_tpu_torch.index.pq import QUERY_CHUNK
from longbow_tpu_torch.ops.distance import (
    MASKED,
    Metric,
    as_rows,
    fit_mask,
    full_f32_matmul,
    normalize_rows,
    pad_to,
    tombstone_rows,
)
from longbow_tpu_torch.ops.topk import pad_k, stable_topk

MIN_CAPACITY = 4096
# int64 elements of one [B, chunk] block of the Hamming scan
HAMMING_BLOCK_ELEMS = 1 << 25
_LOW32 = 0xFFFFFFFF


def _pack_bits(v: torch.Tensor) -> torch.Tensor:
    """[N, D] f32 -> [N, ceil(D / 32)] int32 sign words (bit = v >= 0)."""
    n, d = v.shape
    d_pad = pad_to(d, 32)
    if d_pad != d:
        v = torch.cat([v, torch.full((n, d_pad - d), -1.0, device=v.device)], dim=1)
    bits = (v >= 0).to(torch.int64).reshape(n, d_pad // 32, 32)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=v.device),
        torch.arange(32, dtype=torch.int64, device=v.device),
    )
    words = (bits * weights).sum(dim=2)  # in [0, 2^32)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit pattern (int32 or int64 holding one), as
    int64; a SWAR count in int64, where no step can overflow."""
    x = x.to(torch.int64) & _LOW32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _LOW32) >> 24


def _hamming_search(codes, qcodes, valid, k: int, chunk: Optional[int] = None):
    """codes [N, W] int32, qcodes [B, W] int32, valid [N] -> (Hamming
    distance [B, k] f32, row [B, k] int64), ascending, ties in row order
    (as jax.lax.top_k); masked rows score MASKED. k <= N."""
    n, w = codes.shape
    b = qcodes.shape[0]
    if chunk is None:
        chunk = max(4096, HAMMING_BLOCK_ELEMS // max(b, 1))
    ds, ix = [], []
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        cc = codes[start:end]
        ham = popcount32(qcodes[:, None, 0] ^ cc[None, :, 0])
        for j in range(1, w):
            ham += popcount32(qcodes[:, None, j] ^ cc[None, :, j])
        dist = torch.where(valid[None, start:end], ham.float(),
                           torch.full((b, end - start), MASKED, device=codes.device))
        d, i = stable_topk(dist, min(k, end - start))
        ds.append(d)
        ix.append(i + start)
    d, pos = stable_topk(torch.cat(ds, dim=1), k)
    return d, torch.cat(ix, dim=1).gather(1, pos)


class BQIndex:
    """1-bit quantized index: Hamming scan + exact re-rank.

    device: None means the CUDA card (and raises without one)."""

    def __init__(
        self,
        dim: int,
        metric: str = Metric.COSINE,
        *,
        rerank: bool = True,
        rerank_factor: int = 32,
        device=None,
    ):
        self.device = resolve_device(device)
        self.dim = dim
        # BQ approximates angular similarity; l2 works after centering
        self.metric = Metric.validate(metric)
        self.rerank = rerank
        self.rerank_factor = rerank_factor
        self.words = pad_to(dim, 32) // 32
        self.codes: Optional[torch.Tensor] = None         # [cap, W] int32
        self.valid: Optional[torch.Tensor] = None         # [cap] bool
        self.vectors_bf16: Optional[torch.Tensor] = None  # [cap, D]
        self.mean: Optional[torch.Tensor] = None          # [D] f32
        self.count = 0
        self._mu = threading.RLock()

    @property
    def capacity(self) -> int:
        return 0 if self.codes is None else self.codes.shape[0]

    def _grow_to(self, need: int) -> None:
        cap = max(self.capacity, MIN_CAPACITY)
        while cap < need:
            cap *= 2
        if cap == self.capacity:
            return
        dev = self.device
        codes = torch.zeros((cap, self.words), dtype=torch.int32, device=dev)
        valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
        vb = torch.zeros((cap, self.dim), dtype=torch.bfloat16, device=dev) if self.rerank else None
        if self.codes is not None:
            old = self.capacity
            codes[:old], valid[:old] = self.codes, self.valid
            if self.rerank:
                vb[:old] = self.vectors_bf16
        self.codes, self.valid, self.vectors_bf16 = codes, valid, vb

    def add(self, vecs) -> np.ndarray:
        v = as_rows(vecs, self.device, self.dim)
        with self._mu:
            if self.mean is None:
                self.mean = v.mean(dim=0)  # centered once, on the first batch
            codes = _pack_bits(v - self.mean[None, :])
            n = codes.shape[0]
            self._grow_to(self.count + n)
            s = self.count
            self.codes[s:s + n] = codes
            self.valid[s:s + n] = True
            if self.rerank:
                self.vectors_bf16[s:s + n] = v.to(torch.bfloat16)
            rows = np.arange(s, s + n, dtype=np.int64)
            self.count += n
        return rows

    def delete_rows(self, rows) -> None:
        if len(rows) and self.valid is not None:
            with self._mu:
                tombstone_rows(self.valid, rows)

    def get_vectors(self, rows) -> np.ndarray:
        """f32 host copies of the stored bf16 rows (rerank=True only:
        sign bits do not decode to rows)."""
        if not self.rerank:
            raise NotImplementedError("get_vectors of a bq index without re-rank rows")
        idx = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        return self.vectors_bf16[idx].float().cpu().numpy()

    def device_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.codes, self.valid, self.vectors_bf16, self.mean)
                   if t is not None)

    def warm(self) -> None:
        if self.count:
            self.search(np.zeros((1, self.dim), np.float32), 10)

    def search(self, queries, k: int, *, filter_mask=None):
        """-> (dist [B, k] f32, rows [B, k] int64) as numpy; masked or
        missing slots are (MASKED, -1). Without re-rank the distances are
        Hamming distances."""
        q = as_rows(queries, self.device, self.dim)
        b = q.shape[0]
        if self.count == 0:
            return np.full((b, k), MASKED, np.float32), np.full((b, k), -1, np.int64)
        outs = []
        with self._mu:
            n = self.count
            valid = self.valid[:n]
            mask = fit_mask(filter_mask, self.capacity, self.device)
            if mask is not None:
                valid = valid & mask[:n]
            kk = min(k * self.rerank_factor if self.rerank else k, n)
            for off in range(0, b, QUERY_CHUNK):
                outs.append(self._search_chunk(q[off:off + QUERY_CHUNK], k, kk, valid))
        return (torch.cat([o[0] for o in outs]).cpu().numpy(),
                torch.cat([o[1] for o in outs]).cpu().numpy())

    def _search_chunk(self, q, k: int, kk: int, valid):
        n = self.count
        qcodes = _pack_bits(q - self.mean[None, :])
        d, i = _hamming_search(self.codes[:n], qcodes, valid, kk)
        if not self.rerank:
            return pad_k(d[:, :k], i[:, :k], k)
        full_f32_matmul()
        cand = self.vectors_bf16[i].float()  # [B, kk, D]
        if self.metric == Metric.COSINE:
            ed = 1.0 - torch.einsum("bd,bkd->bk", normalize_rows(q), cand / torch.clamp_min(
                torch.linalg.norm(cand, dim=2, keepdim=True), 1e-30))
        else:
            # l2, and (as in longbow_tpu) dot: both re-rank by l2
            ip = torch.einsum("bd,bkd->bk", q, cand)
            qn = (q * q).sum(dim=1, keepdim=True)
            ed = torch.clamp_min(qn - 2.0 * ip + (cand * cand).sum(dim=2), 0.0)
        ed = torch.where(d < MASKED, ed, torch.full_like(ed, MASKED))
        vals, pos = stable_topk(ed, min(k, kk))
        return pad_k(vals, i.gather(1, pos), k)

    # -- persistence --------------------------------------------------

    def export_state(self) -> dict:
        """longbow_tpu's BQIndex.export_state layout: uint32 codes, the
        mean, validity and the re-rank rows as f32."""
        with self._mu:
            n = self.count
            codes = self.codes[:n].cpu().numpy() if n else np.zeros((0, self.words), np.int32)
            return {
                "kind": "bq",
                "dim": self.dim,
                "metric": self.metric,
                "rerank": self.rerank,
                "count": n,
                "mean": None if self.mean is None else self.mean.cpu().numpy(),
                "codes": codes.view(np.uint32),
                "valid": self.valid[:n].cpu().numpy() if n else np.zeros((0,), bool),
                "vectors_bf16": (
                    self.vectors_bf16[:n].float().cpu().numpy() if self.rerank and n else None
                ),
            }

    @classmethod
    def import_state(cls, st: dict, *, device=None) -> "BQIndex":
        """Rebuild from export_state() output, this package's or
        longbow_tpu's (same keys)."""
        idx = cls(int(st["dim"]), st["metric"], rerank=bool(st["rerank"]), device=device)
        dev = idx.device
        if st.get("mean") is not None:
            idx.mean = torch.tensor(np.asarray(st["mean"], np.float32), device=dev)
        n = int(st["count"])
        if n:
            idx._grow_to(n)
            words = np.ascontiguousarray(np.asarray(st["codes"], np.uint32)).view(np.int32)
            idx.codes[:n] = torch.tensor(words).to(dev)
            idx.valid[:n] = torch.tensor(np.asarray(st["valid"], bool)).to(dev)
            if idx.rerank and st.get("vectors_bf16") is not None:
                vb = torch.tensor(np.asarray(st["vectors_bf16"], np.float32))
                idx.vectors_bf16[:n] = vb.to(dev).to(torch.bfloat16)
        idx.count = n
        return idx
