"""Product quantization: codebook training, encoding, ADC search.

Counterpart of longbow_tpu/index/pq.py, in plain PyTorch. Training is one
batched Lloyd run over the M subspaces (ops/kmeans.py); encoding is a
batched nearest-centroid product; the asymmetric-distance (ADC) scan
builds a per-query table [B, M, 256] with one einsum, then sums table
entries picked by the codes, chunk by chunk, with a stable top-k per
chunk and across chunks, so results do not depend on the chunk size. An
exact f32 re-rank of the top `rerank_factor * k` ADC candidates against
the stored full rows follows (rerank=True).

Where the reference gathers a [B, chunk * M] block (XLA fuses it), the
scan here adds one [B, chunk] gather per subspace, and chunks are sized
by memory.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from longbow_tpu_torch.device import resolve_device
from longbow_tpu_torch.ops.distance import (
    MASKED,
    Metric,
    as_rows,
    cosine_report,
    fit_mask,
    full_f32_matmul,
    normalize_rows,
    tombstone_rows,
)
from longbow_tpu_torch.ops.kmeans import kmeans_init, lloyd
from longbow_tpu_torch.ops.topk import pad_k, stable_topk

MIN_CAPACITY = 4096
# rows per encode step: the [M, chunk, 256] assignment block
ENCODE_CHUNK = 65_536
# f32 elements of one [B, chunk] score block of the ADC scan
ADC_BLOCK_ELEMS = 1 << 26
# queries per search dispatch: bounds the [B, pool, D] re-rank block
QUERY_CHUNK = 4096


def _encode(subvecs: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """subvecs [M, N, dsub] x codebooks [M, 256, dsub] -> codes [N, M]
    uint8 (nearest centroid per subspace; ties to the lower id)."""
    full_f32_matmul()
    ip = torch.bmm(subvecs, codebooks.transpose(1, 2))
    sn = (subvecs * subvecs).sum(dim=2)[:, :, None]
    cn = (codebooks * codebooks).sum(dim=2)[:, None, :]
    assign = torch.argmin(sn - 2.0 * ip + cn, dim=2)  # [M, N]
    return assign.to(torch.uint8).T.contiguous()


def encode_rows(v: torch.Tensor, codebooks: torch.Tensor, chunk: int = ENCODE_CHUNK) -> torch.Tensor:
    """Rows [n, D] f32 -> codes [n, M] uint8, ENCODE_CHUNK rows at a
    time (the result does not depend on the chunk)."""
    m, _, dsub = codebooks.shape
    out = [
        _encode(v[s:s + chunk].reshape(-1, m, dsub).transpose(0, 1), codebooks)
        for s in range(0, v.shape[0], chunk)
    ]
    return torch.cat(out) if out else torch.zeros((0, m), dtype=torch.uint8, device=v.device)


def train_codebooks(v: torch.Tensor, m: int, iters: int, seed: int = 0) -> torch.Tensor:
    """k-means codebooks [M, 256, D / M] over the rows v [N, D] (N >= 256),
    from a seeded random-subset init."""
    sub = v.reshape(v.shape[0], m, -1).transpose(0, 1)  # [M, N, D / M]
    books, _ = lloyd(sub, kmeans_init(sub, 256, seed), iters)
    return books


def adc_table(queries: torch.Tensor, codebooks: torch.Tensor, metric: str) -> torch.Tensor:
    """Per-query lookup table [B, M, 256]: the l2 distance of each query
    subvector to each centroid, or the negated inner product for dot
    (sum over m of -q_m.c_m = -q.v_hat, smaller is better)."""
    full_f32_matmul()
    b = queries.shape[0]
    m, _, dsub = codebooks.shape
    qs = queries.reshape(b, m, dsub)
    ip = torch.einsum("bmd,mkd->bmk", qs, codebooks)
    if metric == Metric.DOT:
        return -ip
    qn = (qs * qs).sum(dim=2)[:, :, None]
    cn = (codebooks * codebooks).sum(dim=2)[None, :, :]
    return qn - 2.0 * ip + cn


def _adc_search(codes, codebooks, queries, valid, k: int, metric: str = Metric.L2,
                chunk: Optional[int] = None):
    """Asymmetric-distance scan over codes [N, M] uint8 -> approximate
    (dist [B, k], idx [B, k] int64), ascending, ties in row order (as
    jax.lax.top_k); masked rows score MASKED. k <= N."""
    b = queries.shape[0]
    n, m = codes.shape
    lut = adc_table(queries, codebooks, metric)  # [B, M, 256]
    if chunk is None:
        chunk = max(4096, ADC_BLOCK_ELEMS // max(b, 1))
    ds, ix = [], []
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        cc = codes[start:end].long()
        scores = lut[:, 0, :].index_select(1, cc[:, 0])
        for j in range(1, m):
            scores += lut[:, j, :].index_select(1, cc[:, j])
        scores = torch.where(valid[None, start:end], scores, torch.full_like(scores, MASKED))
        d, i = stable_topk(scores, min(k, end - start))
        ds.append(d)
        ix.append(i + start)
    d, pos = stable_topk(torch.cat(ds, dim=1), k)
    return d, torch.cat(ix, dim=1).gather(1, pos)


class PQIndex:
    """PQ-compressed corpus with ADC scan + exact re-rank.

    m: subquantizers (code bytes per row). rerank: keep the full rows
    (rerank_dtype, f32 by default) and re-rank the top rerank_factor * k
    ADC candidates exactly; rerank=False is the compressed-only mode.
    device: None means the CUDA card (and raises without one).
    """

    def __init__(
        self,
        dim: int,
        m: int = 16,
        metric: str = Metric.L2,
        *,
        rerank: bool = True,
        rerank_factor: int = 16,
        rerank_dtype=torch.float32,
        train_iters: int = 12,
        device=None,
    ):
        if dim % m != 0:
            raise ValueError(f"dim {dim} not divisible by m {m}")
        self.device = resolve_device(device)
        self.dim = dim
        self.m = m
        self.dsub = dim // m
        self.metric = Metric.validate(metric)
        self.rerank = rerank
        self.rerank_factor = rerank_factor
        self.rerank_dtype = rerank_dtype
        self.train_iters = train_iters
        self.codebooks: Optional[torch.Tensor] = None      # [M, 256, dsub] f32
        self.codes: Optional[torch.Tensor] = None          # [cap, M] uint8
        self.valid: Optional[torch.Tensor] = None          # [cap] bool
        self.rerank_vectors: Optional[torch.Tensor] = None  # [cap, D]
        self.count = 0
        self._mu = threading.RLock()

    @property
    def is_trained(self) -> bool:
        return self.codebooks is not None

    @property
    def capacity(self) -> int:
        return 0 if self.codes is None else self.codes.shape[0]

    def _prep(self, vecs) -> torch.Tensor:
        """f32 rows on the device, normalized for cosine."""
        v = as_rows(vecs, self.device, self.dim)
        return normalize_rows(v) if self.metric == Metric.COSINE else v

    def train(self, vecs, seed: int = 0) -> None:
        """k-means codebooks over the rows (at least 256 of them)."""
        self.codebooks = train_codebooks(self._prep(vecs), self.m, self.train_iters, seed)

    def _grow_to(self, need: int) -> None:
        cap = max(self.capacity, MIN_CAPACITY)
        while cap < need:
            cap *= 2
        if cap == self.capacity:
            return
        dev = self.device
        codes = torch.zeros((cap, self.m), dtype=torch.uint8, device=dev)
        valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
        rr = torch.zeros((cap, self.dim), dtype=self.rerank_dtype, device=dev) if self.rerank else None
        if self.codes is not None:
            old = self.capacity
            codes[:old], valid[:old] = self.codes, self.valid
            if self.rerank:
                rr[:old] = self.rerank_vectors
        self.codes, self.valid, self.rerank_vectors = codes, valid, rr

    def add(self, vecs) -> np.ndarray:
        with self._mu:
            if not self.is_trained:
                self.train(vecs)
            v = self._prep(vecs)
            codes = encode_rows(v, self.codebooks)
            n = codes.shape[0]
            self._grow_to(self.count + n)
            s = self.count
            self.codes[s:s + n] = codes
            self.valid[s:s + n] = True
            if self.rerank:
                self.rerank_vectors[s:s + n] = v.to(self.rerank_dtype)
            rows = np.arange(s, s + n, dtype=np.int64)
            self.count += n
        return rows

    def delete_rows(self, rows) -> None:
        if len(rows) and self.valid is not None:
            with self._mu:
                tombstone_rows(self.valid, rows)

    def decode(self, rows) -> np.ndarray:
        """Approximate f32 rows rebuilt from the codes."""
        idx = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        cc = self.codes[idx].long()  # [R, M]
        sub = torch.arange(self.m, device=self.device)
        return self.codebooks[sub[None, :], cc].reshape(len(idx), self.dim).cpu().numpy()

    def get_vectors(self, rows) -> np.ndarray:
        """The re-rank rows (f32 host copies), else the decoded rows."""
        if not self.rerank:
            return self.decode(rows)
        idx = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        return self.rerank_vectors[idx].float().cpu().numpy()

    def device_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.codes, self.valid, self.rerank_vectors, self.codebooks)
                   if t is not None)

    def warm(self) -> None:
        """One search of a single query, off the query path."""
        if self.count:
            self.search(np.zeros((1, self.dim), np.float32), 10)

    def search(self, queries, k: int, *, filter_mask=None):
        """-> (dist [B, k] f32, rows [B, k] int64) as numpy; masked or
        missing slots are (MASKED, -1). filter_mask: bool of allowed rows
        (cut or padded to the capacity)."""
        q = self._prep(queries)
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
        d = torch.cat([o[0] for o in outs]).cpu().numpy()
        i = torch.cat([o[1] for o in outs]).cpu().numpy()
        if self.metric == Metric.COSINE:  # l2^2 on unit rows -> 1 - cos
            d = cosine_report(d)
        return d, i

    def _search_chunk(self, q, k: int, kk: int, valid):
        n = self.count
        d, i = _adc_search(self.codes[:n], self.codebooks, q, valid, kk, self.metric)
        if not self.rerank:
            return pad_k(d[:, :k], i[:, :k], k)
        full_f32_matmul()
        cand = self.rerank_vectors[i].float()  # [B, kk, D]
        ip = torch.einsum("bd,bkd->bk", q, cand)
        if self.metric == Metric.DOT:
            ed = -ip
        else:
            qn = (q * q).sum(dim=1, keepdim=True)
            ed = torch.clamp_min(qn - 2.0 * ip + (cand * cand).sum(dim=2), 0.0)
        ed = torch.where(d < MASKED, ed, torch.full_like(ed, MASKED))
        vals, pos = stable_topk(ed, min(k, kk))
        return pad_k(vals, i.gather(1, pos), k)

    # -- persistence --------------------------------------------------

    def export_state(self) -> dict:
        """longbow_tpu's PQIndex.export_state layout: uint8 codes, f32
        books and re-rank rows, cut to `count`."""
        with self._mu:
            n = self.count
            return {
                "kind": "pq",
                "dim": self.dim,
                "m": self.m,
                "metric": self.metric,
                "rerank": self.rerank,
                "count": n,
                "codebooks": None if self.codebooks is None else self.codebooks.cpu().numpy(),
                "codes": self.codes[:n].cpu().numpy() if n else np.zeros((0, self.m), np.uint8),
                "valid": self.valid[:n].cpu().numpy() if n else np.zeros((0,), bool),
                "rerank_vectors": (
                    self.rerank_vectors[:n].float().cpu().numpy() if self.rerank and n else None
                ),
            }

    @classmethod
    def import_state(cls, st: dict, *, device=None) -> "PQIndex":
        """Rebuild from export_state() output, this package's or
        longbow_tpu's (same keys)."""
        idx = cls(int(st["dim"]), int(st["m"]), st["metric"], rerank=bool(st["rerank"]),
                  device=device)
        dev = idx.device
        if st.get("codebooks") is not None:
            idx.codebooks = torch.tensor(np.asarray(st["codebooks"], np.float32), device=dev)
        n = int(st["count"])
        if n:
            idx._grow_to(n)
            idx.codes[:n] = torch.tensor(np.asarray(st["codes"], np.uint8)).to(dev)
            idx.valid[:n] = torch.tensor(np.asarray(st["valid"], bool)).to(dev)
            if idx.rerank and st.get("rerank_vectors") is not None:
                rr = np.asarray(st["rerank_vectors"], np.float32)
                idx.rerank_vectors[:n] = torch.tensor(rr).to(dev).to(idx.rerank_dtype)
        idx.count = n
        return idx
