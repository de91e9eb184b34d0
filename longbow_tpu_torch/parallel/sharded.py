"""Shard-parallel flat index: a row-sharded corpus and a top-k merge.

Counterpart of longbow_tpu/parallel/sharded.py (reference:
sharded_hnsw.go:378-470, an errgroup fan-out and a merge;
global_search.go:48, a per-peer fan-out and a top-k merge). Each shard's
rows, norms and validity live on its own device (mesh.devices[j]); a
search runs the local search of every shard on its device (the fused
scan K1 and an exact re-rank for bf16 rows and k <= 64, else the f32
exact_search), maps local rows to public ids, gathers the [B, k] pairs
to the first device and merges them with one top-k.

Ingest routing: striped placement (row i of an append goes to shard
i % n_shards, after the rows already there). Every search fans out to
every shard, so placement needs no key affinity.

ROW-ID CONTRACT (longbow_tpu's): the public row id of (shard j, slot s)
is s * S + j, independent of the shard capacity. Growth doubles each
shard's slots without moving any public id. The state's arrays are
shard-major ([j * cap + s]); the mapping is applied at the edges.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from longbow_tpu_torch.index.flat import FUSED_MAX_K, POOL, dtype_name, storage_dtype
from longbow_tpu_torch.metrics.registry import count_dispatch
from longbow_tpu_torch.ops.distance import (
    MASKED_GUARD,
    Metric,
    cosine_report,
    exact_search,
    normalize_rows,
    pad_to,
    tombstone_rows,
)
from longbow_tpu_torch.ops.scan import flat_search_rerank
from longbow_tpu_torch.ops.topk import stable_topk
from longbow_tpu_torch.parallel.mesh import Mesh, make_mesh

MIN_SHARD_CAPACITY = 2048


def merge_shards(dists: list, rows: list, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-shard [B, k] (distance, public id) pairs, in shard order,
    -> the k smallest per query; ties go to the lower shard and slot, as
    jax.lax.top_k over the gathered pairs gives them."""
    d, pos = stable_topk(torch.cat(dists, dim=1), k)
    return d, torch.cat(rows, dim=1).gather(1, pos)


class ShardedFlatIndex:
    """Exact k-NN over a corpus row-sharded across a mesh.

    dtype: the storage dtype (bf16 rows are searched through K1 for
    k <= 64); shard_capacity: initial slots per shard, a multiple of
    MIN_SHARD_CAPACITY. `_mu` serializes appends, deletes and searches.
    """

    def __init__(
        self,
        dim: int,
        mesh: Mesh,
        metric: str = Metric.L2,
        dtype=torch.float32,
        shard_capacity: int = MIN_SHARD_CAPACITY,
    ):
        self.dim = dim
        self.mesh = mesh
        self.n_shards = mesh.size
        self.metric = Metric.validate(metric)
        self.dtype = storage_dtype(dtype)
        self.shard_capacity = pad_to(shard_capacity, MIN_SHARD_CAPACITY)
        self._shard_counts = np.zeros(self.n_shards, np.int64)
        self._mu = threading.Lock()
        self.vectors, self.norms_sq, self.valid = self._alloc(self.shard_capacity)

    def _alloc(self, cap: int) -> tuple[list, list, list]:
        """Zeroed per-shard tensors of `cap` slots, each on its device."""
        return (
            [torch.zeros((cap, self.dim), dtype=self.dtype, device=d) for d in self.mesh.devices],
            [torch.zeros((cap,), dtype=torch.float32, device=d) for d in self.mesh.devices],
            [torch.zeros((cap,), dtype=torch.bool, device=d) for d in self.mesh.devices],
        )

    def __len__(self) -> int:
        return int(self._shard_counts.sum())

    @property
    def capacity(self) -> int:
        """The public row space: every public id is below it."""
        return self.n_shards * self.shard_capacity

    def _split(self, rows) -> tuple[np.ndarray, np.ndarray]:
        """public ids -> (shard, slot)."""
        rows = np.asarray(rows, np.int64)
        return rows % self.n_shards, rows // self.n_shards

    def _grow(self, per_shard_need: int) -> None:
        new_cap = self.shard_capacity
        while new_cap < per_shard_need:
            new_cap *= 2
        if new_cap == self.shard_capacity:
            return
        # public ids do not depend on the capacity: growth only pads each
        # shard's slots
        old = self.shard_capacity
        vectors, norms, valid = self._alloc(new_cap)
        for j in range(self.n_shards):
            vectors[j][:old] = self.vectors[j]
            norms[j][:old] = self.norms_sq[j]
            valid[j][:old] = self.valid[j]
        self.vectors, self.norms_sq, self.valid = vectors, norms, valid
        self.shard_capacity = new_cap

    # ------------------------------------------------------------------

    def add(self, vecs) -> np.ndarray:
        """Append vectors (numpy or a tensor) striped across shards;
        returns their public ids."""
        if isinstance(vecs, torch.Tensor):
            x = vecs.float()
        else:
            x = torch.from_numpy(np.ascontiguousarray(np.atleast_2d(vecs), dtype=np.float32))
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}] vectors, got {tuple(x.shape)}")
        if self.metric == Metric.COSINE:
            x = normalize_rows(x)
        n, s = x.shape[0], self.n_shards
        counts = np.array([len(range(j, n, s)) for j in range(s)], np.int64)
        rows = np.zeros(n, np.int64)
        with self._mu:
            self._grow(int((self._shard_counts + counts).max()))
            for j, dev in enumerate(self.mesh.devices):
                m = int(counts[j])
                if m == 0:
                    continue
                start = int(self._shard_counts[j])
                stored = x[j::s].to(dev, self.dtype)
                # norms of the STORED (rounded) rows, summed in f64 as
                # longbow_tpu does: f32 norms of the originals paired with
                # rounded inner products bias every distance
                sd = stored.double()
                self.vectors[j][start:start + m] = stored
                self.norms_sq[j][start:start + m] = (sd * sd).sum(dim=1).float()
                self.valid[j][start:start + m] = True
                rows[j::s] = (start + np.arange(m)) * s + j
            self._shard_counts += counts
        return rows

    def delete_rows(self, rows) -> None:
        """Tombstone public ids (ids past the rows are ignored)."""
        if len(rows) == 0:
            return
        shard, slot = self._split(rows)
        with self._mu:
            for j in np.unique(shard):
                tombstone_rows(self.valid[j], slot[shard == j])

    # ------------------------------------------------------------------

    def _shard_masks(self, filter_mask) -> list:
        """A public-order filter mask -> per-shard slot masks on each
        shard's device, or Nones. The mask is cut or padded (False) to
        the public row space first."""
        if filter_mask is None:
            return [None] * self.n_shards
        cap = self.capacity
        m = torch.as_tensor(filter_mask).bool()[:cap]
        if m.shape[0] < cap:
            m = torch.cat([m, torch.zeros(cap - m.shape[0], dtype=torch.bool, device=m.device)])
        # public r = slot * S + shard: a [cap, S] view's column j is shard j
        grid = m.reshape(self.shard_capacity, self.n_shards)
        return [grid[:, j].to(dev) for j, dev in enumerate(self.mesh.devices)]

    def local_search(self, j: int, q: torch.Tensor, k: int, mask, metric: str,
                     normalize: bool) -> tuple[torch.Tensor, torch.Tensor]:
        """Shard j's top-k on its device -> (dist [B, k] f32, public id
        [B, k] int64), (MASKED, -1) where nothing was found. The caller
        holds `_mu`."""
        dev = self.mesh.devices[j]
        qj = q.to(dev)
        if self.dtype == torch.bfloat16 and k <= FUSED_MAX_K:
            d, i = flat_search_rerank(
                qj, self.vectors[j], self.norms_sq[j], self.valid[j], k, metric,
                pool=POOL, extra_mask=mask, normalize=normalize, device=dev,
            )
            count_dispatch("pallas_fused", dev.type == "cuda")
        else:
            count_dispatch("xla")
            d, i = exact_search(
                qj, self.vectors[j], k, metric, corpus_norms_sq=self.norms_sq[j],
                valid=self.valid[j], extra_mask=mask, normalize=normalize, device=dev,
            )
        pub = torch.where(d < MASKED_GUARD, i.long() * self.n_shards + j, -1)
        return d, pub

    def search(self, queries, k: int, *, filter_mask=None) -> tuple[np.ndarray, np.ndarray]:
        """Batched k-NN over every shard -> (dist [B, k] f32, public id
        [B, k] int32) as numpy. filter_mask: rows allowed, in public
        order."""
        if isinstance(queries, torch.Tensor):
            q = queries.float()
        else:
            q = torch.from_numpy(np.atleast_2d(np.asarray(queries, dtype=np.float32)))
        if q.ndim == 1:
            q = q[None, :]
        # cosine rides the l2 scan on unit rows and is reported as 1 - cos
        normalize = self.metric == Metric.COSINE
        metric = Metric.L2 if normalize else self.metric
        first = self.mesh.devices[0]
        with self._mu:
            masks = self._shard_masks(filter_mask)
            parts = [self.local_search(j, q, k, masks[j], metric, normalize)
                     for j in range(self.n_shards)]
            d, i = merge_shards([p[0].to(first) for p in parts],
                                [p[1].to(first) for p in parts], k)
        d = d.cpu().numpy()
        if normalize:
            d = cosine_report(d)
        return d, i.int().cpu().numpy()

    def get_vectors(self, rows) -> np.ndarray:
        """The stored rows of public ids, as f32 numpy in the given order."""
        shard, slot = self._split(rows)
        out = np.zeros((len(shard), self.dim), np.float32)
        with self._mu:
            for j in np.unique(shard):
                sel = shard == j
                idx = torch.as_tensor(slot[sel], device=self.mesh.devices[j])
                out[sel] = self.vectors[j][idx].float().cpu().numpy()
        return out

    def device_bytes(self) -> int:
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return self.capacity * (self.dim * itemsize + 4 + 1)

    def warm(self) -> None:
        """Build the scan kernel and run one search, off the query path."""
        self.search(np.zeros((1, self.dim), np.float32), 10)

    # ------------------------------------------------------------------

    def export_state(self) -> dict:
        """longbow_tpu's layout: shard-major arrays (rows as f32). Public
        ids depend on n_shards, so an import makes a mesh of that size;
        the shard capacity is kept."""
        with self._mu:
            return {
                "kind": "mesh_flat",
                "dim": self.dim,
                "metric": self.metric,
                "dtype": dtype_name(self.dtype),
                "n_shards": self.n_shards,
                "shard_capacity": self.shard_capacity,
                "shard_counts": self._shard_counts.copy(),
                "vectors": torch.cat([v.float().cpu() for v in self.vectors]).numpy(),
                "norms_sq": torch.cat([n.cpu() for n in self.norms_sq]).numpy(),
                "valid": torch.cat([v.cpu() for v in self.valid]).numpy(),
            }

    @classmethod
    def import_state(cls, st: dict, *, device=None) -> "ShardedFlatIndex":
        """From export_state() output, this package's or longbow_tpu's, on
        make_mesh(n_shards, device=device) (which raises when there are
        fewer devices)."""
        mesh = make_mesh(int(st["n_shards"]), device=device)
        idx = cls(int(st["dim"]), mesh, st["metric"], dtype=storage_dtype(st["dtype"]),
                  shard_capacity=int(st["shard_capacity"]))
        cap = idx.shard_capacity
        idx._shard_counts = np.asarray(st["shard_counts"], np.int64).copy()
        vectors = np.asarray(st["vectors"], np.float32)
        norms = np.asarray(st["norms_sq"], np.float32)
        valid = np.asarray(st["valid"], bool)
        for j, dev in enumerate(mesh.devices):
            sl = slice(j * cap, (j + 1) * cap)
            idx.vectors[j] = torch.from_numpy(vectors[sl].copy()).to(dev, idx.dtype)
            idx.norms_sq[j] = torch.from_numpy(norms[sl].copy()).to(dev)
            idx.valid[j] = torch.from_numpy(valid[sl].copy()).to(dev)
        return idx
