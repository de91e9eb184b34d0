"""Index construction behind one uniform surface.

Counterpart of longbow_tpu/index/factory.py. Every kind is ported:
"adaptive" and "hnsw" (storage "dense", "sq8" or "pq"), "flat", "sq8",
"sq8r", "pq", "bq", "ivf", "disk", and the device-mesh kinds
"mesh_flat" and "mesh_graph" (parallel/).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from longbow_tpu_torch.index.adaptive import DEFAULT_MIGRATION_THRESHOLD, AdaptiveIndex
from longbow_tpu_torch.index.bq import BQIndex
from longbow_tpu_torch.index.flat import MIN_CAPACITY, FlatIndex
from longbow_tpu_torch.index.hardness import DEFAULT_MIN_CONTRAST
from longbow_tpu_torch.index.ivf import IVFIndex
from longbow_tpu_torch.index.pq import PQIndex
from longbow_tpu_torch.index.sq8 import SQ8Index, SQ8ResidualIndex
from longbow_tpu_torch.index.tiered import TieredIndex
from longbow_tpu_torch.ops.distance import MASKED, exact_search
from longbow_tpu_torch.parallel.mesh import make_mesh
from longbow_tpu_torch.parallel.sharded import ShardedFlatIndex
from longbow_tpu_torch.parallel.sharded_graph import ShardedGraphIndex

INDEX_KINDS = (
    "adaptive", "flat", "hnsw", "pq", "sq8", "sq8r", "bq", "disk",
    "ivf",
    "mesh_flat", "mesh_graph",
)


PORTED_KINDS = INDEX_KINDS

# the quantized kinds behind _QuantizedAdapter, by the kind in their state
_QUANTIZED = {
    "pq": PQIndex, "sq8": SQ8Index, "sq8r": SQ8ResidualIndex, "bq": BQIndex,
    "ivf": IVFIndex, "disk": TieredIndex,
}


class _FlatAdapter:
    """The surface the Dataset uses — search(q, k, *, filter_mask,
    ef_search, exact) — over a FlatIndex. ef_search does not apply to an
    exhaustive scan; exact=True goes to exact_search."""

    kind = "flat"
    accepts_blocks = True

    def __init__(self, inner: FlatIndex):
        self._flat = inner
        self.dim = inner.dim
        self.metric = inner.metric

    @property
    def capacity(self) -> int:
        return self._flat.capacity

    def __len__(self) -> int:
        return len(self._flat)

    def add(self, vecs) -> np.ndarray:
        return self._flat.add(vecs)

    def delete_rows(self, rows) -> None:
        self._flat.delete_rows(rows)

    def flush(self) -> None:
        self._flat.flush()

    def search(self, queries, k, *, filter_mask=None, ef_search=None,
               exact=False):
        return self._flat.search(queries, k, filter_mask=filter_mask, exact=exact)

    def warm(self) -> None:
        self._flat.warm()

    def get_vectors(self, rows) -> np.ndarray:
        return self._flat.get_vectors(rows)

    def get_vectors_device(self, rows) -> torch.Tensor:
        return self._flat.get_vectors_device(rows)

    def mirror_rows(self, rows):
        return self._flat.mirror_rows(rows)

    def export_state(self) -> dict:
        return self._flat.export_state()

    def device_bytes(self) -> int:
        return self._flat.device_bytes()


class _QuantizedAdapter:
    """The same surface over the PQ, SQ8, SQ8-residual, BQ, IVF and tiered
    indexes. ef_search and exact do not apply to them."""

    accepts_blocks = False

    def __init__(self, inner, kind: str):
        self._inner = inner
        self.kind = kind
        self.dim = inner.dim
        self.metric = inner.metric

    @property
    def capacity(self) -> int:
        return max(self._inner.capacity, self._inner.count, 1)

    def __len__(self) -> int:
        return self._inner.count

    def add(self, vecs) -> np.ndarray:
        return self._inner.add(vecs)

    def delete_rows(self, rows) -> None:
        self._inner.delete_rows(rows)

    def flush(self) -> None:
        """Rows are stored once add returns; a disk tier syncs its file."""
        flush = getattr(self._inner, "flush", None)
        if flush is not None:
            flush()

    def search(self, queries, k, *, filter_mask=None, ef_search=None,
               exact=False):
        # each index fits the mask to its rows itself
        return self._inner.search(queries, k, filter_mask=filter_mask)

    def warm(self) -> None:
        self._inner.warm()

    def get_vectors(self, rows) -> np.ndarray:
        return self._inner.get_vectors(rows)

    def get_vectors_device(self, rows) -> torch.Tensor:
        """f32 rows on the index's device: a device gather where the index
        has one (sq8), else its host rows uploaded."""
        gather = getattr(self._inner, "get_vectors_device", None)
        if gather is not None:
            return gather(rows)
        return torch.from_numpy(self._inner.get_vectors(rows)).to(self._inner.device)

    def export_state(self) -> dict:
        return self._inner.export_state()

    def device_bytes(self) -> int:
        return self._inner.device_bytes()

    def host_bytes(self) -> int:
        """Host RAM or file bytes beside the device ("disk")."""
        host_bytes = getattr(self._inner, "host_bytes", None)
        return 0 if host_bytes is None else host_bytes()


class _MeshAdapter:
    """The same surface over the mesh-sharded indexes
    (parallel/sharded.py, parallel/sharded_graph.py): a corpus
    row-sharded over a mesh of devices, a search per shard and a merge of
    their top-k (reference capability: ShardedHNSW, sharded_hnsw.go:378,
    and scatter-gather)."""

    accepts_blocks = False

    def __init__(self, inner, kind: str):
        self._inner = inner
        self.kind = kind
        self.dim = inner.dim
        self.metric = inner.metric

    def __len__(self) -> int:
        return len(self._inner)

    @property
    def n_shards(self) -> int:
        """The store's sharded metrics (shard size, load factor, search
        splits) read it."""
        return self._inner.n_shards

    @property
    def _shard_counts(self):
        return getattr(self._inner, "_shard_counts", None)

    @property
    def capacity(self) -> int:
        return max(self._inner.capacity, len(self._inner), 1)

    def add(self, vecs) -> np.ndarray:
        return self._inner.add(vecs)

    def delete_rows(self, rows) -> None:
        self._inner.delete_rows(np.asarray(rows))

    def search(self, queries, k, *, filter_mask=None, ef_search=None,
               exact=False):
        if self.kind == "mesh_flat":  # exhaustive already; fits the mask itself
            return self._inner.search(queries, k, filter_mask=filter_mask)
        if exact:
            # the oracle contract is not served approximate results: an
            # exact scan over the host copy of the rows
            return self._exact(queries, k, filter_mask)
        if filter_mask is None:
            return self._inner.search(queries, k, ef_search=ef_search)
        # traversal is unfiltered: oversample, then filter on the host (the
        # reference's bitmap post-filter)
        kk = min(max(4 * k, 32), max(len(self._inner), k))
        d, r = self._inner.search(queries, kk, ef_search=ef_search)
        m = torch.as_tensor(filter_mask).bool().cpu().numpy()
        keep = (r >= 0) & (r < m.shape[0]) & m[np.clip(r, 0, m.shape[0] - 1)]
        d = np.where(keep, d, np.float32(MASKED))
        order = np.argsort(d, axis=1)[:, :k]
        d2 = np.take_along_axis(d, order, axis=1)
        r2 = np.where(d2 < float(MASKED), np.take_along_axis(r, order, axis=1), -1)
        return d2.astype(np.float32), r2.astype(np.int32)

    def _exact(self, queries, k, filter_mask):
        inner = self._inner
        allv = inner._host_all()
        b = np.atleast_2d(np.asarray(queries)).shape[0]
        if len(allv) == 0:
            return np.full((b, k), np.float32(MASKED)), np.full((b, k), -1, np.int32)
        valid = torch.ones(len(allv), dtype=torch.bool)
        if inner._deleted:
            valid[torch.as_tensor(sorted(inner._deleted))] = False
        if filter_mask is not None:
            m = torch.as_tensor(filter_mask).bool().cpu()[: len(allv)]
            valid[: len(m)] &= m
        d, r = exact_search(
            np.atleast_2d(np.asarray(queries, np.float32)), torch.from_numpy(allv), k,
            inner.metric, valid=valid, device=inner.mesh.devices[0],
        )
        return d.cpu().numpy(), r.cpu().numpy()

    def warm(self) -> None:
        self._inner.search(np.zeros((1, self.dim), np.float32), 10)

    def get_vectors(self, rows) -> np.ndarray:
        return self._inner.get_vectors(np.asarray(rows))

    def get_vectors_device(self, rows) -> torch.Tensor:
        """f32 rows on the mesh's first device."""
        return torch.from_numpy(self.get_vectors(rows)).to(self._inner.mesh.devices[0])

    def export_state(self) -> dict:
        st = self._inner.export_state()
        st["kind"] = self.kind
        st["dim"] = self.dim
        return st

    def device_bytes(self) -> int:
        return self._inner.device_bytes()


def make_index(
    kind: str, dim: int, metric: str, *, dtype, device=None,
    migration_threshold: int = DEFAULT_MIGRATION_THRESHOLD, hnsw_config=None,
    **params,
):
    """A new index of `kind`.

    "adaptive" is flat until `migration_threshold` rows and a graph
    after; "hnsw" is the same class migrating on its first add; both take
    hnsw_config (an HNSWConfig) and the params storage ("dense", "sq8"
    or "pq"), pq_m (storage "pq": code bytes, 0 for dim / 4),
    min_contrast (default: LONGBOW_ADAPTIVE_MIN_CONTRAST, else 2.0;
    "adaptive" only) and capacity. Other params: capacity (flat: rows to
    preallocate), n_clusters (sq8r: k-means clusters, 0 for the default),
    pq_m (pq: subquantizers, default 16) and rerank (pq, bq: default
    True), n_cells (ivf: 0 picks about 2 sqrt(n)) and n_probe (ivf:
    default 8), path (disk: an mmap file for the host rows, None keeps
    them in RAM), rerank_factor (disk: default 8) and mesh_shards
    ("mesh_flat", "mesh_graph": one shard per device of
    make_mesh(mesh_shards, device=device); 0 takes every card, or one
    shard on the CPU)."""
    kind = (kind or "adaptive").lower()
    if kind in ("mesh_flat", "mesh_graph"):
        mesh = make_mesh(int(params.get("mesh_shards", 0)) or None, device=device)
        if kind == "mesh_flat":
            return _MeshAdapter(ShardedFlatIndex(dim, mesh, metric, dtype=dtype), kind)
        inner = ShardedGraphIndex(dim, mesh, metric, config=hnsw_config, dtype=dtype)
        return _MeshAdapter(inner, kind)
    if kind in ("adaptive", "hnsw"):
        common = dict(
            dtype=dtype, hnsw_config=hnsw_config,
            storage=str(params.get("storage", "dense")).lower(),
            pq_m=int(params.get("pq_m", 0)) or None,
            capacity=int(params.get("capacity", 0)), device=device,
        )
        if kind == "hnsw":  # migrate on the first add
            return AdaptiveIndex(dim, metric, migration_threshold=0, **common)
        min_contrast = float(params.get(
            "min_contrast",
            os.environ.get("LONGBOW_ADAPTIVE_MIN_CONTRAST", DEFAULT_MIN_CONTRAST),
        ))
        return AdaptiveIndex(
            dim, metric, migration_threshold=migration_threshold,
            min_contrast=min_contrast, **common,
        )
    if kind == "flat":
        capacity = int(params.get("capacity", 0))
        return _FlatAdapter(
            FlatIndex(dim, metric, dtype, capacity=max(capacity, 0) or MIN_CAPACITY,
                      device=device)
        )
    if kind == "sq8":
        return _QuantizedAdapter(SQ8Index(dim, metric, device=device), "sq8")
    if kind == "sq8r":
        inner = SQ8ResidualIndex(
            dim, metric, n_clusters=int(params.get("n_clusters", 0)), device=device
        )
        return _QuantizedAdapter(inner, "sq8r")
    if kind == "pq":
        inner = PQIndex(dim, int(params.get("pq_m", 16)), metric,
                        rerank=bool(params.get("rerank", True)), device=device)
        return _QuantizedAdapter(inner, "pq")
    if kind == "bq":
        inner = BQIndex(dim, metric, rerank=bool(params.get("rerank", True)), device=device)
        return _QuantizedAdapter(inner, "bq")
    if kind == "ivf":
        inner = IVFIndex(dim, metric, n_cells=int(params.get("n_cells", 0)),
                         n_probe=int(params.get("n_probe", 8)), dtype=dtype, device=device)
        return _QuantizedAdapter(inner, "ivf")
    if kind == "disk":
        inner = TieredIndex(dim, metric, path=params.get("path"),
                            rerank_factor=int(params.get("rerank_factor", 8)), device=device)
        return _QuantizedAdapter(inner, "disk")
    raise ValueError(f"unknown index kind {kind!r}; want one of {INDEX_KINDS}")


def import_index(state: dict, *, device=None):
    """Rebuild an index from export_state() output (this package's or
    longbow_tpu's)."""
    kind = state["kind"]
    if kind == "hnsw" or (kind == "flat" and "migration_threshold" in state):
        return AdaptiveIndex.import_state(state, device=device)
    if kind == "flat":
        return _FlatAdapter(FlatIndex.import_state(state, device=device))
    if kind in _QUANTIZED:
        return _QuantizedAdapter(_QUANTIZED[kind].import_state(state, device=device), kind)
    if kind == "mesh_flat":
        return _MeshAdapter(ShardedFlatIndex.import_state(state, device=device), kind)
    if kind == "mesh_graph":
        return _MeshAdapter(ShardedGraphIndex.import_state(state, device=device), kind)
    raise ValueError(f"cannot import index state of kind {kind!r}")
