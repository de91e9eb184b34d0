"""VectorStore: the top-level object owning all datasets.

Counterpart of longbow_tpu/store/vector_store.py: the same surface the
Flight handlers call (put, search, delete, the dataset lifecycle and
readiness). Persistence, eviction, memory backpressure, hybrid search
and graph re-rank are not ported yet, and neither are the metrics calls.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from longbow_tpu_torch.device import resolve_device
from longbow_tpu_torch.ops.distance import Metric
from longbow_tpu_torch.store.dataset import Dataset
from longbow_tpu_torch.utils.query_cache import QueryCache


class VectorStore:
    """All datasets of one process, on one device.

    dtype: storage dtype of new datasets (bf16 is what the fused scan
    serves; torch.float32 serves every flat search through exact_search).
    The default index kind is "adaptive": a flat scan until
    migration_threshold rows, a graph (hnsw_config) after.
    device: None means the CUDA card (and raises without one).
    """

    def __init__(
        self,
        *,
        default_metric: str = Metric.L2,
        dtype=torch.bfloat16,
        migration_threshold: int = 200_000,
        hnsw_config=None,
        query_cache_size: int = 1024,
        query_cache_ttl: float = 60.0,
        default_index_kind: str = "adaptive",
        default_index_params: Optional[dict] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self._datasets: dict[str, Dataset] = {}
        self._namespaces: dict[str, set] = {}  # ns -> dataset names
        self._lock = threading.Lock()
        self.default_metric = Metric.validate(default_metric)
        self.dtype = dtype
        # rows at which an adaptive dataset moves from the flat scan to
        # the graph, and the graph's knobs (an HNSWConfig; None: defaults)
        self.migration_threshold = migration_threshold
        self.hnsw_config = hnsw_config
        self.default_index_kind = default_index_kind
        self.default_index_params = dict(default_index_params or {})
        self.query_cache = QueryCache(query_cache_size, query_cache_ttl)
        self.started_at = time.time()

    # -- dataset lifecycle --------------------------------------------

    def get_or_create(
        self,
        name: str,
        dim: int,
        metric: Optional[str] = None,
        *,
        index_kind: Optional[str] = None,
        index_params: Optional[dict] = None,
        dtype_hint=None,
    ) -> Dataset:
        # a dataset first seen with int8/uint8 vectors, in a store whose
        # default kind is adaptive and with no kind asked for, stores the
        # bytes 1:1 as identity-affine sq8 codes
        if (
            dtype_hint is not None
            and index_kind is None
            and self.default_index_kind in (None, "adaptive")
            and np.dtype(dtype_hint) in (np.dtype(np.int8), np.dtype(np.uint8))
        ):
            index_kind = "sq8"
        with self._lock:
            ds = self._datasets.get(name)
            if ds is None:
                ds = Dataset(
                    name,
                    dim,
                    metric or self.default_metric,
                    dtype=self.dtype,
                    hnsw_config=self.hnsw_config,
                    migration_threshold=self.migration_threshold,
                    index_kind=index_kind or self.default_index_kind,
                    index_params=(
                        index_params
                        if index_params is not None
                        else self.default_index_params
                    ),
                    device=self.device,
                )
                self._datasets[name] = ds
                ns = name.split("/", 1)[0] if "/" in name else "default"
                self._namespaces.setdefault(ns, set()).add(name)
            elif ds.dim != dim:
                raise ValueError(
                    f"dataset {name!r} has dim {ds.dim}, put has {dim}"
                )
            return ds

    def get(self, name: str) -> Dataset:
        ds = self._datasets.get(name)
        if ds is None:
            raise KeyError(f"dataset {name!r} not found")
        return ds

    def drop(self, name: str) -> bool:
        """The 'delete-dataset' action."""
        with self._lock:
            ds = self._datasets.pop(name, None)
            for members in self._namespaces.values():
                members.discard(name)
            self.query_cache.clear()
            return ds is not None

    def list_datasets(self) -> list[str]:
        return sorted(self._datasets)

    def list_namespaces(self) -> list[str]:
        return sorted(self._namespaces)

    # -- data plane ---------------------------------------------------

    def put(
        self,
        dataset: str,
        ids,
        vectors,
        columns: Optional[dict] = None,
        metric: Optional[str] = None,
        *,
        timestamp=None,
    ) -> None:
        """Upsert rows (the DoPut path). vectors: a numpy array, a list
        of numpy blocks of one dim, or a tensor (kept on its device)."""
        if isinstance(vectors, list):
            dim, dtype_hint = vectors[0].shape[1], vectors[0].dtype
        else:
            dtype_hint = None
            if not isinstance(vectors, torch.Tensor):
                vectors = np.atleast_2d(np.asarray(vectors))
                dtype_hint = vectors.dtype
            dim = vectors.shape[1]
        ds = self.get_or_create(dataset, dim, metric, dtype_hint=dtype_hint)
        ds.put(np.asarray(ids), vectors, columns, timestamp=timestamp)
        self.query_cache.clear()

    def search(
        self,
        dataset: str,
        queries,
        k: int,
        *,
        filters: Optional[list] = None,
        ef_search: Optional[int] = None,
        exact: bool = False,
        use_cache: bool = True,
    ):
        """-> (ids [B, k] object, scores [B, k] f32, ok [B, k] bool),
        the DoGet search path. Results are cached by dataset, query
        bytes and parameters until the next mutation or the TTL."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        key = None
        if use_cache:
            key = QueryCache.hash_query(
                dataset, queries.tobytes(), k, filters, ef_search, exact
            )
            hit = self.query_cache.get(key)
            if hit is not None:
                self.get(dataset).touch()
                return hit
        out = self.get(dataset).search(
            queries, k, filters=filters, ef_search=ef_search, exact=exact
        )
        if key is not None:
            self.query_cache.put(key, out)
        return out

    def delete(self, dataset: str, ids) -> int:
        """The 'delete' action: tombstone rows by user id."""
        n = self.get(dataset).delete(ids)
        self.query_cache.clear()
        return n

    # -- introspection ------------------------------------------------

    def readiness(self) -> dict:
        """The 'check_readiness' action. A migration to the graph tier
        runs in the background while the flat tier serves every row, so
        the store is READY once a call returns. A migration that failed
        leaves its dataset on the flat tier and is listed by name."""
        failed = {}
        for name, ds in list(self._datasets.items()):
            err = getattr(ds.index, "migration_error", None)
            if err is not None:
                failed[name] = repr(err)
        return {
            "status": "READY",
            "datasets": len(self._datasets),
            "migration_errors": failed,
            "uptime_s": time.time() - self.started_at,
        }
