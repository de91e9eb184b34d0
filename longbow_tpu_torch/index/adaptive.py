"""AdaptiveIndex: exact scan for small datasets, graph ANN after a
threshold.

Counterpart of longbow_tpu/index/adaptive.py. Below the threshold
everything is a FlatIndex. On crossing it, a graph index is bulk-built
from the flat corpus and later adds use the graph's incremental insert.
The build runs on a background thread while the flat index keeps serving
every row; the migration thread catches up on rows added meanwhile and swaps under
the mutation lock, so there is no read gap and no blocked put.

A search takes its tier from one consistent look (`_tiers`) and then
relies on that tier's own dispatch lock: FlatIndex._mu or HNSWIndex._mu.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np
import torch

from longbow_tpu_torch.device import resolve_device
from longbow_tpu_torch.index.flat import FlatIndex, storage_dtype
from longbow_tpu_torch.index.hardness import (
    DEFAULT_MIN_CONTRAST,
    relative_contrast_from_sample,
    sample_for_contrast,
)
from longbow_tpu_torch.index.hnsw import HNSWConfig, HNSWIndex
from longbow_tpu_torch.metrics import get_registry
from longbow_tpu_torch.ops._kernels import KernelError
from longbow_tpu_torch.ops.distance import Metric

log = logging.getLogger("longbow.adaptive")

DEFAULT_MIGRATION_THRESHOLD = 200_000
# a backlog of at most this many rows is folded in under the lock,
# together with the swap
SWAP_BACKLOG_ROWS = 4096


class AdaptiveIndex:
    def __init__(
        self,
        dim: int,
        metric: str = Metric.L2,
        *,
        dtype=torch.float32,
        migration_threshold: int = DEFAULT_MIGRATION_THRESHOLD,
        hnsw_config: Optional[HNSWConfig] = None,
        storage: str = "dense",
        pq_m: Optional[int] = None,
        min_contrast: float = DEFAULT_MIN_CONTRAST,
        capacity: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.dim = dim
        self.metric = Metric.validate(metric)
        self.dtype = storage_dtype(dtype)
        self.migration_threshold = migration_threshold
        self.hnsw_config = hnsw_config or HNSWConfig()
        # graph vector payload: "dense" (dtype), "sq8" or "pq" codes
        self.storage = storage
        self.pq_m = pq_m
        # capacity pre-sizing skips every growth step
        self._flat = FlatIndex(
            dim, metric, self.dtype, capacity=max(int(capacity), 0) or 4096,
            device=self.device,
        )
        self._graph: Optional[HNSWIndex] = None
        # background migration: the flat index keeps serving ALL rows
        # while the migration thread catches up. _mlock guards mutations and
        # the final swap.
        self.background_migration = True
        self._mlock = threading.RLock()
        self._migrator: Optional[threading.Thread] = None
        # what ended the last migration, if it failed (the index then
        # stays flat; Dataset.stats() and VectorStore.readiness() show it).
        # No new attempt starts before the row count reaches _retry_at,
        # and a kernel that failed to build or launch is raised from the
        # next add (_unraised), before that add stores anything.
        self.migration_error: Optional[BaseException] = None
        self._retry_at = 0
        self._unraised: Optional[BaseException] = None
        # hardness-aware routing (index/hardness.py): distance-
        # concentrated corpora never migrate. 0 disables the probe.
        self.min_contrast = min_contrast
        self.last_contrast: Optional[float] = None
        self._contrast_checked_at = 0
        # seconds and rows of the last migration's stages: probe_s,
        # bulk_s / bulk_rows, catchup_s / catchup_rows
        self.migration_stats: dict = {}

    # ------------------------------------------------------------------

    def _tiers(self) -> tuple[FlatIndex, Optional[HNSWIndex]]:
        """(flat, graph) as one search should see them. The swap sets
        the graph first and the empty flat second, so reading the flat
        first can never pair "no graph yet" with the emptied flat."""
        flat = self._flat
        return flat, self._graph

    @property
    def kind(self) -> str:
        return "hnsw" if self._graph is not None else "flat"

    @property
    def capacity(self) -> int:
        return (self._graph or self._flat).capacity

    def __len__(self) -> int:
        return len(self._graph or self._flat)

    # ------------------------------------------------------------------

    def _enter_device(self) -> None:
        """Make the index's card the calling thread's current device (a
        new thread starts on card 0; "cuda" without an index means the
        current one already)."""
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)

    def _graph_chunk(self, g: HNSWIndex, a: int, b: int, stage: str) -> None:
        """Feed flat rows [a, b) to the graph, preserving row ids (graph
        insertion order == flat row order). The rows stay on the device;
        for l2 dense storage of the same dtype they are not even cast.
        Waits for the device and books the time under `stage`."""
        t0 = time.perf_counter()
        g.add(self._flat.vectors[a:b])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        st = self.migration_stats
        st[f"{stage}_s"] = st.get(f"{stage}_s", 0.0) + time.perf_counter() - t0
        st[f"{stage}_rows"] = st.get(f"{stage}_rows", 0) + (b - a)

    def _migration_failed(self, e: BaseException, what: str) -> None:
        self.migration_error = e
        self._retry_at = 2 * len(self._flat)  # the next count-doubling
        if isinstance(e, KernelError) and self.migration_threshold > 0:
            self._unraised = e
        log.exception("%s failed; staying flat", what)

    def _build_graph(self) -> None:
        """Migration-thread body: bulk-build from a snapshot, then catch up
        on rows added meanwhile, then swap under the mutation lock."""
        try:
            self._enter_device()
            probe_s = self.migration_stats.get("probe_s")
            self.migration_stats = {} if probe_s is None else {"probe_s": probe_s}
            with self._mlock:
                self._flat.flush()
                built = self._flat.count
                cap = self._flat.capacity
            g = HNSWIndex(
                self.dim, self.metric, self.hnsw_config, self.dtype,
                capacity=cap, storage=self.storage, pq_m=self.pq_m,
                device=self.device,
            )
            self._graph_chunk(g, 0, built, "bulk")  # the long part, lock-free
            while True:
                with self._mlock:
                    self._flat.flush()
                    count = self._flat.count
                    if count - built <= SWAP_BACKLOG_ROWS:
                        # final small delta: fold in + swap atomically
                        if count > built:
                            self._graph_chunk(g, built, count, "catchup")
                        dead = torch.nonzero(~self._flat.valid[:count])[:, 0]
                        if dead.numel():
                            g.delete_rows(dead.cpu().numpy())
                        self._graph = g
                        self._flat = FlatIndex(
                            self.dim, self.metric, self.dtype, capacity=1,
                            device=self.device,
                        )
                        try:
                            get_registry().inc("longbow_adaptive_index_migrations_total")
                        except Exception:
                            pass
                        break
                # large backlog: catch up outside the lock (adds only
                # append past `count`, so [built, count) is stable)
                self._graph_chunk(g, built, count, "catchup")
                built = count
        except Exception as e:
            self._migration_failed(e, "background migration")
        finally:
            self._migrator = None

    def _probe_contrast(self, count: int) -> bool:
        """Hardness probe: True = enough structure to migrate. It runs an
        exact self-search of a sample of up to 65,536 rows, so callers
        must not hold a put on it (see _maybe_migrate)."""
        with self._mlock:
            self._flat.flush()
            fl = self._flat
        # the sample is taken under the flat index's dispatch lock (rows
        # are appended in place) and is a copy, so the probe itself runs
        # outside every lock
        t0 = time.perf_counter()
        with fl._mu:
            sampled = sample_for_contrast(fl.vectors, count)
        if sampled is None:
            return True  # too small to judge; graphs are fine small
        rc = relative_contrast_from_sample(*sampled)  # a host read: the device is done
        self.last_contrast = rc
        self.migration_stats = {"probe_s": time.perf_counter() - t0}
        try:
            reg = get_registry()
            # relative contrast is the hardness signal this index adapts
            # on (the reference gauges adaptive m and intrinsic
            # dimensionality per index)
            reg.set("longbow_hnsw_intrinsic_dimensionality", rc, index_name="adaptive")
            reg.set("longbow_hnsw_adaptive_m_value", self.hnsw_config.m, index_name="adaptive")
            reg.inc("longbow_hnsw_adaptive_adjustments_total", index_name="adaptive")
        except Exception:
            pass
        if rc < self.min_contrast:
            log.warning(
                "corpus relative contrast %.2f < %.2f at n=%d: "
                "distance-concentrated data - staying on the exact scan "
                "(graph search cannot beat it here; index/hardness.py)",
                rc, self.min_contrast, count,
            )
            return False
        return True

    def _maybe_migrate(self) -> None:
        # decision under _mlock: two concurrent adds at the threshold
        # could both see _migrator None and start two migrations, whose
        # second swap discards rows acked into the first graph
        with self._mlock:
            if self._graph is not None or self._migrator is not None:
                return
            if len(self._flat) < self.migration_threshold:
                return
            if self.migration_threshold > 0 and len(self._flat) < self._retry_at:
                return  # the last attempt failed: wait for the doubling
            probe = self.min_contrast > 0 and self.migration_threshold > 0
            count = len(self._flat)
            if probe:
                # probe once per count-doubling: low-contrast data stays
                # on the exact scan; a distribution that gains structure
                # as it grows still migrates at the next doubling
                if count < 2 * self._contrast_checked_at:
                    return
                self._contrast_checked_at = count
            if self.background_migration and self.migration_threshold > 0:
                t = threading.Thread(
                    target=self._probe_then_build_body,
                    args=(probe, count),
                    daemon=True,
                    name="longbow-migrate",
                )
                self._migrator = t
                t.start()
                return
        # threshold 0 = the explicit "hnsw" kind: the graph IS the index,
        # so the first batch builds synchronously (outside the lock -
        # _build_graph takes it again)
        if probe and not self._probe_contrast(count):
            return
        self.migration_error = None
        self._build_graph()
        if self.migration_error is not None and self.migration_threshold <= 0:
            # nobody asked for a flat index here: a graph that cannot be
            # built is the caller's error to see
            raise self.migration_error

    def _probe_then_build_body(self, probe: bool, count: int) -> None:
        # the probe must not stall the put that crossed the threshold
        try:
            self._enter_device()
            if probe and not self._probe_contrast(count):
                self._migrator = None  # free the slot for the next try
                return
        except Exception as e:
            self._migration_failed(e, "hardness probe")
            self._migrator = None
            return
        self._build_graph()  # its finally clears _migrator

    def wait_migration(self, timeout_s: Optional[float] = None) -> bool:
        """Block until any in-flight migration finishes (tests/ops)."""
        t = self._migrator
        if t is not None:
            t.join(timeout_s)
        return self._graph is not None

    # lists of blocks pass through to the flat tier's staging buffer;
    # resolved under _mlock in add() (a migration between the caller's
    # capability check and the add must not hand a list to the graph)
    accepts_blocks = True

    def add(self, vecs) -> np.ndarray:
        with self._mlock:
            if self._unraised is not None:
                e, self._unraised = self._unraised, None
                raise e
            if self._graph is not None:
                if isinstance(vecs, list):
                    vecs = np.concatenate(vecs)
                return self._graph.add(vecs)
            rows = self._flat.add(vecs)
        self._maybe_migrate()
        return rows

    def warm(self) -> None:
        """Build the active tier's kernel and run one search, off the
        query path."""
        flat, g = self._tiers()
        if g is None:
            return flat.warm()
        g.search(np.zeros((1, self.dim), np.float32), 10)

    def delete_rows(self, rows) -> None:
        with self._mlock:
            (self._graph or self._flat).delete_rows(rows)

    def search(
        self,
        queries,
        k: int,
        *,
        filter_mask=None,
        ef_search: Optional[int] = None,
        exact: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        flat, g = self._tiers()
        if g is not None and not exact:
            return g.search(queries, k, filter_mask=filter_mask, ef_search=ef_search)
        if g is not None:
            return g.exact_search(queries, k, filter_mask=filter_mask)
        return flat.search(queries, k, filter_mask=filter_mask, exact=exact)

    # ------------------------------------------------------------------

    def get_vectors(self, rows) -> np.ndarray:
        flat, g = self._tiers()
        return (g or flat).get_vectors(rows)

    def get_vectors_device(self, rows) -> torch.Tensor:
        """Device-resident f32 gather."""
        flat, g = self._tiers()
        return (g or flat).get_vectors_device(rows)

    def device_bytes(self) -> int:
        flat, g = self._tiers()
        return (g or flat).device_bytes()

    def host_bytes(self) -> int:
        """Host RAM the index holds besides the device (the re-rank copy
        of a graph with storage="pq")."""
        _, g = self._tiers()
        return 0 if g is None else g.host_bytes()

    def export_state(self) -> dict:
        flat, g = self._tiers()
        st = (g or flat).export_state()
        st["migration_threshold"] = self.migration_threshold
        st.setdefault("storage", self.storage)
        return st

    @classmethod
    def import_state(cls, st: dict, *, device=None) -> "AdaptiveIndex":
        """Rebuild from export_state() output - this package's or
        longbow_tpu's."""
        idx = cls(
            int(st["dim"]),
            st["metric"],
            dtype=storage_dtype(str(st["dtype"])),
            migration_threshold=int(
                st.get("migration_threshold", DEFAULT_MIGRATION_THRESHOLD)
            ),
            storage=str(st.get("storage", "dense")),
            pq_m=int(st.get("pq_m", 0)) or None,
            device=device,
        )
        if st["kind"] == "hnsw":
            idx._graph = HNSWIndex.import_state(st, device=device)
            idx.hnsw_config = idx._graph.config
            idx._flat = FlatIndex(idx.dim, idx.metric, idx.dtype, capacity=1, device=device)
        else:
            idx._flat = FlatIndex.import_state(st, device=device)
        return idx
