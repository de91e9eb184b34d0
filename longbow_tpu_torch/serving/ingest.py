"""Asynchronous ingestion: a put is acknowledged once queued, and
applied off the caller's thread.

Counterpart of longbow_tpu/serving/ingest.py (reference: the
backpressured ingest pipeline, store_actions.go:426-708, and
`check_readiness` reporting BUSY from queue depths,
store_actions.go:57-101). One bounded host queue in front of
`store.put`: it decouples the callers' threads from index work (a
kernel's first build, a bulk graph build), not CPU work from the card.

Durability: with async ingest an acknowledgement means "accepted", not
"applied" - the reference's async persistence contract; `drain` returns
True only once every accepted job is applied.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np

from longbow_tpu_torch.metrics import get_registry
from longbow_tpu_torch.store.compaction import MemoryPressureError


class IngestQueue:
    """max_depth: jobs the queue holds before submit blocks; workers:
    threads applying them."""

    # coalescing cap: one store.put per <= this many rows (reference:
    # adaptive batching to 50k rows / 32MB, store_actions.go:530-618)
    MAX_COALESCE_ROWS = 65536

    def __init__(self, store, *, max_depth: int = 256, workers: int = 1):
        self.store = store
        self._q: queue.Queue = queue.Queue(maxsize=max_depth)
        self._stop = threading.Event()
        # jobs counted from BEFORE they enter the queue until applied:
        # a depth taken from qsize() plus the jobs in flight would read 0
        # between a worker's get() and its in-flight count, with an
        # acknowledged batch in hand, and a checkpoint polling drain()
        # there could truncate the WAL under unapplied rows
        self._pending = 0
        self._lock = threading.Lock()
        self.errors: list[str] = []
        self._threads = [
            threading.Thread(target=self._loop, args=(i,), daemon=True)
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    @property
    def pressure(self) -> float:
        """Queue fullness 0..1 (reference: DoPut signals slow_down at 80%
        of the WAL queue's capacity, docs/admin_api.md)."""
        return self.depth / max(self._q.maxsize, 1)

    @property
    def depth(self) -> int:
        """Jobs accepted and not yet applied."""
        with self._lock:
            return self._pending

    def _observe_depth(self) -> None:
        get_registry().gauge("longbow_index_queue_depth").set(self.depth)

    def submit(
        self, dataset, ids, vectors, columns, metric, timestamp,
        block_s: float = 30.0,
    ) -> None:
        """Enqueue one put; blocks (backpressure) while the queue is full,
        up to block_s, then raises queue.Full. The memory hard limit is
        checked BEFORE the job is accepted: an accepted job is a
        durability promise, so a write over the limit is rejected here
        (MemoryPressureError), not dropped by the worker later."""
        bp = getattr(self.store, "backpressure", None)
        if bp is not None:
            bp.check_admit(self.store)
        with self._lock:
            self._pending += 1
        try:
            self._q.put(
                (dataset, ids, vectors, columns, metric, timestamp),
                timeout=block_s,
            )
        except BaseException:
            with self._lock:
                self._pending -= 1
            raise
        self._observe_depth()

    @staticmethod
    def _stamp(j):
        """Give a job without a timestamp its LWW timestamp AT DEQUEUE, in
        queue order: a stamp taken later, inside Dataset.put, would let a
        job submitted later in another group win over the caller's last
        write of the same id."""
        if j[5] is None:
            return (j[0], j[1], j[2], j[3], j[4], time.time())
        return j

    @staticmethod
    def _group_key(j) -> tuple:
        """Jobs that may share one store.put: the same dataset, metric,
        column names and dtypes, vector dtype and width. An int8 job
        merged with an f32 one would upcast the codes; a width mismatch
        fails the concatenate; a column dtype flip promotes the merged
        column and fails check_types - each would take the acknowledged
        rows of its group mates down with it."""
        shp = getattr(j[2], "shape", None)
        dim = shp[-1] if shp else len(j[2][0])
        colsig = tuple(sorted(
            (c, str(np.asarray(v).dtype)) for c, v in (j[3] or {}).items()
        ))
        vdt = getattr(j[2], "dtype", None)
        return (j[0], j[4], colsig, vdt is not None and str(vdt), dim)

    def _loop(self, worker_id: int = 0):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            # group commit: take the queued jobs greedily and apply each
            # (dataset, metric, columns, vector dtype, width) group as ONE
            # store.put - one WAL frame, one device append, one metrics
            # pass. Per-row timestamps keep LWW across the merge.
            batch = [self._stamp(first)]
            rows = len(first[1])
            while rows < self.MAX_COALESCE_ROWS:
                try:
                    j = self._q.get_nowait()
                except queue.Empty:
                    break
                batch.append(self._stamp(j))
                rows += len(j[1])
            # the share of the coalescing window this worker filled
            # (reference: pipeline_worker_utilization per worker)
            get_registry().set(
                "longbow_pipeline_worker_utilization",
                min(rows / self.MAX_COALESCE_ROWS, 1.0),
                worker_id=str(worker_id),
            )
            try:
                groups: dict = {}
                for j in batch:
                    try:
                        key = self._group_key(j)
                    except Exception:  # a malformed job goes alone; its put raises
                        key = ("alone", id(j))
                    groups.setdefault(key, []).append(j)
                for key, gs in groups.items():
                    try:
                        self._apply(*self._merge(key, gs))
                    except Exception as e:
                        if len(gs) == 1:
                            self._record(e)
                            continue
                        # the merged apply failed: apply each job alone, so
                        # that one bad job does not drop its group mates'
                        # acknowledged rows
                        for g in gs:
                            try:
                                self._apply(*g)
                            except Exception as e2:
                                self._record(e2)
            finally:
                with self._lock:
                    self._pending -= len(batch)
                self._observe_depth()

    @staticmethod
    def _merge(key, gs) -> tuple:
        """One group's jobs as one put's arguments. The vectors stay a list
        of blocks: Dataset.put stages them into the index's buffer
        directly, with no extra copy of the vector bytes (indexes that
        need one array, and the WAL, concatenate downstream)."""
        if len(gs) == 1:
            return gs[0]
        dataset, metric, colsig, _vdt, _dim = key
        ids = np.concatenate([np.asarray(g[1]) for g in gs])
        vectors = [np.atleast_2d(g[2]) for g in gs]
        columns = {
            c: np.concatenate([np.asarray(g[3][c]) for g in gs])
            for c, _dt in colsig
        } or None

        def ts_rows(g):
            # jobs were stamped at dequeue, but a replicated write carries
            # a timestamp per row: scalars expand, arrays pass
            t = np.asarray(g[5], np.float64)
            return np.full(len(g[1]), float(t)) if t.ndim == 0 else t

        ts = np.concatenate([ts_rows(g) for g in gs])
        return dataset, ids, vectors, columns, metric, ts

    def _record(self, e: Exception) -> None:
        self.errors.append(f"{time.time():.0f} {e!r}")
        del self.errors[:-20]

    def _apply(self, dataset, ids, vectors, columns, metric, ts):
        while not self._stop.is_set():
            try:
                self.store.put(
                    dataset, ids, vectors, columns,
                    metric=metric, timestamp=ts,
                )
                return
            except MemoryPressureError:
                # the batch was acknowledged: dropping it would lose data
                # silently. The worker waits until the backpressure
                # controller admits again; meanwhile the queue fills and
                # submit's own check rejects NEW writes up front.
                time.sleep(0.5)

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Wait until every accepted job is applied, up to timeout_s;
        returns whether it was."""
        t0 = time.time()
        while self.depth > 0 and time.time() - t0 < timeout_s:
            time.sleep(0.02)
        return self.depth == 0

    def close(self) -> None:
        self.drain(timeout_s=30.0)
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
