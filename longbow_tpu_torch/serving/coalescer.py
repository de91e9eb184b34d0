"""Search coalescing: merge concurrent search requests into one store
search.

Counterpart of longbow_tpu/serving/coalescer.py. A fused scan reads the
whole corpus once per launch whatever the number of queries in it, so
its cost grows far slower than the batch: one request per launch wastes
most of the card's memory bandwidth under concurrency.

The reference serves each request on its own goroutine (Go's model; its
SIMD scan is per query anyway). Here the answer is NATURAL BATCHING: a
dispatch thread drains whatever requests queued while the previous
search ran, groups them by compatible signature (dataset, k, filters,
ef, exact), concatenates their query rows, runs ONE search, and splits
the results. An idle server runs a lone request at once: coalescing
only takes place when concurrency exists, so it adds throughput without
a latency tax (no timer windows, no artificial delay).

Two dispatch threads serve each queue, with one launch turn between
them. A dispatch takes the turn before it drains the queue and holds it
until its search is queued on the card: where the index says so
(utils/launch.py; sq8r does), the other thread drains and launches the
next batch while this one waits for its answer, so the card starts the
next batch as it finishes this one. Every other index says nothing, and
the turn comes back when the search returns: their dispatches stay one
at a time.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Optional

import numpy as np

from longbow_tpu_torch.metrics import get_registry
from longbow_tpu_torch.metrics.registry import count
from longbow_tpu_torch.utils import tracing
from longbow_tpu_torch.utils.launch import on_launched

log = logging.getLogger("longbow.coalescer")

DISPATCHERS = 2  # dispatch threads a shard, so two searches a dataset in flight


class _Future:
    __slots__ = ("_ev", "_val", "_err", "enq")

    def __init__(self):
        self._ev = threading.Event()
        self._val = None
        self._err = None
        # (thread, perf_counter_ns) where the request was queued, while traced
        self.enq = None

    def set(self, val) -> None:
        self._val = val
        self._ev.set()

    def set_err(self, err: BaseException) -> None:
        self._err = err
        self._ev.set()

    def get(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("coalesced search timed out")
        if self._err is not None:
            raise self._err
        return self._val


class _Shard:
    """A queue, its launch turn (held by the one dispatch that drains the
    queue and launches) and how many of its dispatches handed the turn on
    and have not finished."""
    __slots__ = ("q", "turn", "mu", "waiting")

    def __init__(self):
        self.q: queue.Queue = queue.Queue()
        self.turn = threading.Lock()
        self.mu = threading.Lock()  # guards waiting
        self.waiting = 0


class _Dispatch:
    """One dispatch's hold on its shard's turn, taken when it is made."""
    __slots__ = ("shard", "held", "handed")

    def __init__(self, shard: _Shard):
        self.shard, self.held, self.handed = shard, True, False

    def hand_on(self) -> None:
        """The launch signal: this dispatch's search is queued."""
        if self.held:
            with self.shard.mu:
                self.shard.waiting += 1
            self.held, self.handed = False, True
            self.shard.turn.release()

    def end(self) -> None:
        if self.held:
            self.held = False
            self.shard.turn.release()
        if self.handed:
            with self.shard.mu:
                self.shard.waiting -= 1


def _filters_key(filters) -> str:
    if not filters:
        return ""
    return "|".join(f.cache_key() for f in filters)


class SearchCoalescer:
    """Wraps a VectorStore's search with natural request batching.

    max_batch bounds the concatenated query rows per dispatch; excess
    requests of a group run in the next dispatch. max_group bounds the
    requests taken off a queue at once. Requests in a multi-request
    group bypass the query cache (their concatenated batch key would
    never repeat); lone requests keep full cache semantics.
    """

    def __init__(
        self,
        store,
        *,
        max_batch: int = 2048,
        max_group: int = 64,
        shards: int = 4,
        autostart: bool = True,
    ):
        self.store = store
        self.max_batch = max_batch
        self.max_group = max_group
        # dataset-sharded dispatch: two threads per shard, routed by
        # hash(dataset), so that one dataset's slow dispatch (a kernel's
        # first build with nvcc takes seconds to minutes) does not
        # head-of-line-block every other dataset. A dataset always lands
        # on the same shard, whose turn orders its launches; the card
        # runs the searches in launch order.
        self._shards = [_Shard() for _ in range(max(1, shards))]
        self._qs = [sh.q for sh in self._shards]
        self._stop = threading.Event()
        self._count_mu = threading.Lock()
        self.dispatches = 0       # store searches issued
        self.coalesced = 0        # requests that shared a dispatch
        self.overlapped = 0       # dispatches issued while another waited on its answer
        self.requests = 0
        # dataset -> start times of its running dispatches, for the
        # timeout's message
        self._inflight: dict = {}
        # the first shard's queue (single-shard callers and tests use it)
        self._q = self._qs[0]
        self._ts: Optional[list] = None
        if autostart:
            self.start()

    def start(self) -> None:
        if self._ts is None:
            self._ts = [
                threading.Thread(
                    target=self._loop, args=(sh,), daemon=True,
                    name=f"longbow-coalesce-{i}" + ("" if j == 0 else f".{j}"),
                )
                for i, sh in enumerate(self._shards)
                for j in range(DISPATCHERS)
            ]
            for t in self._ts:
                t.start()

    def stop(self) -> None:
        self._stop.set()
        for q in self._qs:
            for _ in range(DISPATCHERS):
                q.put(None)
        if self._ts is not None:
            for t in self._ts:
                t.join(timeout=5.0)
            self._ts = None

    # ------------------------------------------------------------------

    def search(
        self,
        dataset: str,
        queries,
        k: int,
        *,
        filters=None,
        ef_search: Optional[int] = None,
        exact: bool = False,
        use_cache: bool = True,
        timeout: Optional[float] = 30.0,
    ):
        """store.search's answer for these queries -> (ids, scores, ok);
        raises what the store raised, or TimeoutError after `timeout`."""
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        fut = _Future()
        with self._count_mu:
            self.requests += 1
        if tracing.recording():
            fut.enq = (threading.get_native_id(), time.perf_counter_ns())
        self._qs[hash(dataset) % len(self._qs)].put(
            (dataset, q, k, filters, ef_search, exact, use_cache, fut)
        )
        try:
            return fut.get(timeout)
        except TimeoutError:
            with self._count_mu:
                t0 = min(self._inflight.get(dataset) or [None])
            if t0 is not None:
                raise TimeoutError(
                    "coalesced search timed out (a dispatch for "
                    f"'{dataset}' has been running {time.time() - t0:.0f}s"
                    " - likely a kernel's first build; retry shortly)"
                )
            raise

    # ------------------------------------------------------------------

    def _loop(self, sh: _Shard) -> None:
        _q = sh.q
        while not self._stop.is_set():
            with tracing.span("longbow.coalescer.turn"):
                sh.turn.acquire()
            dispatch = _Dispatch(sh)
            try:
                if self._stop.is_set():
                    break
                with tracing.span("longbow.coalescer.idle"):
                    item = _q.get()
                if item is None:
                    continue
                batch = [item]
                while len(batch) < self.max_group:
                    try:
                        nxt = _q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        break
                    batch.append(nxt)
                try:
                    self._drain(batch, dispatch)
                except Exception as e:
                    log.exception("coalescer dispatch failed")
                    # a grouping failure must not orphan the batch: an
                    # unresolved future blocks its caller for the whole
                    # request timeout instead of surfacing the error
                    for it in batch:
                        if not it[7]._ev.is_set():
                            it[7].set_err(e)
            finally:
                dispatch.end()
        # shutdown: fail whatever is still queued instead of leaving
        # callers to time out
        while True:
            try:
                item = _q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[7].set_err(RuntimeError("coalescer stopped"))

    def _drain(self, batch: list, dispatch: Optional[_Dispatch] = None) -> None:
        """Group compatible requests, one store.search per group; the last
        group's launch signal hands `dispatch`'s turn on."""
        groups: dict = {}
        for it in batch:
            dataset, q, k, filters, ef, exact, use_cache, fut = it
            # the query width is part of the signature: a wrong-width
            # query must not poison a group's concatenate and fail its
            # innocent group mates
            sig = (
                dataset, k, _filters_key(filters), ef, exact,
                q.shape[-1],
            )
            groups.setdefault(sig, []).append(it)
        chunks = []
        for items in groups.values():
            # the row ceiling: split oversized groups
            start = 0
            while start < len(items):
                chunk, rows = [], 0
                while start < len(items):
                    nrows = items[start][1].shape[0]
                    if chunk and rows + nrows > self.max_batch:
                        break
                    chunk.append(items[start])
                    rows += nrows
                    start += 1
                chunks.append(chunk)
        for n, chunk in enumerate(chunks, 1):
            self._run(chunk, dispatch, last=n == len(chunks))

    def _run(self, items: list, dispatch: Optional[_Dispatch] = None,
             last: bool = False) -> None:
        if tracing.recording():
            now = time.perf_counter_ns()
            for it in items:
                if it[7].enq is not None:
                    thread, t0 = it[7].enq
                    tracing.interval("longbow.coalescer.queue", t0, now, thread=thread)
        dataset, _, k, filters, ef, exact, _, _ = items[0]
        try:
            qs = (
                items[0][1]
                if len(items) == 1
                else np.concatenate([it[1] for it in items], axis=0)
            )
        except Exception as e:  # a malformed member fails THIS group only
            for it in items:
                it[7].set_err(e)
            return
        use_cache = items[0][6] if len(items) == 1 else False
        t0 = time.time()
        with self._count_mu:
            self.dispatches += 1
            if len(items) > 1:
                self.coalesced += len(items)
            overlapped = dispatch is not None and dispatch.shard.waiting > 0
            self.overlapped += overlapped
            self._inflight.setdefault(dataset, []).append(t0)
        if overlapped:
            count("longbow_coalescer_overlapped_dispatches_total")
        get_registry().observe("longbow_search_coalesce_batch_size", qs.shape[0])
        try:
            with on_launched(dispatch.hand_on if dispatch is not None and last else None):
                ids, scores, ok = self.store.search(
                    dataset, qs, k, filters=filters, ef_search=ef,
                    exact=exact, use_cache=use_cache,
                )
        except Exception as e:
            for it in items:
                it[7].set_err(e)
            return
        finally:
            with self._count_mu:
                starts = self._inflight[dataset]
                starts.remove(t0)
                if not starts:
                    del self._inflight[dataset]
        off = 0
        for it in items:
            n = it[1].shape[0]
            it[7].set((ids[off:off + n], scores[off:off + n],
                       ok[off:off + n]))
            off += n
