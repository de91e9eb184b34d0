"""Compaction and eviction: reclaim tombstoned rows, enforce memory
targets, expire by TTL.

Counterpart of longbow_tpu/store/compaction.py (reference:
CompactionWorker compaction.go:59, FragmentationTracker
fragmentation_tracker.go:11, RecordEvictionManager LRU/LFU/TTL
record_eviction.go:79-230, evictToTarget memory_enforcement.go:66,
MemoryBackpressureController memory_backpressure.go:31).

A delete only tombstones a row. Compaction rebuilds the index from the
live rows into new tensors and swaps the new (index, columns, id maps)
in under the dataset lock; the rebuild itself runs outside it, so
searches and puts keep being served. The live rows are gathered on the
device (`get_vectors_device`) and never cross to the host. Memory is
counted by `Dataset.device_bytes()`, which covers every tensor of the
index and the metadata columns.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np
import torch

from longbow_tpu_torch.index.factory import make_index
from longbow_tpu_torch.metrics import get_registry
from longbow_tpu_torch.query.filters import ColumnStore

log = logging.getLogger("longbow.compaction")

# trained quantizer state carried into the rebuilt index, so that pq
# codebooks, the sq8 affine, the bq mean and the sq8r clusters (and with
# them every row's codes) stay the same across a compaction
QUANTIZER_STATE = ("codebooks", "lo", "hi", "mean", "centers", "n_clusters")


class FragmentationTracker:
    """Dead-row ratio per dataset."""

    def __init__(self, threshold: float = 0.3):
        self.threshold = threshold

    def ratio(self, dataset) -> float:
        # (index rows, live ids) read under the dataset lock: put() appends
        # index rows before it updates the id map, so an unlocked read
        # mid-put sees a gap that looks like dead rows
        with dataset._lock:
            total = len(dataset.index)
            live = dataset.live_count
        if total == 0:
            return 0.0
        return 1.0 - live / total

    def needs_compaction(self, dataset) -> bool:
        return self.ratio(dataset) > self.threshold


def compact_dataset(dataset) -> dict:
    """Rebuild the dataset's index and columns with only the live rows.

    The rebuild runs outside the dataset lock; the lock is held only to
    snapshot the live rows and to swap the rebuilt trio in. Mutations
    that land during the rebuild are reconciled at the swap: a re-put id
    changes its row number (rows are append-only within an index
    generation), so comparing the id -> row map with the snapshot finds
    every upsert and delete exactly.

    Returns {reclaimed_rows, live_rows, delta_upserts, delta_deletes,
    seconds}."""
    reg = get_registry()
    ds_label = getattr(dataset, "name", "") or "default"
    try:
        with dataset._compact_mu:
            out = _compact_concurrent(dataset)
    except Exception:
        reg.inc("longbow_compaction_operations_total", dataset=ds_label, status="error")
        raise
    reg.inc("longbow_compaction_operations_total", dataset=ds_label, status="ok")
    reg.observe("longbow_compaction_duration_seconds", out["seconds"], dataset=ds_label)
    reg.inc("longbow_compaction_records_removed_total", out["reclaimed_rows"],
            dataset=ds_label)
    # the per-dataset gauges the store refreshes on every mutation: a
    # compaction changes them too (the reference leaves them stale until
    # the next write)
    reg.set("longbow_vector_index_size", len(dataset.index), dataset=ds_label)
    reg.set("longbow_tombstones_total", len(dataset.index) - dataset.live_count,
            dataset=ds_label)
    reg.set("longbow_tpu_hbm_bytes_in_use", dataset.device_bytes(), dataset=ds_label)
    return out


def _fresh_index(dataset):
    """A new empty index from the dataset's construction params."""
    return make_index(
        dataset.index_kind,
        dataset.dim,
        dataset.metric,
        dtype=dataset.dtype,
        device=dataset.device,
        migration_threshold=dataset.migration_threshold,
        hnsw_config=dataset.hnsw_config,
        **dataset.index_construction_params(),
    )


def _gather_cols(cols: ColumnStore, rows: np.ndarray) -> dict:
    """Host copies of the column values at `rows` (strings decoded from
    their dictionary codes; an absent string reads as "")."""
    out = {}
    rows_t = torch.as_tensor(np.asarray(rows, np.int64), device=cols.device)
    for name in cols.fields():
        if name in cols._numeric:
            out[name] = cols._numeric[name][rows_t].cpu().numpy()
        else:
            codes = cols._str_codes[name][rows_t].cpu().numpy()
            rev = {v: k for k, v in cols._str_dicts[name].items()}
            out[name] = np.asarray([rev.get(int(c), "") for c in codes])
    return out


def _reset_empty(dataset) -> None:
    """A fully deleted dataset: a minimal new index, so that the device
    bytes come back."""
    dataset.index = _fresh_index(dataset)
    dataset.columns = ColumnStore(dataset.index.capacity, device=dataset.device)
    dataset._id_to_row = {}
    dataset._row_to_id = []
    dataset.filter_cache.invalidate()


def _flat_tier(index):
    """The FlatIndex serving a flat or not yet migrated adaptive index,
    else None."""
    if getattr(index, "_graph", None) is not None:
        return None
    return getattr(index, "_flat", None)


def _compact_concurrent(dataset) -> dict:
    t0 = time.time()

    # ---- phase 1 (locked): snapshot the live rows ----
    with dataset._lock:
        pairs = list(dataset._id_to_row.items())
        dead = len(dataset.index) - len(pairs)
        if not pairs:
            if dead == 0:
                return {"reclaimed_rows": 0, "live_rows": 0, "delta_upserts": 0,
                        "delta_deletes": 0, "seconds": 0.0}
            _reset_empty(dataset)
            return {"reclaimed_rows": dead, "live_rows": 0, "delta_upserts": 0,
                    "delta_deletes": 0, "seconds": time.time() - t0}
        rows = np.asarray([r for _, r in pairs])
        ids = [u for u, _ in pairs]
        vecs = dataset.index.get_vectors_device(rows)
        live_cols = _gather_cols(dataset.columns, rows)
        old_inner = getattr(dataset.index, "_inner", None)
        # the host scan mirror of a flat tier, carried into the rebuilt
        # index (whose device-tensor add disables its own) so that scans
        # keep reading host RAM
        mr = _flat_tier(dataset.index)
        mr = mr.mirror_rows(rows) if mr is not None else None

    # ---- phase 2 (unlocked): build the new trio off to the side; the
    # old trio keeps serving and stays consistent in itself ----
    new_index = _fresh_index(dataset)
    new_inner = getattr(new_index, "_inner", None)
    if old_inner is not None and new_inner is not None and type(old_inner) is type(new_inner):
        for attr in QUANTIZER_STATE:
            val = getattr(old_inner, attr, None)
            if val is not None and hasattr(new_inner, attr):
                setattr(new_inner, attr, val)
    new_rows = new_index.add(vecs)
    del vecs
    if mr is not None and _flat_tier(new_index) is not None:
        _flat_tier(new_index).adopt_mirror(mr)
    new_columns = ColumnStore(new_index.capacity, device=dataset.device)
    new_columns.append(live_cols, len(ids), new_index.capacity, rows=new_rows)
    new_i2r = {uid: int(r) for uid, r in zip(ids, new_rows.tolist())}
    top = int(np.max(new_rows)) if len(new_rows) else -1
    new_r2i: list = [None] * (top + 1)
    for uid, r in zip(ids, new_rows.tolist()):
        new_r2i[r] = uid

    # ---- phase 3 (locked): reconcile what landed during the build, then
    # swap. Deletes (and the stale version of every re-put id) leave the
    # new trio; upserts and new ids are added in their current version ----
    snap_map = dict(pairs)
    with dataset._lock:
        cur = dataset._id_to_row
        drop_new_rows = []
        for uid, old_row in snap_map.items():
            if cur.get(uid) == old_row:
                continue  # unchanged since the snapshot
            nr = new_i2r.pop(uid, None)
            if nr is not None:
                drop_new_rows.append(nr)
                if nr < len(new_r2i):
                    new_r2i[nr] = None
        if drop_new_rows:
            new_index.delete_rows(np.asarray(drop_new_rows))
        changed = [uid for uid, row in cur.items() if snap_map.get(uid) != row]
        if changed:
            rows2 = np.asarray([cur[uid] for uid in changed])
            # the delta is small (writes during the build): a host gather
            vecs2 = dataset.index.get_vectors(rows2)
            cols2 = _gather_cols(dataset.columns, rows2)
            nr2 = new_index.add(vecs2)
            new_columns.append(cols2, len(changed), new_index.capacity, rows=nr2)
            nr2_list = nr2.tolist()
            need = max(nr2_list) + 1 - len(new_r2i)
            if need > 0:
                new_r2i.extend([None] * need)
            for uid, r in zip(changed, nr2_list):
                new_i2r[uid] = int(r)
                new_r2i[int(r)] = uid
        dataset.index = new_index
        dataset.columns = new_columns
        dataset._id_to_row = new_i2r
        dataset._row_to_id = new_r2i
        dataset.filter_cache.invalidate()
    return {
        "reclaimed_rows": dead,
        "live_rows": len(new_i2r),
        "delta_upserts": len(changed),
        "delta_deletes": len(drop_new_rows),
        "seconds": time.time() - t0,
    }


class EvictionManager:
    """TTL + LRU/LFU eviction per dataset.

    TTL: rows older than ttl_s (by LWW write timestamp) are deleted on
    sweep. LRU/LFU: when live_count exceeds max_rows, the coldest rows go
    first; recency and frequency come from record_access(), which the
    store calls with the ids every search returns.
    """

    def __init__(self, policy: str = "lru", ttl_s: Optional[float] = None,
                 max_rows: Optional[int] = None):
        if policy not in ("lru", "lfu"):
            raise ValueError("policy must be lru|lfu")
        self.policy = policy
        self.ttl_s = ttl_s
        self.max_rows = max_rows
        self._last_access: dict = {}
        self._freq: dict = {}
        self.evicted_total = 0

    def record_access(self, ids) -> None:
        now = time.time()
        for uid in ids:
            self._last_access[uid] = now
            self._freq[uid] = self._freq.get(uid, 0) + 1

    def sweep(self, dataset, store=None) -> int:
        """Apply TTL + size policy; returns rows evicted. With a store,
        evictions go through its delete (which also clears the query
        cache)."""
        victims = []
        now = time.time()
        with dataset._lock:  # ingest mutates these dicts concurrently
            if self.ttl_s is not None:
                for uid, ts in dataset._lww.items():
                    if uid in dataset._id_to_row and now - ts > self.ttl_s:
                        victims.append(uid)
            ttl_n = len(victims)
            if self.max_rows is not None:
                over = dataset.live_count - len(victims) - self.max_rows
                if over > 0:
                    vs = set(victims)
                    pool = [u for u in dataset._id_to_row if u not in vs]
                    if self.policy == "lru":
                        pool.sort(key=lambda u: self._last_access.get(u, 0.0))
                    else:
                        pool.sort(key=lambda u: self._freq.get(u, 0))
                    victims.extend(pool[:over])
        if victims:
            ids = np.asarray(victims, dtype=object)
            if store is not None:
                store.delete(dataset.name, ids)
            else:
                dataset.delete(ids)
            self.evicted_total += len(victims)
            # each victim is counted under the policy branch that chose it
            reg = get_registry()
            if ttl_n:
                reg.inc("longbow_evictions_total", ttl_n, reason="ttl")
            if len(victims) > ttl_n:
                reg.inc("longbow_evictions_total", len(victims) - ttl_n, reason=self.policy)
        return len(victims)


class CompactionWorker:
    """Background sweep: memory enforcement, dataset TTL, eviction, then
    fragmentation-triggered compaction."""

    def __init__(
        self,
        store,
        *,
        interval_s: float = 30.0,
        frag_threshold: float = 0.3,
        eviction: Optional[EvictionManager] = None,
        backpressure: Optional["MemoryBackpressureController"] = None,
        dataset_ttl_s: float = 0.0,
    ):
        self.store = store
        self.interval_s = interval_s
        self.tracker = FragmentationTracker(frag_threshold)
        self.eviction = eviction
        self.backpressure = backpressure
        # dataset-level TTL: drop whole datasets not read or written for
        # the duration (row TTL/LRU is the EvictionManager's)
        self.dataset_ttl_s = dataset_ttl_s
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    def run_once(self) -> dict:
        reg = get_registry()
        if self.backpressure is not None:
            self.backpressure.enforce(self.store)
        if self.dataset_ttl_s > 0:
            now = time.time()
            for name in self.store.list_datasets():
                ds = self.store.get(name)
                if now - ds.last_access > self.dataset_ttl_s:
                    # counted in rows, the counter's unit everywhere else
                    rows = ds.live_count
                    self.store.drop(name)
                    reg.inc("longbow_evictions_total", rows, reason="dataset_ttl")
        stats = {}
        worst_frag = 0.0
        for name in self.store.list_datasets():
            ds = self.store.get(name)
            evicted = self.eviction.sweep(ds, store=self.store) if self.eviction else 0
            compacted = None
            if self.tracker.needs_compaction(ds):
                reg.inc("longbow_compaction_auto_triggers_total")
                compacted = compact_dataset(ds)
                self.store.query_cache.clear()
            frag = self.tracker.ratio(ds)
            worst_frag = max(worst_frag, frag)
            stats[name] = {"evicted": evicted, "fragmentation": round(frag, 3),
                           "compacted": compacted}
        reg.gauge("longbow_memory_fragmentation_ratio").set(worst_frag)
        return stats

    def start(self) -> None:
        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.run_once()
                except Exception:  # keep the worker alive, but loudly
                    log.exception("compaction sweep failed")

        self._thread = threading.Thread(target=loop, daemon=True, name="longbow-compaction")
        self._thread.start()

    def stop(self) -> None:
        if self._stop:
            self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


class MemoryPressureError(RuntimeError):
    """Raised by the hard admission limit (a server maps it to a
    resource-exhausted error)."""


class MemoryBackpressureController:
    """Byte targets on the device memory of the store's datasets.

    - above `soft_bytes`: enforce() evicts the coldest rows (least
      recently read when an EvictionManager has recorded reads, else the
      oldest writes) and compacts, until usage is at or under the soft
      target;
    - above `hard_bytes`: check_admit() raises, so that a write is
      rejected instead of running the device out of memory.
    """

    def __init__(self, soft_bytes: Optional[int] = None, hard_bytes: Optional[int] = None,
                 eviction: Optional[EvictionManager] = None, batch_rows: int = 1024):
        self.soft_bytes = soft_bytes
        self.hard_bytes = hard_bytes
        self.eviction = eviction
        self.batch_rows = batch_rows
        self.rejected_total = 0
        self.evicted_total = 0

    @staticmethod
    def total_bytes(store) -> int:
        return sum(store.get(n).device_bytes() for n in store.list_datasets())

    def check_admit(self, store) -> None:
        if self.hard_bytes is None:
            return
        reg = get_registry()
        used = self.total_bytes(store)
        reg.set("longbow_memory_pressure_level", self._level(used))
        if used > self.hard_bytes:
            self.rejected_total += 1
            reg.inc("longbow_memory_backpressure_rejects_total")
            raise MemoryPressureError(f"device memory hard limit: {used} > {self.hard_bytes} bytes")
        reg.inc("longbow_memory_backpressure_acquires_total")

    def _level(self, used: int) -> int:
        """0 = under soft, 1 = soft..hard, 2 = over hard."""
        if self.hard_bytes is not None and used > self.hard_bytes:
            return 2
        if self.soft_bytes is not None and used > self.soft_bytes:
            return 1
        return 0

    def _coldest_rows(self, ds, k: int) -> list:
        # the id set is copied under the dataset lock: this runs on the
        # worker thread while ingest mutates _id_to_row and _lww
        with ds._lock:
            ids = list(ds._id_to_row)
            lww = dict(ds._lww)
        if self.eviction is not None and self.eviction._last_access:
            ids.sort(key=lambda u: self.eviction._last_access.get(u, 0.0))
        else:  # oldest write first
            ids.sort(key=lambda u: lww.get(u, 0.0))
        return ids[:k]

    def enforce(self, store) -> int:
        """Evict until under the soft target; returns rows evicted.
        Eviction tombstones rows; compaction gives the bytes back, so each
        round compacts the dataset it evicted from."""
        if self.soft_bytes is None:
            return 0
        evicted = 0
        no_progress = 0
        # capacity doubles, so bytes come back in power-of-two steps:
        # evict in proportion to the overshoot, compact, check again; stop
        # when bytes stop shrinking twice in a row (the minimum capacity)
        # or nothing is left to evict
        for _ in range(8):
            used = self.total_bytes(store)
            if used <= self.soft_bytes:
                break
            names = store.list_datasets()
            if not names:
                break
            # the largest dataset pays first
            name = max(names, key=lambda n: store.get(n).device_bytes())
            ds = store.get(name)
            live = ds.live_count
            want = max(int(live * (1.0 - self.soft_bytes / used)), self.batch_rows)
            victims = self._coldest_rows(ds, min(want, live))
            if not victims:
                break
            # through the store: the query cache must drop them too
            store.delete(name, np.asarray(victims, dtype=object))
            evicted += len(victims)
            compact_dataset(ds)
            if self.total_bytes(store) >= used:
                # no bytes back yet: one grace pass may cross the next
                # capacity halving; two in a row is the floor
                no_progress += 1
                if no_progress >= 2:
                    break
            else:
                no_progress = 0
        self.evicted_total += evicted
        if evicted:
            store.query_cache.clear()
            get_registry().inc("longbow_evictions_total", evicted, reason="backpressure")
        return evicted
