"""Dataset: one collection of vectors + metadata + its index.

Counterpart of longbow_tpu/store/dataset.py: records, tombstones, the
primary user-id index, the vector index, the metric (schema metadata
`longbow.metric`), filter masks with caching, the BM25 index over a
text column, the GraphRAG edge store and the anti-entropy surface
(apply_remote_tombstones, export_delta, merkle_state) that the cluster
layer's SyncWorker reads across nodes of either package.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

import numpy as np
import torch

from longbow_tpu_torch.device import resolve_device
from longbow_tpu_torch.hybrid.bm25 import BM25Index
from longbow_tpu_torch.hybrid.graph_store import DiskGraphStore, GraphStore
from longbow_tpu_torch.index.factory import make_index
from longbow_tpu_torch.metrics import get_registry
from longbow_tpu_torch.metrics.registry import count
from longbow_tpu_torch.ops.distance import MASKED_GUARD, Metric
from longbow_tpu_torch.query.filters import ColumnStore, FilterCache
from longbow_tpu_torch.query.parser import Filter
from longbow_tpu_torch.utils.tracing import span

# string columns indexed into BM25 for hybrid search (the reference
# indexes document text fed through its BM25 pipeline)
TEXT_COLUMNS = ("text", "content", "body")

# metric value aliases; the schema metadata key is wire_types.METRIC_METADATA_KEY
# (reference: dataset.go:176-189)
_METRIC_ALIASES = {
    "euclidean": Metric.L2,
    "l2": Metric.L2,
    "cosine": Metric.COSINE,
    "dot_product": Metric.DOT,
    "dot": Metric.DOT,
}


class _RowIds:
    """A numpy mirror of a row -> id list (`src`): `ids` holds the list's
    objects by row (None for a dead row) and `live` whether a row holds
    one, over the list's length `n`; past it both grow by doubling. Built
    once from its list, then kept by each put and delete with one
    vectorized write, so that a search's answer is a gather."""

    def __init__(self, src: list):
        n = len(src)
        self.src = src
        self.n = n
        # None throughout; at least one slot, since an answer gathers row 0
        # in place of a miss
        self.ids = np.empty(max(16, n), dtype=object)
        self.ids[:n] = src
        self.live = np.zeros(len(self.ids), dtype=bool)
        self.live[:n] = np.not_equal(self.ids[:n], None)

    def set(self, rows: np.ndarray, keys: list, n: int) -> None:
        """Rows `rows` now hold `keys`; the list is `n` long."""
        if n > len(self.ids):
            cap = max(n, 2 * len(self.ids))
            ids = np.empty(cap, dtype=object)
            ids[: self.n] = self.ids[: self.n]
            live = np.zeros(cap, dtype=bool)
            live[: self.n] = self.live[: self.n]
            self.ids, self.live = ids, live
        self.n = max(self.n, n)
        vals = np.empty(len(keys), dtype=object)
        vals[:] = keys
        self.ids[rows] = vals
        self.live[rows] = True

    def clear(self, rows: list) -> None:
        """Rows `rows` are dead."""
        rows = np.asarray(rows, dtype=np.int64)
        rows = rows[rows < self.n]
        self.ids[rows] = None
        self.live[rows] = False


class Dataset:
    def __init__(
        self,
        name: str,
        dim: int,
        metric: str = Metric.L2,
        *,
        dtype=torch.float32,
        hnsw_config=None,
        migration_threshold: int = 200_000,
        index_kind: str = "adaptive",
        index_params: Optional[dict] = None,
        graph_disk_path=None,
        device=None,
    ):
        self.name = name
        self.dim = dim
        self.metric = _METRIC_ALIASES.get(metric.lower(), None) or Metric.validate(metric)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.hnsw_config = hnsw_config
        self.migration_threshold = migration_threshold
        self.index_kind = (index_kind or "adaptive").lower()
        # graph_disk is the dataset's (a disk edge store), not the index's;
        # it stays in index_params so that a snapshot can record it
        self.index_params = dict(index_params or {})
        self.index = make_index(
            self.index_kind, dim, self.metric, dtype=dtype, device=self.device,
            migration_threshold=migration_threshold, hnsw_config=hnsw_config,
            **self.index_construction_params(),
        )
        self.columns = ColumnStore(self.index.capacity, device=self.device)
        self.filter_cache = FilterCache()
        # primary index: user id -> internal row
        self._id_to_row: dict = {}
        self._row_to_id: list = []
        self._rows = _RowIds(self._row_to_id)  # see _row_ids
        # LWW timestamps for conflict resolution (reference: lww.go:8)
        self._lww: dict = {}
        self.bm25 = BM25Index()
        self.graph = (
            GraphStore() if graph_disk_path is None else DiskGraphStore(graph_disk_path)
        )
        self._lock = threading.RLock()
        # serializes compactions (the rebuild runs outside self._lock so
        # serving continues; two rebuilds of one dataset would race on
        # the swap)
        self._compact_mu = threading.Lock()
        self.created_at = time.time()
        self.last_access = time.time()

    def touch(self) -> None:
        self.last_access = time.time()

    def index_construction_params(self) -> dict:
        """index_params without the dataset-level knobs: what make_index
        takes (compaction builds its new index from these too)."""
        return {k: v for k, v in self.index_params.items() if k != "graph_disk"}

    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._id_to_row)

    @property
    def live_count(self) -> int:
        return len(self._id_to_row)

    def put(
        self,
        ids,
        vectors,
        columns: Optional[dict] = None,
        timestamp=None,
    ) -> None:
        """Upsert rows by user id. Duplicate ids tombstone the old row and
        write a new one, last-writer-wins by timestamp (reference:
        lww.go, store_actions.go:813). timestamp: scalar, per-row array,
        or None (now). In-batch duplicate ids dedupe to the newest
        occurrence before the append.

        vectors: a numpy array, a list of numpy blocks, or a tensor (a
        device tensor goes straight to the index, no host round trip)."""
        ids = np.asarray(ids)
        self.touch()
        device_input = isinstance(vectors, torch.Tensor)
        blocks: Optional[list] = None
        if isinstance(vectors, list):
            if not getattr(self.index, "accepts_blocks", False):
                vectors = np.concatenate(vectors)
            else:
                blocks = vectors
        if not device_input:

            def _canon(v):
                # f16/i8/u8 keep their dtype to the index (which converts
                # exactly); everything else becomes f32 here
                if v.dtype in (np.float16, np.int8, np.uint8):
                    return np.ascontiguousarray(v)
                return np.ascontiguousarray(v, dtype=np.float32)

            if blocks is not None:
                blocks = [_canon(b) for b in blocks]
                vectors = blocks
            else:
                vectors = _canon(np.asarray(vectors))
        n = len(ids)
        n_vec = (
            sum(b.shape[0] for b in blocks) if blocks is not None else vectors.shape[0]
        )
        if n_vec != n:
            raise ValueError("ids/vectors length mismatch")
        keys = ids.tolist()
        ts_list = None
        if isinstance(timestamp, np.ndarray):
            ts_list = timestamp.tolist()
            ts = ts_list[-1] if ts_list else time.time()
        else:
            ts = timestamp if timestamp is not None else time.time()

        with self._lock:
            lww = self._lww
            idr = self._id_to_row
            row_ids = self._row_ids()
            # LWW stale-drop + in-batch dedupe (newest occurrence wins)
            keep = np.ones(n, dtype=bool)
            seen: dict = {}
            dropped = False
            for j, k in enumerate(keys):
                tj = ts_list[j] if ts_list is not None else ts
                old_ts = lww.get(k)
                if old_ts is not None and old_ts > tj:
                    keep[j] = False
                    dropped = True
                    continue
                prev = seen.get(k)
                if prev is not None:
                    if ts_list is not None and ts_list[prev] > tj:
                        keep[j] = False
                        dropped = True
                        continue
                    keep[prev] = False
                    dropped = True
                seen[k] = j
            if dropped:
                sel = np.nonzero(keep)[0]
                if blocks is not None:  # rare path: pay the merge here
                    vectors = np.concatenate(blocks)
                    blocks = None
                if device_input:
                    vectors = vectors[torch.as_tensor(sel, device=vectors.device)]
                else:
                    vectors = vectors[sel]
                ids = ids[sel]
                sl = sel.tolist()
                keys = [keys[j] for j in sl]
                if ts_list is not None:
                    ts_list = [ts_list[j] for j in sl]
                if columns:
                    columns = {k: np.asarray(v)[sel] for k, v in columns.items()}
                n = len(keys)
            if n == 0:
                return

            # schema evolution is additive-only: reject type flips BEFORE
            # any mutation
            self.columns.check_types(columns or {})

            # tombstone overwritten rows and clear their slot in the
            # row -> id map
            stale_rows = [idr[k] for k in keys if k in idr]
            if stale_rows:
                self.index.delete_rows(np.asarray(stale_rows))
                for r in stale_rows:
                    if r < len(self._row_to_id):
                        self._row_to_id[r] = None
                row_ids.clear(stale_rows)

            rows = self.index.add(vectors)
            self.columns.append(columns or {}, n, self.index.capacity, rows=rows)
            if columns:
                for tc in TEXT_COLUMNS:
                    if tc in columns:
                        vals = np.asarray(columns[tc])
                        for j in range(n):
                            self.bm25.add(keys[j], str(vals[j]))
                        break
            rows_list = rows.tolist()
            if ts_list is None:
                for k, r in zip(keys, rows_list):
                    idr[k] = r
                    lww[k] = ts
            else:
                for k, r, tj in zip(keys, rows_list, ts_list):
                    idr[k] = r
                    lww[k] = tj
            need = max(rows_list) + 1 - len(self._row_to_id)
            if need > 0:
                self._row_to_id.extend([None] * need)
            r2i = self._row_to_id
            for r, k in zip(rows_list, keys):
                r2i[r] = k
            row_ids.set(rows, keys, len(r2i))
            self.filter_cache.invalidate()

    @staticmethod
    def _key(uid):
        return uid.item() if hasattr(uid, "item") else uid

    def apply_remote_tombstones(self, ids, tss) -> int:
        """Anti-entropy tombstones, LWW-checked atomically under the
        dataset lock: a concurrent newer local put survives and its
        timestamp never rolls back to the remote tombstone's."""
        keys = [self._key(np.asarray(uid)) for uid in ids]
        return self._tombstone(keys, list(tss), lww=True, held_only=False)

    def delete(self, ids, timestamp=None, *, replicated: bool = False) -> int:
        """Delete by user id; returns the number removed
        (reference: DoAction 'delete', store_actions.go:103). Every
        tombstone bears one time, `timestamp` or now. replicated: a peer's
        delete at its origin's time, under apply_remote_tombstones' LWW
        rule; like the origin's delete, it stamps only the rows held, so
        the replicas' Merkle leaves stay equal to the origin's."""
        ts = time.time() if timestamp is None else float(timestamp)
        keys = [self._key(uid) for uid in np.asarray(ids)]
        return self._tombstone(keys, [ts] * len(keys), lww=replicated, held_only=True)

    def _tombstone(self, keys, tss, *, lww: bool, held_only: bool) -> int:
        """Removes the rows of `keys` and stamps each tombstone with its
        time. lww: a key whose last write is at least as new is left.
        held_only: a key this dataset does not hold gets no tombstone.
        Returns the tombstones stamped."""
        with self._lock:
            rows = []
            n = 0
            for key, ts in zip(keys, tss):
                if lww and self._lww.get(key, -np.inf) >= ts:
                    continue
                row = self._id_to_row.pop(key, None)
                if row is None and held_only:
                    continue
                self._lww[key] = ts
                n += 1
                if row is not None:
                    rows.append(row)
                    self.bm25.remove(key)
                    if row < len(self._row_to_id):
                        self._row_to_id[row] = None
            if rows:
                self.index.delete_rows(np.asarray(rows))
                self._row_ids().clear(rows)
                self.filter_cache.invalidate()
            return n

    # ------------------------------------------------------------------

    def filter_mask(
        self, filters: list[Filter], *, _columns=None, _index=None
    ) -> Optional[torch.Tensor]:
        """Predicate filters -> device row mask [index capacity], cached.
        _columns/_index: the snapshot a search took under the lock."""
        cols = _columns if _columns is not None else self.columns
        idx = _index if _index is not None else self.index
        return self._fit(self.filter_cache.get_or_eval_versioned(cols, filters)[0], idx)

    @staticmethod
    def _fit(mask: Optional[torch.Tensor], idx) -> Optional[torch.Tensor]:
        """A mask cut or padded (False) to the index's capacity."""
        if mask is None:
            return None
        cap = idx.capacity
        if mask.shape[0] < cap:
            pad = torch.zeros(cap - mask.shape[0], dtype=torch.bool, device=mask.device)
            mask = torch.cat([mask, pad])
        elif mask.shape[0] > cap:
            mask = mask[:cap]
        return mask

    def warm(self) -> None:
        """Build the search kernel and run one search off the query path."""
        self.index.warm()

    def search(
        self,
        queries,
        k: int,
        *,
        filters: Optional[list] = None,
        ef_search: Optional[int] = None,
        exact: bool = False,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched search -> (ids [B, k] object, scores [B, k] f32,
        ok [B, k] bool). Scores follow the reference's semantics:
        distance for l2/cosine, raw inner product for dot."""
        self.touch()
        with self._lock:
            idx = self.index
            row_ids = self._row_ids()  # the mirror of idx's rows
            cols = self.columns
        mask, version = self.filter_cache.get_or_eval_versioned(cols, filters or [])
        mask = self._fit(mask, idx)
        if mask is not None and not exact and idx.kind == "hnsw":
            # selectivity routing: a highly selective predicate starves a
            # graph beam, while the exact scan finds every eligible row.
            # Below max(4096, capacity / 50) eligible rows the filtered
            # query is served from the exact path. The count is cached
            # per filter list under the store version its mask was
            # evaluated at, so it costs one host read per distinct filter.
            cnt = self.filter_cache.selectivity_count(filters or [], mask, version)
            if cnt < max(4096, idx.capacity // 50):
                exact = True
        if not isinstance(queries, torch.Tensor):
            queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        t0 = time.perf_counter()
        d, r = idx.search(
            queries, k, filter_mask=mask, ef_search=ef_search, exact=exact
        )
        dt = time.perf_counter() - t0
        if dt > 1.0:
            # a search of over a second is a kernel build (nvcc, at a
            # kernel's first launch); warm searches take milliseconds
            try:
                get_registry().histogram("longbow_tpu_kernel_compile_seconds").observe(dt)
            except Exception:
                pass
        with span("longbow.dataset.answer"):
            ok = (d < float(MASKED_GUARD)) & (r >= 0)
            # read after the search: a row put meanwhile has its id, and a
            # row deleted meanwhile is not live
            with self._lock:
                ok &= r < row_ids.n
                rs = np.where(ok, r, 0)
                ok &= row_ids.live[rs]
                ids = row_ids.ids[rs]
            ids[~ok] = None
            scores = -d if self.metric == Metric.DOT else d
        return ids, scores, ok

    def _row_ids(self) -> _RowIds:
        """The mirror of _row_to_id; under self._lock. A compaction or a
        snapshot's load replaces the list, and the mirror is then built
        anew, once (O(rows), counted by
        longbow_dataset_row_ids_rebuilds_total)."""
        if self._rows.src is not self._row_to_id:
            self._rows = _RowIds(self._row_to_id)
            count("longbow_dataset_row_ids_rebuilds_total", dataset=self.name)
        return self._rows

    def row_ids_array(self) -> np.ndarray:
        """row -> user id as an object ndarray (None = dead row): a view
        of the mirror, which later puts and deletes write."""
        with self._lock:
            row_ids = self._row_ids()
            return row_ids.ids[: row_ids.n]

    def graph_heuristic(self):
        """Embedding-distance heuristic for A* graph navigation. Vector
        fetches go through a small host cache (one device gather a miss)."""
        cache: dict = {}

        def vec(uid):
            v = cache.get(uid)
            if v is None:
                row = self._id_to_row.get(self._key(np.asarray(uid)))
                if row is None:
                    return None
                if len(cache) > 256:
                    cache.clear()
                v = np.asarray(self.index.get_vectors(np.asarray([row]))[0], np.float32)
                cache[uid] = v
            return v

        def h(node, dst):
            a, b = vec(node), vec(dst)
            if a is None or b is None:
                return 0.0  # unknown node: no guidance
            return float(np.linalg.norm(a - b))

        return h

    def search_by_id(self, uid, k: int, **kw):
        """Search with the stored vector of `uid` (the VectorSearchByID
        action)."""
        t0 = time.perf_counter()
        row = self._id_to_row.get(self._key(np.asarray(uid)))
        if row is None:
            raise KeyError(f"id {uid!r} not found in {self.name!r}")
        vec = self.index.get_vectors(np.asarray([row]))
        get_registry().observe(
            "longbow_id_resolution_duration_seconds", time.perf_counter() - t0
        )
        return self.search(vec, k, **kw)

    def get_vectors_by_rows(self, rows: np.ndarray) -> np.ndarray:
        return self.index.get_vectors(rows)

    # -- anti-entropy (reference: ExportDelta/ApplyDelta
    #    types/interfaces.go:56-57, merkle.go) -------------------------

    def _bucket_map(self) -> dict:
        """bucket -> [uids], kept up to date as the id set grows (bucket_of
        depends only on the uid, so ts-only LWW updates never move a
        row between buckets): export_delta is called for every bucket
        of a sync round, and re-hashing the whole id set each time
        would cost 256 x N hashes a round. No uid ever leaves _lww (a
        delete keeps its timestamp) and a dict keeps insertion order,
        so only the uids past the last count are hashed; the reference
        hashes every uid again whenever the count has changed."""
        from longbow_tpu_torch.distributed.merkle import bucket_of

        with self._lock:  # RLock: callers may already hold it
            lww = self._lww
            n = len(lww)
            cached = getattr(self, "_bucket_cache", None)
            if cached is not None and cached[2] is lww and cached[0] == n:
                return cached[1]
            if cached is not None and cached[2] is lww and cached[0] < n:
                # a copy: a caller may still hold the map it was given
                m = {b: list(u) for b, u in cached[1].items()}
                new = itertools.islice(lww, cached[0], None)
            else:
                m, new = {}, lww
            for uid in new:
                m.setdefault(bucket_of(uid), []).append(uid)
            self._bucket_cache = (n, m, lww)
            return m

    def export_delta(self, bucket: int, have=None) -> dict:
        """Rows + deletion markers in one Merkle bucket, in the
        reference's JSON layout (vectors as lists of floats), so that a
        node of either package applies the other's delta. Vectors come
        from ONE batched index gather (the host mirror where there is
        one), the metadata columns from ColumnStore.host_view.

        have: optional [[uid, ts], ...] of what the puller already
        holds — only strictly-newer or missing rows are returned, so a
        bucket that differs by one row costs one row, not the whole
        bucket."""
        have_ts = {u: t for u, t in (have or [])}
        dead: list = []
        dead_ts: list = []
        live_uids: list = []
        live_ts: list = []
        live_rows: list = []
        # (row, ts) pairs are captured under the mutation lock: a ts read
        # after the gather could pair an old row's vector with a newer
        # concurrent put's ts, and both sides would then hash equal
        # leaves over different vectors
        with self._lock:
            lww = self._lww
            for uid in self._bucket_map().get(bucket, ()):
                ts = lww.get(uid, 0.0)
                hts = have_ts.get(uid)
                if hts is not None and ts <= hts:
                    continue  # the puller is current for this row
                row = self._id_to_row.get(uid)
                if row is None:
                    dead.append(uid)
                    dead_ts.append(ts)
                else:
                    live_uids.append(uid)
                    live_ts.append(ts)
                    live_rows.append(row)
            idx = self.index
            cols_snap = self.columns
        rows = [{"id": u, "ts": t, "deleted": True} for u, t in zip(dead, dead_ts)]
        if live_rows:
            rowarr = np.asarray(live_rows)
            vecs = np.asarray(idx.get_vectors(rowarr), np.float32)
            # metadata columns ride the delta too: rows healed without
            # them would fail filters and drop out of BM25, and equal
            # Merkle leaves would hide the loss
            cols = cols_snap.host_view(rowarr) if cols_snap.fields() else {}
            for j, (u, t, vec) in enumerate(zip(live_uids, live_ts, vecs)):
                rec = {"id": u, "ts": t, "vector": vec.tolist()}
                if cols:
                    rec["columns"] = {
                        k: (v[j].item() if hasattr(v[j], "item") else v[j])
                        for k, v in cols.items()
                    }
                rows.append(rec)
        return {"dataset": self.name, "bucket": bucket, "rows": rows}

    def merkle_state(self) -> dict:
        from longbow_tpu_torch.distributed.merkle import MerkleTree

        t = MerkleTree.from_dataset(self)
        return {"root": t.root_hex, "leaves": t.leaves_hex()}

    def device_bytes(self) -> int:
        """Device-memory footprint of the index (whatever its kind) and
        the metadata columns."""
        total = self.index.device_bytes()
        for col in (*self.columns._numeric.values(), *self.columns._str_codes.values()):
            total += col.numel() * col.element_size()
        return total

    def stats(self) -> dict:
        err = getattr(self.index, "migration_error", None)
        return {
            "name": self.name,
            "dim": self.dim,
            "metric": self.metric,
            "live_rows": self.live_count,
            "tombstones": len(self.index) - self.live_count,
            "index_kind": self.index.kind,
            "index_rows": len(self.index),
            "capacity": self.index.capacity,
            "device_bytes": self.device_bytes(),
            # host RAM or file bytes of the index beside the device: the
            # disk tier's rows, a PQ graph's re-rank copy
            "host_bytes": getattr(self.index, "host_bytes", lambda: 0)(),
            "fields": self.columns.fields(),
            # a failed migration to the graph tier leaves the flat tier
            # serving; this is where it shows
            "migration_error": None if err is None else repr(err),
        }
