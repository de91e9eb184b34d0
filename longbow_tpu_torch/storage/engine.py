"""StorageEngine: the WAL, snapshots and recovery behind one facade.

Counterpart of longbow_tpu/storage/engine.py. Every acknowledged write
is logged (a put as an Arrow IPC frame, a delete, drop or edge as a JSON
op) under the commit guard, together with its apply. A snapshot
captures every dataset's full state (index arrays, metadata columns, id
maps, LWW timestamps, BM25 and edges) under the commit lock, rotates the
WAL at that point and writes the files outside the lock. Recovery
imports the snapshot (no rebuild, no retraining), then replays the
rotated pre-snapshot segment, then the live log. A snapshot or WAL
written by longbow_tpu recovers here, and the reverse.
"""
from __future__ import annotations

import itertools
import json
import logging
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from longbow_tpu_torch.metrics import get_registry
from longbow_tpu_torch.storage import arrow_ipc
from longbow_tpu_torch.storage.snapshot import read_snapshot, write_snapshot
from longbow_tpu_torch.storage.wal import KIND_BATCH, WAL
from longbow_tpu_torch.wire_types import NATIVE_VECTOR_DTYPES

MAX_WAL_BYTES = 100 * 1024 * 1024  # a snapshot is taken past this much WAL

# reserved per-row column carrying each row's LWW timestamp in a put
# frame; never surfaced as user metadata
_TS_COL = "__longbow_ts"
_log = logging.getLogger("longbow.storage")


class _RWLock:
    """Many committers, one snapshotter. Writer-preferring, so that a
    pending snapshot is not starved by a steady stream of puts."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()


def _dtype_name(dt) -> str:
    """A storage dtype as longbow_tpu writes it (jnp.dtype's string):
    "bfloat16", "float16", "float32"."""
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return str(np.dtype(dt))


def _column(vals) -> np.ndarray:
    """A metadata column as the put frame carries it: int32, int64,
    float32, float64, bool or strings (other ints widen to int64, other
    floats to float32 or float64, objects become strings), as the
    column store reads them."""
    arr = np.asarray(vals)
    k = arr.dtype.kind
    if k in "iu" and arr.dtype not in (np.dtype(np.int32), np.dtype(np.int64)):
        return arr.astype(np.int64)
    if k == "f" and arr.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        return arr.astype(np.float32 if arr.dtype.itemsize < 4 else np.float64)
    if k == "O":
        return np.array([str(v) for v in arr], dtype=str)
    return arr


def _host_vectors(vectors) -> np.ndarray:
    """The vectors of a put as the frame logs them: their own dtype where
    it is a wire dtype, else float32; a tensor comes to the host."""
    if isinstance(vectors, torch.Tensor):
        t = vectors.detach()
        if t.dtype not in (torch.float32, torch.float16, torch.int8, torch.uint8, torch.int32):
            t = t.float()
        vectors = t.cpu().numpy()
    v = np.asarray(vectors)
    return v if v.dtype in NATIVE_VECTOR_DTYPES else v.astype(np.float32)


def _put_table(ids, vectors, columns: Optional[dict], timestamp=None,
               metric: Optional[str] = None) -> arrow_ipc.Table:
    """A put as the table longbow_tpu logs: `id` (int64, or utf8 for
    string ids), `vector` (a fixed-size list of the ingest dtype), the
    metadata columns and `__longbow_ts` (float64 a row) where the put
    carried a timestamp; the metric as schema metadata."""
    ids = np.asarray(ids)
    id_arr = (
        np.array([str(i) for i in ids], dtype=str)
        if ids.dtype.kind in "OUS"
        else ids.astype(np.int64)
    )
    cols = {"id": id_arr, "vector": _host_vectors(vectors)}
    for name, vals in (columns or {}).items():
        cols[name] = _column(vals)
    if timestamp is not None:
        # replay resolves conflicts by the origin time, not the append time
        cols[_TS_COL] = np.ascontiguousarray(
            np.broadcast_to(np.asarray(timestamp, dtype=np.float64), (len(ids),))
        )
    return arrow_ipc.Table(cols, {"longbow.metric": metric} if metric else None)


def _table_to_put(table: arrow_ipc.Table):
    """-> (ids, vectors, columns, timestamp); timestamp is a float64 a row
    where the frame carried one, else None."""
    ids = table.column("id")
    vectors = table.column("vector")
    ts = table.column(_TS_COL).astype(np.float64) if _TS_COL in table.column_names else None
    columns = {
        n: table.column(n)
        for n in table.column_names
        if n not in ("id", "vector", _TS_COL)
    }
    return ids, vectors, columns or None, ts


def _json_scalar(u):
    return u.item() if hasattr(u, "item") else u


class StorageEngine:
    """The WAL (`<dir>/wal.log`) and the snapshot (`<dir>/snapshot`) of
    one store.

    sync: the WAL's group commit ("always", "batch", "adaptive",
    "never"). snapshot_backend: an optional remote mirror (LocalBackend,
    S3Backend); every snapshot is uploaded after the local swap, and
    recovery downloads the remote one when there is no local snapshot.
    A snapshot is started in the background once the WAL passes
    max_wal_bytes."""

    def __init__(
        self,
        directory: str | Path,
        *,
        max_wal_bytes: int = MAX_WAL_BYTES,
        sync: str = "batch",
        snapshot_backend=None,
        io_uring: bool = False,
        direct_io: bool = False,
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_wal_bytes = max_wal_bytes
        self.wal = WAL(self.dir / "wal.log", sync=sync, io_uring=io_uring, direct_io=direct_io)
        self.backend = snapshot_backend
        # a WAL append and its apply must not interleave with a
        # snapshot's capture and rotation, or an acknowledged write can
        # land in neither: writes hold the read side, a snapshot the write
        self._commit_rw = _RWLock()
        # one snapshot at a time: the directory swap is not reentrant
        self._snap_lock = threading.Lock()
        self._snap_bg: Optional[threading.Thread] = None
        # seconds of the last recovery, by part (read, import, replay)
        self.recovery_stats: dict = {}

    @contextmanager
    def commit_guard(self):
        """The critical section of a WAL append and its apply."""
        self._commit_rw.acquire_read()
        try:
            yield
        finally:
            self._commit_rw.release_read()

    # -- logging ------------------------------------------------------

    def log_put(self, dataset, ids, vectors, columns, metric=None, timestamp=None) -> None:
        self.wal.append_batch(
            dataset, _put_table(ids, vectors, columns, timestamp=timestamp, metric=metric)
        )

    def log_delete(self, dataset: str, ids) -> None:
        self.wal.append_op(
            dataset, {"op": "delete", "ids": [_json_scalar(i) for i in np.asarray(ids)]}
        )

    def log_drop(self, dataset: str) -> None:
        self.wal.append_op(dataset, {"op": "drop"})

    def log_edge(self, dataset: str, src, dst, edge_type, weight) -> None:
        self.wal.append_op(
            dataset,
            {"op": "add_edge", "from": src, "to": dst, "type": edge_type, "weight": weight},
        )

    # -- snapshot / recovery ------------------------------------------

    def snapshot(self, store) -> None:
        """Write every dataset's full state, then drop the WAL it covers.
        The commit lock is held only for the capture and the WAL's
        rotation; the files are written outside it. If the write fails,
        the rotated segment stays and replays before the live log."""
        t0 = time.perf_counter()
        with self._snap_lock:
            self._commit_rw.acquire_write()
            try:
                blobs = {}
                for name in store.list_datasets():
                    ds = store.get(name)
                    with ds._lock:
                        blobs[name] = self._export_dataset(ds)
                rotated = self.wal.rotate()
            finally:
                self._commit_rw.release_write()
            final = write_snapshot(self.dir, blobs)
            if rotated is None:
                # an earlier snapshot failed after rotating: this one
                # covers that segment too
                rotated = Path(str(self.wal.path) + self.wal.PRE_SNAPSHOT_SUFFIX)
            rotated.unlink(missing_ok=True)
        if self.backend is not None:
            try:
                self.backend.upload(final, "snapshot")
            except Exception:  # the local snapshot stands; report and go on
                _log.exception("remote snapshot upload failed (local copy intact)")
        get_registry().observe("longbow_snapshot_duration_seconds", time.perf_counter() - t0)

    @staticmethod
    def _export_dataset(ds) -> dict:
        """One dataset's snapshot blob, in longbow_tpu's layout. The
        caller holds the dataset's lock; every array is a copy."""
        cols = ds.columns.export_state()
        aux = {f"colnum:{k}": v for k, v in cols["numeric"].items()}
        aux.update({f"colstr:{k}": v for k, v in cols["str_codes"].items()})
        state = ds.index.export_state()
        if ds.device.type == "cpu":
            # on the CPU, export_state's arrays may be views of the live
            # tensors, which later writes change in place
            state = {k: np.array(v) if isinstance(v, np.ndarray) else v
                     for k, v in state.items()}
        return {
            "table": None,
            "index_state": state,
            "aux": aux,
            "json": {
                "row_to_id": [_json_scalar(u) for u in ds._row_to_id],
                # the whole LWW map, deletion markers included
                "lww": [[_json_scalar(k), ts] for k, ts in ds._lww.items()],
                "str_dicts": cols["str_dicts"],
                "col_count": cols["count"],
            },
            "bm25": ds.bm25.export_state() if len(ds.bm25) else None,
            "graph": ds.graph.export_state() if ds.graph.stats()["edges"] else None,
            "meta": {
                "version": 2,
                "dim": ds.dim,
                "metric": ds.metric,
                "dtype": _dtype_name(ds.dtype),
                "index_kind": ds.index_kind,
                "index_params": ds.index_params,
                "migration_threshold": ds.migration_threshold,
            },
        }

    def maybe_snapshot(self, store) -> bool:
        """Start a snapshot on a background thread once the WAL passes
        max_wal_bytes; skipped while one runs. Returns whether it started."""
        if (
            self.wal.size_bytes <= self.max_wal_bytes
            or self._snap_lock.locked()
            or self._snap_bg is not None and self._snap_bg.is_alive()
        ):
            return False

        def _bg():
            try:
                self.snapshot(store)
            except Exception:  # a failed snapshot must not break ingest
                _log.exception("background snapshot failed")

        self._snap_bg = threading.Thread(target=_bg, daemon=True, name="longbow-wal-snapshot")
        self._snap_bg.start()
        return True

    def recover(self, store) -> int:
        """The snapshot first, then the WAL. Returns the datasets and
        frames applied. recovery_stats gets the seconds of each part."""
        from longbow_tpu_torch.hybrid.bm25 import BM25Index
        from longbow_tpu_torch.hybrid.graph_store import GraphStore

        reg = get_registry()
        reg.set("longbow_warmup_progress_percent", 0)
        stats = {"snapshot_read_s": 0.0, "index_import_s": 0.0, "wal_replay_s": 0.0,
                 "datasets": 0, "frames": 0, "rows_replayed": 0}
        n = 0
        t0 = time.perf_counter()
        snap = read_snapshot(self.dir)
        if snap is None and self.backend is not None:
            # a fresh node: pull the remote snapshot
            try:
                if self.backend.download("snapshot", self.dir / "snapshot"):
                    snap = read_snapshot(self.dir)
            except Exception:  # start from the WAL alone; report it
                _log.exception("remote snapshot download failed")
        stats["snapshot_read_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for name, blob in (snap or {}).items():
            meta = blob["meta"]
            if meta.get("version", 1) >= 2 and blob["index_state"].get("kind"):
                store.restore_dataset(name, blob)
            else:
                store.get_or_create(name, meta["dim"], meta.get("metric"))
            ds = store.get(name)
            if blob["bm25"]:
                ds.bm25 = BM25Index.import_state(blob["bm25"])
            if blob["graph"] and getattr(ds.graph, "path", None) is None:
                # a disk-backed edge store replayed its own log on open;
                # importing the blob as well would double its edges
                ds.graph = GraphStore.import_state(blob["graph"])
            n += 1
        if store.device.type == "cuda":
            torch.cuda.synchronize(store.device)
        stats["index_import_s"] = time.perf_counter() - t0
        stats["datasets"] = n
        reg.set("longbow_warmup_progress_percent", 50)

        t_wal = time.perf_counter()
        pre = Path(str(self.dir / "wal.log") + WAL.PRE_SNAPSHOT_SUFFIX)
        frames = itertools.chain(
            # a pending pre-snapshot segment is older than the live log
            WAL.replay(pre) if pre.exists() else iter(()),
            WAL.replay(self.dir / "wal.log"),
        )
        for seq, ts, name, kind, payload in frames:
            try:
                if kind == KIND_BATCH:
                    table = WAL.decode_batch(payload)
                    ids, vecs, cols, put_ts = _table_to_put(table)
                    store.put(
                        name, ids, vecs, cols,
                        metric=table.schema_metadata.get("longbow.metric"),
                        _log=False,
                        timestamp=put_ts if put_ts is not None else ts,
                    )
                    stats["rows_replayed"] += len(ids)
                else:
                    self._replay_op(store, name, json.loads(payload))
            except (ValueError, KeyError) as e:
                # a frame the store rejects (logged before its validation
                # was fixed) must not stop every restart: skip it loudly.
                # A CRC error stops the replay inside WAL.replay itself.
                _log.error("skipping unreplayable WAL frame seq=%s ds=%s: %s", seq, name, e)
                reg.inc("longbow_wal_replay_skipped_frames_total")
            n += 1
            stats["frames"] += 1
        if store.device.type == "cuda":
            torch.cuda.synchronize(store.device)
        stats["wal_replay_s"] = time.perf_counter() - t_wal
        reg.observe("longbow_wal_replay_duration_seconds", stats["wal_replay_s"])
        reg.set("longbow_warmup_progress_percent", 100)
        self.recovery_stats = stats
        return n

    @staticmethod
    def _replay_op(store, name: str, op: dict) -> None:
        if op["op"] == "delete":
            store.delete(name, op["ids"], _log=False)
        elif op["op"] == "drop":
            store.drop(name, _log=False)
        elif op["op"] == "add_edge":
            # a disk-backed edge store already holds this edge from its
            # own log; adding it again would write a second durable copy
            try:
                g = store.get(name).graph
            except KeyError:
                g = None
            if not (
                g is not None
                and getattr(g, "path", None) is not None
                and g.has_edge(op["from"], op["to"], op["type"], op["weight"])
            ):
                store.add_edge(name, op["from"], op["to"], op["type"], op["weight"], _log=False)

    def close(self) -> None:
        self.wal.close()
