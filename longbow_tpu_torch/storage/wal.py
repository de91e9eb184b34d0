"""Write-ahead log: CRC32C-framed Arrow IPC / op entries.

Counterpart of longbow_tpu/storage/wal.py, frame for frame: the frame
layout (`_HDR`, CRC32C over everything after the CRC) is encoded and
scanned by the native library (lb_wal_encode / lb_wal_scan), and a put's
payload is an Arrow IPC stream written by storage/arrow_ipc.py, which
pyarrow reads as an equal table. A log written by either package
replays in the other.

Group-commit fsync ("always", "batch", "adaptive", "never"), rotation
at a snapshot's capture point, the sequence resumed and a torn tail cut
off on reopen, and three append backends: a buffered file ("fs"),
O_DIRECT ("direct") and io_uring ("io_uring"). Where the OS refuses the
last two, the log opens the file backend; `backend_name` says which one
serves.
"""
from __future__ import annotations

import ctypes
import json
import logging
import os
import struct
import threading
import time
from pathlib import Path
from typing import Iterator, Optional

from longbow_tpu_torch.metrics import get_registry
from longbow_tpu_torch.storage import arrow_ipc, native

KIND_BATCH = 0  # payload = Arrow IPC stream (put)
KIND_OP = 1     # payload = JSON op (delete, drop, add_edge)

_HDR = struct.Struct("<IQdHBI")  # crc, seq, ts, name_len, kind, payload_len
_log = logging.getLogger("longbow.storage")


def _encode_frame(seq: int, ts: float, name: bytes, kind: int, payload: bytes) -> bytes:
    lib = native.get_lib()
    size = lib.lb_wal_frame_size(len(name), len(payload))
    buf = ctypes.create_string_buffer(size)
    n = lib.lb_wal_encode(buf, seq, ts, name, len(name), kind, payload, len(payload))
    return buf.raw[:n]


def _scan_frames(buf: bytes) -> tuple[list[int], int]:
    """-> (frame start offsets, clean prefix length)."""
    lib = native.get_lib()
    max_entries = max(len(buf) // _HDR.size, 1)
    offsets = (ctypes.c_uint64 * max_entries)()
    valid = ctypes.c_uint64(0)
    n = lib.lb_wal_scan(buf, len(buf), offsets, max_entries, ctypes.byref(valid))
    return list(offsets[:n]), valid.value


def _py_scan_frames(buf: bytes) -> tuple[list[int], int]:
    """The plain version of _scan_frames, in Python."""
    out = []
    pos = 0
    while pos + _HDR.size <= len(buf):
        crc, seq, ts, nlen, kind, plen = _HDR.unpack_from(buf, pos)
        frame = _HDR.size + nlen + plen
        if pos + frame > len(buf):
            break
        if native._py_crc32c(buf[pos + 4: pos + frame]) != crc:
            break
        out.append(pos)
        pos += frame
    return out, pos


class _FileBackend:
    """Buffered appends to a regular file."""

    name = "fs"

    def __init__(self, path: Path):
        self.path = path
        self._f = open(path, "ab")

    def write(self, frame: bytes) -> None:
        self._f.write(frame)

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def truncate(self) -> None:
        self._f.close()
        open(self.path, "wb").close()
        self._f = open(self.path, "ab")

    def close(self) -> None:
        self._f.close()


class _DirectBackend:
    """O_DIRECT appends: a group-commit sync is one aligned pwrite and an
    fdatasync, and the log does not fill the page cache.

    O_DIRECT needs the buffer address, length and file offset aligned to
    4096. Frames are staged in a page-aligned mmap and a sync rewrites
    from the last block boundary, zero-padding the tail block. The
    padding is on disk between syncs; replay's scan reads it as a torn
    tail, and close() trims the file to its logical size.
    """

    name = "direct"
    BLOCK = 4096
    _STAGE = 4 << 20  # staging mmap; larger pending syncs go in slices

    def __init__(self, path: Path):
        import mmap

        self.path = path
        self._fd = os.open(str(path), os.O_WRONLY | os.O_CREAT | os.O_DIRECT, 0o644)
        logical = path.stat().st_size if path.exists() else 0
        tail = logical % self.BLOCK
        self._flush_base = logical - tail
        self._pending = bytearray()
        if tail:
            # re-stage the partial tail block: the next sync rewrites it
            with open(path, "rb") as f:
                f.seek(self._flush_base)
                self._pending += f.read(tail)
        self._buf = mmap.mmap(-1, self._STAGE)

    def write(self, frame: bytes) -> None:
        self._pending += frame

    def sync(self) -> None:
        data = self._pending
        if not data:
            os.fdatasync(self._fd)
            return
        pad = -len(data) % self.BLOCK
        total = len(data) + pad
        mv = memoryview(self._buf)
        off = self._flush_base
        for s in range(0, total, self._STAGE):
            m = min(self._STAGE, total - s)
            chunk = bytes(data[s:s + m])
            mv[:len(chunk)] = chunk
            if len(chunk) < m:  # zero-pad the final tail block
                mv[len(chunk):m] = b"\0" * (m - len(chunk))
            os.pwrite(self._fd, mv[:m], off + s)
        os.fdatasync(self._fd)
        # full blocks are durable; the partial tail stays staged so that
        # the next sync rewrites its block with the appended bytes
        keep = len(data) % self.BLOCK
        self._flush_base = off + len(data) - keep
        self._pending = bytearray(data[len(data) - keep:]) if keep else bytearray()

    def truncate(self) -> None:
        os.close(self._fd)
        open(self.path, "wb").close()
        self._fd = os.open(str(self.path), os.O_WRONLY | os.O_CREAT | os.O_DIRECT, 0o644)
        self._flush_base = 0
        self._pending = bytearray()

    def close(self) -> None:
        self.sync()
        # trim the zero padding so that readers see the logical bytes
        os.ftruncate(self._fd, self._flush_base + len(self._pending))
        os.fdatasync(self._fd)
        os.close(self._fd)
        self._buf.close()


class _UringBackend:
    """Linux io_uring: appends are submitted asynchronously and the
    group-commit sync is a drain-ordered fdatasync that reaps every
    completion (native lb_uring_*). Raises OSError at construction when
    the kernel or a seccomp filter refuses io_uring."""

    name = "io_uring"

    def __init__(self, path: Path, entries: int = 128):
        self._lib = native.get_lib()
        self._h = self._lib.lb_uring_open(str(path).encode(), entries)
        if not self._h:
            raise OSError("io_uring setup failed")
        self.path = path

    def write(self, frame: bytes) -> None:
        if self._lib.lb_uring_write(self._h, frame, len(frame)) < 0:
            raise OSError("io_uring write failed")

    def sync(self) -> None:
        if self._lib.lb_uring_fsync(self._h) < 0:
            raise OSError("io_uring fsync reported IO errors")

    def truncate(self) -> None:
        if self._lib.lb_uring_truncate(self._h) < 0:
            raise OSError("io_uring truncate failed")

    def close(self) -> None:
        self._lib.lb_uring_close(self._h)
        self._h = 0


class WAL:
    """Append-only CRC-framed log with group-commit fsync.

    sync: "always" (fsync every append), "batch" (a background thread
    fsyncs every sync_interval_s), "adaptive" (the same, its interval
    stretched under load and shrunk when idle, 5-250 ms) or "never".
    """

    PRE_SNAPSHOT_SUFFIX = ".pre-snapshot"

    # adaptive mode: aim for about 1 MB a group commit within [5 ms, 250 ms]
    _ADAPT_TARGET_BYTES = 1 << 20
    _ADAPT_MIN_S = 0.005
    _ADAPT_MAX_S = 0.25

    def __init__(
        self,
        path: str | Path,
        *,
        sync: str = "batch",
        sync_interval_s: float = 0.05,
        io_uring: bool = False,
        direct_io: bool = False,
    ):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # resume the sequence from an existing log, and cut a torn tail
        # off before appending: frames written after garbage would be
        # acknowledged but unreachable by the next replay
        self._seq = 0
        if self.path.exists() and self.path.stat().st_size:
            buf = self.path.read_bytes()
            offsets, valid = _scan_frames(buf)
            if offsets:
                self._seq = _HDR.unpack_from(buf, offsets[-1])[1]
            if valid < len(buf):
                _log.warning("truncating %d torn bytes off WAL tail (%s)",
                             len(buf) - valid, self.path)
                with open(self.path, "r+b") as f:
                    f.truncate(valid)
        self._io_uring = io_uring
        self._direct_io = direct_io
        self._backend = self._open_backend()
        self._lock = threading.Lock()
        # running byte total, so that size_bytes costs no syscall
        self._total_bytes = self.path.stat().st_size if self.path.exists() else 0
        self.sync = sync
        self._dirty = False
        self._sync_interval = sync_interval_s
        self._bytes_since_sync = 0
        self._stop = threading.Event()
        self._fsync_thread: Optional[threading.Thread] = None
        if sync in ("batch", "adaptive"):
            self._fsync_thread = threading.Thread(
                target=self._fsync_loop, daemon=True, name="longbow-wal-fsync"
            )
            self._fsync_thread.start()

    def _open_backend(self):
        if self._io_uring:
            try:
                return _UringBackend(self.path)
            except OSError:
                pass  # an old kernel or a seccomp filter that refuses io_uring
        if self._direct_io:
            try:
                return _DirectBackend(self.path)
            except OSError:
                pass  # a file system without O_DIRECT (tmpfs, overlayfs)
        return _FileBackend(self.path)

    def rotate(self) -> Optional[Path]:
        """Move the live log aside as the snapshot's capture point and
        start a fresh one; returns the rotated path. Returns None while an
        earlier rotation is still pending (a snapshot failed after it):
        the live log is then left alone, and the caller deletes the stale
        segment once its own snapshot succeeded. Recovery replays
        `<wal>.pre-snapshot` before the live log (puts are LWW upserts,
        so a replay the snapshot already covers changes nothing)."""
        pre = Path(str(self.path) + self.PRE_SNAPSHOT_SUFFIX)
        with self._lock:
            if pre.exists():
                return None
            self._backend.sync()
            self._backend.close()
            if self.path.exists():
                self.path.rename(pre)
            self._backend = self._open_backend()
            self._total_bytes = 0
            self._dirty = False
            return pre

    def _fsync_loop(self) -> None:
        reg = get_registry()
        while not self._stop.wait(self._sync_interval):
            with self._lock:
                if self._dirty:
                    t0 = time.perf_counter()
                    status = "ok"
                    try:
                        self._backend.sync()
                    except OSError:
                        # a transient EIO/ENOSPC must not end the group
                        # commit for the life of the process
                        status = "error"
                        _log.exception("WAL fsync failed; retrying next interval")
                    finally:
                        self._dirty = status == "error"
                        reg.observe("longbow_wal_fsync_duration_seconds",
                                    time.perf_counter() - t0, status=status)
                batch = self._bytes_since_sync
                self._bytes_since_sync = 0
            if batch:
                reg.observe("longbow_wal_batch_size", batch)
            reg.set("longbow_wal_write_rate_per_second",
                    batch / max(self._sync_interval, 1e-9))
            reg.set("longbow_wal_adaptive_interval_ms", self._sync_interval * 1000.0)
            if self.sync == "adaptive":
                if batch > self._ADAPT_TARGET_BYTES:
                    self._sync_interval = min(self._sync_interval * 1.5, self._ADAPT_MAX_S)
                elif batch == 0:
                    self._sync_interval = max(self._sync_interval * 0.5, self._ADAPT_MIN_S)

    # ------------------------------------------------------------------

    def append_batch(self, dataset: str, table: arrow_ipc.Table) -> int:
        """Log a put as an Arrow IPC stream."""
        return self._append(dataset.encode(), KIND_BATCH, arrow_ipc.encode_stream(table))

    def append_op(self, dataset: str, op: dict) -> int:
        return self._append(dataset.encode(), KIND_OP, json.dumps(op).encode())

    def _append(self, name: bytes, kind: int, payload: bytes) -> int:
        reg = get_registry()
        with self._lock:
            self._seq += 1
            frame = _encode_frame(self._seq, time.time(), name, kind, payload)
            try:
                self._backend.write(frame)
            except OSError:
                reg.inc("longbow_wal_writes_total", status="error")
                raise
            reg.inc("longbow_wal_writes_total", status="ok")
            reg.inc("longbow_wal_bytes_written_total", len(frame))
            # "pending": bytes written but not yet fsynced
            reg.set("longbow_wal_pending_entries", self._bytes_since_sync + len(frame))
            self._bytes_since_sync += len(frame)
            self._total_bytes += len(frame)
            if self.sync == "always":
                self._backend.sync()
            else:
                self._dirty = True
            return self._seq

    def flush(self) -> None:
        with self._lock:
            self._backend.sync()
            self._dirty = False

    @property
    def size_bytes(self) -> int:
        return self._total_bytes

    @property
    def backend_name(self) -> str:
        return self._backend.name

    def truncate(self) -> None:
        """Drop every entry."""
        with self._lock:
            self._backend.truncate()
            self._dirty = False
            self._total_bytes = 0

    def close(self) -> None:
        self._stop.set()
        if self._fsync_thread:
            self._fsync_thread.join(timeout=2)
        self.flush()
        self._backend.close()

    # ------------------------------------------------------------------

    @staticmethod
    def replay(path: str | Path) -> Iterator[tuple[int, float, str, int, bytes]]:
        """Yield (seq, ts, dataset, kind, payload) for every clean frame;
        stops at the first corrupt or truncated one."""
        path = Path(path)
        if not path.exists():
            return
        buf = path.read_bytes()
        offsets, _ = _scan_frames(buf)
        for pos in offsets:
            _, seq, ts, nlen, kind, plen = _HDR.unpack_from(buf, pos)
            start = pos + _HDR.size
            name = buf[start: start + nlen].decode()
            yield seq, ts, name, kind, buf[start + nlen: start + nlen + plen]

    @staticmethod
    def decode_batch(payload: bytes) -> arrow_ipc.Table:
        return arrow_ipc.decode_stream(payload)
