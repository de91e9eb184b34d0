"""Durable storage: the WAL, snapshots and recovery.

Counterpart of longbow_tpu/storage/: CRC32C framing and scanning run in
a small C++ library (native_src/, built with g++ at first use), a put's
frame is an Arrow IPC stream (arrow_ipc.py, numpy only), snapshots are
npz plus JSON (version 2), and recovery imports the snapshot and then
replays the WAL, stopping at the first corrupt frame. Imports torch,
numpy and the standard library only; boto3 only inside S3Backend.
"""
from longbow_tpu_torch.storage.engine import StorageEngine  # noqa: F401
from longbow_tpu_torch.storage.wal import WAL  # noqa: F401
