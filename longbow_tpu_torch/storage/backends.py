"""Snapshot backends: local filesystem + S3-compatible object storage.

Counterpart of longbow_tpu/storage/backends.py (a copy): the
SnapshotBackend interface, LocalBackend, an S3/MinIO/R2 backend with an
injectable client (boto3, imported only when no client is given) and a
fire-and-forget wrapper. Every S3 call is timed and counted in the
longbow_s3_* metrics, with bounded retries.
"""
from __future__ import annotations

import shutil
import threading
from pathlib import Path
from typing import Optional, Protocol

from longbow_tpu_torch.metrics import get_registry


class SnapshotBackend(Protocol):
    def upload(self, local_dir: Path, remote_prefix: str) -> None: ...
    def download(self, remote_prefix: str, local_dir: Path) -> bool: ...
    def list_snapshots(self) -> list[str]: ...


class LocalBackend:
    """Copies snapshots to another directory (NFS mount, etc.)."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def upload(self, local_dir: Path, remote_prefix: str) -> None:
        dst = self.root / remote_prefix
        if dst.exists():
            shutil.rmtree(dst)
        shutil.copytree(local_dir, dst)

    def download(self, remote_prefix: str, local_dir: Path) -> bool:
        src = self.root / remote_prefix
        if not src.exists():
            return False
        if local_dir.exists():
            shutil.rmtree(local_dir)
        shutil.copytree(src, local_dir)
        return True

    def list_snapshots(self) -> list[str]:
        return sorted(p.name for p in self.root.iterdir() if p.is_dir())


def _s3_op(operation: str, retries: int = 2):
    """Decorator timing + counting an S3 call (reference metric names
    longbow_s3_*, docs/metrics.md WAL & Persistence) with bounded
    retries (reference: s3_backend.go retry loop)."""
    import functools
    import time as _time

    def wrap(fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            reg = get_registry()
            last = None
            for attempt in range(retries + 1):
                if attempt:
                    reg.inc("longbow_s3_retries_total", operation=operation)
                t0 = _time.perf_counter()
                try:
                    out = fn(*a, **kw)
                except Exception as e:  # noqa: BLE001 — boto errs vary
                    last = e
                    reg.inc(
                        "longbow_s3_operations_total",
                        operation=operation, status="error",
                    )
                    continue
                reg.inc(
                    "longbow_s3_operations_total",
                    operation=operation, status="ok",
                )
                reg.observe(
                    "longbow_s3_request_duration_seconds",
                    _time.perf_counter() - t0,
                    operation=operation,
                )
                return out
            raise last

        return run

    return wrap


class S3Backend:
    """S3/MinIO/R2 snapshot storage (reference: s3_backend.go:33)."""

    def __init__(
        self,
        bucket: str,
        prefix: str = "longbow",
        endpoint_url: Optional[str] = None,
        client=None,
    ):
        """client: injectable S3 client (upload_file / download_file /
        get_paginator surface) — tests exercise the full backend with a
        fake; production passes None and gets boto3."""
        self.bucket = bucket
        self.prefix = prefix
        if client is not None:
            self.client = client
            return
        try:
            import boto3
        except ImportError as e:
            raise RuntimeError(
                "S3 backend needs boto3; install it or use LocalBackend"
            ) from e
        self.client = boto3.client("s3", endpoint_url=endpoint_url)

    @_s3_op("upload")
    def upload(self, local_dir: Path, remote_prefix: str) -> None:
        for p in Path(local_dir).rglob("*"):
            if p.is_file():
                key = f"{self.prefix}/{remote_prefix}/{p.relative_to(local_dir)}"
                self.client.upload_file(str(p), self.bucket, key)

    @_s3_op("download")
    def download(self, remote_prefix: str, local_dir: Path) -> bool:
        pre = f"{self.prefix}/{remote_prefix}/"
        pages = self.client.get_paginator("list_objects_v2").paginate(
            Bucket=self.bucket, Prefix=pre
        )
        found = False
        for page in pages:
            for obj in page.get("Contents", []):
                found = True
                rel = obj["Key"][len(pre):]
                dst = Path(local_dir) / rel
                dst.parent.mkdir(parents=True, exist_ok=True)
                self.client.download_file(self.bucket, obj["Key"], str(dst))
        return found

    @_s3_op("list")
    def list_snapshots(self) -> list[str]:
        out = set()
        pages = self.client.get_paginator("list_objects_v2").paginate(
            Bucket=self.bucket, Prefix=f"{self.prefix}/", Delimiter="/"
        )
        for page in pages:
            for cp in page.get("CommonPrefixes", []):
                out.add(cp["Prefix"].split("/")[-2])
        return sorted(out)


class AsyncBackend:
    """Fire-and-forget wrapper (reference: async S3 wrapper)."""

    def __init__(self, inner: SnapshotBackend):
        self.inner = inner
        self._threads: list[threading.Thread] = []

    def upload(self, local_dir: Path, remote_prefix: str) -> None:
        t = threading.Thread(
            target=self.inner.upload, args=(local_dir, remote_prefix),
            daemon=True,
        )
        t.start()
        self._threads.append(t)

    def download(self, remote_prefix: str, local_dir: Path) -> bool:
        return self.inner.download(remote_prefix, local_dir)

    def list_snapshots(self) -> list[str]:
        return self.inner.list_snapshots()

    def wait(self, timeout: float = 60.0) -> None:
        for t in self._threads:
            t.join(timeout=timeout)
