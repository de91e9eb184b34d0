"""Input sanitizing, audit logging and transport security.

Counterpart of longbow_tpu/serving/security.py (reference:
security/input_sanitizer.go:9-62, audit.go:16-32; the reference SDK
sends `Bearer <api_key>` call headers and deployments assume TLS,
longbowclientsdk/src/longbow/client.py:63-70, docs/security.md).
pyarrow.flight is imported only inside the bearer middleware, which
only a Flight server uses.
"""
from __future__ import annotations

import hmac
import json
import re
import threading
import time
from pathlib import Path
from typing import Optional

MAX_DATASET_NAME = 256
MAX_K = 10_000
MAX_QUERY_VECTORS = 4096
MAX_FILTERS = 64
_NAME_RE = re.compile(r"^[A-Za-z0-9._/\-]+$")


class SanitizationError(ValueError):
    pass


def sanitize_dataset_name(name: str) -> str:
    """Reject path traversal / control characters in dataset names
    (names become snapshot directory components)."""
    if not name or len(name) > MAX_DATASET_NAME:
        raise SanitizationError("dataset name empty or too long")
    if ".." in name or name.startswith("/"):
        raise SanitizationError("dataset name must not traverse paths")
    if not _NAME_RE.match(name):
        raise SanitizationError(
            "dataset name may only contain [A-Za-z0-9._/-]"
        )
    return name


def sanitize_search_request(req) -> None:
    """Bounds-check a parsed VectorSearchRequest."""
    if req.k > MAX_K:
        raise SanitizationError(f"k {req.k} exceeds limit {MAX_K}")
    # len()-based (never truthiness): the fast-path parser stores query
    # vectors as np.ndarray, whose bool() raises for >1 element
    nq = 0 if req.vectors is None else len(req.vectors)
    if not nq and req.vector is not None and len(req.vector):
        nq = 1
    if nq > MAX_QUERY_VECTORS:
        raise SanitizationError(
            f"{nq} query vectors exceeds limit {MAX_QUERY_VECTORS}"
        )
    if len(req.filters) > MAX_FILTERS:
        raise SanitizationError("too many filters")
    sanitize_dataset_name(req.dataset)


class AuditLogger:
    """Append-only JSONL audit trail of mutating operations
    (reference: security/audit.go:16-32)."""

    def __init__(self, path: Optional[str | Path] = None):
        self.path = Path(path) if path else None
        self._lock = threading.Lock()
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def record(self, op: str, dataset: str, detail: Optional[dict] = None):
        if self.path is None:
            return
        entry = {
            "ts": round(time.time(), 6),
            "op": op,
            "dataset": dataset,
            **(detail or {}),
        }
        with self._lock, open(self.path, "a") as f:
            f.write(json.dumps(entry, default=str) + "\n")


# -- transport security (reference: SDK bearer headers client.py:63-70,
#    docs/security.md TLS) ---------------------------------------------

def _load_bearer_middleware():
    """The middleware factory class, with pyarrow.flight loaded here and
    not at import (security.py also serves code paths that must not need
    grpc)."""
    import pyarrow.flight as flight

    class BearerTokenMiddlewareFactory(flight.ServerMiddlewareFactory):
        """Rejects every call that doesn't carry a valid
        `authorization: Bearer <token>` header. Constant-time compare;
        tokens may be rotated by passing several accepted values."""

        def __init__(self, tokens):
            self.tokens = [t for t in tokens if t]

        def start_call(self, info, headers):
            vals = []
            for k, v in headers.items():
                if (k.lower() if isinstance(k, str) else k) == "authorization":
                    vals = v if isinstance(v, (list, tuple)) else [v]
                    break
            for v in vals:
                if isinstance(v, bytes):
                    v = v.decode("utf-8", "replace")
                if not v.startswith("Bearer "):
                    continue
                presented = v[len("Bearer "):]
                for tok in self.tokens:
                    if hmac.compare_digest(presented, tok):
                        return None
            raise flight.FlightUnauthenticatedError(
                "missing or invalid bearer token"
            )

    return BearerTokenMiddlewareFactory


def bearer_middleware(tokens) -> dict:
    """-> the `middleware=` dict for FlightServerBase."""
    factory = _load_bearer_middleware()(tokens)
    return {"auth": factory}


def load_tls_certificates(cert_file: str, key_file: str):
    """-> the `tls_certificates=` list for FlightServerBase."""
    with open(cert_file, "rb") as f:
        cert = f.read()
    with open(key_file, "rb") as f:
        key = f.read()
    return [(cert, key)]
