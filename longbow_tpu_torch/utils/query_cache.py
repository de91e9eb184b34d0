"""Generic LRU+TTL query cache (reference: cache/query_cache.go:17,
cache_key.go:22 — xxhash-keyed; we use blake2b from stdlib, the hash
just needs to be fast and stable, not cryptographic). Counterpart of
longbow_tpu/utils/query_cache.py.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Any, Optional

from longbow_tpu_torch.metrics import get_registry

_COUNTERS: dict = {}


def _count(name: str) -> None:
    """Tick a pre-declared counter. The counter object is resolved once:
    re-resolving through the global registry lock on every cache get
    would nest two locks inside the per-search hot path."""
    c = _COUNTERS.get(name)
    if c is None:
        c = _COUNTERS[name] = get_registry().counter(name)
    c.inc()


class QueryCache:
    def __init__(self, max_entries: int = 1024, ttl_s: float = 60.0):
        self.max_entries = max_entries
        self.ttl_s = ttl_s
        self._d: OrderedDict[str, tuple[float, Any]] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def hash_query(*parts) -> str:
        h = hashlib.blake2b(digest_size=16)
        for p in parts:
            if isinstance(p, bytes):
                h.update(p)
            else:
                h.update(repr(p).encode())
            h.update(b"\x00")
        return h.hexdigest()

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            item = self._d.get(key)
            if item is None:
                self.misses += 1
                _count("longbow_query_cache_misses_total")
                return None
            ts, val = item
            if time.time() - ts > self.ttl_s:
                del self._d[key]
                self.misses += 1
                _count("longbow_query_cache_misses_total")
                return None
            self._d.move_to_end(key)
            self.hits += 1
            _count("longbow_query_cache_hits_total")
            return val

    def put(self, key: str, val: Any) -> None:
        with self._lock:
            self._d[key] = (time.time(), val)
            self._d.move_to_end(key)
            while len(self._d) > self.max_entries:
                self._d.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def stats(self) -> dict:
        return {
            "entries": len(self._d),
            "hits": self.hits,
            "misses": self.misses,
        }
