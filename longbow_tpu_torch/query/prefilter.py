"""O(1) equality pre-filters: per-column bloom + inverted row index.

The reference keeps a ColumnInvertedIndex (dataset -> column -> value ->
[]RowPosition, reference: internal/store/column_inverted_index.go:47)
for O(1) equality lookups and bloom filters for cheap absent-value
rejection (bloom_filter.go:23, inverted_index_sharded.go:34).

Counterpart of longbow_tpu/query/prefilter.py (host-only numpy). These
structures answer equality predicates without a device compare per
value: the bloom rejects absent values instantly, the inverted index
turns present values into a row list that scatters into one bool mask
uploaded once (and LRU-cached by FilterCache like every other mask).
"""
from __future__ import annotations

import zlib

import numpy as np


def _h2(key: str) -> tuple[int, int]:
    """Two independent 32-bit hashes for double hashing
    (reference derives k probes as h1 + i*h2, bloom_filter.go:62)."""
    b = key.encode("utf-8", "surrogatepass")
    h1 = zlib.crc32(b)
    # adler32 with a seed: a different family than CRC, C-speed (the
    # ingest path calls this per novel value)
    h2 = zlib.adler32(b, 0xBEEF)
    return h1, h2 | 1  # odd step: full-period probing for pow2 sizes


class BloomFilter:
    """No-false-negative membership filter (reference:
    bloom_filter.go:23-118). Sized for `n` items at false-positive
    rate `p`; `grown()` returns a doubled-capacity empty filter so
    callers can scale by rebuilding from their backing dict."""

    def __init__(self, n: int = 10_000, p: float = 0.01):
        n = max(n, 1)
        m = int(np.ceil(-n * np.log(p) / (np.log(2) ** 2)))
        self.size = 1 << max(int(np.ceil(np.log2(max(m, 64)))), 6)
        self.num_hash = max(1, min(30, round(self.size / n * np.log(2))))
        self.bits = np.zeros(self.size // 64, np.uint64)
        self.capacity = n
        self.count = 0

    def add(self, key: str) -> None:
        h1, h2 = _h2(key)
        mask = self.size - 1
        for i in range(self.num_hash):
            bit = (h1 + i * h2) & mask
            self.bits[bit >> 6] |= np.uint64(1 << (bit & 63))
        self.count += 1

    def might_contain(self, key: str) -> bool:
        h1, h2 = _h2(key)
        mask = self.size - 1
        for i in range(self.num_hash):
            bit = (h1 + i * h2) & mask
            if not (self.bits[bit >> 6] >> np.uint64(bit & 63)) & np.uint64(1):
                return False
        return True

    def grown(self) -> "BloomFilter":
        return BloomFilter(self.capacity * 4, 0.01)


class ColumnPrefilter:
    """Per-column value -> row-array index with a bloom front.

    Rows accumulate as small np arrays per value (append batches touch
    each value once); `rows_for` concatenates lazily. Cardinality is
    capped — past `max_distinct` distinct values the dict would cost
    ~100B/row, so the index drops itself and equality falls back to
    the column-scan path (the bloom stays: absent-value rejection is
    the cheap half of the win and its memory is O(bits)).
    """

    def __init__(self, max_distinct: int = 2_000_000):
        self.max_distinct = max_distinct
        self.rows: dict[str, list] | None = {}
        self.bloom = BloomFilter(16_384)

    def add_batch(self, keys: np.ndarray, row_ids: np.ndarray) -> None:
        """keys: [n] str-like; row_ids: [n] int64 positions."""
        # grow by NOVEL-key count, not batch row count: a
        # low-cardinality column appended in 1M-row batches otherwise
        # quadruples the bloom every batch for zero accuracy gain
        novel = 0
        if self.rows is not None:
            seen = self.rows
            novel = sum(1 for k in set(keys.tolist()) if k not in seen)
        if (
            self.rows is not None
            and self.bloom.count + novel > self.bloom.capacity
        ):
            # rebuild a doubled filter from the backing dict; bloom-only
            # columns never grow (rehashing without the key set would
            # introduce false negatives) — their bits just saturate,
            # degrading toward the scan fallback but never lying
            nb = self.bloom.grown()
            for k in self.rows:
                nb.add(k)
            self.bloom = nb
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        sr = row_ids[order]
        bounds = np.flatnonzero(
            np.concatenate(([True], sk[1:] != sk[:-1]))
        )
        for j, start in enumerate(bounds):
            end = bounds[j + 1] if j + 1 < len(bounds) else len(sk)
            key = str(sk[start])
            if key not in (self.rows or ()):
                self.bloom.add(key)
            if self.rows is not None:
                self.rows.setdefault(key, []).append(sr[start:end])
                if len(self.rows) > self.max_distinct:
                    self.rows = None  # cardinality blowout: bloom-only

    def rows_for(self, key: str) -> np.ndarray | None:
        """Row positions for an exact value, or None when this column
        is bloom-only (caller falls back to the scan path). A bloom
        miss returns an empty array without touching the dict."""
        if not self.bloom.might_contain(str(key)):
            return np.empty((0,), np.int64)
        if self.rows is None:
            return None
        parts = self.rows.get(str(key))
        if parts is None:
            return np.empty((0,), np.int64)
        if len(parts) > 1:  # consolidate lazily
            parts = [np.concatenate(parts)]
            self.rows[str(key)] = parts
        return parts[0]
