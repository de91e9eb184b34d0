"""Merkle tree over dataset content for anti-entropy.

Counterpart of longbow_tpu/distributed/merkle.py, byte for byte: a node of
either package that holds the same rows under the same LWW timestamps
gives the same root.

reference: merkle.go:21 (per-dataset tree, store.go:456-490 updates),
mesh/sync/sync_worker.go:41-250 (background root comparison + delta
sync). Leaves are fixed buckets by id hash; a leaf hash covers the
sorted (id, lww_ts, deleted) triples in that bucket, so two replicas
can find divergent buckets in O(log leaves) root/level compares and
exchange only those buckets' rows.
"""
from __future__ import annotations

import hashlib
import struct
from typing import Iterable

N_BUCKETS = 256


def _h(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=16).digest()


def bucket_of(uid) -> int:
    raw = str(uid).encode()
    return int.from_bytes(_h(raw)[:4], "little") % N_BUCKETS


class MerkleTree:
    """Built from a dataset's id->lww-timestamp map (tombstones carry a
    timestamp but no row, so deletions propagate too)."""

    def __init__(self, leaf_hashes: list[bytes]):
        assert len(leaf_hashes) == N_BUCKETS
        self.leaves = leaf_hashes
        level = leaf_hashes
        self.levels = [level]
        while len(level) > 1:
            level = [
                _h(level[i] + level[i + 1]) for i in range(0, len(level), 2)
            ]
            self.levels.append(level)

    @property
    def root(self) -> bytes:
        return self.levels[-1][0]

    @classmethod
    def from_dataset(cls, dataset) -> "MerkleTree":
        """The same leaves as the reference's, computed with less Python a
        row: the uids come grouped by the dataset's cached bucket map (so a
        root does not hash every uid into its bucket again), and each leaf
        is one blake2b over its items' concatenated bytes (equal to the
        reference's update per field)."""
        # snapshot under the dataset lock: iterating the live _lww dict
        # races concurrent ingest
        with dataset._lock:
            live = dataset._id_to_row
            lww = dataset._lww
            groups = dataset._bucket_map()
            buckets = [
                [(str(uid), lww[uid], uid not in live) for uid in groups.get(b, ())]
                for b in range(N_BUCKETS)
            ]
        pack = struct.Struct("<dB").pack
        leaves = []
        for items in buckets:
            items.sort()
            leaves.append(_h(b"".join([uid.encode() + pack(ts, deleted)
                                       for uid, ts, deleted in items])))
        return cls(leaves)

    def diff_buckets(self, other_leaves: Iterable[bytes]) -> list[int]:
        """Bucket indices whose leaf hashes differ."""
        return [
            i
            for i, (a, b) in enumerate(zip(self.leaves, other_leaves))
            if a != b
        ]

    def leaves_hex(self) -> list[str]:
        return [leaf.hex() for leaf in self.leaves]

    @property
    def root_hex(self) -> str:
        return self.root.hex()
