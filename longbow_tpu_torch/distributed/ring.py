"""Consistent-hash ring for partitioned placement.

Counterpart of longbow_tpu/distributed/ring.py (the same hashing, so that
both packages place a key on the same node).

reference: sharding/ring.go:15-309 — SHA-256 ring, 20 vnodes per node,
clockwise key assignment, `GetPreferenceList(key, n)` distinct-node
replica walk. The replicated deployment mode doesn't need a ring (every
node holds everything and reads merge freshness); partitioned mode
routes each row id to its owner through this ring so the corpus can
exceed one node's HBM.
"""
from __future__ import annotations

import bisect
import hashlib


class ConsistentHashRing:
    def __init__(self, nodes=(), vnodes: int = 20):
        self.vnodes = vnodes
        self.nodes: set[str] = set()
        self._keys: list[int] = []      # sorted vnode hashes
        self._owners: list[str] = []    # node per vnode, aligned
        for n in nodes:
            self.add(n)

    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(
            hashlib.sha256(s.encode()).digest()[:8], "big"
        )

    def add(self, node: str) -> None:
        if node in self.nodes:
            return
        self.nodes.add(node)
        for v in range(self.vnodes):
            h = self._hash(f"{node}#{v}")
            i = bisect.bisect_left(self._keys, h)
            self._keys.insert(i, h)
            self._owners.insert(i, node)

    def remove(self, node: str) -> None:
        if node not in self.nodes:
            return
        self.nodes.discard(node)
        keep = [
            (h, o)
            for h, o in zip(self._keys, self._owners)
            if o != node
        ]
        self._keys = [h for h, _ in keep]
        self._owners = [o for _, o in keep]

    def lookup(self, key: str) -> str:
        """Clockwise owner of key (reference: ring.go key assignment)."""
        if not self._keys:
            raise ValueError("empty ring")
        i = bisect.bisect_right(self._keys, self._hash(key))
        return self._owners[i % len(self._owners)]

    def preference_list(self, key: str, n: int) -> list[str]:
        """First n DISTINCT nodes walking clockwise from key
        (reference: GetPreferenceList replica walk)."""
        if not self._keys:
            return []
        out: list[str] = []
        start = bisect.bisect_right(self._keys, self._hash(key))
        for step in range(len(self._owners)):
            o = self._owners[(start + step) % len(self._owners)]
            if o not in out:
                out.append(o)
                if len(out) >= n:
                    break
        return out
