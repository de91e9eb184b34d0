"""Vector clocks + split-brain detection.

Counterpart of longbow_tpu/distributed/vector_clock.py (a copy).

reference: vector_clock.go:23, split_brain_detector.go:25.
"""
from __future__ import annotations

from typing import Optional


class VectorClock:
    def __init__(self, clock: Optional[dict] = None):
        self.clock: dict[str, int] = dict(clock or {})

    def tick(self, node: str) -> "VectorClock":
        self.clock[node] = self.clock.get(node, 0) + 1
        return self

    def merge(self, other: "VectorClock") -> "VectorClock":
        for n, c in other.clock.items():
            self.clock[n] = max(self.clock.get(n, 0), c)
        return self

    def compare(self, other: "VectorClock") -> str:
        """-> 'before' | 'after' | 'equal' | 'concurrent'."""
        keys = set(self.clock) | set(other.clock)
        le = all(self.clock.get(k, 0) <= other.clock.get(k, 0) for k in keys)
        ge = all(self.clock.get(k, 0) >= other.clock.get(k, 0) for k in keys)
        if le and ge:
            return "equal"
        if le:
            return "before"
        if ge:
            return "after"
        return "concurrent"

    def to_dict(self) -> dict:
        return dict(self.clock)

    @classmethod
    def from_dict(cls, d: dict) -> "VectorClock":
        return cls(d)


class SplitBrainDetector:
    """Detects partitioned membership views: if two live peers disagree
    about a third peer's liveness past a tolerance window, flag it
    (reference: split_brain_detector.go:25)."""

    def __init__(self, quorum_fraction: float = 0.5):
        self.quorum_fraction = quorum_fraction

    def check(self, my_view: dict, peer_views: dict) -> dict:
        """my_view: {node: alive_bool}; peer_views: {peer: {node: bool}}.
        Returns {"split_brain": bool, "suspects": [...], "have_quorum": bool}.
        """
        total = len(my_view)
        alive_mine = sum(my_view.values())
        have_quorum = alive_mine / max(total, 1) > self.quorum_fraction
        suspects = []
        for node, mine in my_view.items():
            disagree = sum(
                1
                for view in peer_views.values()
                if node in view and view[node] != mine
            )
            if disagree:
                suspects.append(node)
        return {
            "split_brain": bool(suspects) and not have_quorum,
            "suspects": suspects,
            "have_quorum": have_quorum,
        }
