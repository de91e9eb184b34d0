"""Content-based query routing over peer data regions.

Counterpart of longbow_tpu/distributed/spatial.py (a copy; the region
summary reads the index's host rows and runs no device op).

reference: internal/mesh/spatial_index.go (VP-tree over region
centroids) + region.go (Router.Route → peers whose region might hold
candidates for a query). A VP-tree earns its keep in Go where every
distance is a pointer-chasing function call; here the whole routing
table is one [P, D] numpy matrix and a single vectorized distance
computation beats tree traversal until far past realistic peer counts
— so the "index" IS the matrix.

Routing is APPROXIMATE by design (the reference routes with the same
centroid+radius ± epsilon heuristic): a peer whose region does not
overlap the query ball can still own a true top-k row when data is not
cleanly partitioned. It is therefore opt-in (LONGBOW_SPATIAL_ROUTING=1)
and fails open — peers with no fresh summary are always fanned to.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

# summaries older than this are treated as absent (fail open)
DEFAULT_TTL_S = 180.0
# region radius slack: sampled radii underestimate the true max
# distance-to-centroid, and clusters drift between refreshes
DEFAULT_MARGIN = 1.5


@dataclass
class RegionSummary:
    peer_id: str
    dataset: str
    centroid: np.ndarray  # [D] f32
    radius: float
    n: int
    ts: float = field(default_factory=time.time)


def dataset_region(ds, sample: int = 4096) -> dict:
    """Summarize a dataset as centroid + radius over a row sample
    (the region the reference's mesh advertises per owner,
    region.go:11-16). Host numpy end to end — this runs on a slow
    timer and must not queue device work beside the serving path
    (get_vectors reads the index's host rows)."""
    with ds._lock:
        rows = ds.live_rows()[1]
        idx = ds.index
    if rows.size == 0:
        return {"centroid": [], "radius": 0.0, "n": 0}
    if rows.size > sample:
        # deterministic stride sample: cheap, covers insertion order
        rows = rows[:: max(1, rows.size // sample)][:sample]
    vecs = np.asarray(idx.get_vectors(rows), np.float32)
    centroid = vecs.mean(axis=0)
    radius = float(np.sqrt(
        ((vecs - centroid) ** 2).sum(axis=1).max()
    ))
    return {
        "centroid": centroid.tolist(),
        "radius": radius,
        "n": int(rows.size),
    }


class RegionRouter:
    """Vectorized routing table: peer regions in, peer subset out."""

    def __init__(
        self, *, margin: float = DEFAULT_MARGIN,
        ttl_s: float = DEFAULT_TTL_S,
    ):
        self.margin = float(margin)
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        # (peer_id, dataset) -> RegionSummary
        self._summaries: dict[tuple[str, str], RegionSummary] = {}
        # dataset -> (peer_ids list, centroids [P,D], radii [P]) cache
        self._cache: dict[str, tuple] = {}

    def update(
        self, peer_id: str, dataset: str, centroid, radius: float,
        n: int,
    ) -> None:
        c = np.asarray(centroid, np.float32)
        with self._lock:
            self._summaries[(peer_id, dataset)] = RegionSummary(
                peer_id, dataset, c, float(radius), int(n)
            )
            self._cache.pop(dataset, None)

    def drop_peer(self, peer_id: str) -> None:
        with self._lock:
            for key in [
                k for k in self._summaries if k[0] == peer_id
            ]:
                self._cache.pop(key[1], None)
                del self._summaries[key]

    def _table(self, dataset: str):
        now = time.time()
        with self._lock:
            hit = self._cache.get(dataset)
            if hit is not None and now - hit[3] < 5.0:
                return hit[:3]
            entries = [
                s for (p, d), s in self._summaries.items()
                if d == dataset
                and now - s.ts < self.ttl_s
                and s.centroid.size
            ]
            if not entries:
                self._cache[dataset] = (None, None, None, now)
                return None, None, None
            ids = [s.peer_id for s in entries]
            cents = np.stack([s.centroid for s in entries])
            radii = np.asarray([s.radius for s in entries], np.float32)
            self._cache[dataset] = (ids, cents, radii, now)
            return ids, cents, radii

    def route(
        self, dataset: str, queries: np.ndarray, peer_ids,
        metric: str = "l2",
    ):
        """Subset of peer_ids worth fanning a search to. A peer is
        skipped ONLY when a fresh summary proves every query in the
        batch lies outside its region ball * margin — no summary (or
        an empty one) means the peer is always included (fail open).
        Returns (kept_ids, skipped_count).

        Ball geometry is only meaningful under L2. Cosine datasets
        store normalized vectors (summaries are unit-ball), so the
        query must be normalized to match before the distance test.
        Dot/MIPS has no distance geometry at all — a top-inner-product
        row can live in any L2-distant region — so routing fails open
        (every peer kept), as does an unknown metric."""
        m = (metric or "").lower()
        if m not in ("l2", "euclidean", "cosine"):
            return list(peer_ids), 0  # no valid ball geometry: fail open
        ids, cents, radii, = self._table(dataset)
        if ids is None:
            return list(peer_ids), 0
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if m == "cosine":
            norms = np.linalg.norm(q, axis=1, keepdims=True)
            q = q / np.maximum(norms, 1e-30)
        if cents.shape[1] != q.shape[1]:
            return list(peer_ids), 0  # dim drift: fail open
        # [B, P] distances, one BLAS call
        d2 = (
            (q * q).sum(axis=1)[:, None]
            - 2.0 * (q @ cents.T)
            + (cents * cents).sum(axis=1)[None, :]
        )
        dmin = np.sqrt(np.maximum(d2, 0.0)).min(axis=0)  # [P]
        keep_map = {
            pid: bool(dmin[j] <= radii[j] * self.margin)
            for j, pid in enumerate(ids)
        }
        kept = [p for p in peer_ids if keep_map.get(p, True)]
        return kept, len(peer_ids) - len(kept)
