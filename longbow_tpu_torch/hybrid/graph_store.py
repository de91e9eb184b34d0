"""GraphRAG edge store: typed weighted edges + traversal + re-ranking.

Counterpart of longbow_tpu/hybrid/graph_store.py (standard library only).

reference: GraphStore (graph_store.go:11), GraphNavigator BFS/A*/
parallel strategies + LRU path cache (graph_navigator.go:25,149,
navigator_strategy_astar.go:11, navigator_strategy_parallel.go),
graph analytics (graph_analytics.go), disk-backed edges
(disk_graph.go:19), spreading-activation RankWithGraph
(docs/vectorsearch.md:266-279).
"""
from __future__ import annotations

import heapq
import logging
import threading
from collections import OrderedDict, defaultdict, deque
from typing import Callable, Optional

log = logging.getLogger("longbow.graph")

PATH_CACHE_SIZE = 1024


class GraphStore:
    def __init__(self):
        self._adj: dict = defaultdict(list)   # from -> [(to, type, weight)]
        self._radj: dict = defaultdict(list)  # reverse adjacency
        self._edge_count = 0
        self._lock = threading.Lock()
        # LRU path cache, invalidated by writes (reference:
        # graph_navigator.go:149 path caching)
        self._path_cache: OrderedDict = OrderedDict()

    def add_edge(self, src, dst, edge_type: str = "", weight: float = 1.0):
        with self._lock:
            self._adj[src].append((dst, edge_type, weight))
            self._radj[dst].append((src, edge_type, weight))
            self._edge_count += 1
            self._path_cache.clear()

    def neighbors(self, node) -> list:
        return list(self._adj.get(node, ()))

    def traverse_paths(
        self,
        start,
        max_hops: int = 2,
        incoming: bool = False,
        weighted: bool = True,
        decay: float = 0.0,
        max_paths: int = 10_000,
    ) -> list[dict]:
        """All simple paths from `start` up to max_hops, in the
        reference's wire shape [{Nodes, Edges, Score}] (reference:
        GraphStore.Traverse graph_store.go:193-380 — BFS layer
        expansion, per-path cycle check, weight/decay scoring).
        max_paths bounds fan-out explosion (logged, not silent)."""
        adj = self._radj if incoming else self._adj
        results: list[dict] = []
        queue: deque = deque([([start], [], 1.0)])
        while queue and len(results) < max_paths:
            nodes, edges, score = queue.popleft()
            if len(nodes) > 1:
                results.append(
                    {"Nodes": nodes, "Edges": edges, "Score": score}
                )
            if len(nodes) - 1 >= max_hops:
                continue
            last = nodes[-1]
            for nbr, etype, w in adj.get(last, ()):
                if nbr in nodes:  # per-path cycle check
                    continue
                s = score * (w if weighted else 1.0)
                if decay:
                    s *= 1.0 - decay
                edge = {
                    "Subject": nbr if incoming else last,
                    "Predicate": etype,
                    "Object": last if incoming else nbr,
                    "Weight": w,
                }
                queue.append((nodes + [nbr], edges + [edge], s))
        if queue:
            log.warning(
                "traverse from %r truncated at %d paths", start, max_paths
            )
        return results

    def stats(self) -> dict:
        return {
            "nodes": len(set(self._adj) | set(self._radj)),
            "edges": self._edge_count,
        }

    # -- traversal (reference: graph_navigator.go strategies) --

    def _cached(self, key, compute):
        with self._lock:
            if key in self._path_cache:
                self._path_cache.move_to_end(key)
                return self._path_cache[key]
        out = compute()
        with self._lock:
            self._path_cache[key] = out
            while len(self._path_cache) > PATH_CACHE_SIZE:
                self._path_cache.popitem(last=False)
        return out

    def find_path(
        self,
        src,
        dst,
        max_hops: int = 3,
        strategy: str = "bfs",
        heuristic: Optional[Callable] = None,
    ) -> Optional[list]:
        """Strategy dispatch + LRU path cache (reference:
        GraphNavigator.FindPath, graph_navigator.go:25,149).
        strategies: bfs | weighted (Dijkstra) | astar (needs a
        heuristic(node, dst) -> float, e.g. vector distance)."""
        key = (src, dst, max_hops, strategy)
        if strategy == "bfs":
            return self._cached(
                key, lambda: self.bfs_path(src, dst, max_hops)
            )
        if strategy == "weighted":
            return self._cached(
                key, lambda: self.weighted_path(src, dst, max_hops)
            )
        if strategy == "astar":
            if heuristic is None:
                return self._cached(
                    key, lambda: self.weighted_path(src, dst, max_hops)
                )
            # heuristic-guided: don't cache across heuristic objects
            return self.astar_path(src, dst, max_hops, heuristic)
        raise ValueError(f"unknown path strategy {strategy!r}")

    def bfs_path(self, src, dst, max_hops: int = 3) -> Optional[list]:
        """Shortest path by hop count; None if unreachable."""
        if src == dst:
            return [src]
        seen = {src}
        q = deque([(src, [src])])
        while q:
            node, path = q.popleft()
            if len(path) > max_hops:
                continue
            for to, _, _ in self._adj.get(node, ()):
                if to in seen:
                    continue
                if to == dst:
                    return path + [to]
                seen.add(to)
                q.append((to, path + [to]))
        return None

    def traverse(self, src, max_hops: int = 3) -> list:
        """BFS frontier expansion -> list of (node, hops)."""
        out = []
        seen = {src}
        q = deque([(src, 0)])
        while q:
            node, hops = q.popleft()
            if hops >= max_hops:
                continue
            for to, _, _ in self._adj.get(node, ()):
                if to not in seen:
                    seen.add(to)
                    out.append((to, hops + 1))
                    q.append((to, hops + 1))
        return out

    def weighted_path(self, src, dst, max_hops: int = 6) -> Optional[list]:
        """Dijkstra on 1/weight costs (the A* strategy's degenerate
        form without coordinates, navigator_strategy_astar.go:11)."""
        pq = [(0.0, src, [src])]
        # best is keyed on (node, hops): pruning on node alone lets a
        # CHEAP path that exhausts the hop budget block a feasible
        # within-budget path, wrongly returning None (and caching it)
        best = {(src, 0): 0.0}
        while pq:
            cost, node, path = heapq.heappop(pq)
            if node == dst:
                return path
            hops = len(path) - 1
            if hops >= max_hops:
                continue
            for to, _, w in self._adj.get(node, ()):
                c = cost + 1.0 / max(w, 1e-9)
                key = (to, hops + 1)
                if c < best.get(key, float("inf")):
                    best[key] = c
                    heapq.heappush(pq, (c, to, path + [to]))
        return None

    def astar_path(
        self, src, dst, max_hops: int, heuristic: Callable
    ) -> Optional[list]:
        """A* with a caller-supplied heuristic(node, dst) -> float
        (reference: navigator_strategy_astar.go:11 — the vector-store
        navigator uses embedding distance as the guide). Edge cost is
        1/weight like the Dijkstra strategy; the heuristic guides
        expansion order (guided search, as in the reference — not
        guaranteed admissible)."""
        if src == dst:
            return [src]
        pq = [(heuristic(src, dst), 0.0, src, [src])]
        best = {(src, 0): 0.0}  # (node, hops): see weighted_path
        while pq:
            _, g, node, path = heapq.heappop(pq)
            if node == dst:
                return path
            hops = len(path) - 1
            if hops >= max_hops:
                continue
            for to, _, w in self._adj.get(node, ()):
                g2 = g + 1.0 / max(w, 1e-9)
                key = (to, hops + 1)
                if g2 < best.get(key, float("inf")):
                    best[key] = g2
                    heapq.heappush(
                        pq, (g2 + heuristic(to, dst), g2, to, path + [to])
                    )
        return None

    def parallel_bfs(self, sources, max_hops: int = 3) -> dict:
        """Multi-source frontier BFS (reference:
        navigator_strategy_parallel.go — goroutine-parallel BFS; here
        one frontier sweep carries every source, which is the
        batched/vectorized shape of the same work).
        -> {node: (hops, origin_source)} for every reached node."""
        out: dict = {}
        frontier = []
        for s in sources:
            if s not in out:
                out[s] = (0, s)
                frontier.append(s)
        hops = 0
        while frontier and hops < max_hops:
            hops += 1
            nxt = []
            for node in frontier:
                origin = out[node][1]
                for to, _, _ in self._adj.get(node, ()):
                    if to not in out:
                        out[to] = (hops, origin)
                        nxt.append(to)
            frontier = nxt
        return out

    # -- analytics (reference: graph_analytics.go) ---------------------

    def analytics(self, top_hubs: int = 10) -> dict:
        """Degree stats, hubs, weakly-connected components."""
        with self._lock:
            adj = {k: list(v) for k, v in self._adj.items()}
            radj = {k: list(v) for k, v in self._radj.items()}
        nodes = set(adj) | set(radj)
        out_deg = {n: len(adj.get(n, ())) for n in nodes}
        in_deg = {n: len(radj.get(n, ())) for n in nodes}
        n = len(nodes)
        # weakly connected components via undirected union traversal
        seen: set = set()
        comp_sizes = []
        for start in nodes:
            if start in seen:
                continue
            size = 0
            stack = [start]
            seen.add(start)
            while stack:
                u = stack.pop()
                size += 1
                for to, _, _ in adj.get(u, ()):
                    if to not in seen:
                        seen.add(to)
                        stack.append(to)
                for fr, _, _ in radj.get(u, ()):
                    if fr not in seen:
                        seen.add(fr)
                        stack.append(fr)
            comp_sizes.append(size)
        hubs = sorted(out_deg.items(), key=lambda kv: -kv[1])[:top_hubs]
        return {
            "nodes": n,
            "edges": self._edge_count,
            "density": (
                self._edge_count / (n * (n - 1)) if n > 1 else 0.0
            ),
            "max_out_degree": max(out_deg.values(), default=0),
            "max_in_degree": max(in_deg.values(), default=0),
            "avg_out_degree": (
                sum(out_deg.values()) / n if n else 0.0
            ),
            "components": len(comp_sizes),
            "largest_component": max(comp_sizes, default=0),
            "top_hubs": [[h, d] for h, d in hubs],
        }

    # -- spreading activation re-rank --

    def rank_with_graph(
        self,
        results: list[tuple],
        graph_alpha: float,
        hops: int = 2,
        decay: float = 0.5,
    ) -> list[tuple]:
        """Blend similarity with graph activation spread from the
        result set (reference: RankWithGraph,
        docs/vectorsearch.md:266-279). results: [(id, similarity)]."""
        if not results or graph_alpha <= 0.0:
            return results
        sim = dict(results)
        lo, hi = min(sim.values()), max(sim.values())
        span = (hi - lo) or 1.0
        act: dict = defaultdict(float)
        frontier = {d: (s - lo) / span for d, s in sim.items()}
        for _ in range(hops):
            nxt: dict = defaultdict(float)
            for node, energy in frontier.items():
                for to, _, w in self._adj.get(node, ()):
                    nxt[to] += energy * decay * w
            for n, e in nxt.items():
                act[n] += e
            frontier = nxt
        fused = []
        for d, s in results:
            norm = (s - lo) / span
            fused.append((d, (1 - graph_alpha) * norm + graph_alpha * act.get(d, 0.0)))
        fused.sort(key=lambda kv: -kv[1])
        return fused

    def export_state(self) -> dict:
        return {
            "edges": [
                (f, t, ty, w)
                for f, lst in self._adj.items()
                for (t, ty, w) in lst
            ]
        }

    @classmethod
    def import_state(cls, st: dict) -> "GraphStore":
        g = cls()
        for f, t, ty, w in st.get("edges", []):
            g.add_edge(f, t, ty, w)
        return g


class _DiskAdjView:
    """Mapping-shaped adjacency view over a DiskGraphStore's offset
    index, so the base-class traversal algorithms work unchanged.
    Persistent instance — no per-access class construction."""

    def __init__(self, store, incoming: bool):
        self._store = store
        self._incoming = incoming

    def get(self, node, default=()):
        st = self._store
        if self._incoming:
            rows = st._read(st._roffsets.get(node, ()))
            return [(src, ty, w) for src, _, ty, w in rows] or default
        rows = st._read(st._offsets.get(node, ()))
        return [(dst, ty, w) for _, dst, ty, w in rows] or default


class DiskGraphStore(GraphStore):
    """Disk-backed edge store (reference: disk_graph.go:19): edge
    payloads live in an append-only log file; RAM holds only
    node -> [file offset] indexes. Adjacency reads seek the log, so
    RAM stays O(edges * 8B) instead of O(edges * payload).
    Crash-safe: a torn tail line is TRUNCATED on open (appending after
    it would merge records and silently drop every later edge at the
    next replay)."""

    def __init__(self, path):
        super().__init__()
        import json as _json
        from pathlib import Path as _Path

        self._json = _json
        self.path = _Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._offsets: dict = defaultdict(list)   # src -> [offset]
        self._roffsets: dict = defaultdict(list)  # dst -> [offset]
        # mapping-shaped views let GraphStore's BFS/Dijkstra/A*/
        # spreading-activation run unchanged over the disk log
        self._adj = _DiskAdjView(self, incoming=False)
        self._radj = _DiskAdjView(self, incoming=True)
        if self.path.exists():
            self._replay()
        self._f = open(self.path, "ab")
        self._rf = open(self.path, "rb") if self.path.exists() else None

    def _replay(self):
        valid = 0
        with open(self.path, "rb") as f:
            off = 0
            for line in f:
                if not line.endswith(b"\n"):
                    break  # torn tail write
                try:
                    src, dst, _, _ = self._json.loads(line)
                except Exception:
                    break
                self._offsets[src].append(off)
                self._roffsets[dst].append(off)
                self._edge_count += 1
                off += len(line)
            valid = off
        size = self.path.stat().st_size
        if valid < size:
            log.warning(
                "truncating %d torn bytes off edge log %s",
                size - valid, self.path,
            )
            with open(self.path, "r+b") as f:
                f.truncate(valid)

    def _read(self, offsets) -> list:
        if not offsets:
            return []
        out = []
        with self._lock:
            self._f.flush()
            if self._rf is None:
                self._rf = open(self.path, "rb")
            for off in offsets:
                self._rf.seek(off)
                src, dst, ty, w = self._json.loads(self._rf.readline())
                out.append((src, dst, ty, w))
        return out

    def add_edge(self, src, dst, edge_type: str = "", weight: float = 1.0):
        with self._lock:
            line = (
                self._json.dumps([src, dst, edge_type, weight]).encode()
                + b"\n"
            )
            off = self._f.tell()
            self._f.write(line)
            self._f.flush()
            self._offsets[src].append(off)
            self._roffsets[dst].append(off)
            self._edge_count += 1
            self._path_cache.clear()

    def has_edge(self, src, dst, edge_type: str = "", weight=None) -> bool:
        """Idempotence check for WAL replay (an edge restored from
        this log must not be re-appended by the WAL tail)."""
        for d, ty, w in self._adj.get(src, ()):
            if d == dst and ty == edge_type and (
                weight is None or w == weight
            ):
                return True
        return False

    def neighbors(self, node) -> list:
        return [
            (d, ty, w)
            for _, d, ty, w in self._read(self._offsets.get(node, ()))
        ]

    def stats(self) -> dict:
        return {
            "nodes": len(
                set(self._offsets) | set(self._roffsets)
            ),
            "edges": self._edge_count,
            "disk": str(self.path),
        }

    def analytics(self, top_hubs: int = 10) -> dict:
        """Same response shape as the in-memory store (the
        graph-analytics action must not have two schemas): degrees
        from the offset indexes, components from ONE sequential pass
        over the log."""
        nodes = set(self._offsets) | set(self._roffsets)
        out_deg = {n: len(self._offsets.get(n, ())) for n in nodes}
        in_deg = {n: len(self._roffsets.get(n, ())) for n in nodes}
        n = len(nodes)
        # undirected union-find over one sequential log read
        parent: dict = {}

        def find(x):
            r = x
            while parent.get(r, r) != r:
                r = parent[r]
            while parent.get(x, x) != x:
                parent[x], x = r, parent[x]
            return r

        with open(self.path, "rb") as f:
            for line in f:
                if not line.endswith(b"\n"):
                    break
                try:
                    src, dst, _, _ = self._json.loads(line)
                except Exception:
                    break
                parent[find(src)] = find(dst)
        comp_sizes: dict = defaultdict(int)
        for node in nodes:
            comp_sizes[find(node)] += 1
        sizes = sorted(comp_sizes.values(), reverse=True)
        hubs = sorted(out_deg.items(), key=lambda kv: -kv[1])[:top_hubs]
        return {
            "nodes": n,
            "edges": self._edge_count,
            "components": len(sizes),
            "largest_component": sizes[0] if sizes else 0,
            "max_out_degree": max(out_deg.values(), default=0),
            "max_in_degree": max(in_deg.values(), default=0),
            "avg_out_degree": sum(out_deg.values()) / n if n else 0.0,
            "top_hubs": [[h, d] for h, d in hubs],
            "disk": str(self.path),
        }

    def export_state(self) -> dict:
        edges = []
        with open(self.path, "rb") as f:
            for line in f:
                if not line.endswith(b"\n"):
                    break
                try:
                    edges.append(tuple(self._json.loads(line)))
                except Exception:
                    break
        return {"edges": edges, "disk": True}

    def close(self):
        self._f.close()
        if self._rf is not None:
            self._rf.close()
