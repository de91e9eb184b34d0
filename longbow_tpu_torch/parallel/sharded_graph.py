"""Shard-parallel graph index: a sub-graph per shard and a top-k merge.

Counterpart of longbow_tpu/parallel/sharded_graph.py (reference:
ShardedHNSW, sharded_hnsw.go:129-470: lock-striped sub-indexes, a
fan-out, a local-to-global id merge). Corpus row r lives on shard
r % S as that shard's row r // S. Each shard is an HNSWIndex on its own
device, built from its rows with the single-device builders; a search
runs beam_search on every shard with the shard's entry sample, maps its
rows back to corpus rows, gathers the [B, k] pairs to the first device
and merges them. Every shard returns a full top-k, so the reference's
k * 2 oversample is not needed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from longbow_tpu_torch.index.flat import FlatIndex, dtype_name, storage_dtype
from longbow_tpu_torch.index.graph import beam_search, count_searches
from longbow_tpu_torch.index.hnsw import HNSWConfig, HNSWIndex
from longbow_tpu_torch.metrics import get_registry
from longbow_tpu_torch.ops.distance import MASKED, MASKED_GUARD, Metric, cosine_report
from longbow_tpu_torch.parallel.mesh import Mesh, make_mesh
from longbow_tpu_torch.parallel.sharded import merge_shards


class ShardedGraphIndex:
    """Graph ANN over a row-sharded corpus.

    Rows added before the first build() are linked by it (a search
    builds on demand). Rows added after it serve at once from an interim
    exact segment (a FlatIndex on the first device) that every search
    merges with the graphs' results - the reference's interim dual-read
    (docs/autoshard.md:16-36, hnsw_autoshard.go:49); the interim folds
    into rebuilt shard graphs on fold_interim(), or by itself once it
    outgrows fold_ratio of the built rows (and 4,096 rows).

    A build swaps in the new shards, samples and layout as one tuple, so
    a search racing it sees one epoch or the other, never a mix."""

    def __init__(
        self,
        dim: int,
        mesh: Mesh,
        metric: str = Metric.L2,
        config: Optional[HNSWConfig] = None,
        dtype=torch.float32,
        fold_ratio: float = 0.25,
    ):
        self.dim = dim
        self.mesh = mesh
        self.n_shards = mesh.size
        self.metric = Metric.validate(metric)
        self.config = config or HNSWConfig()
        self.dtype = storage_dtype(dtype)
        self.fold_ratio = fold_ratio
        self._vectors_host: list[np.ndarray] = []
        self.count = 0
        self.built_count = 0  # rows covered by the shard graphs
        # (shards [HNSWIndex], entry samples [one per shard, on its
        # device]) of the last build; None before it
        self._built: Optional[tuple] = None
        self._interim: Optional[FlatIndex] = None
        self._deleted: set = set()
        # dot: ONE MIPS augmentation bound shared by every shard; bounds
        # per shard would make the augmented-l2 distances incomparable in
        # the merge
        self._mips_msq = 0.0

    def __len__(self) -> int:
        return self.count

    @property
    def shard_rows(self) -> int:
        """Slots per shard of the current build (0 before it)."""
        return 0 if self._built is None else self._built[0][0].capacity

    def add(self, vecs) -> np.ndarray:
        """Stage vectors; returns their corpus rows. Before the first build
        they become searchable on build(); after it, at once through the
        interim segment (no rebuild per add)."""
        if isinstance(vecs, torch.Tensor):
            vecs = vecs.float().cpu().numpy()
        vecs = np.ascontiguousarray(np.atleast_2d(vecs), np.float32)
        if vecs.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}] vectors, got {vecs.shape}")
        start = self.count
        self._vectors_host.append(vecs)
        self.count += len(vecs)
        if self._built is not None:
            if self._interim is None:
                self._interim = FlatIndex(self.dim, self.metric, torch.float32,
                                          device=self.mesh.devices[0])
            self._interim.add(vecs)
            if self.count - self.built_count > max(self.fold_ratio * self.built_count, 4096):
                self.build()  # fold the interim into the shard graphs
        return np.arange(start, start + len(vecs), dtype=np.int64)

    def fold_interim(self) -> None:
        """Fold the interim rows into the shard graphs (a full rebuild)."""
        if self.count > self.built_count:
            self.build()

    def build(self) -> None:
        """Build every shard's graph from its stripe of the rows."""
        # every (re)build redistributes rows over the shards (reference:
        # the hnsw sharding migration counter)
        get_registry().inc("longbow_hnsw_sharding_migrations_total")
        allv = self._host_all()
        if len(allv) == 0:
            return  # nothing to build; searches answer masked
        s = self.n_shards
        subs = [allv[j::s] for j in range(s)]
        per = max(len(x) for x in subs)
        mips_bound = None
        if self.metric == Metric.DOT:
            nsq = np.sum(allv.astype(np.float64) ** 2, axis=1)
            mips_bound = float(nsq.max()) * 1.5
        shards = []
        for j, dev in enumerate(self.mesh.devices):
            idx = HNSWIndex(self.dim, self.metric, self.config, self.dtype,
                            capacity=max(4096, per), mips_bound=mips_bound, device=dev)
            idx.add(subs[j])
            shards.append(idx)
        # entry samples, one length for every shard: a strided sample of
        # each shard's rows (n / 16, at least entry_sample_size, at most
        # 32,768 and the rows; past 2,048 rounded up to a multiple of it)
        slen = min(max(self.config.entry_sample_size, per // 16, 1), 32768, per)
        if slen > 2048:
            slen = -(-slen // 2048) * 2048
        samples = [
            torch.from_numpy(
                np.linspace(0, max(len(subs[j]) - 1, 0), slen, dtype=np.int32).astype(np.int64)
            ).to(dev)
            for j, dev in enumerate(self.mesh.devices)
        ]
        # deleted rows come back in a rebuild: tombstone them again
        dead = np.asarray(sorted(self._deleted), np.int64)
        for j in range(s):
            mine = dead[dead % s == j] // s
            if len(mine):
                shards[j].delete_rows(mine)
        if mips_bound is not None:
            self._mips_msq = mips_bound
        self._built = (shards, samples)
        self.built_count = self.count
        self._interim = None  # folded in

    def delete_rows(self, rows) -> None:
        """Tombstone corpus rows, in the shard graphs and the interim
        segment; kept across rebuilds."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        self._deleted.update(int(r) for r in rows)
        if self._built is None:
            return
        shards = self._built[0]
        in_graph = rows[rows < self.built_count]
        for j in np.unique(in_graph % self.n_shards):
            shards[j].delete_rows(in_graph[in_graph % self.n_shards == j] // self.n_shards)
        in_interim = rows[rows >= self.built_count]
        if len(in_interim) and self._interim is not None:
            self._interim.delete_rows(in_interim - self.built_count)

    def search(self, queries, k: int, *, ef_search: Optional[int] = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """-> (dist [B, k] f32, corpus row [B, k]) as numpy; (MASKED, -1)
        where nothing was found. Builds first if nothing is built."""
        if self._built is None:
            self.build()
        q = np.atleast_2d(np.asarray(queries, np.float32))
        if self._built is None:  # still empty: masked results, not a crash
            return (np.full((q.shape[0], k), np.float32(MASKED)),
                    np.full((q.shape[0], k), -1, np.int32))
        shards, samples = self._built
        built_count, interim = self.built_count, self._interim
        q_orig = q
        if self.metric == Metric.DOT:
            # the zero column matches the [x, sqrt(M^2 - |x|^2)] rows
            q = np.concatenate([q, np.zeros((q.shape[0], 1), np.float32)], axis=1)
        normalize = self.metric == Metric.COSINE
        ef = max(ef_search or self.config.ef_search, k)
        # deferred result extraction unless tombstone-heavy (HNSWIndex's
        # gate: exact while the beams hold >= k valid rows)
        track = len(self._deleted) * 10 > 3 * max(self.count, 1)
        qt = torch.from_numpy(q)
        first = self.mesh.devices[0]
        ds, rs, calls = [], [], []
        for j, (shard, dev) in enumerate(zip(shards, self.mesh.devices)):
            calls.append({})
            with shard._mu:
                d, r = beam_search(
                    shard.state, qt.to(dev), samples[j], k, ef, normalize=normalize,
                    track_results=track, expand_per_iter=self.config.search_expand,
                    m_used=self.config.search_m_max, stats=calls[-1],
                )
            ds.append(d.to(first))
            rs.append(torch.where(d < MASKED_GUARD, r.long() * self.n_shards + j, -1).to(first))
        d, corpus_rows = merge_shards(ds, rs, k)
        d = d.cpu().numpy()
        corpus_rows = corpus_rows.cpu().numpy()
        count_searches(calls, q.shape[0])
        if self.metric == Metric.DOT:
            # augmented l2 -> the raw inner product, reported as -ip
            qn = np.sum(q.astype(np.float64) ** 2, axis=1)[:, None]
            ip = (qn + self._mips_msq - d) / 2.0
            d = np.where(d >= MASKED, d, -ip).astype(np.float32)

        # the interim exact segment (rows added after the build): the
        # reference's interim dual-read (docs/autoshard.md:23-36)
        if interim is not None and len(interim):
            di, ri = interim.search(q_orig, min(k, len(interim)))
            di = np.asarray(di, np.float32)
            if self.metric == Metric.COSINE:
                # FlatIndex reports 1 - cos; merge in the graphs' space,
                # l2^2 on unit vectors = 2 - 2 cos
                di = np.where(di >= MASKED, di, 2.0 * di)
            ci = np.where((ri >= 0) & (di < MASKED), ri + built_count, -1)
            d_all = np.concatenate([d, di], axis=1)
            r_all = np.concatenate([corpus_rows, ci], axis=1)
            order = np.argsort(d_all, axis=1)[:, :k]
            d = np.take_along_axis(d_all, order, axis=1)
            corpus_rows = np.take_along_axis(r_all, order, axis=1)
        if self.metric == Metric.COSINE:
            d = cosine_report(np.asarray(d, np.float32))
        return d, corpus_rows

    # -- the index surface (factory adapter) ----------------------------

    @property
    def capacity(self) -> int:
        return max(self.count, 1)

    def _host_all(self) -> np.ndarray:
        if len(self._vectors_host) > 1:
            self._vectors_host = [np.concatenate(self._vectors_host)]
        return (self._vectors_host[0] if self._vectors_host
                else np.zeros((0, self.dim), np.float32))

    def get_vectors(self, rows) -> np.ndarray:
        return self._host_all()[np.asarray(rows, np.int64)]

    def device_bytes(self) -> int:
        total = 0 if self._built is None else sum(s.device_bytes() for s in self._built[0])
        return total + (0 if self._interim is None else self._interim.device_bytes())

    def export_state(self) -> dict:
        """longbow_tpu's layout: the rows in corpus order and the deleted
        rows. The rows do not depend on the mesh, so an import may build
        on any number of shards."""
        return {
            "kind": "mesh_graph",
            "dim": self.dim,
            "metric": self.metric,
            "dtype": dtype_name(self.dtype),
            "count": self.count,
            "fold_ratio": self.fold_ratio,
            "m": self.config.m,
            "m_max": self.config.m_max,
            "ef_construction": self.config.ef_construction,
            "ef_search": self.config.ef_search,
            "vectors": self._host_all().copy(),
            "deleted": np.asarray(sorted(self._deleted), np.int64),
        }

    @classmethod
    def import_state(cls, st: dict, *, device=None) -> "ShardedGraphIndex":
        """From export_state() output, this package's or longbow_tpu's: the
        rows re-added, the deletes applied and the shard graphs built on
        make_mesh(device=device)."""
        cfg = HNSWConfig(
            m=int(st["m"]), m_max=int(st["m_max"]),
            ef_construction=int(st["ef_construction"]),
            ef_search=int(st["ef_search"]),
        )
        idx = cls(
            int(st["dim"]), make_mesh(device=device), st["metric"], config=cfg,
            dtype=storage_dtype(st["dtype"]),
            fold_ratio=float(st.get("fold_ratio", 0.25)),
        )
        v = np.asarray(st["vectors"], np.float32)
        if len(v):
            idx.add(v)
            dead = np.asarray(st.get("deleted", []), np.int64)
            if len(dead):
                idx.delete_rows(dead)
            idx.build()
        return idx
