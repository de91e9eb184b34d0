"""HNSW-capability graph index on torch tensors.

Counterpart of longbow_tpu/index/hnsw.py. Public semantics follow HNSW
(M, MMax, efConstruction, efSearch, the adaptive ef retry), the machinery
is the flat fixed-fanout graph of index/graph.py built with the batched
inserts and bulk builds of index/graph_build.py: no hierarchy, no
per-query heaps.

Concurrency: the graph tensors are written in place, so `_mu` serializes
whoever touches them. A search holds it from its first gather to its last
(the beam loop reads the host once per iteration, so dispatch and fetch
cannot be split as FlatIndex does); an add holds it for the store and
then once per insert batch, so searches slip in between batches and see
every batch whole or not at all.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from longbow_tpu_torch.device import resolve_device
from longbow_tpu_torch.index.flat import dtype_name, storage_dtype
from longbow_tpu_torch.index.graph import beam_search, gather_vectors_f32, graph_init, pq_decode
from longbow_tpu_torch.index.graph_build import (
    build_stage_timer,
    bulk_build_clustered,
    bulk_build_edges,
    bulk_build_rp,
    insert_batch,
)
from longbow_tpu_torch.index.pq import encode_rows, train_codebooks
from longbow_tpu_torch.metrics import get_registry
from longbow_tpu_torch.ops.distance import (
    MASKED,
    Metric,
    cosine_report,
    exact_search,
    fit_mask,
    normalize_rows,
    pad_to,
    squared_norms,
    tombstone_rows,
)

# capacity granularity is a multiple of the bulk build's block (8192):
# otherwise bulk_build_rp's padded row count lands past the capacity and
# it must make a padded copy of vectors/norms/valid
MIN_CAPACITY = 8192
# first adds of at least this many rows go to a sub-quadratic bulk build
EXACT_BUILD_LIMIT = 150_000
# storage="pq": the codebooks train on at most this many rows of the first add
PQ_TRAIN_SAMPLE = 65_536
PQ_TRAIN_ITERS = 12


class HNSWConfig:
    """The knobs of the graph index (HNSW's names)."""

    def __init__(
        self,
        m: int = 32,
        m_max: int = 64,
        ef_construction: int = 100,
        ef_search: int = 50,
        insert_batch_size: int = 1024,
        entry_sample_size: int = 2048,
        adaptive_ef_retries: int = 2,
        insert_expand: int = 4,
        reverse_passes: int = 4,
        search_m_max: int = 0,
        search_expand: int = 4,
    ):
        self.m = m
        self.m_max = m_max
        self.ef_construction = ef_construction
        self.ef_search = ef_search
        self.insert_batch_size = insert_batch_size
        self.entry_sample_size = entry_sample_size
        # construction beam width per iteration + reverse-edge passes: the
        # live-insert throughput levers; raise reverse_passes for heavy
        # same-target contention
        self.insert_expand = insert_expand
        self.reverse_passes = reverse_passes
        # an under-filled search is retried with ef * 5, this many times
        self.adaptive_ef_retries = adaptive_ef_retries
        # search-time levers that need no rebuild: traverse only the
        # first `search_m_max` edges per node (bulk-built adjacency rows
        # are distance-sorted; 0 = every stored edge) and expand
        # `search_expand` beam nodes per iteration
        self.search_m_max = search_m_max
        self.search_expand = search_expand


class HNSWIndex:
    """Approximate k-NN graph index with tombstones and filtered search.

    storage="sq8" stores per-dim affine uint8 codes as the graph's vector
    payload; traversal gathers 1-byte codes and folds the dequant affine
    into the query; the quantizer trains on the first add batch.
    storage="pq" stores pq_m-byte PQ codes (pq_m defaults to dim / 4; the
    codebooks train on the first add batch); traversal ranks by ADC
    tables, and an f16 copy of the rows in host RAM re-ranks an
    oversampled pool exactly. l2 and cosine only.
    device: None means the CUDA card (and raises without one).
    """

    def __init__(
        self,
        dim: int,
        metric: str = Metric.L2,
        config: Optional[HNSWConfig] = None,
        dtype=torch.float32,
        capacity: int = MIN_CAPACITY,
        mips_bound: Optional[float] = None,
        storage: str = "dense",
        edge_dtype=torch.float32,
        pq_m: Optional[int] = None,
        *,
        device=None,
    ):
        self.device = resolve_device(device)
        self.dim = dim
        self.metric = Metric.validate(metric)
        # MIPS via norm augmentation: for the dot metric, rows become
        # [x, sqrt(M^2 - |x|^2)] and queries [q, 0]; argmax q.x ==
        # argmin L2 on the augmented space, so the L2 graph serves dot
        # unchanged. mips_bound pre-sets the M^2 bound so several indexes
        # can share one.
        self._mips = self.metric == Metric.DOT
        self._mips_msq = float(mips_bound or 0.0)  # max |x|^2 bound
        self.config = config or HNSWConfig()
        self.dtype = storage_dtype(dtype)
        if storage not in ("dense", "sq8", "pq"):
            raise ValueError("storage must be dense|sq8|pq")
        self.storage = storage
        self.edge_dtype = storage_dtype(edge_dtype)
        self.pq_m = 0
        if storage == "pq":
            if self._mips:
                raise ValueError(
                    "storage='pq' serves l2/cosine; use index kind 'pq' for "
                    "the dot metric (native MIPS tables)"
                )
            self.pq_m = int(pq_m or max(dim // 4, 1))
            if dim % self.pq_m != 0:
                raise ValueError(f"dim {dim} not divisible by pq_m {self.pq_m}")
        # PQ traversal ranks by ADC; a host-RAM f16 copy re-ranks an
        # oversampled pool exactly, so device memory holds only codes and
        # adjacency
        self.pq_rerank = storage == "pq"
        self._rerank_host: Optional[np.ndarray] = None  # [cap, dim] f16
        self.count = 0
        self._dead = 0  # tombstoned rows (gates deferred extraction)
        cap = pad_to(capacity, MIN_CAPACITY)
        store_dim = self.pq_m if storage == "pq" else (dim + 1 if self._mips else dim)
        self.state = graph_init(
            cap, store_dim, self.config.m_max,
            torch.uint8 if storage in ("sq8", "pq") else self.dtype,
            edge_dtype=self.edge_dtype, device=self.device,
        )
        self._sample_dirty = True
        self._sample_rows = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self._mu = threading.RLock()
        # loop iterations of the last beam search (a measurement hook)
        self.last_search_iters = 0

    # ------------------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.state.vectors.shape[0]

    def __len__(self) -> int:
        return self.count

    def _grow_to(self, need: int) -> None:
        new_cap = self.capacity
        while new_cap < need:
            new_cap *= 2
        if new_cap == self.capacity:
            return
        s = self.state

        def grown(t, fill):
            out = torch.full((new_cap,) + t.shape[1:], fill, dtype=t.dtype, device=t.device)
            out[: t.shape[0]] = t
            return out

        self.state = s._replace(
            vectors=grown(s.vectors, 0),
            norms_sq=grown(s.norms_sq, 0),
            valid=grown(s.valid, False),
            nbrs=grown(s.nbrs, -1),
            nbr_dists=grown(s.nbr_dists, MASKED),
            nbr_count=grown(s.nbr_count, 0),
        )
        self._sample_dirty = True

    def _refresh_sample(self) -> None:
        """Strided sample of stored rows for the entry scan (the role of
        HNSW's upper layers), refreshed lazily as the index grows.

        The sample scales with the corpus (n/16, capped at 32,768,
        rounded up to a multiple of 2,048): on clustered data the kNN
        graph can lack inter-cluster edges, so recall depends on starting
        near the right cluster. The size decides results, so the formula
        is the reference's."""
        if not self._sample_dirty and self._sample_rows.shape[0] > 1:
            return
        n = max(self.count, 1)
        if n <= self.config.entry_sample_size:
            s = n  # tiny index: every row (no duplicate entries)
        else:
            s = min(32768, -(-max(self.config.entry_sample_size, n // 16) // 2048) * 2048)
        rows = np.linspace(0, n - 1, s, dtype=np.int32)
        self._sample_rows = torch.from_numpy(rows.astype(np.int64)).to(self.device)
        self._sample_dirty = False

    # ------------------------------------------------------------------

    def _pq_host_rerank(self, q: np.ndarray, d: np.ndarray, r: np.ndarray, k: int,
                        normalize: bool) -> tuple[np.ndarray, np.ndarray]:
        """Exact re-rank of the ADC-ranked pool against the host f16 copy
        -> ([B, k] f32, [B, k] int32), in numpy as the reference does."""
        if normalize:
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
        vec = self._rerank_host[np.maximum(r, 0)].astype(np.float32)  # [B, P, dim]
        ip = np.einsum("bd,bpd->bp", q, vec, dtype=np.float32)
        vn = np.sum(vec * vec, axis=2)
        qn = np.sum(q * q, axis=1, keepdims=True)
        dist = np.maximum(qn - 2.0 * ip + vn, 0.0)
        dist[(r < 0) | (d >= MASKED)] = np.float32(MASKED)
        order = np.argsort(dist, axis=1)[:, :k]
        d2 = np.take_along_axis(dist, order, axis=1).astype(np.float32)
        r2 = np.take_along_axis(r, order, axis=1)
        return d2, np.where(d2 >= MASKED, -1, r2).astype(np.int32)

    def _host_store(self, vecs16: np.ndarray, start: int) -> None:
        """Write rows into the host-RAM f16 re-rank copy, grown to the
        capacity (the device never holds it)."""
        cap = self.capacity
        if self._rerank_host is None or self._rerank_host.shape[0] < cap:
            new = np.zeros((cap, self.dim), np.float16)
            if self._rerank_host is not None:
                new[: self._rerank_host.shape[0]] = self._rerank_host
            self._rerank_host = new
        self._rerank_host[start:start + len(vecs16)] = vecs16

    def add(self, vecs) -> np.ndarray:
        """Store + link vectors; returns assigned internal row ids.

        vecs: a numpy array or a tensor. A tensor already on this device
        is never copied to the host; for plain-L2 dense storage it is
        only cast to the storage dtype."""
        is_tensor = isinstance(vecs, torch.Tensor)
        if (
            is_tensor
            and self.storage == "dense"
            and not self._mips
            and self.metric == Metric.L2
            and vecs.ndim == 2
            and vecs.shape[1] == self.dim
        ):
            return self._add_arrays(vecs.to(self.device, self.dtype), None)
        if is_tensor:
            jv = vecs.to(self.device, torch.float32)
            if jv.ndim == 1:
                jv = jv[None, :]
        else:
            arr = np.ascontiguousarray(np.atleast_2d(vecs), dtype=np.float32)
            jv = torch.from_numpy(arr).to(self.device)
        if jv.ndim != 2 or jv.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}], got {tuple(jv.shape)}")

        if self._mips:
            nsq = (jv.double() ** 2).sum(dim=1)
            mx = float(nsq.max())
            if self.count == 0 and self._mips_msq == 0.0:
                self._mips_msq = mx * 1.5  # headroom for later adds
            elif mx > self._mips_msq:
                raise ValueError(
                    "MIPS augmentation bound exceeded: new vector norm "
                    f"{mx:.3g} > bound {self._mips_msq:.3g}; rebuild the "
                    "index (bound fixed at first add with 1.5x headroom)"
                )
            aug = torch.sqrt((self._mips_msq - nsq).clamp_min(0.0)).float()
        if self.metric == Metric.COSINE:
            jv = normalize_rows(jv)
        if self._mips:
            jv = torch.cat([jv, aug[:, None]], dim=1)
        host = None  # storage="pq": the rows of the host re-rank copy
        if self.storage == "sq8":
            with self._mu:
                if self.state.scale is None:
                    lo = jv.min(dim=0).values
                    hi = jv.max(dim=0).values
                    self.state = self.state._replace(
                        scale=(hi - lo).clamp_min(1e-12) / 255.0, offset=lo
                    )
                scale, offset = self.state.scale, self.state.offset
            store = torch.clamp(torch.round((jv - offset) / scale), 0, 255).to(torch.uint8)
            # norms of the *dequantized* vectors: distances computed from
            # codes must see consistent |v|^2
            norms = squared_norms(store.float() * scale + offset)
        elif self.storage == "pq":
            with self._mu:
                if self.state.pq_books is None:
                    t0 = time.perf_counter()
                    books = train_codebooks(
                        jv[:PQ_TRAIN_SAMPLE], self.pq_m, PQ_TRAIN_ITERS
                    )
                    self.state = self.state._replace(pq_books=books)
                    try:
                        get_registry().observe(
                            "longbow_hnsw_pq_training_duration_seconds",
                            time.perf_counter() - t0,
                            dataset="",  # the index layer has no dataset name
                        )
                    except Exception:
                        pass  # a metric never fails an add
                books = self.state.pq_books
            store = encode_rows(jv, books)
            # |v_hat|^2 of the decoded rows: ADC distances see consistent norms
            norms = squared_norms(pq_decode(store, books))
            if self.pq_rerank:
                host = jv.half().cpu().numpy()
        else:
            store = jv.to(self.dtype)
            # norms of the STORED (rounded) vectors, not the f32
            # originals: with bf16 storage, f32 norms paired with rounded
            # inner products add a per-row bias 2*v.dv; consistent norms
            # make the metric |q - v_hat|^2 exactly
            norms = squared_norms(store)
        return self._add_arrays(store, norms, host)

    def _add_arrays(self, store: torch.Tensor, norms, host_rows=None) -> np.ndarray:
        """Write already-prepared storage rows + link (shared tail of
        add(); the device fast path enters here directly). host_rows: the
        f16 re-rank rows of storage="pq"."""
        n = store.shape[0]
        cfg = self.config
        with self._mu:
            self._grow_to(self.count + n)
            if norms is None:
                norms = squared_norms(store)
            if host_rows is not None:
                self._host_store(host_rows, self.count)
            s = self.state
            start = self.count
            s.vectors[start:start + n] = store
            s.norms_sq[start:start + n] = norms
            s.valid[start:start + n] = True
            rows = np.arange(start, start + n, dtype=np.int64)
            was_empty = self.count == 0
            self.count += n
            self._sample_dirty = True
            try:
                # each state swap is one "epoch" in the reference's RCU sense
                get_registry().inc("longbow_hnsw_epoch_transitions_total")
            except Exception:
                pass
            build_stage_timer(n, tag="add")("store/norms/scatter", s.vectors)

            if was_empty and n >= 2 * cfg.insert_batch_size:
                # bulk path: a kNN graph + symmetrize, far faster than
                # insertion and a better graph. Exact O(N^2) kNN below
                # EXACT_BUILD_LIMIT rows; above it random-projection
                # blocks on a card, k-means cells on the CPU.
                # 63: the fused self-kNN scans for kk + 1 (self included)
                # and is asked for at most 64
                kk = min(63, max(cfg.m * 2, 16))
                on_card = s.vectors.device.type == "cuda"
                if n >= EXACT_BUILD_LIMIT and on_card:
                    self.state = bulk_build_rp(
                        s, n, m=cfg.m, m_max=cfg.m_max, knn_k=max(cfg.m, 48),
                        rounds=3, block=8192, nn_rounds=1 if n >= 500_000 else 2,
                    )
                elif n >= EXACT_BUILD_LIMIT:
                    self.state = bulk_build_clustered(
                        s, n, m=cfg.m, m_max=cfg.m_max, knn_k=kk
                    )
                else:
                    self.state = bulk_build_edges(
                        s, n, m=cfg.m, m_max=cfg.m_max, knn_k=kk
                    )
                return rows

        # incremental path: link in fixed-size batches (the tail batch is
        # padded by repeating its last row, as the reference does: the
        # padding takes part in the batch's kNN and arbitration)
        bs = cfg.insert_batch_size
        for off in range(0, n, bs):
            chunk = rows[off:off + bs]
            if len(chunk) < bs:
                chunk = np.pad(chunk, (0, bs - len(chunk)), mode="edge")
            with self._mu:
                self._refresh_sample()
                self.state = insert_batch(
                    self.state,
                    torch.from_numpy(chunk).to(self.device),
                    self._sample_rows,
                    ef_construction=cfg.ef_construction,
                    m=cfg.m,
                    cand_cap=min(64, max(cfg.m * 2, 16)),
                    reverse_passes=cfg.reverse_passes,
                    expand_per_iter=cfg.insert_expand,
                )
        return rows

    def delete_rows(self, rows) -> None:
        """Tombstone rows: they stop appearing in results but remain
        routable."""
        if len(rows) == 0:
            return
        with self._mu:
            self._dead += len(rows)
            tombstone_rows(self.state.valid, rows)

    # ------------------------------------------------------------------

    def _queries(self, queries) -> torch.Tensor:
        """[B, D] f32 queries on the device, augmented for MIPS."""
        if isinstance(queries, torch.Tensor):
            q = queries.to(self.device, torch.float32)
        else:
            q = torch.from_numpy(np.atleast_2d(np.asarray(queries, dtype=np.float32)))
            q = q.to(self.device)
        if q.ndim == 1:
            q = q[None, :]
        if self._mips:
            q = torch.cat([q, torch.zeros((q.shape[0], 1), device=self.device)], dim=1)
        return q

    def _fit_mask(self, mask) -> Optional[torch.Tensor]:
        """A filter mask on this device, cut or padded (False) to the
        capacity."""
        return fit_mask(mask, self.capacity, self.device)

    def _report(self, q: torch.Tensor, d: torch.Tensor) -> np.ndarray:
        """Internal (augmented or unit-vector) L2 distances as the
        declared metric's: -q.x for dot, 1 - cos for cosine."""
        if self._mips:
            # dist = |q|^2 + M^2 - 2 q.x  =>  q.x = (|q|^2 + M^2 - dist)/2
            qn = (q.double() ** 2).sum(dim=1, keepdim=True)
            ip = (qn + self._mips_msq - d.double()) / 2.0
            return torch.where(d >= MASKED, d, (-ip).float()).cpu().numpy()
        if self.metric == Metric.COSINE:
            return cosine_report(d.cpu().numpy())
        return d.cpu().numpy()

    def search(
        self,
        queries,
        k: int,
        *,
        ef_search: Optional[int] = None,
        filter_mask=None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched ANN search -> (dist [B, k] f32, rows [B, k] int32) as
        numpy. If any query comes back under-filled, the search is
        retried with ef * 5 (adaptive_ef_retries times).

        The batch is searched as it is given: the loop stops batch-wide,
        so the answers of one query can depend on the others beside it."""
        q = self._queries(queries)
        normalize = self.metric == Metric.COSINE
        cfg = self.config
        ef = max(ef_search or cfg.ef_search, k)
        # PQ with re-rank: an oversampled ADC-ranked pool, re-ranked on the host
        rerank = self.pq_rerank and self._rerank_host is not None
        pool_k = min(max(4 * k, 32), ef) if rerank else k
        with self._mu:
            self._refresh_sample()
            eligible = self._fit_mask(filter_mask)
            # deferred result extraction (top-k of the final beam) is
            # exact whenever the beam holds >= k valid rows, so it is
            # gated on no filter and light tombstoning
            track = eligible is not None or (self._dead * 10 > 3 * max(self.count, 1))
            stats: dict = {}
            kw = dict(
                eligible=eligible, normalize=normalize, track_results=track,
                expand_per_iter=cfg.search_expand, m_used=cfg.search_m_max, stats=stats,
            )
            d, r = beam_search(self.state, q, self._sample_rows, pool_k, ef, **kw)
            # the retry needs a host read to see fill-ness: skipped when
            # under-fill is implausible (no filter and the corpus dwarfs
            # ef: the entry scan alone yields >= k valid rows)
            if cfg.adaptive_ef_retries > 0 and (eligible is not None or self.count < 8 * ef):
                for _ in range(cfg.adaptive_ef_retries):
                    filled = bool(d[:, k - 1].max() < MASKED)
                    if filled or ef >= self.count:
                        break
                    ef = ef * 5
                    d, r = beam_search(self.state, q, self._sample_rows, pool_k, ef, **kw)
            self.last_search_iters = stats["iters"]
        if rerank:
            d, r = self._pq_host_rerank(q.cpu().numpy(), d.cpu().numpy(), r.cpu().numpy(), k,
                                        normalize)
            return (cosine_report(d) if normalize else d), r
        return self._report(q, d), r.cpu().numpy()

    # ------------------------------------------------------------------

    def get_vectors(self, rows) -> np.ndarray:
        """Original-dimension vectors (strips the MIPS augmentation;
        dequantized for SQ8 storage)."""
        return self.get_vectors_device(rows).cpu().numpy()

    def get_vectors_device(self, rows) -> torch.Tensor:
        """The same gather, left on the device."""
        if isinstance(rows, torch.Tensor):
            idx = rows.to(self.device).long()
        else:
            idx = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        with self._mu:
            out = gather_vectors_f32(self.state, idx)
        return out[:, : self.dim]

    def exact_search(self, queries, k: int, *, filter_mask=None):
        """Exact scan over the stored block (post-migration exact mode),
        in full f32; handles cosine/MIPS like search()."""
        q = self._queries(queries)
        with self._mu:
            s = self.state
            corpus = s.vectors
            # codes: a transient f32 decode, the rows whose norms norms_sq
            # holds (the reference rounds it to bf16 and pairs it with
            # the f32 norms, which biases every distance by 2 q.dv)
            if s.scale is not None:  # sq8
                corpus = corpus.float() * s.scale + s.offset
            elif s.pq_books is not None:  # pq
                corpus = pq_decode(corpus, s.pq_books)
            metric = Metric.L2 if (self._mips or self.metric == Metric.COSINE) else self.metric
            d, r = exact_search(
                q, corpus, k, metric,
                corpus_norms_sq=s.norms_sq, valid=s.valid,
                extra_mask=self._fit_mask(filter_mask),
                normalize=self.metric == Metric.COSINE, device=self.device,
            )
        return self._report(q, d), r.cpu().numpy()

    def device_bytes(self) -> int:
        return self.state.device_bytes()

    def host_bytes(self) -> int:
        """The host-RAM re-rank copy of storage="pq"."""
        return 0 if self._rerank_host is None else self._rerank_host.nbytes

    def export_state(self) -> dict:
        """longbow_tpu's HNSWIndex.export_state layout: numpy arrays cut
        to `count` rows; bf16 rows and edge distances travel as f32 (bf16
        does not survive np.save)."""
        with self._mu:
            n = self.count
            s = self.state

            def host(t):
                return t[:n].cpu().numpy()

            st = {
                "kind": "hnsw",
                "dim": self.dim,
                "metric": self.metric,
                "dtype": dtype_name(self.dtype),
                "storage": self.storage,
                "count": n,
                "m": self.config.m,
                "m_max": self.config.m_max,
                "ef_construction": self.config.ef_construction,
                "ef_search": self.config.ef_search,
                "search_m_max": self.config.search_m_max,
                "search_expand": self.config.search_expand,
                "mips_msq": self._mips_msq,
                "pq_m": self.pq_m,
                "vectors": (
                    host(s.vectors) if self.storage in ("sq8", "pq") else host(s.vectors.float())
                ),
                "edge_dtype": dtype_name(self.edge_dtype),
                "norms_sq": host(s.norms_sq),
                "valid": host(s.valid),
                "nbrs": host(s.nbrs),
                "nbr_dists": host(s.nbr_dists.float()),
                "nbr_count": host(s.nbr_count),
            }
            if s.scale is not None:
                st["sq8_scale"] = s.scale.cpu().numpy()
                st["sq8_offset"] = s.offset.cpu().numpy()
            if s.pq_books is not None:
                st["pq_books"] = s.pq_books.cpu().numpy()
            if self._rerank_host is not None:
                st["pq_rerank_host"] = self._rerank_host[:n].copy()
        return st

    @classmethod
    def import_state(cls, st: dict, *, device=None) -> "HNSWIndex":
        """Rebuild from export_state() output - this package's or
        longbow_tpu's (same keys; dtype names map without JAX)."""
        cfg = HNSWConfig(
            m=int(st["m"]), m_max=int(st["m_max"]),
            ef_construction=int(st["ef_construction"]),
            ef_search=int(st["ef_search"]),
            search_m_max=int(st.get("search_m_max", 0)),
            search_expand=int(st.get("search_expand", 4)),
        )
        storage = str(st.get("storage", "dense"))
        n = int(st["count"])
        idx = cls(
            int(st["dim"]), st["metric"], cfg, storage_dtype(str(st["dtype"])),
            capacity=max(MIN_CAPACITY, n),
            storage=storage,
            edge_dtype=storage_dtype(str(st.get("edge_dtype", "float32"))),
            pq_m=int(st.get("pq_m", 0)) or None,
            device=device,
        )
        # without the bound a dot-metric index reports wrong inner
        # products and rejects all later adds
        idx._mips_msq = float(st.get("mips_msq", 0.0))
        s = idx.state
        if "sq8_scale" in st:
            s = s._replace(
                scale=torch.tensor(np.asarray(st["sq8_scale"], np.float32), device=idx.device),
                offset=torch.tensor(np.asarray(st["sq8_offset"], np.float32), device=idx.device),
            )
        if "pq_books" in st:  # trained books survive an import of 0 rows too
            s = s._replace(
                pq_books=torch.tensor(np.asarray(st["pq_books"], np.float32), device=idx.device)
            )
        if n:
            for name in ("vectors", "norms_sq", "valid", "nbrs", "nbr_dists", "nbr_count"):
                t = getattr(s, name)
                t[:n] = torch.as_tensor(np.array(st[name]), device=idx.device).to(t.dtype)
            idx.count = n
            idx._dead = int(n - np.asarray(st["valid"], bool).sum())
            idx._sample_dirty = True
        idx.state = s
        if "pq_rerank_host" in st:
            idx._host_store(np.asarray(st["pq_rerank_host"], np.float16), 0)
        elif n:  # a state without the host copy is served by ADC alone
            idx.pq_rerank = False
        return idx
