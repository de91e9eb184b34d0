"""Cluster coordinator: membership + replication + anti-entropy +
cross-process global search, wired as one object the serving tier owns.

Counterpart of longbow_tpu/distributed/cluster.py. Each node's share of a
global search is its own local search (on the card: kernel K1 for a flat
dataset); the merge runs on the host.

reference: the boot wiring in cmd/longbow/main.go:370-458
(gossip -> ring -> forwarder -> interceptors) and the read path's
GlobalSearchCoordinator (store/global_search.go:48-328, used from DoGet
at store_query.go:696-717 when !LocalOnly). Two placements: replicated
(every node holds the full dataset; reads fan out to merge freshness)
and partitioned (each row id has one owner on the consistent-hash ring;
reads merge every owner's share). A global search is a scatter to alive
peers with `local_only: true` + a top-k merge.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Optional

import numpy as np

from longbow_tpu_torch.distributed.membership import MembershipManager, Member
from longbow_tpu_torch.distributed.replicator import Peer, PeerReplicator, SyncWorker
from longbow_tpu_torch.distributed.vector_clock import (
    SplitBrainDetector,
    VectorClock,
)

log = logging.getLogger("longbow.cluster")


class ConsistencyError(RuntimeError):
    """A read's consistency level could not be met (reference:
    QuorumManager read levels, quorum.go:93-126)."""


class ClusterCoordinator:
    def __init__(
        self,
        store,
        self_id: str,
        peers: list[str],
        *,
        replication_mode: str = "async",   # async | quorum | off
        replication_level: str = "QUORUM",
        sync_interval_s: float = 30.0,
        probe_interval_s: float = 1.0,
        global_search_timeout_s: float = 5.0,
        dns_name: str = "",
        k8s_service: str = "",
        region: str = "",
        lan_group: str = "",
        placement: str = "replicated",  # replicated | partitioned
        api_key: str = "",
        tls_root_certs=None,
        spatial_routing: bool = False,
        spatial_margin: float = 1.5,
    ):
        self.store = store
        self.self_id = self_id
        # shared fan-out pool (created lazily, grown to the largest
        # fan-out seen): global_search previously spawned a fresh OS
        # thread per peer per request
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_size = 0
        self._pool_mu = threading.Lock()
        # peer-auth credentials: intra-cluster hops present the same
        # bearer token / TLS roots the serving edge requires
        self._api_key = api_key or None
        self._tls_root_certs = tls_root_certs
        if placement not in ("replicated", "partitioned"):
            raise ValueError("placement must be replicated|partitioned")
        # partitioned: each row id has ONE owner through a
        # consistent-hash ring (reference: sharding/ring.go + partition
        # proxy semantics) — the corpus can exceed one node's HBM and
        # reads merge through global search. Replication + Merkle
        # anti-entropy are replicated-mode machinery and stay off.
        self.placement = placement
        if placement == "partitioned":
            replication_mode = "off"
        self.membership = MembershipManager(
            self_id, peers, probe_interval_s=probe_interval_s,
            dns_name=dns_name or None,
            k8s_service=k8s_service or None,
            self_region=region,
            lan_group=lan_group or None,
        )
        self._peers: dict[str, Peer] = {}
        for m in self.membership.members.values():
            self._peers[m.id] = self._make_peer(m)
        self.replication_mode = replication_mode
        self.replicator: Optional[PeerReplicator] = None
        if replication_mode != "off" and self._peers:
            self.replicator = PeerReplicator(
                list(self._peers.values()),
                mode="async" if replication_mode == "async" else "quorum",
                level=replication_level,
            )
        self.sync_worker: Optional[SyncWorker] = None
        if self._peers and placement == "replicated":
            self.sync_worker = SyncWorker(
                store, list(self._peers.values()), interval_s=sync_interval_s
            )
        self.ring = None
        if placement == "partitioned":
            from longbow_tpu_torch.distributed.ring import ConsistentHashRing

            self.ring = ConsistentHashRing(
                sorted({self_id, *self._peers.keys()})
            )
        self.global_search_timeout_s = global_search_timeout_s
        self._replication_level = replication_level
        # causality tracking per dataset: local writes tick this node's
        # component, replica applies merge the origin's clock; a
        # 'concurrent' comparison = writes that LWW resolved silently —
        # surfaced as a counter (reference: vector_clock.go:23 in the
        # write path; LWW remains the resolution policy, lww.go:8)
        self.clocks: dict[str, VectorClock] = {}
        self._clock_lock = threading.Lock()
        self.conflicts = 0
        # spatial (content-based) routing: peer region summaries
        # pulled on a slow timer bound which peers a global search
        # fans to (reference: mesh/region.go Router + spatial_index.go
        # VP-tree; here one vectorized numpy distance over [P, D]
        # centroids). Approximate — opt-in, fails open.
        self.spatial = None
        self._spatial_stop = threading.Event()
        self._spatial_thread: Optional[threading.Thread] = None
        if spatial_routing:
            from longbow_tpu_torch.distributed.spatial import RegionRouter

            self.spatial = RegionRouter(margin=spatial_margin)
        # split-brain watchdog: compares this node's membership view
        # with alive peers' views on a slow timer (reference:
        # split_brain_detector.go:25)
        self.split_brain = SplitBrainDetector()
        self._split_brain_view: Optional[dict] = None
        self._sb_stop = threading.Event()
        self._sb_thread: Optional[threading.Thread] = None
        self._started = False
        # DNS-discovered members join live: create their Peer clients
        # and fold them into the replication/sync fan-outs
        self.membership.subscribe(self._on_member_change)
        # SWIM transport hook: indirect probes + digest piggybacking
        # travel as `gossip-probe` Flight actions over the existing
        # peer clients (reference: ping-req packets, gossip.go:235)
        self.membership.probe_action = self._gossip_action

    def _gossip_action(self, m: Member, payload: dict) -> Optional[dict]:
        peer = self._peer_for(m)
        return peer.client._action("gossip-probe", payload)

    def _make_peer(self, m: Member) -> Peer:
        return Peer(
            m.host, m.data_port, m.meta_port,
            api_key=self._api_key, tls_root_certs=self._tls_root_certs,
            # every peer hop carries a gRPC deadline: a blackholed peer
            # FAILS its calls (feeding the breaker) instead of pinning
            # fan-out pool slots forever. Generous vs the global-search
            # deadline — replication puts ride the same client.
            call_timeout_s=float(
                os.environ.get("LONGBOW_PEER_CALL_TIMEOUT_S", "60")
            ) or None,
        )

    def _peer_for(self, m: Member) -> Peer:
        p = self._peers.get(m.id)
        if p is None:
            p = self._make_peer(m)
            self._peers[m.id] = p
            if self.replicator is not None:
                self.replicator.peers.append(p)
            elif self.replication_mode != "off":
                self.replicator = PeerReplicator(
                    [p],
                    mode="async"
                    if self.replication_mode == "async"
                    else "quorum",
                    level=self._replication_level,
                )
            if self.sync_worker is not None:
                self.sync_worker.peers.append(p)
            elif self.placement == "replicated":
                # mirror the __init__ guard: Merkle anti-entropy stays
                # off in partitioned mode (it would pull every dataset
                # to every node, collapsing partitioning into full
                # replication)
                self.sync_worker = SyncWorker(self.store, [p])
                if self._started:
                    self.sync_worker.start()
        return p

    def _on_member_change(self, m: Member) -> None:
        from longbow_tpu_torch.distributed.membership import ALIVE, DEAD

        if m.status == ALIVE:
            self._peer_for(m)
            if self.ring is not None:
                self.ring.add(m.id)  # discovered nodes take ownership
        elif m.status == DEAD:
            # prune everywhere, or dead peers poison quorum math
            # (required_acks counts them) and every round pays their
            # connect timeouts; in k8s a rolling restart gives every
            # pod a fresh IP that would otherwise accumulate forever
            p = self._peers.pop(m.id, None)
            if p is not None:
                if self.replicator is not None and p in self.replicator.peers:
                    self.replicator.peers.remove(p)
                if (
                    self.sync_worker is not None
                    and p in self.sync_worker.peers
                ):
                    self.sync_worker.peers.remove(p)
                try:
                    p.client.close()
                except Exception:
                    pass
            if self.ring is not None:
                self.ring.remove(m.id)
            if self.spatial is not None:
                self.spatial.drop_peer(m.id)

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        self._started = True
        self.membership.start()
        if self.sync_worker:
            self.sync_worker.start()
        if self._peers:
            self._sb_thread = threading.Thread(
                target=self._split_brain_loop, daemon=True
            )
            self._sb_thread.start()
        if self.spatial is not None:
            self._spatial_thread = threading.Thread(
                target=self._spatial_loop, daemon=True
            )
            self._spatial_thread.start()

    def _spatial_loop(self) -> None:
        """Pull region-summary from alive peers on a slow timer and
        refresh the routing table (reference: region updates ride the
        mesh; here an explicit pull keeps the action surface small)."""
        while not self._spatial_stop.wait(10.0):
            for m in self.membership.alive():
                try:
                    resp = self._peer_for(m).client._action(
                        "region-summary", {}
                    )
                    for nm, reg in (resp or {}).get(
                        "regions", {}
                    ).items():
                        if reg.get("n"):
                            self.spatial.update(
                                m.id, nm, reg["centroid"],
                                reg["radius"], reg["n"],
                            )
                except Exception:  # peer down: summaries expire via TTL
                    continue

    def stop(self) -> None:
        self._spatial_stop.set()
        self._sb_stop.set()
        self.membership.stop()
        if self.sync_worker:
            self.sync_worker.stop()
        if self.replicator:
            self.replicator.drain(timeout_s=5.0)
            self.replicator.close()
        for p in list(self._peers.values()):
            try:
                p.client.close()
            except Exception:
                pass

    # -- write path -----------------------------------------------------

    def on_put(self, dataset, ids, vectors, columns, metric, timestamp):
        """Replicate a locally-applied put (reference:
        peer_replicator.go:76). Returns False when a quorum write
        misses its consistency level."""
        with self._clock_lock:
            clock = (
                self.clocks.setdefault(dataset, VectorClock())
                .tick(self.self_id)
                .to_dict()
            )
        if self.replicator is None:
            return True
        return self.replicator.on_put(
            dataset, ids, vectors, columns,
            metric=metric, timestamp=timestamp, clock=clock,
        )

    def observe_remote_clock(self, dataset: str, remote: dict) -> None:
        """Merge a replica write's origin clock; count concurrent
        (conflicting, LWW-resolved) writes so operators can see silent
        conflict resolution happening (reference: vector_clock.go:23)."""
        rc = VectorClock.from_dict(remote)
        with self._clock_lock:
            local = self.clocks.setdefault(dataset, VectorClock())
            if local.compare(rc) == "concurrent":
                self.conflicts += 1
                try:
                    from longbow_tpu_torch.metrics import get_registry

                    reg = get_registry()
                    reg.inc("longbow_replication_conflicts_total")
                    reg.inc("longbow_vector_clock_conflicts_total")
                except Exception:
                    pass
                log.warning(
                    "concurrent writes on %s (LWW resolved): %s vs %s",
                    dataset, local.to_dict(), remote,
                )
            local.merge(rc)
            try:
                from longbow_tpu_torch.metrics import get_registry

                get_registry().inc("longbow_vector_clock_merges_total")
            except Exception:
                pass

    def _split_brain_loop(self) -> None:
        while not self._sb_stop.wait(15.0):
            try:
                self._split_brain_view = self.check_split_brain()
            except Exception:
                pass

    def check_split_brain(self) -> dict:
        """One membership-view comparison round; caches the verdict
        for status() (reference: split_brain_detector.go:25)."""
        mine = {
            m.id: m.status == "alive"
            for m in self.membership.members.values()
        }
        # count self: a 3-node cluster losing one peer still holds a
        # 2/3 majority — excluding self flagged split_brain=True on
        # every routine single-node failure
        mine[self.self_id] = True
        peer_views: dict[str, dict] = {}
        for m in self.membership.alive():
            try:
                st = self._peer_for(m).client.cluster_status()
                peer_views[m.id] = {
                    x["id"]: x.get("status") == "alive"
                    for x in st.get("members", [])
                    if x.get("id") in mine
                }
            except Exception:
                continue
        verdict = self.split_brain.check(mine, peer_views)
        try:
            from longbow_tpu_torch.metrics import get_registry

            reg = get_registry()
            split = bool(verdict["split_brain"])
            reg.set("longbow_cluster_split_brain", 1.0 if split else 0.0)
            # fenced_state mirrors the verdict 1:1 — this node treats a
            # detected partition as fenced for operator alerts
            reg.set("longbow_split_brain_fenced_state", int(split))
            reg.inc("longbow_split_brain_heartbeats_total", len(peer_views))
            reg.set(
                "longbow_split_brain_healthy_peers",
                sum(1 for v in mine.values() if v),
            )
            if split:
                reg.inc("longbow_split_brain_partitions_total")
        except Exception:
            pass
        return verdict

    def on_delete(self, dataset, ids, timestamp=None) -> bool:
        """Sends a delete to the peers at the time the origin stamped on
        it (timestamp), so that their tombstones equal its own."""
        if self.placement == "partitioned":
            # broadcast: only the owner holds the row, everyone else's
            # delete is an idempotent no-op (reference routes deletes by
            # key through the ring; broadcast trades one cheap RPC per
            # node for not tracking ownership on the delete path)
            # snapshot: the probe thread inserts discovered peers
            # concurrently (dict mutation during iteration)
            for p in list(self._peers.values()):
                p.replicate_delete(dataset, ids, timestamp)
            return True
        if self.replicator is None:
            return True
        return self.replicator.on_delete(dataset, ids, timestamp)

    def partition_put(
        self, dataset, ids, vectors, columns, metric, timestamp
    ) -> "np.ndarray":
        """Partitioned placement: route each row to its ring owner
        (reference: partition proxy sharding/proxy.go:21-145 + ring
        assignment). Forwards remote slices as replication-marked puts
        (the owner applies them without re-forwarding) and returns the
        boolean mask of rows THIS node keeps. Rows whose owner is
        unreachable stay local — availability over placement purity
        (the reference's forwarder falls back the same way)."""
        try:
            from longbow_tpu_torch.metrics import get_registry

            _reg = get_registry()
        except Exception:
            _reg = None
        ids = np.asarray(ids)
        owners = np.asarray(
            [self.ring.lookup(str(i)) for i in ids.tolist()]
        )
        keep = owners == self.self_id
        for node in set(owners.tolist()) - {self.self_id}:
            sl = owners == node
            peer = self._peers.get(node)
            cols = (
                {k: np.asarray(v)[sl] for k, v in columns.items()}
                if columns
                else None
            )
            t0 = time.perf_counter()
            ok = peer is not None and peer.replicate_put(
                dataset, ids[sl], np.asarray(vectors)[sl], cols,
                metric, timestamp,
            )
            if _reg is not None:
                _reg.inc(
                    "longbow_load_balancer_selections_total",
                    strategy="ring",
                )
                _reg.inc(
                    "longbow_proxy_requests_forwarded_total",
                    method="DoPut", status="ok" if ok else "error",
                )
                _reg.observe(
                    "longbow_proxy_request_latency_seconds",
                    time.perf_counter() - t0,
                    method="DoPut",
                )
            if not ok:
                keep = keep | sl  # owner down: keep rows serving here
        if _reg is not None:
            alive = {m.id for m in self.membership.alive()}
            _reg.set("longbow_load_balancer_replicas_total", len(alive))
            _reg.set(
                "longbow_load_balancer_unhealthy_total",
                max(len(self._peers) - len(alive), 0),
            )
        return keep

    # -- read path ------------------------------------------------------

    def has_peers(self) -> bool:
        return bool(self.membership.alive())

    def _fanout_pool(self, fanout: int) -> ThreadPoolExecutor:
        """Shared executor for peer fan-outs, sized to 2x the largest
        fan-out seen (headroom for stragglers still holding slots past
        a deadline). Recreated on growth; the old pool drains itself."""
        need = max(8, 2 * fanout)
        with self._pool_mu:
            if self._pool is None or self._pool_size < need:
                old = self._pool
                self._pool = ThreadPoolExecutor(
                    max_workers=need,
                    thread_name_prefix="longbow-fanout",
                )
                self._pool_size = need
                if old is not None:
                    old.shutdown(wait=False)
            return self._pool

    def global_search(
        self,
        dataset: str,
        query_vectors: np.ndarray,
        k: int,
        *,
        raw_filters=None,
        local: Optional[tuple] = None,
        metric: Optional[str] = "l2",
        consistency: str = "",
        hybrid: Optional[dict] = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fan `VectorSearch {local_only: true}` out to alive peers,
        merge with the local top-k (reference: global_search.go:48-280;
        per-peer flight clients, merged local+remote results).

        local: optional (ids, scores, ok) from the local search.
        metric: None = unknown locally (the dataset lives only on
        peers) — resolved from the peers' responses so dot-metric
        scores merge in the right direction.
        consistency: ""/best-effort, or ONE|QUORUM|ALL — raises
        ConsistencyError when fewer nodes (peers + self) answer than
        the level requires (reference: quorum.go:93-126).
        hybrid: optional {"text_query", "alpha", "fusion",
        "graph_alpha", "graph_depth"} — forwarded to every peer so
        each runs its LOCAL hybrid pipeline (the reference forwards
        the full VectorSearchRequest, global_search.go:48). Because
        BM25 statistics are node-local, per-node fused scores are NOT
        comparable across nodes; hybrid responses merge by
        reciprocal-rank fusion over the per-node ranked lists (scores
        returned are RRF scores — documented in docs/DISTRIBUTED.md).
        Returns merged (ids [B,k] object, scores [B,k] f32, ok [B,k]).
        """
        try:
            from longbow_tpu_torch.metrics import get_registry

            _reg = get_registry()
        except Exception:
            _reg = None
        _t0 = time.perf_counter()
        qv = np.atleast_2d(np.asarray(query_vectors, np.float32))
        b = qv.shape[0]
        # per-query candidate pools {id: best_score}; direction is
        # resolved after the fan-out when the metric is unknown
        bigger_better = metric == "dot"
        pools: list[dict] = [dict() for _ in range(b)]

        def fold(ids, scores, ok):
            for row in range(min(b, ids.shape[0])):
                for j in range(ids.shape[1]):
                    if not ok[row, j]:
                        continue
                    uid = ids[row, j]
                    uid = uid.item() if hasattr(uid, "item") else uid
                    s = float(scores[row, j])
                    cur = pools[row].get(uid)
                    if cur is None or (s > cur if bigger_better else s < cur):
                        pools[row][uid] = s

        alive = self.membership.alive()
        if self.spatial is not None and alive:
            kept, skipped = self.spatial.route(
                dataset, qv, [m.id for m in alive], metric=metric
            )
            if skipped:
                keep = set(kept)
                alive = [m for m in alive if m.id in keep]
                if _reg is not None:
                    _reg.inc(
                        "longbow_spatial_routing_skipped_total",
                        skipped,
                    )
        results: list[Optional[dict]] = [None] * len(alive)

        def one(i: int, m: Member):
            # Arrow both directions via DoExchange (reference streams
            # Arrow for exactly this hop, stream_aggregator.go:17 —
            # JSON-encoded vectors/results don't scale past toy sizes)
            peer = self._peer_for(m)
            # breaker gate (reference: per-peer breakers on every hop):
            # a peer that keeps failing/hanging is skipped outright
            # rather than burning a shared pool slot per request
            if not peer.breaker.allow():
                return
            # per-peer in-flight cap: a hung peer saturates ITS slots,
            # not the shared pool (head-of-line isolation)
            if not peer.search_slots.acquire(blocking=False):
                if _reg is not None:
                    _reg.inc(
                        "longbow_global_search_peer_saturated_total"
                    )
                return
            try:
                tables, peer_metric = peer.client.exchange_search(
                    dataset, [qv], k,
                    filters=raw_filters, local_only=True,
                    with_metric=True, hybrid=hybrid,
                )
                t = tables[0]
                results[i] = {
                    "ids": t.column("id").to_pylist(),
                    "scores": t.column("score").to_numpy(
                        zero_copy_only=False
                    ),
                    "query_index": t.column("query_index").to_numpy(
                        zero_copy_only=False
                    ),
                    "metric": peer_metric,
                }
                peer.breaker.record_success()
            except Exception as e:  # peer slow/dead: skip, breaker counts
                peer.breaker.record_failure()
                log.debug("global search: peer %s failed: %s", m.id, e)
            finally:
                peer.search_slots.release()

        # pooled fan-out (reference: bounded worker pool in the global
        # coordinator, global_search.go) — thread-per-peer allocates a
        # fresh OS thread per request per peer, which at high QPS and
        # larger clusters is allocation + scheduler churn on the
        # serving path. Pool is sized lazily to the largest fan-out.
        futures = [
            self._fanout_pool(len(alive)).submit(one, i, m)
            for i, m in enumerate(alive)
        ]
        # ONE shared deadline across all waits: per-future timeouts
        # compound to n_peers x timeout worst-case wall clock
        deadline = time.monotonic() + self.global_search_timeout_s
        for f in futures:
            try:
                f.result(timeout=max(0.0, deadline - time.monotonic()))
            except FuturesTimeout:
                # leave the straggler running; its slot returns to the
                # pool when the peer call finishes or fails. `one`
                # swallows peer errors, so result() only times out.
                pass

        if _reg is not None:
            _reg.observe("longbow_global_search_fanout_size", len(alive))
            misses = sum(1 for r in results if not r)
            if misses:
                _reg.inc(
                    "longbow_global_search_partial_failures_total", misses
                )
            _reg.observe(
                "longbow_global_search_duration_seconds",
                time.perf_counter() - _t0,
            )

        # consistency accounting: answered = peers that responded + self
        # (when it holds the dataset). Replicated placement judges the
        # level against the CURRENT member view (alive peers + self),
        # like the reference's quorum of replicas (quorum.go:118): every
        # replica holds every row. Partitioned placement judges it
        # against every member this node knows, suspect and dead ones
        # included: each holds the only copy of its share, so after a
        # death ALL cannot be met. (The reference counts the alive ones
        # there too, and answers ALL from the live shares.)
        if consistency:
            if self.placement == "partitioned":
                with self.membership._lock:
                    total = len(self.membership.members) + 1
            else:
                total = len(alive) + 1
            answered = sum(1 for r in results if r) + (
                1 if local is not None else 0
            )
            required = {
                "ONE": 1,
                "QUORUM": total // 2 + 1,
                "ALL": total,
            }[consistency]
            met = answered >= required
            if _reg is not None:
                _reg.observe(
                    "longbow_quorum_operation_duration_seconds",
                    time.perf_counter() - _t0,
                    operation="search", consistency=consistency,
                )
                if met:
                    _reg.inc(
                        "longbow_quorum_success_total",
                        operation="search", consistency=consistency,
                    )
                else:
                    _reg.inc(
                        "longbow_quorum_failure_total",
                        operation="search", consistency=consistency,
                        reason="insufficient_nodes",
                    )
            if not met:
                raise ConsistencyError(
                    f"consistency {consistency} not met: "
                    f"{answered}/{total} nodes answered, "
                    f"required {required}"
                )

        if metric is None:
            # dataset unknown locally: take the metric the owning
            # peers report (VectorSearch responses carry it)
            metric = next(
                (r["metric"] for r in results if r and r.get("metric")),
                "l2",
            )
            bigger_better = metric == "dot"

        if hybrid and hybrid.get("text_query"):
            # cross-node hybrid merge: RRF over per-node ranked lists
            # (each node's fused list is already best-first; its raw
            # scores reflect node-local BM25 stats + normalization and
            # must not be compared across nodes)
            from longbow_tpu_torch.hybrid.fusion import fuse_rrf

            node_lists: list[list[list]] = [[] for _ in range(b)]
            if local is not None:
                lid, _ls, lok = local
                for row in range(min(b, lid.shape[0])):
                    lst = [
                        lid[row, j]
                        for j in range(lid.shape[1])
                        if lok[row, j]
                    ]
                    if lst:
                        node_lists[row].append(lst)
            for resp in results:
                if not resp:
                    continue
                rid = resp.get("ids", [])
                rq = resp.get("query_index")
                if rq is None:
                    rq = [0] * len(rid)
                per_row: dict[int, list] = {}
                for uid, row in zip(rid, rq):
                    if row < b:
                        # response rows are row-major in fused order
                        per_row.setdefault(int(row), []).append(uid)
                for row, lst in per_row.items():
                    node_lists[row].append(lst)
            out_ids = np.empty((b, k), dtype=object)
            out_scores = np.zeros((b, k), np.float32)
            out_ok = np.zeros((b, k), bool)
            for row in range(b):
                for j, (uid, s) in enumerate(
                    fuse_rrf(node_lists[row], k)
                ):
                    out_ids[row, j] = uid
                    out_scores[row, j] = s
                    out_ok[row, j] = True
            return out_ids, out_scores, out_ok

        if local is not None:
            fold(*local)

        for resp in results:
            if not resp:
                continue
            rid, rs, rq = (
                resp.get("ids", []),
                resp.get("scores", []),
                resp.get("query_index"),
            )
            if rq is None:
                # flattened batch=1 responses: everything is query 0
                rq = [0] * len(rid)
            for uid, s, row in zip(rid, rs, rq):
                if row >= b:
                    continue
                cur = pools[row].get(uid)
                if cur is None or (s > cur if bigger_better else s < cur):
                    pools[row][uid] = s

        out_ids = np.empty((b, k), dtype=object)
        out_scores = np.zeros((b, k), np.float32)
        out_ok = np.zeros((b, k), bool)
        for row in range(b):
            ranked = sorted(
                pools[row].items(),
                key=lambda kv: -kv[1] if bigger_better else kv[1],
            )[:k]
            for j, (uid, s) in enumerate(ranked):
                out_ids[row, j] = uid
                out_scores[row, j] = s
                out_ok[row, j] = True
        return out_ids, out_scores, out_ok

    # -- coordinated checkpoints ---------------------------------------

    def coordinated_checkpoint(self, timeout_s: float = 30.0) -> dict:
        """Two-phase cluster checkpoint (reference:
        CheckpointCoordinator InitiateCheckpoint/WaitForBarrier,
        checkpoint_coordinator.go:21-126): every alive peer first
        drains its ingest queue and acks the epoch (prepare barrier),
        and only when ALL ack does anyone snapshot+truncate — so a
        cluster restore never mixes snapshot epochs.
        """
        import time as _t

        epoch = int(_t.time() * 1000)
        alive = self.membership.alive()
        prepared, failed = [], []
        for m in alive:
            peer = self._peer_for(m)
            try:
                r = peer.client._action(
                    "checkpoint-prepare",
                    {"epoch": epoch, "timeout_s": timeout_s},
                )
                if r.get("ready"):
                    prepared.append(m.id)
                else:
                    failed.append(m.id)
            except Exception as e:
                log.warning("checkpoint prepare %s failed: %s", m.id, e)
                failed.append(m.id)
        if failed:
            return {
                "epoch": epoch, "ok": False, "phase": "prepare",
                "prepared": prepared, "failed": failed,
            }
        committed = []
        for m in alive:
            peer = self._peer_for(m)
            try:
                r = peer.client._action(
                    "checkpoint-commit", {"epoch": epoch}
                )
                if r.get("committed"):
                    committed.append(m.id)
                else:
                    failed.append(m.id)
            except Exception as e:
                log.warning("checkpoint commit %s failed: %s", m.id, e)
                failed.append(m.id)
        return {
            "epoch": epoch, "ok": not failed, "phase": "commit",
            "prepared": prepared, "committed": committed,
            "failed": failed,
        }

    def status(self) -> dict:
        st = self.membership.status()
        st["placement"] = self.placement
        if self.ring is not None:
            st["ring_nodes"] = sorted(self.ring.nodes)
        if self.replicator:
            st["replication"] = {
                "mode": self.replication_mode,
                "replicated": self.replicator.replicated,
                "failed": self.replicator.failed,
            }
        if self.sync_worker:
            st["anti_entropy"] = {"synced_rows": self.sync_worker.synced_rows}
        st["write_conflicts_lww_resolved"] = self.conflicts
        if self._split_brain_view is not None:
            st["split_brain"] = self._split_brain_view
        return st
