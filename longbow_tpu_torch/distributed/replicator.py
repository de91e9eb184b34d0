"""Peer replication with quorum and per-peer circuit breakers.

Counterpart of longbow_tpu/distributed/replicator.py, over this package's
client (serving/client.py, pyarrow.flight) and CircuitBreaker.

reference: PeerReplicator async/quorum record replication with per-peer
breakers (peer_replicator.go:76-370), QuorumManager ONE/QUORUM/ALL
(quorum.go:15-230). Transport is the same Arrow Flight protocol clients
use (DoPut / delete actions), so a replica is just another longbow-tpu
server.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np

from longbow_tpu_torch.serving.client import LongbowClient
from longbow_tpu_torch.serving.middleware import CircuitBreaker

ONE = "ONE"
QUORUM = "QUORUM"
ALL = "ALL"


def required_acks(level: str, n_peers: int) -> int:
    """Peer acks needed to satisfy `level`. QUORUM counts the LOCAL
    replica toward the majority (the local apply always succeeded by
    the time replication runs), matching the read path: a 3-node
    cluster with one peer down still satisfies QUORUM with 1 peer ack
    (2/3 nodes hold the write)."""
    if level == ONE:
        return min(1, n_peers)
    if level == ALL:
        return n_peers
    # majority of (peers + self), minus self's own implicit ack
    return max(0, (n_peers + 1) // 2 + 1 - 1) if n_peers else 0


class Peer:
    def __init__(
        self, host: str, data_port: int, meta_port: int,
        api_key=None, tls_root_certs=None, call_timeout_s=None,
    ):
        self.addr = f"{host}:{data_port}"
        self.client = LongbowClient(
            host, data_port, meta_port,
            api_key=api_key, tls_root_certs=tls_root_certs,
            call_timeout_s=call_timeout_s,
        )
        self.breaker = CircuitBreaker(
            threshold=5, cooldown_s=10.0, name=f"peer:{self.addr}"
        )
        # per-peer in-flight cap for search fan-out: one hung/blackholed
        # peer must not consume every slot of the SHARED fan-out pool
        # (head-of-line blocking would degrade later global searches to
        # local-only until the hangs clear). Non-blocking acquire —
        # a saturated peer is skipped for that request, not waited on.
        self.search_slots = threading.BoundedSemaphore(8)

    def replicate_put(
        self, dataset, ids, vectors, columns, metric=None, timestamp=None,
        clock=None,
    ) -> bool:
        if self.breaker.state == "half-open":
            # a half-open probe IS the retry after earlier failures
            try:
                from longbow_tpu_torch.metrics import get_registry

                get_registry().inc("longbow_replication_retries_total")
            except Exception:
                pass
        if not self.breaker.allow():
            return False
        try:
            self.client.write(
                dataset, ids, vectors, columns, metric,
                timestamp=timestamp, replicated=True, clock=clock,
            )
            self.breaker.record_success()
            return True
        except Exception:
            self.breaker.record_failure()
            return False

    def replicate_delete(self, dataset, ids, timestamp=None) -> bool:
        """timestamp: the origin's delete time, sent as "timestamp" (a
        longbow_tpu node ignores the key and stamps its own)."""
        if not self.breaker.allow():
            return False
        try:
            ids = [i.item() if hasattr(i, "item") else i for i in ids]
            body = {"dataset": dataset, "ids": ids, "replicated": True}
            if timestamp is not None:
                body["timestamp"] = float(timestamp)
            self.client._action("delete", body)
            self.breaker.record_success()
            return True
        except Exception:
            self.breaker.record_failure()
            return False


class PeerReplicator:
    """Replicates local writes to peers.

    mode 'async': fire-and-forget via a background queue (reference
    default). mode 'quorum': the write call blocks until
    required_acks(level) peers ack.
    """

    def __init__(
        self,
        peers: list[Peer],
        mode: str = "async",
        level: str = QUORUM,
        queue_size: int = 4096,
    ):
        from concurrent.futures import ThreadPoolExecutor

        self.peers = peers
        self.mode = mode
        self.level = level
        # parallel fan-out: one hung peer must not add its full
        # timeout to every other peer's replication (sequential
        # fan-out lag compounds across the shared async queue)
        self._pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="longbow-repl"
        )
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self.replicated = 0
        self.failed = 0
        if mode == "async":
            self._worker = threading.Thread(target=self._loop, daemon=True)
            self._worker.start()

    def _observe(self, enq_ts: float) -> None:
        try:
            from longbow_tpu_torch.metrics import get_registry

            reg = get_registry()
            reg.gauge("longbow_replication_queue_depth").set(
                self._q.qsize()
            )
            # the async queue is shared, so lag is per-fanout not
            # per-peer; label with the slowest peer's address (reference
            # labels peer, docs/metrics.md Replication & Quorum)
            lag = max(time.time() - enq_ts, 0.0)
            for p in self.peers:
                reg.set(
                    "longbow_replication_lag_seconds", lag, peer=p.addr
                )
            reg.set("longbow_replication_peers_total", len(self.peers))
        except Exception:
            pass  # metrics must never fail replication

    def _loop(self):
        while not self._stop.is_set():
            try:
                enq_ts, job = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            self._fanout(*job)
            self._observe(enq_ts)

    def _fanout(
        self, kind, dataset, ids, vectors, columns, metric=None, ts=None,
        clock=None,
    ) -> int:
        peers = list(self.peers)  # DEAD pruning mutates the live list

        def _one(p: Peer) -> bool:
            return (
                p.replicate_put(
                    dataset, ids, vectors, columns, metric, ts, clock
                )
                if kind == "put"
                else p.replicate_delete(dataset, ids, ts)
            )

        if len(peers) <= 1:
            results = [_one(p) for p in peers]
        else:
            results = list(self._pool.map(_one, peers))
        acks = sum(map(int, results))
        self.replicated += acks
        self.failed += len(peers) - acks
        try:
            from longbow_tpu_torch.metrics import get_registry

            reg = get_registry()
            if acks:
                reg.inc("longbow_replication_success_total", acks)
            if len(peers) - acks:
                reg.inc(
                    "longbow_replication_failures_total",
                    len(peers) - acks,
                )
        except Exception:
            pass
        return acks

    def on_put(
        self, dataset, ids, vectors, columns=None, metric=None,
        timestamp=None, clock=None,
    ) -> bool:
        """Returns True when the consistency level is satisfied."""
        if self.mode == "async":
            try:
                self._q.put_nowait((
                    time.time(),
                    ("put", dataset, ids, vectors, columns, metric,
                     timestamp, clock),
                ))
                try:
                    from longbow_tpu_torch.metrics import get_registry

                    get_registry().inc("longbow_replication_queued_total")
                except Exception:
                    pass
                return True
            except queue.Full:
                return False
        t0 = time.perf_counter()
        acks = self._fanout(
            "put", dataset, ids, vectors, columns, metric, timestamp,
            clock,
        )
        met = acks >= required_acks(self.level, len(self.peers))
        self._observe_quorum("put", met, time.perf_counter() - t0)
        return met

    def on_delete(self, dataset, ids, timestamp=None) -> bool:
        if self.mode == "async":
            try:
                self._q.put_nowait((
                    time.time(),
                    ("delete", dataset, ids, None, None, None, timestamp,
                     None),
                ))
                return True
            except queue.Full:
                return False
        t0 = time.perf_counter()
        acks = self._fanout("delete", dataset, ids, None, None, None, timestamp)
        met = acks >= required_acks(self.level, len(self.peers))
        self._observe_quorum("delete", met, time.perf_counter() - t0)
        return met

    def _observe_quorum(self, op: str, met: bool, dt: float) -> None:
        try:
            from longbow_tpu_torch.metrics import get_registry

            reg = get_registry()
            reg.observe(
                "longbow_quorum_operation_duration_seconds", dt,
                operation=op, consistency=self.level,
            )
            if met:
                reg.inc(
                    "longbow_quorum_success_total",
                    operation=op, consistency=self.level,
                )
            else:
                reg.inc(
                    "longbow_quorum_failure_total",
                    operation=op, consistency=self.level,
                    reason="insufficient_acks",
                )
        except Exception:
            pass

    def drain(self, timeout_s: float = 10.0) -> None:
        t0 = time.time()
        while not self._q.empty() and time.time() - t0 < timeout_s:
            time.sleep(0.02)

    def close(self):
        self._stop.set()
        if self._worker:
            self._worker.join(timeout=2)
        self._pool.shutdown(wait=False)
        for p in self.peers:
            try:
                p.client.close()
            except Exception:
                pass


class SyncWorker:
    """Merkle anti-entropy against peers (reference:
    mesh/sync/sync_worker.go:41-250): compare roots, diff buckets, pull
    newer rows / deletions via LWW merge."""

    def __init__(self, store, peers: list[Peer], interval_s: float = 30.0):
        self.store = store
        self.peers = peers
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.synced_rows = 0

    def sync_dataset_once(self, name: str) -> int:
        """Pull divergent rows for one dataset from all peers; returns
        rows applied locally."""
        from longbow_tpu_torch.distributed.merkle import MerkleTree

        from longbow_tpu_torch.metrics import get_registry

        reg = get_registry()
        applied = 0
        try:
            ds = self.store.get(name)
            mine = MerkleTree.from_dataset(ds)
        except KeyError:
            # dataset only exists on peers (e.g. this node restarted
            # with a lost disk): pull every bucket; rows re-create it
            ds = None
            mine = None
        healed = False
        for p in self.peers:
            if healed:
                # rows came from the previous peer: compare the next one
                # with this node's tree as it stands now. (The reference
                # keeps the tree of the round's start, so a second peer
                # that is current differs in every bucket the first one
                # healed, and every have list is sent to it again.)
                try:
                    ds = self.store.get(name)
                    mine = MerkleTree.from_dataset(ds)
                except KeyError:
                    pass
                healed = False
            try:
                remote = p.client._action(
                    "merkle-state", {"dataset": name}
                )
            except Exception:
                continue
            if mine is not None and remote.get("root") == mine.root_hex:
                reg.inc("longbow_mesh_merkle_match_total", result="match")
                continue
            reg.inc("longbow_mesh_merkle_match_total", result="mismatch")
            theirs = [bytes.fromhex(x) for x in remote["leaves"]]
            if mine is not None:
                diff = mine.diff_buckets(theirs)
                with ds._lock:  # consistent (bucket, ts) snapshot
                    bucket_ids = ds._bucket_map()
                    haves = {
                        b: [[u, ds._lww[u]] for u in bucket_ids.get(b, ())]
                        for b in diff
                    }
            else:
                import hashlib as _hashlib

                empty_leaf = _hashlib.blake2b(digest_size=16).digest()
                diff = [
                    i for i, leaf in enumerate(theirs)
                    if leaf != empty_leaf  # non-empty remote bucket
                ]
                haves = {b: [] for b in diff}
            # batched pulls: one RPC per ~64 buckets (per-bucket round
            # trips against a write-busy donor measured ~75ms each —
            # the whole 256-bucket sweep cost ~19s/round), have-lists
            # keep each bucket's transfer delta-only
            GROUP = 64
            for goff in range(0, len(diff), GROUP):
                group = diff[goff : goff + GROUP]
                try:
                    delta = p.client._action(
                        "export-delta",
                        {
                            "dataset": name,
                            "buckets": group,
                            "haves": {
                                str(b): haves[b] for b in group
                            },
                        },
                    )
                except Exception:
                    reg.inc(
                        "longbow_mesh_sync_deltas_total", status="error"
                    )
                    continue
                got = self._apply_delta(name, delta)
                applied += got
                healed = healed or got > 0
                reg.inc("longbow_mesh_sync_deltas_total", status="ok")
                reg.inc(
                    "longbow_mesh_sync_bytes_total",
                    sum(
                        len(r.get("vector", [])) * 4
                        for r in delta.get("rows", [])
                    ),
                )
        self.synced_rows += applied
        return applied

    def _apply_delta(self, name: str, delta: dict) -> int:
        """Apply one bucket's divergent rows in BATCHES: the per-row
        store.put version healed at ~1k rows/s, so a node restarted
        under write load could not catch up within sync rounds
        (chaos-soak regression after the 12x ingest rewrite)."""
        try:
            ds = self.store.get(name)
        except KeyError:
            ds = None  # first pulled rows create it via store.put
        put_ids: list = []
        put_vecs: list = []
        put_ts: list = []
        put_cols: list = []
        del_ids: list = []
        del_ts: list = []
        for rec in delta.get("rows", []):
            uid = rec["id"]
            ts = rec["ts"]
            if ds is not None:
                local_ts = ds._lww.get(ds._key(np.asarray(uid)))
                if local_ts is not None and local_ts >= ts:
                    continue  # LWW: ours is newer (put re-checks)
            if rec.get("deleted"):
                del_ids.append(uid)
                del_ts.append(ts)
            else:
                put_ids.append(uid)
                put_vecs.append(rec["vector"])
                put_ts.append(ts)
                put_cols.append(rec.get("columns"))
        if del_ids and ds is not None:
            # atomic LWW-checked tombstones: a newer concurrent local
            # put must survive and its ts must not roll back
            ds.apply_remote_tombstones(del_ids, del_ts)
        if put_ids:
            columns = None
            if put_cols and all(c is not None for c in put_cols):
                keys = sorted(set().union(*put_cols))
                columns = {
                    k: np.asarray([c.get(k) for c in put_cols])
                    for k in keys
                }
            self.store.put(
                name,
                np.asarray(put_ids),
                np.asarray(put_vecs, dtype=np.float32),
                columns,
                timestamp=np.asarray(put_ts, dtype=np.float64),
                _log=False,
            )
        return len(del_ids) + len(put_ids)

    def run_once(self) -> int:
        total = 0
        # union with peers' dataset lists: a node restarted with a
        # lost disk has nothing locally and would otherwise never pull
        names = set(self.store.list_datasets())
        for p in self.peers:
            try:
                remote = p.client._action("list-datasets", {})
                if isinstance(remote, list):
                    names.update(remote)
            except Exception:
                pass
        for name in sorted(names):
            try:
                total += self.sync_dataset_once(name)
            except Exception:
                # one bad dataset (e.g. dropped mid-round) must not
                # abort the rest of the sweep
                import logging

                logging.getLogger("longbow.sync").exception(
                    "anti-entropy failed for dataset %r", name
                )
        return total

    def start(self):
        def loop():
            wait = self.interval_s
            while not self._stop.wait(wait):
                try:
                    applied = self.run_once()
                    # converge fast after a restart: keep pulling
                    # back-to-back while rounds find BULK divergence.
                    # The threshold keeps steady replication lag (a few
                    # rows per round under live writes) from turning
                    # this into a permanent 200ms full-merkle hot loop.
                    wait = 0.2 if applied >= 64 else self.interval_s
                except Exception:
                    wait = self.interval_s

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
