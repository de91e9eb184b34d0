"""A writer that crashes: puts, a snapshot, a WAL tail, then SIGKILL.

    python3 -m longbow_tpu_torch.tools.persist_child DIR [--rows N]
        [--queries B] [--device cuda|cpu]

On VectorStore(persist_dir=DIR, wal_sync="batch"):
  1. N clustered rows (bench.py's recipe: 1,024 Gaussian clusters, seed 0;
     the queries are the B rows after them) put as a flat bf16 dataset
     "sift" in 65,536-row puts with a `category` column (id mod 10),
     then 1% of the ids deleted;
  2. snapshot();
  3. a WAL tail: N/10 rows more (half of them new ids, half upserts of
     live ids), N/200 deletes, a second dataset put and dropped, one edge;
  4. wal.flush(), then the B queries' top 10 and a filtered search
     (category == 3, the first 100 queries) written to DIR/child.npz;
  5. one JSON line on standard output with what it measured, then
     SIGKILL to itself: no close(), no final snapshot.

`scenario` is the same data for a reader: the live rows after step 3
and the ids that must not come back.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time
from pathlib import Path

import numpy as np
import torch

PUT_BATCH = 65_536
DIM = 128
DROPPED_IDS = np.arange(5_000_000, 5_001_000, dtype=np.int64)  # the dropped dataset's


def make_corpus(n: int, d: int, seed: int = 0) -> np.ndarray:
    """bench.py's clustered recipe: 1,024 Gaussian clusters (centers x4,
    unit noise), seeded."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((1024, d)).astype(np.float32) * 4.0
    assign = rng.integers(0, 1024, n)
    return (centers[assign] + rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def scenario(n: int, n_queries: int) -> dict:
    """The rows and ids of every step, from seeds: corpus [n, D], queries,
    the first deletes, the tail's ids and rows, its deletes, and the live
    rows (ids, f32 rows) once it is applied."""
    allv = make_corpus(n + n_queries, DIM, seed=0)
    corpus, queries = allv[:n], allv[n:]
    rng = np.random.default_rng(1)
    dead1 = rng.choice(n, n // 100, replace=False)
    alive = np.setdiff1d(np.arange(n), dead1)
    n_tail = n // 10
    upserts = rng.choice(alive, n_tail // 2, replace=False)
    new_ids = np.arange(n, n + n_tail - len(upserts), dtype=np.int64)
    tail_ids = rng.permutation(np.concatenate([upserts, new_ids]))
    tail_rows = make_corpus(n_tail, DIM, seed=7)
    live = dict.fromkeys(alive.tolist())
    live.update(dict.fromkeys(new_ids.tolist()))
    dead2 = rng.choice(np.fromiter(live, np.int64), n // 200, replace=False)
    rows = np.zeros((n + len(new_ids), DIM), np.float32)
    rows[:n] = corpus
    rows[tail_ids] = tail_rows
    keep = np.ones(len(rows), bool)
    keep[dead1] = False
    keep[dead2] = False
    live_ids = np.nonzero(keep)[0]
    return {
        "corpus": corpus, "queries": queries, "dead1": dead1,
        "tail_ids": tail_ids, "tail_rows": tail_rows, "dead2": dead2,
        "live_ids": live_ids, "live_rows": rows[live_ids],
    }


def _ids_out(ids: np.ndarray, ok: np.ndarray) -> np.ndarray:
    out = np.full(ids.shape, -1, np.int64)
    out[ok] = ids[ok].astype(np.int64)
    return out


def run(directory: Path, n: int, n_queries: int, device: str) -> dict:
    from longbow_tpu_torch.metrics import get_registry
    from longbow_tpu_torch.query.parser import Filter
    from longbow_tpu_torch.store.vector_store import VectorStore

    sc = scenario(n, n_queries)
    corpus, queries = sc["corpus"], sc["queries"]
    out: dict = {"rows": n}
    store = VectorStore(persist_dir=directory, wal_sync="batch", device=device,
                        dtype=torch.bfloat16)
    eng = store.engine
    out["wal_backend"] = eng.wal.backend_name
    snapshots = []
    real_snapshot = eng.snapshot

    def counted_snapshot(st):  # explicit and WAL-triggered snapshots alike
        t0 = time.perf_counter()
        real_snapshot(st)
        snapshots.append(time.perf_counter() - t0)

    eng.snapshot = counted_snapshot
    frames = 0
    store.get_or_create("sift", DIM, index_kind="flat")
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    wal_bytes = get_registry().counter("longbow_wal_bytes_written_total")._only()
    bytes0 = wal_bytes.value
    sync()
    t0 = time.perf_counter()
    for s in range(0, n, PUT_BATCH):
        e = min(s + PUT_BATCH, n)
        ids = np.arange(s, e, dtype=np.int64)
        store.put("sift", ids, corpus[s:e], {"category": ids % 10})
        frames += 1
    store.get("sift").index.flush()
    sync()
    out["logged_ingest_s"] = time.perf_counter() - t0
    out["logged_ingest_rows_per_s"] = n / out["logged_ingest_s"]
    out["wal_bytes_per_row"] = (wal_bytes.value - bytes0) / n
    if store.delete("sift", sc["dead1"]) != len(sc["dead1"]):
        raise SystemExit("persist_child: the first deletes did not all apply")
    frames += 1
    out["snapshots_during_ingest"] = len(snapshots)
    out["snapshot_s_during_ingest"] = sum(snapshots)
    if eng._snap_bg is not None:
        eng._snap_bg.join()  # a WAL-triggered snapshot still writing
    n_before = len(snapshots)
    store.snapshot()
    out["snapshot_s"] = snapshots[-1] if len(snapshots) > n_before else None
    snap_dir = directory / "snapshot"
    out["snapshot_bytes"] = sum(p.stat().st_size for p in snap_dir.rglob("*") if p.is_file())
    frames_before_tail = frames

    tail_ids, tail_rows = sc["tail_ids"], sc["tail_rows"]
    for s in range(0, len(tail_ids), PUT_BATCH):
        e = min(s + PUT_BATCH, len(tail_ids))
        store.put("sift", tail_ids[s:e], tail_rows[s:e], {"category": tail_ids[s:e] % 10})
        frames += 1
    store.delete("sift", sc["dead2"])
    store.get_or_create("gone", DIM, index_kind="flat")
    store.put("gone", DROPPED_IDS, corpus[: len(DROPPED_IDS)])
    store.drop("gone")
    store.add_edge("sift", int(tail_ids[0]), int(tail_ids[1]), "rel", 1.0)
    frames += 4
    eng.wal.flush()
    out["frames"] = frames
    out["tail_frames"] = frames - frames_before_tail
    out["last_seq"] = eng.wal._seq
    reg = get_registry()
    out["wal_writes_total"] = reg.counter("longbow_wal_writes_total", ("status",)).labels(
        status="ok").value
    out["snapshots"] = len(snapshots)
    out["snapshot_histogram_count"] = sum(
        reg.histogram("longbow_snapshot_duration_seconds")._only().counts)

    ids, dist, ok = store.search("sift", queries, 10, use_cache=False)
    fids, _, fok = store.search("sift", queries[:100], 10, use_cache=False,
                                filters=[Filter("category", "eq", "3")])
    np.savez(directory / "child.npz", ids=_ids_out(ids, ok), dist=dist.astype(np.float32),
             filtered_ids=_ids_out(fids, fok))
    with open(directory / "child.npz", "rb") as f:
        os.fsync(f.fileno())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir", type=Path)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=1_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = run(args.dir, args.rows, args.queries, args.device)
    print(json.dumps({"persist_child": out}), flush=True)
    os.kill(os.getpid(), signal.SIGKILL)
    return 1  # not reached


if __name__ == "__main__":
    raise SystemExit(main())
