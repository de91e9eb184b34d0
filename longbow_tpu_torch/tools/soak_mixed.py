"""Mixed-load soak against a live node, the port's twin of
tools/soak_mixed.py: ingest, upserts (tombstone pressure, so live
compactions), deletes and searches at once, with a read-back check at
the end.

  python -m longbow_tpu_torch.tools.soak_mixed [DURATION_S] [--host localhost]
      [--data-port 3000] [--meta-port 3001] [--metrics-port 9090]

Seeds a flat l2 dataset "soak" (capacity 1,000,000) with 100,000 rows of
128 floats (numpy default_rng(0)), waits for the node's ingest queue to
drain, then runs for DURATION_S seconds (default 1200):
  - one writer: 1,000 rows every 0.4 s, half fresh ids and half upserts
    of existing ones (default_rng(1)); every 100th row is kept as that
    id's acknowledged vector, and a kept vector is dropped when its id is
    written again unkept (the reference keeps it, and then counts the
    newer row as a miss);
  - three searchers: k = 10 queries back to back (default_rng(100 + i));
  - one deleter: 200 random ids every 5 s (default_rng(7)).
A progress line, with the node's compaction and fragmentation metrics, is
printed every 60 s and at the end. After the load, the queue drains again,
the last 40 kept vectors are searched with k = 1, and the reference's END
line is printed, then one JSON line with every count.

The writer and the deleter take turns, and a delete waits for the node's
ingest queue to be empty first: an acknowledged write is queued (async
ingest) and a delete is not, so without the wait a delete could reach the
rows before a write acknowledged ahead of it. That makes the set of ids
deleted and not written since exact, and the check that none of them is
in a final scan of the dataset sound.

Unlike the reference, which only prints its counts, the exit code is 1
when a kept acknowledged write is not its own first answer, when no write
was kept (nothing to check), when any search errored, or when a deleted
id is still in the dataset; else 0.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request

import numpy as np

DS = "soak"
DIM = 128
N0 = 100_000                 # seeded rows
CAPACITY = 1_000_000         # the dataset's pre-sized rows
SEED_BATCH = 20_000
WRITE_ROWS, WRITE_EVERY_S = 1_000, 0.4
SAMPLE_EVERY = 100           # every 100th written row is kept for the end check
SEARCHERS = 3
DELETE_ROWS, DELETE_EVERY_S = 200, 5.0
REPORT_EVERY_S = 60.0
CHECKED = 40                 # kept vectors searched at the end
WARM_S, DRAIN_S = 20.0, 15.0  # the longest waits for the queue to drain


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("duration", nargs="?", type=float, default=1200.0,
                    help="seconds of mixed load")
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--data-port", type=int, default=3000)
    ap.add_argument("--meta-port", type=int, default=3001)
    ap.add_argument("--metrics-port", type=int, default=9090)
    return ap.parse_args(argv)


def settle(client, limit_s: float) -> None:
    """Waits (at most limit_s) until the node is ready with an empty
    ingest queue."""
    t0 = time.time()
    while time.time() - t0 < limit_s:
        try:
            r = client.check_readiness()
            if r.get("status") == "READY" and not r.get("index_queue_depth"):
                return
        except Exception:
            pass
        time.sleep(0.05)


def main(argv=None) -> int:
    args = parse_args(argv)
    from longbow_tpu_torch.serving.client import LongbowClient

    def connect():
        return LongbowClient(args.host, data_port=args.data_port,
                             meta_port=args.meta_port).connect()

    c0 = connect()
    try:
        c0.create_namespace(DS, dim=DIM, metric="l2", index="flat", capacity=CAPACITY)
    except Exception as e:
        print("create:", e)
    rng = np.random.default_rng(0)
    for off in range(0, N0, SEED_BATCH):
        c0.write(DS, np.arange(off, off + SEED_BATCH, dtype=np.int64),
                 rng.standard_normal((SEED_BATCH, DIM)).astype(np.float32))
    print("seeded", N0, flush=True)
    settle(c0, WARM_S)
    c0.search(DS, np.zeros(DIM, np.float32), k=10)  # warm

    stop = threading.Event()
    stats = {"writes": 0, "werr": 0, "searches": 0, "serr": 0, "deletes": 0, "derr": 0}
    latest: dict = {}      # id -> its last acknowledged vector, sampled
    deleted: set = set()   # ids deleted and not written since
    lk = threading.Lock()  # stats, latest, deleted, next_id
    turn = threading.Lock()  # the writer's and the deleter's calls, one at a time
    next_id = [N0]

    def writer():
        c = connect()
        r = np.random.default_rng(1)
        while not stop.is_set():
            fresh = r.integers(0, 2) == 0
            n = WRITE_ROWS
            with lk:
                if fresh:
                    ids = np.arange(next_id[0], next_id[0] + n, dtype=np.int64)
                    next_id[0] += n
                else:
                    ids = np.asarray(r.choice(next_id[0], n, replace=False), dtype=np.int64)
            v = r.standard_normal((n, DIM)).astype(np.float32)
            try:
                with turn:
                    c.write(DS, ids, v)
                    with lk:
                        stats["writes"] += n
                        deleted.difference_update(ids.tolist())
                        for j, uid in enumerate(ids.tolist()):
                            if j % SAMPLE_EVERY == 0:
                                latest[uid] = v[j].copy()
                            else:  # an upsert not kept: a kept vector of it is stale
                                latest.pop(uid, None)
            except Exception:
                with lk:
                    stats["werr"] += 1
                time.sleep(1)
            time.sleep(WRITE_EVERY_S)
        c.close()

    def searcher(i):
        c = connect()
        r = np.random.default_rng(100 + i)
        lat = []
        while not stop.is_set():
            try:
                t0 = time.perf_counter()
                c.search(DS, r.standard_normal(DIM).astype(np.float32), k=10)
                lat.append(time.perf_counter() - t0)
                with lk:
                    stats["searches"] += 1
            except Exception:
                with lk:
                    stats["serr"] += 1
                time.sleep(0.5)
        stats[f"lat{i}"] = lat
        c.close()

    def deleter():
        c = connect()
        r = np.random.default_rng(7)
        while not stop.is_set():
            with lk:
                ids = r.choice(next_id[0], DELETE_ROWS, replace=False).tolist()
            try:
                with turn:
                    settle(c, DRAIN_S)
                    c.delete(DS, ids)
                    with lk:
                        stats["deletes"] += DELETE_ROWS
                        deleted.update(ids)
                        for i in ids:
                            latest.pop(int(i), None)
            except Exception:
                with lk:
                    stats["derr"] += 1
            stop.wait(DELETE_EVERY_S)
        c.close()

    def report(elapsed: float) -> None:
        try:
            url = f"http://{args.host}:{args.metrics_port}/metrics"
            m = urllib.request.urlopen(url, timeout=10).read().decode()
            comp = [ln for ln in m.splitlines()
                    if ln.startswith("longbow_compaction_operations_total")]
            frag = [ln for ln in m.splitlines()
                    if ln.startswith("longbow_memory_fragmentation_ratio")]
        except Exception as e:
            comp, frag = [f"metrics err {e}"], []
        print(f"[{elapsed:.0f}s] {stats['writes']}w/{stats['werr']}we "
              f"{stats['searches']}s/{stats['serr']}se {stats['deletes']}d/{stats['derr']}de "
              f"| {comp} {frag}", flush=True)

    threads = ([threading.Thread(target=writer)]
               + [threading.Thread(target=searcher, args=(i,)) for i in range(SEARCHERS)]
               + [threading.Thread(target=deleter)])
    t0 = time.time()
    for t in threads:
        t.start()
    while (left := args.duration - (time.time() - t0)) > 0:
        time.sleep(min(REPORT_EVERY_S, left))
        report(time.time() - t0)
    stop.set()
    for t in threads:
        t.join(timeout=60)

    # ---- invariant checks ----
    settle(c0, DRAIN_S)
    fails = 0
    with lk:
        sample = list(latest.items())[-CHECKED:]
    ok_top1 = 0
    for uid, vec in sample:
        try:
            t = c0.search(DS, vec, k=1)
            if t.column("id")[0].as_py() == uid:
                ok_top1 += 1
        except Exception:
            fails += 1
    live = set(c0.scan(DS).column("id").to_pylist())
    back = sorted(live & deleted)
    c0.close()
    la = np.asarray(sorted(sum((stats.get(f"lat{i}", []) for i in range(SEARCHERS)), []))) * 1000
    p50, p99 = (np.percentile(la, 50), np.percentile(la, 99)) if len(la) else (0.0, 0.0)
    print(f"END: top1 self-match {ok_top1}/{len(sample)} (errors {fails}); "
          f"search p50 {p50:.0f}ms p99 {p99:.0f}ms n={len(la)}", flush=True)
    ok = (0 < len(sample) == ok_top1 and fails == 0 and stats["serr"] == 0
          and not back)
    print(json.dumps({
        "seconds": time.time() - t0, **{k: stats[k] for k in
                                         ("writes", "werr", "searches", "serr", "deletes", "derr")},
        "top1_self_match": ok_top1, "checked": len(sample), "check_errors": fails,
        "live_rows": len(live), "deleted_ids": len(deleted), "deleted_ids_back": back[:20],
        "search_p50_ms": float(p50), "search_p99_ms": float(p99), "ok": ok,
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
