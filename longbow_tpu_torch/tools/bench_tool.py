"""Load generator for a running longbow_tpu_torch node or cluster, the
port's twin of tools/bench_tool.py (the reference's cmd/bench-tool,
main.go:27-100):

  python -m longbow_tpu_torch.tools.bench_tool --mode ingest --host localhost \\
      --concurrency 4 --duration 30 --batch-size 1000 --dim 128
  python -m longbow_tpu_torch.tools.bench_tool --mode search --k 10 --duration 30
  python -m longbow_tpu_torch.tools.bench_tool --mode hybrid --duration 10
  python -m longbow_tpu_torch.tools.bench_tool --mode scan --duration 10
  python -m longbow_tpu_torch.tools.bench_tool --mode micro [--device cpu] [--out m.json]

ingest, search, hybrid and scan drive a node over Flight from
--concurrency client threads for --duration seconds and print one JSON
line (ops, rates, errors, latency percentiles). --dtype picks the ingest
payload's vector type: i8 rows put into a dataset of no declared kind make
an identity-affine sq8 dataset on a port node, whose searches run kernel
K2; f32 rows into a dataset created with --index flat run kernel K1.

micro runs an in-process VectorStore on the CUDA card (the CPU with
--device cpu or LONGBOW_FORCE_CPU=1; no card and neither of those raises)
and prints the reference micro mode's keys, so that tools/perf_gate.py
compares two such files. Its times are host clocks around calls whose
results are on the host (a search's answers), or followed by a device
synchronize (puts).
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

MODES = ("ingest", "search", "hybrid", "scan", "micro")
DTYPES = ("f32", "f16", "i8", "u8", "i32")


def _client():
    from longbow_tpu_torch.serving.client import LongbowClient

    return LongbowClient


def payload(rng, batch: int, dim: int, dtype: str) -> np.ndarray:
    """One ingest payload of `dtype` (the reference publishes an ingest
    matrix per vector dtype, docs/performance.md:27-53)."""
    f = rng.standard_normal((batch, dim), dtype=np.float32)
    if dtype == "f16":
        return f.astype(np.float16)
    if dtype == "i8":
        return (f * 30).clip(-128, 127).astype(np.int8)
    if dtype == "u8":
        return (f * 30 + 128).clip(0, 255).astype(np.uint8)
    if dtype == "i32":
        return (f * 1000).astype(np.int32)
    return f


def run_worker(args, worker_id, stats, stop):
    c = _client()(args.host, args.data_port, args.meta_port).connect()
    rng = np.random.default_rng(worker_id)
    next_id = worker_id * 10_000_000
    lat = []
    ops = rows = errors = 0
    # pre-generated payloads: the generator must not spend its CPU on
    # standard_normal per op, which would cap the measured server rate
    pregen = [payload(rng, args.batch_size, args.dim, args.dtype) for _ in range(4)]
    while not stop.is_set():
        try:
            t0 = time.perf_counter()
            if args.mode == "ingest":
                v = pregen[ops & 3]
                ids = np.arange(next_id, next_id + args.batch_size)
                next_id += args.batch_size
                c.write(args.dataset, ids, v)
                rows += args.batch_size
            elif args.mode == "search":
                q = rng.standard_normal((args.dim,), dtype=np.float32)
                t = c.search(args.dataset, q, k=args.k)
                rows += t.num_rows
            elif args.mode == "scan":
                # full-dataset DoGet streaming (the reference's DoGet scan
                # throughput axis, docs/performance.md:20-25)
                t = c.scan(args.dataset, limit=args.scan_limit)
                rows += t.num_rows
            else:  # hybrid
                q = rng.standard_normal((args.dim,), dtype=np.float32)
                r = c.hybrid_search(
                    args.dataset, vector=q,
                    text_query="benchmark query text", k=args.k,
                )
                rows += len(r.get("ids", []))
            lat.append(time.perf_counter() - t0)
            ops += 1
        except Exception:
            errors += 1
            time.sleep(0.05)
    c.close()
    stats[worker_id] = {"ops": ops, "rows": rows, "errors": errors, "lat": lat}


def run_micro(out_path, device=None) -> int:
    """Serverless in-process micro benchmarks for a perf gate (the
    reference's go test -bench micro-benchmarks behind the benchstat
    PR-against-main gate, .github/workflows/benchmark.yml:33-60). Keys:
    ingest_rows_per_s, search_qps, hybrid_qps and
    wal_<backend>_sync_appends_per_s for each WAL backend that opens."""
    import tempfile

    import torch

    from longbow_tpu_torch.device import entry_device
    from longbow_tpu_torch.storage.wal import WAL
    from longbow_tpu_torch.store.vector_store import VectorStore

    dev = entry_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)
    out = {}

    store = VectorStore(device=dev)
    v = rng.standard_normal((20_000, 64), dtype=np.float32)
    t0 = time.time()
    for off in range(0, 20_000, 2_000):
        store.put("m", np.arange(off, off + 2_000), v[off : off + 2_000])
    sync()
    out["ingest_rows_per_s"] = round(20_000 / (time.time() - t0), 1)

    q = rng.standard_normal((16, 64), dtype=np.float32)
    store.search("m", q, 10, use_cache=False)  # warm
    t0 = time.time()
    iters = 20
    for _ in range(iters):
        store.search("m", q, 10, use_cache=False)
    out["search_qps"] = round(16 * iters / (time.time() - t0), 1)

    store.put(
        "h", np.arange(2_000), v[:2_000],
        columns={"text": np.asarray(
            [f"doc {i} alpha beta" for i in range(2_000)]
        )},
    )
    store.hybrid_search("h", q[:1], 10, text_query="alpha doc", alpha=0.5)
    t0 = time.time()
    iters = 50
    for _ in range(iters):
        store.hybrid_search("h", q[:1], 10, text_query="alpha doc", alpha=0.5)
    out["hybrid_qps"] = round(iters / (time.time() - t0), 1)

    # WAL append + fsync rate by backend (the reference's
    # wal_benchmark_test.go: io_uring against buffered FS)
    with tempfile.TemporaryDirectory() as td:
        payload_op = {"op": "delete", "ids": list(range(64))}
        for uring in (False, True):
            w = WAL(f"{td}/w{int(uring)}.log", sync="always", io_uring=uring)
            name = w.backend_name
            if uring and name != "io_uring":
                w.close()
                continue  # the host refused io_uring
            for _ in range(10):
                w.append_op("bench", payload_op)  # warm
            n = 300
            t0 = time.time()
            for _ in range(n):
                w.append_op("bench", payload_op)
            out[f"wal_{name}_sync_appends_per_s"] = round(n / (time.time() - t0), 1)
            w.close()

    blob = json.dumps(out)
    if out_path:
        with open(out_path, "w") as f:
            f.write(blob)
    print(blob, flush=True)
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=MODES, default="search")
    ap.add_argument("--scan-limit", type=int, default=0,
                    help="scan mode: rows per DoGet (0 = full dataset)")
    ap.add_argument("--out", default=None,
                    help="micro mode: write the JSON here too")
    ap.add_argument("--device", default=None,
                    help="micro mode: cuda (the default) or cpu")
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--data-port", type=int, default=3000)
    ap.add_argument("--meta-port", type=int, default=3001)
    ap.add_argument("--dataset", default="bench")
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--batch-size", type=int, default=1000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--dtype", choices=DTYPES, default="f32",
                    help="ingest mode: vector dtype for the payloads")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--warmup-rows", type=int, default=0,
                    help="rows to ingest before a search benchmark")
    ap.add_argument("--index", default="",
                    help="create the dataset with this index kind first "
                         "(a dataset of no declared kind is adaptive, and "
                         "its migration to the graph from 200,000 rows on "
                         "runs beside the benchmark)")
    ap.add_argument("--capacity", type=int, default=0,
                    help="pre-size device arrays at creation "
                         "(growth doubles are copies)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.mode == "micro":
        return run_micro(args.out, args.device)

    if args.index or args.capacity:
        c = _client()(args.host, args.data_port, args.meta_port).connect()
        try:
            kw = {}
            if args.capacity:
                kw["capacity"] = args.capacity
            c.create_namespace(
                args.dataset, dim=args.dim,
                index=args.index or "flat", **kw,
            )
        except Exception as e:
            print(f"create_namespace: {e}", file=sys.stderr)
        c.close()

    if args.warmup_rows:
        c = _client()(args.host, args.data_port, args.meta_port).connect()
        rng = np.random.default_rng(0)
        for off in range(0, args.warmup_rows, 10_000):
            n = min(10_000, args.warmup_rows - off)
            c.write(
                args.dataset,
                np.arange(off, off + n),
                rng.standard_normal((n, args.dim), dtype=np.float32),
            )
        c.close()

    stats: dict = {}
    stop = threading.Event()
    workers = [
        threading.Thread(target=run_worker, args=(args, i, stats, stop))
        for i in range(args.concurrency)
    ]
    t0 = time.time()
    for w in workers:
        w.start()
    time.sleep(args.duration)
    stop.set()
    for w in workers:
        w.join()
    wall = time.time() - t0

    ops = sum(s["ops"] for s in stats.values())
    rows = sum(s["rows"] for s in stats.values())
    errors = sum(s["errors"] for s in stats.values())
    lats = sorted(x for s in stats.values() for x in s["lat"])

    def pct(p):
        return lats[min(int(len(lats) * p), len(lats) - 1)] * 1000 if lats else 0

    print(json.dumps({
        "mode": args.mode,
        "wall_s": round(wall, 1),
        "ops": ops,
        "ops_per_s": round(ops / wall, 1),
        "rows_per_s": round(rows / wall, 1),
        "dtype": args.dtype,
        "mb_per_s": round(
            rows * args.dim * {"f16": 2, "i8": 1, "u8": 1}.get(args.dtype, 4)
            / wall / 1e6, 1,
        )
        if args.mode in ("ingest", "scan") else None,
        "errors": errors,
        "p50_ms": round(pct(0.5), 2),
        "p95_ms": round(pct(0.95), 2),
        "p99_ms": round(pct(0.99), 2),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
