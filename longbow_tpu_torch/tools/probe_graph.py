"""Where the graph tier's time goes on one CUDA card.

    python3 -m longbow_tpu_torch.tools.probe_graph [--rows N] [--dim D]
        [--queries B] [--inserts R] [--profile]

Builds an HNSWIndex over N clustered bf16 rows from the device tensor
(one add: bulk_build_rp at N >= 150,000, else bulk_build_edges through
kernel K1), and prints one JSON object per line:
  - the build's stage times (build_stage_timer),
  - recall@10 against the f32 exact_search oracle, the rate, the loop
    iterations and the time per iteration of one B-query batch at
    ef 100 and 150, for the default profile and the fast profile
    (search_m_max=32, search_expand=8), and of single queries,
  - beam_search alone on device queries: wall time against the span
    between two CUDA events around it (the loop's launches and its one
    host read per iteration show as wall time the device does not fill),
  - rows/s of R incremental inserts (insert_batch, 1,024 rows a batch),
  - with --profile, for one batch search and one single-query search:
    device time by kernel name and host time by operator (torch.profiler)
    and the device's idle share against the unprofiled wall time.
Needs a CUDA card; the first line names it with its power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def make_corpus(n: int, d: int, seed: int = 0) -> np.ndarray:
    """1024 Gaussian clusters (centers x4, unit noise), seeded."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((1024, d)).astype(np.float32) * 4.0
    return (centers[rng.integers(0, 1024, n)]
            + rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def recall(got: np.ndarray, truth: np.ndarray) -> float:
    return float(np.mean([len(set(g.tolist()) & set(t.tolist())) / len(t)
                          for g, t in zip(got, truth)]))


def timed(fn, reps: int) -> float:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return statistics.median(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--inserts", type=int, default=16_384)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_graph needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"card": card, "torch": torch.__version__})

    os.environ["LONGBOW_BUILD_DEBUG"] = "1"
    from longbow_tpu_torch.index import graph_build
    from longbow_tpu_torch.index.graph import beam_search
    from longbow_tpu_torch.index.hnsw import HNSWConfig, HNSWIndex
    from longbow_tpu_torch.ops import _kernels
    from longbow_tpu_torch.ops.distance import exact_search

    n, d, b = args.rows, args.dim, args.queries
    allv = make_corpus(n + args.inserts + b, d)
    corpus = torch.from_numpy(allv[:n]).to("cuda").to(torch.bfloat16)
    extra = torch.from_numpy(allv[n:n + args.inserts]).to("cuda").to(torch.bfloat16)
    queries = allv[n + args.inserts:]
    _kernels.build_all()

    idx = HNSWIndex(d, "l2", HNSWConfig(m=32, m_max=48, ef_search=100),
                    dtype=torch.bfloat16, edge_dtype=torch.bfloat16,
                    capacity=n + args.inserts)
    _kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx.add(corpus)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    emit({"build": {"rows": n, "seconds": build_s, "rows_per_s": n / build_s,
                    "k1_launches": _kernels.FUSED_SCAN.launches,
                    "stages": [{"tag": t, "label": lab, "s": s}
                               for t, _, lab, s in graph_build.stage_log],
                    "state_bytes": idx.device_bytes(),
                    "peak_bytes": torch.cuda.max_memory_allocated()}})

    _, truth = exact_search(queries, corpus, 10, device="cuda")
    truth = truth.cpu().numpy()
    q_dev = torch.from_numpy(queries).to("cuda")
    for profile, (mu, ex) in (("default", (0, 4)), ("fast", (32, 8))):
        idx.config.search_m_max, idx.config.search_expand = mu, ex
        for ef in (100, 150):
            _, rows = idx.search(queries, 10, ef_search=ef)
            iters = idx.last_search_iters
            sec = timed(lambda: idx.search(queries, 10, ef_search=ef), 3)
            row = {"profile": profile, "ef": ef, "B": b, "recall_at_10": recall(rows, truth),
                   "ms": 1e3 * sec, "qps": b / sec, "iters": iters,
                   "ms_per_iter": 1e3 * sec / max(iters, 1)}
            if b > 1:
                one = timed(lambda: idx.search(queries[:1], 10, ef_search=ef), 9)
                row.update(single_ms=1e3 * one, single_iters=idx.last_search_iters)
            emit({"search": row})
    idx.config.search_m_max, idx.config.search_expand = 0, 4

    # one iteration's launches and host read: device time against wall time
    idx._refresh_sample()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    stats: dict = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    ev0.record()
    beam_search(idx.state, q_dev, idx._sample_rows, 10, 100, track_results=False, stats=stats)
    ev1.record()
    torch.cuda.synchronize()
    emit({"beam_search_alone": {"B": b, "ef": 100, "iters": stats["iters"],
                                "wall_ms": 1e3 * (time.perf_counter() - t),
                                "device_span_ms": ev0.elapsed_time(ev1)}})

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        for label, qs in (("batch", queries), ("single", queries[:1])):
            wall = timed(lambda: idx.search(qs, 10, ef_search=100), 5)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                idx.search(qs, 10, ef_search=100)
                torch.cuda.synchronize()
            events = prof.key_averages()
            dev_attr = ("device_time_total" if hasattr(events[0], "device_time_total")
                        else "cuda_time_total")
            by_kernel = sorted(((getattr(e, dev_attr), e.count, e.key) for e in events
                                if getattr(e, dev_attr) > 0 and e.device_type.name != "CPU"),
                               reverse=True)
            by_host = sorted(((e.self_cpu_time_total, e.count, e.key) for e in events),
                             reverse=True)
            busy = sum(x[0] for x in by_kernel) / 1e6
            # the kernels' time from the trace against the wall time of
            # the same search WITHOUT the profiler, whose own cost would
            # count as idle time
            emit({"profile": {"search": label, "iters": idx.last_search_iters,
                              "wall_s_unprofiled": wall, "device_busy_s": busy,
                              "device_idle_share": 1.0 - busy / wall,
                              "kernel_launches": sum(x[1] for x in by_kernel),
                              "top_kernels": [{"us": x[0], "n": x[1], "name": x[2][:60]}
                                              for x in by_kernel[:8]],
                              "top_host_ops": [{"us": x[0], "n": x[1], "name": x[2][:40]}
                                               for x in by_host[:8]]}})

    if args.inserts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.add(extra)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        _, rows = idx.search(queries, 10, ef_search=150)
        emit({"insert": {"rows": args.inserts, "seconds": sec, "rows_per_s": args.inserts / sec,
                         "ms_per_1024_row_batch": 1e3 * sec / (args.inserts / 1024)}})
    emit({"card": card})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
