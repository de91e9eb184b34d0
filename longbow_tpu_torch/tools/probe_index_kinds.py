"""Recall of the quantized index kinds by configuration.

    python3 -m longbow_tpu_torch.tools.probe_index_kinds [--rows N]
        [--graph-rows G] [--kinds pq:16,pq:64,bq,ivf,disk,hnsw_pq:32,hnsw_pq:64]
        [--device cuda|cpu]

Builds each index straight from index/factory.py over N rows of the
clustered recipe (1024 Gaussian clusters, centers x4, unit noise, seed
0; the graphs over the first G rows), in 65,536-row adds (ivf: one add),
and prints one JSON object per kind: recall@10 of 1,000 held-out
queries against the f32 exact_search oracle (for ivf also the rows in
its spill segment) and, on a CUDA card, the host time of the 1,000-query
search. "pq:M" is kind pq with pq_m M,
"hnsw_pq:M" kind hnsw with storage="pq" and pq_m M. On the CPU it
prints recalls only: a time taken there says nothing about the card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from longbow_tpu_torch.index.factory import make_index
from longbow_tpu_torch.ops.distance import exact_search
from longbow_tpu_torch.tools.probe_graph import make_corpus, recall

ADD_BATCH = 65_536
N_QUERIES = 1000


def build(spec: str, dim: int, device):
    kind, _, arg = spec.partition(":")
    if kind == "hnsw_pq":
        return make_index("hnsw", dim, "l2", dtype=torch.bfloat16, device=device,
                          storage="pq", pq_m=int(arg or 0))
    params = {"pq_m": int(arg)} if kind == "pq" and arg else {}
    return make_index(kind, dim, "l2", dtype=torch.bfloat16, device=device, **params)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--graph-rows", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--kinds", default="pq:16,pq:64,bq,ivf,disk,hnsw_pq:32,hnsw_pq:64")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    allv = make_corpus(args.rows + N_QUERIES, args.dim)
    corpus, queries = allv[:args.rows], allv[args.rows:]
    truths = {}
    for spec in args.kinds.split(","):
        n = args.graph_rows if spec.startswith("hnsw") else args.rows
        if n not in truths:
            truths[n] = exact_search(queries, corpus[:n], 10, device=dev)[1].cpu().numpy()
        idx = build(spec, args.dim, dev)
        step = n if spec == "ivf" or spec.startswith("hnsw") else ADD_BATCH
        for s in range(0, n, step):
            idx.add(corpus[s:min(s + step, n)])
        if on_card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        _, rows = idx.search(queries, 10)
        out = {"kind": spec, "rows": n, "recall_at_10": recall(rows, truths[n])}
        if spec == "ivf":
            out["spill_rows"] = idx._inner.spill_rows
        if on_card:
            out["search_1000_ms"] = 1e3 * (time.perf_counter() - t)
        print(json.dumps(out), flush=True)
        del idx
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
