"""What the flat re-rank's batch-invariant form costs, and what it buys.

    python3 -m longbow_tpu_torch.tools.probe_rerank [--rows N]

On one CUDA card, over N bf16 rows of the clustered recipe (default
1,000,000 x 128) and K1's pool of 64 for 1,000 held-out queries, times
the exact l2 re-rank two ways, in turns (einsum, port, port, einsum;
CUDA events, median of 20): |q|^2 - 2 q.v + |v|^2 with torch.einsum and
reduction sums (the reference's form), and ops/scan.py::
rerank_distances (the port's). For each it prints the time at B = 1 and
B = 1,000 and the largest relative difference between a query's
distances alone and inside the batch. Prints the card's name and power
limit first; raises without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from longbow_tpu_torch.ops.scan import fused_flat_search, rerank_distances
from longbow_tpu_torch.tools.probe_graph import make_corpus

POOL = 64


def rerank_einsum(qf, cand):
    ip = torch.einsum("bd,bkd->bk", qf, cand)
    return torch.clamp_min((qf * qf).sum(dim=1, keepdim=True) - 2.0 * ip
                           + (cand * cand).sum(dim=2), 0.0)


def rerank_port(qf, cand):
    return rerank_distances(qf, cand, True)


def time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_rerank needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    allv = make_corpus(args.rows + 1000, 128)
    corpus = torch.from_numpy(allv[:args.rows]).cuda().to(torch.bfloat16)
    norms = (corpus.float() ** 2).sum(dim=1)
    valid = torch.ones(args.rows, dtype=torch.bool, device="cuda")
    q = torch.from_numpy(allv[args.rows:]).cuda()
    _, idx = fused_flat_search(q, corpus, norms, valid, POOL, "l2")
    cand = corpus[idx.long()].float()
    out = {}
    for name in ("einsum", "port", "port", "einsum"):
        fn = rerank_einsum if name == "einsum" else rerank_port
        batch = fn(q, cand)
        alone = torch.cat([fn(q[j:j + 1], cand[j:j + 1]) for j in range(q.shape[0])])
        rel = ((alone - batch).abs() / batch.abs().clamp_min(1e-30)).max().item()
        row = out.setdefault(name, {"ms_b1": [], "ms_b1000": [], "max_rel_alone_vs_batch": rel})
        row["ms_b1"].append(time_ms(lambda: fn(q[:1], cand[:1])))
        row["ms_b1000"].append(time_ms(lambda: fn(q, cand)))
    print(json.dumps({"probe_rerank": out, "rows": args.rows, "pool": POOL}), flush=True)


if __name__ == "__main__":
    main()
