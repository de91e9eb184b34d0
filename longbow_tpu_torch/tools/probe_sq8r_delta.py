"""sq8r's delta region by route: the plain chunked scan against kernel K2
over the delta's cluster-grouped view, the view's build, and the route
that index/sq8.py's rule (DELTA_VIEW_MAX) takes.

    python3 -m longbow_tpu_torch.tools.probe_sq8r_delta [--rows 4096,65536,300000,2500000]
        [--batches 1,1000,2000] [--dim 96] [--clusters 1024] [--device cpu]

For each delta size, a fresh sq8r index holds every row in its delta
(rows drawn around `--clusters` Gaussian centres, 1% of them deleted; the
k-means state is trained once, on the largest size). For each batch, a
search through each route is `_sq8r_search` with no main region (query
terms, the delta's pool of 64 and its re-rank, the merge; k = 10): its
device ms (CUDA events around 10 calls back to back, the median of 3
such runs) and its host ms with a synchronize (median of 10 calls), and
how many answers differ. The view's build, its row count included, is
timed apart (median of 5): a search after each put pays it once more on
the K2 route. One JSON line a (rows, batch), with "rule" the route the
index takes there, then a line naming the card. On the CPU
(--device cpu, a rehearsal at small sizes) every time is the host's and
no device ms is given.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from longbow_tpu_torch.index.sq8 import (
    DELTA_VIEW_MAX,
    SQ8ResidualIndex,
    _sq8r_search,
    delta_view,
    delta_view_rows,
)
from longbow_tpu_torch.ops.distance import Metric

K = 10


def _ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def _index(rows: torch.Tensor, n: int, trained: SQ8ResidualIndex | None, clusters: int,
           gen: torch.Generator) -> SQ8ResidualIndex:
    idx = SQ8ResidualIndex(rows.shape[1], n_clusters=clusters, device=rows.device)
    if trained is not None:
        idx.centers, idx.lo, idx.hi = trained.centers, trained.lo, trained.hi
    idx.rebuild_min = 2 * n + 1  # no fold: every row stays in the delta
    idx.add(rows[:n])
    dead = torch.randperm(n, generator=gen, device=rows.device)[: n // 100]
    idx.delete_rows(dead.cpu().numpy())
    return idx


def _search(idx: SQ8ResidualIndex, q: torch.Tensor, view):
    return _sq8r_search(
        q, idx.m_codes, idx.m_gcid, idx.m_norms, idx.m_valid, idx.m_ext,
        idx.d_codes, idx.d_cid, idx.d_norms, idx.d_valid, idx.d_ext,
        idx.centers, idx.lo, idx.hi, None, K, Metric.L2, False, True, True, idx.device, view,
    )


def _times(fn, cuda: bool) -> dict:
    """Device ms a call (CUDA events, median of 3 runs of 10) and host ms
    a call with a synchronize (median of 10)."""
    fn()
    out = {}
    if cuda:
        runs = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            for _ in range(10):
                fn()
            b.record()
            torch.cuda.synchronize()
            runs.append(a.elapsed_time(b) / 10)
        out["device_ms"] = statistics.median(runs)
    host = []
    for _ in range(10):
        t = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    out["host_ms"] = statistics.median(host)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="4096,65536,300000,2500000")
    ap.add_argument("--batches", default="1,1000,2000")
    ap.add_argument("--dim", type=int, default=96)
    ap.add_argument("--clusters", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu for a rehearsal")
    sizes, batches = sorted(_ints(args.rows)), _ints(args.batches)
    gen = torch.Generator(device=dev).manual_seed(0)
    centres = torch.randn((args.clusters, args.dim), generator=gen, device=dev) * 4.0
    pick = torch.randint(0, args.clusters, (sizes[-1],), generator=gen, device=dev)
    rows = centres[pick] + torch.randn((sizes[-1], args.dim), generator=gen, device=dev)
    trained = None
    for n in reversed(sizes):
        idx = _index(rows, n, trained, args.clusters, gen)
        trained = trained or idx
        region = (idx.d_codes, idx.d_cid, idx.d_norms, idx.d_valid, args.clusters)

        def build_view():
            return delta_view(*region, delta_view_rows(idx.d_cid, idx.d_valid, args.clusters))

        build = [_times(build_view, cuda) for _ in range(5)]
        view = build_view()
        rule = "k2" if view.codes.shape[0] <= DELTA_VIEW_MAX * idx.d_codes.shape[0] else "plain"
        for b in batches:
            q = rows[torch.randint(0, n, (b,), generator=gen, device=dev)] + 0.3 * torch.randn(
                (b, args.dim), generator=gen, device=dev)
            plain = _times(lambda: _search(idx, q, None), cuda)
            k2 = _times(lambda: _search(idx, q, view), cuda)
            (pd, pi), (kd, ki) = _search(idx, q, None), _search(idx, q, view)
            line = {"delta_rows": n, "delta_capacity": idx.d_codes.shape[0],
                    "view_rows": view.codes.shape[0], "batch": b, "rule": rule,
                    "plain": plain, "k2": k2,
                    "build": {key: statistics.median(x[key] for x in build) for key in build[0]},
                    "answers_differ": int((pi != ki).sum()),
                    "max_rel_dist": float(((kd - pd).abs() / pd.abs().clamp_min(1e-30)).max())}
            print(json.dumps(line), flush=True)
        del idx, view
    print(json.dumps({"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
                      "dim": args.dim, "clusters": args.clusters, "k": K}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
