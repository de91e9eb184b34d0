#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (longbow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or ends the run with a non-zero exit:
  1. device  - a CUDA card is required; prints nvidia-smi's name and power limit;
  2. build   - every CUDA kernel is compiled with nvcc from csrc/ (timed);
  3. kernels - kernel K1 (the fused scan, csrc/fused_scan.cu) against its plain
               PyTorch version at N = 1,048,576 x D = 128 bf16, B in {1, 128, 2048},
               k in {10, 64, 512}, l2 and ip, with tombstones, an extra mask,
               fewer valid rows than k, and D = 100 with N not a multiple of the
               tile; times the kernel, the plain version and torch.matmul +
               torch.topk over the same scores (a two-call yardstick: no single
               PyTorch call computes K1);
  4. store   - the main path: VectorStore.put / search / delete on 1,000,000 x 128
               clustered rows in bf16 (a flat index), recall@10 against the f32
               exact_search oracle, a filtered search, deletes, and 100,000-row
               cosine and dot datasets; the kernels' launch counts are set to 0
               just before this phase and read just after it.
The last line of standard output is {"ok": true, "device": {...}}.

Imports torch, numpy and longbow_tpu_torch only.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_KERNEL, D_KERNEL = 1_048_576, 128
N_STORE, D_STORE, N_QUERIES = 1_000_000, 128, 1_000
N_SMALL = 100_000
PUT_BATCH = 65_536
RECALL_GATE = 0.95
TIMED_LAUNCHES = 20
DEVICE = "cuda"
# kernel vs plain: f32 sums are taken in another order, so distances agree
# to this tolerance and no better
RTOL, ATOL = 1e-3, 1e-2

# (bytes/s, dense bf16 FLOP/s) from NVIDIA's data sheets; the first name
# fragment found in the card's name is used
_PEAKS = (
    ("H100 PCIe", 2.0e12, 756e12),
    ("H100 NVL", 3.9e12, 835e12),
    ("H100", 3.35e12, 989e12),  # SXM
    ("H200", 4.8e12, 989e12),
)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def make_corpus(n: int, d: int, seed: int = 0) -> np.ndarray:
    """The clustered recipe of bench.py's make_corpus: a mixture of 1024
    Gaussian clusters (centers x4, unit noise), seeded."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((1024, d)).astype(np.float32) * 4.0
    assign = rng.integers(0, 1024, n)
    out = centers[assign] + rng.standard_normal((n, d)).astype(np.float32)
    return out.astype(np.float32)


def time_ms(fn, reps: int) -> float:
    """Median device time of fn() over `reps` calls, CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# -- 1. device -----------------------------------------------------------

def phase_device() -> tuple[str, float, float]:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    for frag, bw, flops in _PEAKS:
        if frag in name:
            break
    else:
        fail(f"no peak rates known for {name!r}")
    emit({"device": name, "nvidia_smi": card, "peak_row": frag,
          "peak_bytes_per_s": bw, "peak_bf16_flops": flops,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return card, bw, flops


# -- 2. build ------------------------------------------------------------

def phase_build() -> None:
    from longbow_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.build_all()
    seconds = time.perf_counter() - t0
    for k in _kernels.KERNELS:
        for line in k.build_log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"[{k.name}] {line.strip()}")
    emit({"build_seconds": seconds,
          "kernels": {k.name: k.build_seconds for k in _kernels.KERNELS}})


# -- 3. kernels ----------------------------------------------------------

def compare(name, dk, ik, dp, ip_) -> float:
    """Kernel (dk, ik) against plain (dp, ip_), both [B, k] ascending.
    Returns the largest |distance error| over real slots."""
    from longbow_tpu_torch.ops.distance import MASKED, MASKED_GUARD

    real = dp < MASKED_GUARD
    if not torch.equal(real, dk < MASKED_GUARD):
        fail(f"{name}: real/masked slots differ")
    ghost_d, ghost_i = dk[~real], ik[~real]
    if not (torch.all(ghost_d == MASKED) and torch.all(ghost_i == -1)):
        fail(f"{name}: unfilled slots are not exactly (MASKED, -1)")
    if not torch.all(ik[real] >= 0):
        fail(f"{name}: a real slot has id -1")
    err = (dk - dp).abs()[real]
    bound = ATOL + RTOL * dp.abs()[real]
    if not torch.all(err <= bound):
        fail(f"{name}: distance error {err.max().item()} beyond tolerance")
    # ids whose distance lies below the k-th by more than the tolerance
    # must be found by the kernel too
    kth = torch.where(real, dp, torch.full_like(dp, -float("inf"))).max(dim=1).values
    sure = real & (dp < (kth - ATOL - RTOL * kth.abs())[:, None])
    sk = torch.sort(ik.long(), dim=1).values
    want = ip_.long()
    pos = torch.searchsorted(sk, want).clamp_max(sk.shape[1] - 1)
    found = sk.gather(1, pos) == want
    if not torch.all(found[sure]):
        fail(f"{name}: {int((~found & sure).sum())} sure ids missing")
    return float(err.max().item()) if err.numel() else 0.0


def phase_kernels(bw: float, flops: float, reps: int) -> dict:
    from longbow_tpu_torch.ops.distance import Metric
    from longbow_tpu_torch.ops.scan import fused_flat_search, fused_flat_search_plain

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(0)

    def corpus_of(n, d):
        c = torch.randn((n, d), generator=g, device=dev).to(torch.bfloat16)
        cf = c.float()
        return c, (cf * cf).sum(dim=1)

    c128, n128 = corpus_of(N_KERNEL, D_KERNEL)
    tomb = torch.rand((N_KERNEL,), generator=g, device=dev) > 0.01
    cases = []
    for metric in (Metric.L2, Metric.DOT):
        for b in (1, 128, 2048):
            for k in (10, 64, 512):
                cases.append(dict(metric=metric, b=b, k=k, corpus=c128,
                                  norms=n128, valid=tomb, extra=None,
                                  tag="tombstones"))
    rows = torch.arange(N_KERNEL, device=dev)
    cases.append(dict(metric=Metric.L2, b=1000, k=64, corpus=c128, norms=n128,
                      valid=tomb, extra=None, tag="served_batch"))
    cases.append(dict(metric=Metric.L2, b=128, k=64, corpus=c128, norms=n128,
                      valid=tomb, extra=rows % 10 == 3, tag="extra_mask"))
    few = rows < 20
    cases.append(dict(metric=Metric.L2, b=128, k=64, corpus=c128, norms=n128,
                      valid=few, extra=None, tag="fewer_valid_than_k"))
    cases.append(dict(metric=Metric.DOT, b=2048, k=512, corpus=c128,
                      norms=n128, valid=few, extra=None,
                      tag="fewer_valid_than_k"))
    cases.append(dict(metric=Metric.L2, b=1, k=10, corpus=c128, norms=n128,
                      valid=torch.zeros_like(tomb), extra=None,
                      tag="all_masked"))
    c100, n100 = corpus_of(1_000_003, 100)
    v100 = torch.ones((1_000_003,), dtype=torch.bool, device=dev)
    cases.append(dict(metric=Metric.L2, b=128, k=64, corpus=c100, norms=n100,
                      valid=v100, extra=None, tag="unaligned_d100_n1000003"))
    cases.append(dict(metric=Metric.DOT, b=2048, k=10, corpus=c100,
                      norms=n100, valid=v100, extra=None,
                      tag="unaligned_d100_n1000003"))

    results = []
    for cs in cases:
        n, d = cs["corpus"].shape
        q = torch.randn((cs["b"], d), generator=g, device=dev)
        args = (q, cs["corpus"], cs["norms"], cs["valid"], cs["k"], cs["metric"])
        kw = dict(extra_mask=cs["extra"], device=dev)
        name = f"{cs['tag']} {cs['metric']} B={cs['b']} k={cs['k']} N={n} D={d}"
        dk, ik = fused_flat_search(*args, **kw)
        dp, ip_ = fused_flat_search_plain(*args, **kw)
        torch.cuda.synchronize()
        err = compare(name, dk, ik, dp, ip_)
        ms = time_ms(lambda: fused_flat_search(*args, **kw), reps)
        plain_ms = time_ms(lambda: fused_flat_search_plain(*args, **kw), reps)
        qb = q.to(torch.bfloat16)
        corpus = cs["corpus"]
        mm_ms = time_ms(
            lambda: torch.topk(torch.matmul(qb, corpus.T), cs["k"], dim=1), reps
        )
        b, k = cs["b"], cs["k"]
        moved = n * d * 2 + n * 4 + n + b * d * 4 + b * k * 8
        bound_by = "bytes" if moved / bw >= 2 * b * n * d / flops else "operations"
        bound_ms = 1e3 * max(moved / bw, 2 * b * n * d / flops)
        row = dict(case=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   matmul_topk_ms=mm_ms, bound_ms=bound_ms, bound_by=bound_by,
                   b=b, k=k, n=n, d=d, metric=cs["metric"], tag=cs["tag"])
        results.append(row)
        emit({"kernel_case": row})
    return {"cases": results}


# -- 4. store (the main path) ---------------------------------------------

def recall_at(served_ids, truth) -> float:
    hits = 0
    for got, want in zip(served_ids, truth):
        hits += len({x for x in got if x is not None} & set(want.tolist()))
    return hits / truth.size


def phase_store() -> dict:
    from longbow_tpu_torch.ops import _kernels
    from longbow_tpu_torch.ops.distance import Metric, exact_search
    from longbow_tpu_torch.query.parser import Filter
    from longbow_tpu_torch.store.vector_store import VectorStore

    allv = make_corpus(N_STORE + N_QUERIES, D_STORE, seed=0)
    corpus, queries = allv[:N_STORE], allv[N_STORE:]
    ids = np.arange(N_STORE, dtype=np.int64)
    category = ids % 10
    out: dict = {}

    _kernels.reset_launch_counts()
    store = VectorStore(device=DEVICE, dtype=torch.bfloat16,
                        default_index_kind="flat")
    t0 = time.perf_counter()
    for s in range(0, N_STORE, PUT_BATCH):
        e = min(s + PUT_BATCH, N_STORE)
        store.put("sift", ids[s:e], corpus[s:e], {"category": category[s:e]})
    ds = store.get("sift")
    ds.index.flush()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    out["ingest_rows_per_s"] = N_STORE / ingest_s
    out["capacity"] = ds.index.capacity
    ds.warm()

    lat = []
    for j in range(16):
        t = time.perf_counter()
        store.search("sift", queries[j:j + 1], 10)
        lat.append(time.perf_counter() - t)
    out["p50_single_query_ms"] = 1e3 * statistics.median(lat)

    served, _, ok = store.search("sift", queries, 10)
    batch_s = []
    for _ in range(5):
        t = time.perf_counter()
        store.search("sift", queries, 10, use_cache=False)
        batch_s.append(time.perf_counter() - t)
    out["batch_1000_ms"] = 1e3 * statistics.median(batch_s)
    out["qps_batch_1000"] = N_QUERIES / statistics.median(batch_s)
    # the index layer alone (scan, re-rank, copies to the host), below the
    # store's query cache and the dataset's id mapping
    for label, qs, reps in (("1", queries[:1], 16), ("1000", queries, 5)):
        idx_s = []
        for _ in range(reps):
            t = time.perf_counter()
            ds.index.search(qs, 10)
            idx_s.append(time.perf_counter() - t)
        out[f"index_search_{label}_ms"] = 1e3 * statistics.median(idx_s)

    _, truth = exact_search(queries, corpus, 10, Metric.L2, device=DEVICE)
    recall = recall_at(served, truth.cpu().numpy())
    out["recall_at_10"] = recall
    if recall < RECALL_GATE:
        fail(f"recall@10 {recall} < {RECALL_GATE} on 1M x 128 bf16 l2")

    fids, _, fok = store.search(
        "sift", queries[:100], 10, filters=[Filter("category", "eq", "3")]
    )
    hits = fids[fok].tolist()
    if not hits or any(x % 10 != 3 for x in hits):
        fail("filtered search returned a row outside category == 3")
    out["filtered_hits"] = len(hits)

    rng = np.random.default_rng(1)
    dead = rng.choice(N_STORE, 1000, replace=False)
    if store.delete("sift", dead) != 1000:
        fail("delete did not remove 1000 ids")
    did, _, dok = store.search("sift", corpus[dead], 10)
    back = set(did[dok].tolist()) & set(dead.tolist())
    if back:
        fail(f"{len(back)} deleted ids came back")
    out["deleted_returned"] = 0

    for metric in (Metric.COSINE, Metric.DOT):
        name = f"small_{metric}"
        for s in range(0, N_SMALL, PUT_BATCH):
            e = min(s + PUT_BATCH, N_SMALL)
            store.put(name, ids[s:e], corpus[s:e], metric=metric)
        got, _, _ = store.search(name, queries, 10)
        want, _, _ = store.search(name, queries, 10, exact=True)
        r = recall_at(got, want)
        out[f"recall_at_10_{metric}_vs_exact"] = r
        if r < RECALL_GATE:
            fail(f"{metric}: recall@10 {r} against exact_search < {RECALL_GATE}")

    torch.cuda.synchronize()
    out["launches"] = {k.name: k.launches for k in _kernels.KERNELS}
    for k in _kernels.KERNELS:
        if k.launches == 0:
            fail(f"kernel {k.name} was not launched on the main path")
    emit({"store": out})
    return out


def main() -> int:
    card, bw, flops = phase_device()
    import longbow_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    kern = phase_kernels(bw, flops, TIMED_LAUNCHES)
    store = phase_store()

    served = next(c for c in kern["cases"] if c["tag"] == "served_batch")
    emit({"kernels": [{
        "name": "fused_scan",
        "route": "cuda",
        "source": "longbow_tpu_torch/csrc/fused_scan.cu",
        "replaces": "longbow_tpu/ops/pallas_scan.py:256",
        "launches": store["launches"]["fused_scan"],
        "max_abs_err": max(c["max_abs_err"] for c in kern["cases"]),
        "ms": served["ms"],
        "plain_ms": served["plain_ms"],
        "bound_ms": served["bound_ms"],
        "bound_by": served["bound_by"],
        "library_ms": None,
        "matmul_topk_ms": served["matmul_topk_ms"],
        "shape": served["case"],
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
