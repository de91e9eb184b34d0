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
               tile; and, aimed at the wgmma variant, a ragged last tile
               (N - 77), B = 17, D = 64, and rows in adversarial order (sorted
               by decreasing distance to the queries' centre, B = 128, k = 64)
               beside the same rows in random order; times the kernel, the
               plain version and torch.matmul + torch.topk over the same scores
               (a two-call yardstick: no single PyTorch call computes K1); each
               case names the variant that ran ("wgmma" or "mma"), a wgmma
               case is also timed through the mma.sync variant ("prev_ms"),
               and the served shape must run wgmma;
  4. store   - the main path: VectorStore.put / search / delete on 1,000,000 x 128
               clustered rows in bf16 (a flat index), recall@10 against the f32
               exact_search oracle, a filtered search, deletes, and 100,000-row
               cosine and dot datasets; the kernels' launch counts are set to 0
               just before this phase and read just after it;
  5. codes   - kernel K2 (the fused int8-codes scan, csrc/fused_codes_scan.cu)
               against its plain PyTorch version at N = 10,240,000 x D = 96 int8
               codes with 1% tombstones: no group term at B in {1, 128, 1000} x
               k in {10, 64}, a bf16 group term at B in {1, 1000} (B = 1000,
               k = 64 is the served shape), an f32 group term, the dot fold, an
               extra mask, fewer valid rows than k, all masked, k = 512,
               D = 100 with N = 1,000,003, and at D = 128 (1,048,576 rows,
               the 1M x 128 stores' shape) a bf16 group term and the dot
               fold at B = 1000, k = 64; a ragged last tile (N - 77), B = 17,
               D = 64, and adversarial order as for K1; times the kernel, the
               plain version and torch.addmm + torch.topk over the same scores
               (a two-call yardstick, without the group term), with "variant"
               and "prev_ms" as for K1;
  6. quantized store - the slice's path: VectorStore with an sq8r dataset at
               Deep-10M's shape (10,000,000 x 96 clustered rows), recall@10
               against exact search over the dequantized rows (gate 0.99) and
               against the f32 rows, a filtered search, deletes in both
               regions; sq8r and sq8 on the 1,000,000 x 128 rows of phase 4
               (sq8r gate 0.95 against the f32 rows, sq8 gate 0.99 against its
               dequantized rows); 100,000-row sq8r cosine, sq8 dot, sq8r dot and
               int8-vector datasets (gate 0.99 each); launch counts are set to 0
               just before this phase and read just after it, then the sq8r
               search at 10M is timed stage by stage;
  7. graph tier - the default index kind: 7.1 a VectorStore with no kind named,
               1,000,000 x 128 bf16 clustered rows put in 65,536-row batches with
               a `category` column; the dataset migrates from the flat scan to the
               graph in the background from 200,000 rows on (hardness probe, bulk
               build, catch-up by insert_batch); the run fails unless the kind is
               "hnsw" after wait_migration and the migration thread ended without an
               error; recall@10 at ef_search 150 against the f32 exact_search
               oracle (gate 0.95), a filter wide enough to stay on the graph and
               one narrow enough to take the exact route (0 violations), deletes
               (0 deleted ids returned), exact=True after migration; 7.2 the bulk
               build alone, HNSWIndex(m 32, m_max 48) on the 1,000,000 x 128 device
               tensor in one add (bulk_build_rp), stage times, recall@10 at ef 150
               over 128 queries (gate 0.95), the fast profile; 7.3 a 100,000-row
               dataset of kind "hnsw" (bulk_build_edges): kernel K1's launch count
               rises by the self-kNN's launches and by nothing else, recall@10
               gate 0.95; 7.4 100,000-row cosine, dot and storage="sq8" graphs
               against exact search over the stored rows (gate 0.90); for each of
               these four builds K1 is held against its plain version on the very
               arguments the build's first self-kNN launch gave the wrapper (a
               block of 4,096 corpus rows as queries, k + 1 = 33, N = the
               capacity with its valid mask; the dot build at its augmented
               width) and timed there beside its bound; and a uniform
               Gaussian dataset that must stay flat (contrast below 2.0); launch
               counts are set to 0 just before this phase and read just after it;
  8. index kinds - the other single-device kinds through VectorStore on phase 4's
               1,000,000 x 128 rows and queries, k = 10, recall@10 against the f32
               exact_search oracle: 8.1 pq in 65,536-row puts (the first trains the
               books), pq_m 16 measured at 1M and gated at 0.85 on 200,000 rows,
               pq_m 64 gated at 0.85 with a filtered search and deletes; 8.2 bq,
               l2 on the 1M rows measured, l2 and cosine on 100,000 rows gated at
               0.90; 8.3 ivf (n_probe 8) with all rows in one put (gate 0.90;
               cells, cap and the spill segment's rows; without a spill, a
               100,000-row dataset in 8,192-row puts makes one), and the same rows
               in 65,536-row puts measured (cells sized on the first put, so most
               rows spill); 8.4 disk with its
               host rows in an mmap file (gate 0.95, deletes, device against host
               bytes); 8.5 100,000-row graphs of kind hnsw with storage="pq": the
               default pq_m measured, pq_m 64 gated at 0.90 for l2 and cosine, K1's
               launches in each build printed. For each kind: queries/s of one
               1,000-query batch, p50 of 16 single-query searches, ingest rows/s,
               device bytes a row. Launch counts are set to 0 just before this
               phase and read just after it; then K1 is held against its plain
               version on the arguments of the IVF spill segment's first launch and
               K2 on those of the disk tier's, each timed there beside its bound;
  9. store services - on phase 4's 1,000,000 x 128 rows and 1,000 queries, k = 10:
               9.1 hybrid search on a flat dataset with a `category` and a `text`
               column (12 Zipf(1.1) words over 50,000 and the row's cluster word):
               ingest rows/s with BM25, BM25Index's top-30 scores against a brute
               force over a scipy.sparse term-document matrix (relative 1e-5, 100
               queries), hybrid_search "rrf" against the RRF formula over the
               store's own two halves, a category filter (0 violations), 1% of the
               ids deleted (none returned by either half), p50 of 16 single-query
               searches in "linear", "rrf" and "cascade" and a 1,000-vector batch
               with one text; 9.2 an edge from every live id to a seeded live id of
               its cluster (edges/s), p50 of traverse_graph (bfs, 2 hops) and of
               hybrid_search with graph_alpha 0.3, every id returned live; 9.3 a flat
               dataset with 600,000 of its rows deleted, compacted while a second
               thread searches it (searches served, their largest latency, none may
               fail): 600,000 rows reclaimed, capacity 1,048,576 -> 524,288, device
               bytes halved, results equal to a fresh dataset of the live rows in
               the same order, recall@10 against the f32 oracle over the live rows
               >= 0.95, K1 launched; 9.4 the same with sq8: the live rows' codes bit
               for bit unchanged, recall@10 against exact search over the
               dequantized live rows >= 0.99, K2 launched; 9.5 memory backpressure
               on the compacted flat dataset (soft limit at half its device bytes,
               hard just under them): a put is rejected, enforce() evicts the least
               recently read rows of an EvictionManager down to the soft limit,
               none comes back, longbow_memory_pressure_level reads 2 then 0; 9.6 the
               metrics registry's text: every sample in the catalog,
               longbow_tpu_hbm_bytes_in_use equal to each dataset's device_bytes(),
               the search count, longbow_simd_dispatch_total{"cuda_fused"} and
               {"cuda_sq8_fused"}, the compactions and the BM25 documents equal to
               what the phase did, and the size of the debug mux's /metrics answer
               over a loopback port. Launch counts are set to 0 just before the phase
               and read just after it; then K1 is held against its plain version on
               the arguments of the hybrid dataset's dense search and K2 on those of
               the compacted sq8 dataset's search.
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
N_CODES, D_CODES = 10_240_000, 96   # the sq8r main region of phase 6
N_DEEP, D_DEEP = 10_000_000, 96     # Deep-10M's shape
TRAIN_ROWS = 131_072                # SQ8ResidualIndex.TRAIN_SAMPLE
FINAL_ROWS = 20_000                 # left in the sq8r delta region
QUANT_RECALL_GATE = 0.99            # against exact search over dequantized rows
GRAPH_RECALL_GATE = 0.95            # graph search against the f32 oracle, ef 150
SMALL_GRAPH_GATE = 0.90             # 100,000-row graphs against exact search on stored rows
# phase 8: recall@10 gates against the f32 oracle
PQ_GATE, BQ_GATE, IVF_GATE, DISK_GATE, PQ_GRAPH_GATE = 0.85, 0.90, 0.90, 0.95, 0.90
IVF_FORCE_PUT = 8_192               # puts that make an ivf index spill, if 1M in one put did not
PQ_M = 64                           # the gated pq configurations: 2-dim subvectors
N_BASIS = 200_000                   # rows of the gated pq_m 16 index
BULK_QUERIES = 128
TIMED_LAUNCHES = 20
PLAIN_LAUNCHES = 5                  # the plain versions are slow and gate nothing
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


def make_corpus(n: int, d: int, seed: int = 0, clusters: bool = False):
    """The clustered recipe of bench.py's make_corpus: a mixture of 1024
    Gaussian clusters (centers x4, unit noise), seeded. clusters=True also
    returns each row's cluster."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((1024, d)).astype(np.float32) * 4.0
    assign = rng.integers(0, 1024, n)
    out = (centers[assign] + rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)
    return (out, assign) if clusters else out


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
    from longbow_tpu_torch.ops.scan import (
        fused_flat_search, fused_flat_search_plain, scan_variant,
    )

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
    # aimed at the wgmma variant
    ragged = N_KERNEL - 77
    cases.append(dict(metric=Metric.L2, b=1000, k=64, corpus=c128[:ragged],
                      norms=n128[:ragged], valid=tomb[:ragged], extra=None,
                      tag="ragged_last_tile"))
    cases.append(dict(metric=Metric.L2, b=17, k=64, corpus=c128, norms=n128,
                      valid=tomb, extra=None, force="wgmma", tag="b17"))
    c64, n64 = corpus_of(N_KERNEL, 64)
    cases.append(dict(metric=Metric.L2, b=1000, k=64, corpus=c64, norms=n64,
                      valid=tomb, extra=None, tag="d64"))
    # queries near the origin see the rows by decreasing norm: nearly every
    # tile then holds a row better than all before it
    worst_first = torch.argsort(n128, descending=True)
    c_adv, n_adv = c128[worst_first].contiguous(), n128[worst_first].contiguous()
    allv = torch.ones_like(tomb)
    cases.append(dict(metric=Metric.L2, b=128, k=64, corpus=c_adv, norms=n_adv,
                      valid=allv, extra=None, qscale=0.1, force="wgmma",
                      tag="adversarial_order"))
    cases.append(dict(metric=Metric.L2, b=128, k=64, corpus=c128, norms=n128,
                      valid=allv, extra=None, qscale=0.1, force="wgmma",
                      tag="adversarial_rows_in_random_order"))

    results = []
    for cs in cases:
        n, d = cs["corpus"].shape
        q = torch.randn((cs["b"], d), generator=g, device=dev) * cs.get("qscale", 1.0)
        args = (q, cs["corpus"], cs["norms"], cs["valid"], cs["k"], cs["metric"])
        kw = dict(extra_mask=cs["extra"], device=dev)
        name = f"{cs['tag']} {cs['metric']} B={cs['b']} k={cs['k']} N={n} D={d}"
        # the wrapper's own choice, unless the case asks for a variant
        variant = cs.get("force") or scan_variant(
            cs["b"], n, d, cs["k"], cs["corpus"].data_ptr() % 16 == 0)
        kernel_kw = dict(kw, variant=cs.get("force"))
        dk, ik = fused_flat_search(*args, **kernel_kw)
        dp, ip_ = fused_flat_search_plain(*args, **kw)
        torch.cuda.synchronize()
        err = compare(name, dk, ik, dp, ip_)
        ms = time_ms(lambda: fused_flat_search(*args, **kernel_kw), reps)
        prev_ms = None  # the mma.sync variant on a shape that wgmma serves
        if variant == "wgmma":
            prev_ms = time_ms(lambda: fused_flat_search(*args, **dict(kw, variant="mma")), reps)
        plain_ms = time_ms(lambda: fused_flat_search_plain(*args, **kw), PLAIN_LAUNCHES)
        qb = q.to(torch.bfloat16)
        corpus = cs["corpus"]
        mm_ms = time_ms(
            lambda: torch.topk(torch.matmul(qb, corpus.T), cs["k"], dim=1), reps
        )
        b, k = cs["b"], cs["k"]
        moved = n * d * 2 + n * 4 + n + b * d * 4 + b * k * 8
        bound_by = "bytes" if moved / bw >= 2 * b * n * d / flops else "operations"
        bound_ms = 1e3 * max(moved / bw, 2 * b * n * d / flops)
        row = dict(case=name, variant=variant, max_abs_err=err, ms=ms, prev_ms=prev_ms,
                   plain_ms=plain_ms, matmul_topk_ms=mm_ms, bound_ms=bound_ms,
                   bound_by=bound_by, b=b, k=k, n=n, d=d, metric=cs["metric"],
                   tag=cs["tag"])
        results.append(row)
        emit({"kernel_case": row})
    check_variants("fused_scan", results)
    return {"cases": results}


def check_variants(kernel: str, results: list) -> None:
    """The served shape ran the wgmma variant, and both variants ran."""
    served = next(r for r in results if r["tag"] == "served_batch")
    if served["variant"] != "wgmma":
        fail(f"{kernel}: the served shape ran the {served['variant']} variant")
    ran = {r["variant"] for r in results}
    if ran != {"wgmma", "mma"}:
        fail(f"{kernel}: only the {sorted(ran)} variant ran")


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
    if _kernels.FUSED_SCAN.launches == 0:
        fail("kernel fused_scan was not launched on the flat path")
    emit({"store": out})
    return out


# -- 5. codes (kernel K2) ---------------------------------------------------

def phase_codes_kernels(bw: float, flops: float, reps: int) -> dict:
    from longbow_tpu_torch.ops.distance import MASKED
    from longbow_tpu_torch.ops.scan import (
        fused_codes_search, fused_codes_search_plain, scan_variant,
    )

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(1)
    # codes under the affine lo = -4, hi = 4 in every dim
    scale = 8.0 / 255.0
    lo_eff = -4.0 + 128.0 * scale

    def codes_of(n, d):
        """Random int8 codes and the |v|^2 of their dequantized rows."""
        codes = torch.randint(-128, 128, (n, d), generator=g, device=dev, dtype=torch.int8)
        norms = torch.empty(n, device=dev)
        step = 1 << 20
        for s in range(0, n, step):
            deq = codes[s:s + step].float() * scale + lo_eff
            norms[s:s + step] = (deq * deq).sum(dim=1)
        return codes, norms

    c96, n96 = codes_of(N_CODES, D_CODES)
    rows = torch.arange(N_CODES, device=dev)
    tomb = torch.rand((N_CODES,), generator=g, device=dev) > 0.01
    centers = torch.randn((1024, D_KERNEL), generator=g, device=dev) * 4.0
    gcid = torch.randint(0, 1024, (N_CODES // 128,), generator=g, device=dev)
    base = dict(codes=c96, norms=n96, valid=tomb, gcid=gcid, extra=None, gt=None, fold="l2")
    cases = [dict(base, b=b, k=k, tag="sq8_fold") for b in (1, 128, 1000) for k in (10, 64)]
    cases += [dict(base, b=1, k=64, gt="bf16", tag="sq8r_gt_bf16"),
              dict(base, b=1000, k=64, gt="bf16", tag="served_batch"),
              dict(base, b=1000, k=64, gt="f32", tag="sq8r_gt_f32"),
              dict(base, b=128, k=64, fold="dot", tag="dot_fold"),
              dict(base, b=128, k=64, extra=rows % 10 == 3, tag="extra_mask"),
              dict(base, b=128, k=64, valid=rows < 20, tag="fewer_valid_than_k"),
              dict(base, b=1, k=10, valid=torch.zeros_like(tomb), tag="all_masked"),
              dict(base, b=128, k=512, tag="k512")]
    c100, n100 = codes_of(1_000_003, 100)
    cases.append(dict(base, codes=c100, norms=n100, b=128, k=64,
                      valid=torch.ones((1_000_003,), dtype=torch.bool, device=dev),
                      tag="unaligned_d100_n1000003"))
    # D = 128 runs all 8 k-steps: the 1M x 128 sq8r/sq8 stores' shape
    c128, n128 = codes_of(N_KERNEL, D_KERNEL)
    d128 = dict(base, codes=c128, norms=n128,
                valid=torch.rand((N_KERNEL,), generator=g, device=dev) > 0.01,
                gcid=torch.randint(0, 1024, (N_KERNEL // 128,), generator=g, device=dev))
    cases += [dict(d128, b=1000, k=64, gt="bf16", tag="sq8r_gt_bf16_d128"),
              dict(d128, b=1000, k=64, fold="dot", tag="dot_fold_d128")]
    # aimed at the wgmma variant
    ragged = N_CODES - 77
    cases += [dict(base, codes=c96[:ragged], norms=n96[:ragged], valid=tomb[:ragged],
                   b=1000, k=64, tag="ragged_last_tile"),
              dict(base, b=17, k=64, tag="b17")]
    c64, n64 = codes_of(N_KERNEL, 64)
    cases.append(dict(d128, codes=c64, norms=n64, b=1000, k=64, gt="bf16",
                      tag="sq8r_gt_bf16_d64"))
    # small queries see the rows by decreasing norm: nearly every tile then
    # holds a row better than all before it
    worst_first = torch.argsort(n128, descending=True)
    allv = torch.ones((N_KERNEL,), dtype=torch.bool, device=dev)
    cases += [dict(d128, codes=c128[worst_first].contiguous(),
                   norms=n128[worst_first].contiguous(), valid=allv, b=128, k=64,
                   qscale=0.05, force="wgmma", tag="adversarial_order"),
              dict(d128, valid=allv, b=128, k=64, qscale=0.05, force="wgmma",
                   tag="adversarial_rows_in_random_order")]

    c16 = {}  # bf16 copies of the codes for the yardstick, made outside the timing
    results = []
    for cs in cases:
        codes, b, k = cs["codes"], cs["b"], cs["k"]
        n, d = codes.shape
        q = torch.randn((b, d), generator=g, device=dev) * cs.get("qscale", 1.0)
        if cs["fold"] == "dot":  # sq8's dot fold: scores are -q.v_deq
            qs, qn, vn, clamp = q * scale * 0.5, -lo_eff * q.sum(dim=1), torch.zeros_like(
                cs["norms"]), False
        else:
            qs, qn, vn, clamp = (q * scale, (q * q).sum(dim=1) - 2.0 * lo_eff * q.sum(dim=1),
                                 cs["norms"], True)
        gt = None
        if cs["gt"]:
            gt = -2.0 * (q @ centers[:, :d].T)[:, cs["gcid"]]
            gt = gt.to(torch.bfloat16) if cs["gt"] == "bf16" else gt
        args = (qs, qn, codes, vn, cs["valid"], k)
        kw = dict(group_term=gt, extra_mask=cs["extra"], clamp_zero=clamp, device=dev)
        name = (f"{cs['tag']} {cs['fold']} gt={cs['gt']} B={b} k={k} N={n} D={d}")
        # the wrapper's own choice, unless the case asks for a variant
        variant = cs.get("force") or scan_variant(b, n, d, k, codes.data_ptr() % 16 == 0)
        kernel_kw = dict(kw, variant=cs.get("force"))
        dk, ik = fused_codes_search(*args, **kernel_kw)
        dp, ip_ = fused_codes_search_plain(*args, **kw)
        torch.cuda.synchronize()
        err = compare(name, dk, ik, dp, ip_)
        ms = time_ms(lambda: fused_codes_search(*args, **kernel_kw), reps)
        prev_ms = None  # the mma.sync variant on a shape that wgmma serves
        if variant == "wgmma":
            prev_ms = time_ms(lambda: fused_codes_search(*args, **dict(kw, variant="mma")), reps)
        plain_ms = time_ms(lambda: fused_codes_search_plain(*args, **kw), PLAIN_LAUNCHES)
        if id(codes) not in c16:
            c16[id(codes)] = codes.to(torch.bfloat16)
        valid = cs["valid"] if cs["extra"] is None else cs["valid"] & cs["extra"]
        bias16 = torch.where(valid, vn, torch.full_like(vn, MASKED)).to(torch.bfloat16)[None, :]
        qs16, codes16 = qs.to(torch.bfloat16), c16[id(codes)]
        yard_ms = time_ms(lambda: torch.topk(
            torch.addmm(bias16, qs16, codes16.T, alpha=-2.0), k, dim=1, largest=False), reps)
        del bias16
        gt_bytes = 0 if gt is None else gt.numel() * gt.element_size()
        moved = n * d + n * 4 + n + gt_bytes + b * d * 4 + b * 4 + b * k * 8
        bound_by = "bytes" if moved / bw >= 2 * b * n * d / flops else "operations"
        bound_ms = 1e3 * max(moved / bw, 2 * b * n * d / flops)
        row = dict(case=name, variant=variant, max_abs_err=err, ms=ms, prev_ms=prev_ms,
                   plain_ms=plain_ms, addmm_topk_ms=yard_ms, bound_ms=bound_ms,
                   bound_by=bound_by, b=b, k=k, n=n, d=d, fold=cs["fold"], gt=cs["gt"],
                   tag=cs["tag"])
        results.append(row)
        emit({"codes_kernel_case": row})
    check_variants("fused_codes_scan", results)
    return {"cases": results}


# -- 6. quantized store (the slice's path) -----------------------------------

def put_batches(store, name, ids, vecs, category, first=TRAIN_ROWS, last=0) -> None:
    """The first `first` rows in one put (a training sample), the rest in
    PUT_BATCH-row puts, and the final `last` rows in one put."""
    n = len(ids)
    bounds = [0, first, *range(first + PUT_BATCH, n - last, PUT_BATCH), n - last, n]
    bounds = sorted(set(min(x, n) for x in bounds))
    for s, e in zip(bounds[:-1], bounds[1:]):
        cols = None if category is None else {"category": category[s:e]}
        store.put(name, ids[s:e], vecs[s:e], cols)


def dequantized_truth(index, queries, n, k, metric, normalize=False):
    """Exact top-k over the index's own dequantized rows (get_vectors),
    uploaded to the card a million rows at a time."""
    from longbow_tpu_torch.ops.distance import exact_search

    step = 1 << 20
    rows = torch.cat([
        torch.from_numpy(index.get_vectors(np.arange(s, min(s + step, n)))).to(DEVICE)
        for s in range(0, n, step)
    ])
    _, truth = exact_search(queries, rows, k, metric, normalize=normalize, device=DEVICE)
    return truth.cpu().numpy()


def timed(fn, reps):
    """Median host seconds of fn() over reps calls."""
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t)
    return statistics.median(out)


def phase_quantized_store():
    """-> (results, the 10M sq8r index, its queries): the index is timed
    stage by stage after the launch counts are read."""
    from longbow_tpu_torch.ops import _kernels
    from longbow_tpu_torch.ops.distance import Metric, exact_search
    from longbow_tpu_torch.query.parser import Filter
    from longbow_tpu_torch.store.vector_store import VectorStore

    out: dict = {}
    _kernels.reset_launch_counts()

    # 6.1 sq8r at Deep-10M's shape
    allv = make_corpus(N_DEEP + N_QUERIES, D_DEEP, seed=0)
    corpus, queries = allv[:N_DEEP], allv[N_DEEP:]
    del allv
    ids = np.arange(N_DEEP, dtype=np.int64)
    store = VectorStore(device=DEVICE, dtype=torch.bfloat16)
    ds = store.get_or_create("deep", D_DEEP, index_kind="sq8r",
                             index_params={"n_clusters": 1024})
    t0 = time.perf_counter()
    put_batches(store, "deep", ids, corpus, ids % 10, last=FINAL_ROWS)
    torch.cuda.synchronize()
    deep: dict = {"ingest_rows_per_s": N_DEEP / (time.perf_counter() - t0)}
    inner = ds.index._inner
    deep.update(main_capacity=inner.m_codes.shape[0], main_live=inner.m_live,
                delta_rows=inner.d_count, n_clusters=inner.n_clusters,
                device_bytes=ds.device_bytes())
    if inner.d_count == 0:
        fail("sq8r: the delta region is empty at search time")
    ds.warm()
    lat = []
    for j in range(16):
        t = time.perf_counter()
        store.search("deep", queries[j:j + 1], 10)
        lat.append(time.perf_counter() - t)
    deep["p50_single_query_ms"] = 1e3 * statistics.median(lat)
    served, _, _ = store.search("deep", queries, 10)
    batch = timed(lambda: store.search("deep", queries, 10, use_cache=False), 5)
    deep["batch_1000_ms"] = 1e3 * batch
    deep["qps_batch_1000"] = N_QUERIES / batch
    deep["index_search_1_ms"] = 1e3 * timed(lambda: ds.index.search(queries[:1], 10), 16)
    deep["index_search_1000_ms"] = 1e3 * timed(lambda: ds.index.search(queries, 10), 5)
    truth = dequantized_truth(ds.index, queries, N_DEEP, 10, Metric.L2)
    deep["recall_at_10_vs_dequantized"] = r = recall_at(served, truth)
    if r < QUANT_RECALL_GATE:
        fail(f"sq8r 10M x 96: recall@10 {r} against the dequantized rows < {QUANT_RECALL_GATE}")
    _, truth = exact_search(queries, corpus, 10, Metric.L2, device=DEVICE)
    deep["recall_at_10_vs_f32"] = recall_at(served, truth.cpu().numpy())
    fids, _, fok = store.search("deep", queries[:100], 10,
                                filters=[Filter("category", "eq", "3")])
    hits = fids[fok].tolist()
    if not hits or any(x % 10 != 3 for x in hits):
        fail("sq8r: filtered search returned a row outside category == 3")
    deep["filtered_hits"] = len(hits)
    rng = np.random.default_rng(2)
    slot = inner._slot[:N_DEEP]
    dead = np.concatenate([rng.choice(np.nonzero(slot >= 0)[0], 500, replace=False),
                           rng.choice(np.nonzero(slot <= -2)[0], 500, replace=False)])
    if store.delete("deep", dead) != 1000:
        fail("sq8r: delete did not remove 1000 ids")
    did, _, dok = store.search("deep", corpus[dead], 10)
    if set(did[dok].tolist()) & set(dead.tolist()):
        fail("sq8r: deleted ids came back")
    deep["deleted_returned"] = 0
    out["sq8r_10m_x_96"] = deep
    emit({"quantized_store_10m": deep})
    deep_queries = queries
    del corpus

    # 6.2 sq8r and sq8 on the 1,000,000 x 128 rows of phase 4
    allv = make_corpus(N_STORE + N_QUERIES, D_STORE, seed=0)
    corpus, queries = allv[:N_STORE], allv[N_STORE:]
    ids = np.arange(N_STORE, dtype=np.int64)
    _, truth = exact_search(queries, corpus, 10, Metric.L2, device=DEVICE)
    truth_f32 = truth.cpu().numpy()
    for kind in ("sq8r", "sq8"):
        name = f"sift_{kind}"
        sds = store.get_or_create(name, D_STORE, index_kind=kind)
        put_batches(store, name, ids, corpus, None)
        got, _, _ = store.search(name, queries, 10)
        row = {"recall_at_10_vs_f32": recall_at(got, truth_f32),
               "recall_at_10_vs_dequantized": recall_at(
                   got, dequantized_truth(sds.index, queries, N_STORE, 10, Metric.L2)),
               "batch_1000_ms": 1e3 * timed(
                   lambda: store.search(name, queries, 10, use_cache=False), 5)}
        out[f"{kind}_1m_x_128"] = row
        emit({f"quantized_store_1m_{kind}": row})
        if kind == "sq8r" and row["recall_at_10_vs_f32"] < RECALL_GATE:
            fail(f"sq8r 1M x 128: recall@10 {row['recall_at_10_vs_f32']} < {RECALL_GATE}")
        if kind == "sq8" and row["recall_at_10_vs_dequantized"] < QUANT_RECALL_GATE:
            fail(f"sq8 1M x 128: recall@10 against the dequantized rows "
                 f"{row['recall_at_10_vs_dequantized']} < {QUANT_RECALL_GATE}")
        store.drop(name)

    # 6.3 100,000 rows: cosine and dot, and int8 vectors into a default store
    sub, ids = corpus[:N_SMALL], ids[:N_SMALL]
    for kind, metric in (("sq8r", Metric.COSINE), ("sq8", Metric.DOT), ("sq8r", Metric.DOT)):
        name = f"small_{kind}_{metric}"
        sds = store.get_or_create(name, D_STORE, metric, index_kind=kind)
        store.put(name, ids, sub)
        got, _, _ = store.search(name, queries, 10)
        want = dequantized_truth(sds.index, queries, N_SMALL, 10,
                                 Metric.DOT if metric == Metric.DOT else Metric.L2,
                                 normalize=metric == Metric.COSINE)
        r = recall_at(got, want)
        out[f"recall_at_10_{kind}_{metric}_vs_dequantized"] = r
        if r < QUANT_RECALL_GATE:
            fail(f"{kind} {metric}: recall@10 {r} against the dequantized rows "
                 f"< {QUANT_RECALL_GATE}")
    v8 = np.clip(np.round(sub * 8.0), -128, 127).astype(np.int8)
    q8 = np.clip(np.round(queries * 8.0), -128, 127).astype(np.float32)
    int8_store = VectorStore(device=DEVICE)  # default kind adaptive
    int8_store.put("int8", ids, v8)
    if int8_store.get("int8").index.kind != "sq8":
        fail("int8 vectors in an adaptive store did not make an sq8 dataset")
    got, _, _ = int8_store.search("int8", q8, 10)
    _, want = exact_search(q8, v8.astype(np.float32), 10, Metric.L2, device=DEVICE)
    out["recall_at_10_int8_vs_exact"] = r = recall_at(got, want.cpu().numpy())
    if r < QUANT_RECALL_GATE:
        fail(f"int8 sq8: recall@10 {r} < {QUANT_RECALL_GATE}")

    torch.cuda.synchronize()
    out["launches"] = {k.name: k.launches for k in _kernels.KERNELS}
    if _kernels.FUSED_CODES_SCAN.launches == 0:
        fail("kernel fused_codes_scan was not launched on the quantized path")
    emit({"quantized_store": {k: v for k, v in out.items() if not k.startswith("sq8")}})
    return out, inner, deep_queries


def sq8r_stages(inner, queries, reps: int = 5) -> dict:
    """Device time of the 10M sq8r index search of 1,000 queries, stage by
    stage (CUDA events): the search as served, the same search with the
    delta region's scan off (so the delta scan and its re-rank are the
    difference), K2 alone on the arguments that search passed it, and
    the group-term gather."""
    from longbow_tpu_torch.index import sq8

    total = time_ms(lambda: inner.search(queries, 10), reps)
    main = time_ms(lambda: inner._search(queries, 10, None, has_delta=False), reps)
    calls = []
    real = sq8.fused_codes_search

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    sq8.fused_codes_search = record
    try:
        inner.search(queries, 10)
    finally:
        sq8.fused_codes_search = real
    if len(calls) != 1:
        fail(f"sq8r search of {len(queries)} queries launched K2 {len(calls)} times, not once")
    args, kw = calls[0]
    k2 = time_ms(lambda: real(*args, **kw), reps)
    qc = torch.from_numpy(queries).to(DEVICE) @ inner.centers.T
    gather = time_ms(lambda: sq8.group_term(qc, inner.m_gcid), reps)
    out = {"search_ms": total, "main_region_ms": main, "delta_scan_and_rerank_ms": total - main,
           "k2_ms": k2, "gt_gather_ms": gather,
           "main_rest_ms (upload, qc, folds, main re-rank, merge, copy out)":
               main - k2 - gather}
    emit({"sq8r_10m_stages": out})
    return out


# -- 7. graph tier (this slice's path) ----------------------------------------

def first_call(module, attr: str, run, what: str) -> tuple:
    """Run `run` and keep the arguments of the first call it makes to
    module.attr, a kernel's wrapper (the call itself goes through)."""
    calls = []
    real = getattr(module, attr)

    def record(*args, **kw):
        if not calls:
            calls.append((args, kw))
        return real(*args, **kw)

    setattr(module, attr, record)
    try:
        run()
    finally:
        setattr(module, attr, real)
    if not calls:
        fail(f"{what} did not call {attr}")
    return calls[0]


def recorded_self_knn(build) -> tuple:
    """The arguments of the first call a graph build's self-kNN makes to
    K1's wrapper."""
    from longbow_tpu_torch.index import graph_build

    return first_call(graph_build, "fused_flat_search", build, "the build")


def scan_row(name, variant, err, ms, plain_ms, moved, ops, bw, flops, **extra) -> dict:
    """One kernel case: times beside the bound, the larger of the bytes
    over the memory rate and the operations over the bf16 peak."""
    return dict(case=name, variant=variant, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=1e3 * max(moved / bw, ops / flops),
                bound_by="bytes" if moved / bw >= ops / flops else "operations", **extra)


def check_build_scan(label: str, call: tuple, bw: float, flops: float, reps: int,
                     finds_itself: bool = True) -> dict:
    """K1 against its plain version on the very arguments a path gave the
    wrapper: for a graph build a block of corpus rows as queries, k + 1
    neighbours, the whole capacity with its valid mask (finds_itself:
    each of those rows must find itself); for an IVF spill segment the
    search's queries, its pool and the segment's rows."""
    from longbow_tpu_torch.ops._kernels import FUSED_SCAN
    from longbow_tpu_torch.ops.scan import (
        fused_flat_search, fused_flat_search_plain, scan_variant,
    )

    held = FUSED_SCAN.launches  # launches made to compare and to time do not count
    args, kw = call
    q, corpus, _, _, k = args[:5]
    (b, d), n = q.shape, corpus.shape[0]
    name = f"{label} {args[5] if len(args) > 5 else 'l2'} B={b} k={k} N={n} D={d}"
    variant = scan_variant(b, n, d, k, corpus.data_ptr() % 16 == 0)
    dk, ik = fused_flat_search(*args, **kw)
    dp, ip_ = fused_flat_search_plain(*args, **kw)
    torch.cuda.synchronize()
    err = compare(name, dk, ik, dp, ip_)
    if finds_itself:
        # the first block's queries are rows 0 .. B-1: the build masks each
        # row's own slot, so every row must find itself
        own = torch.arange(b, device=ik.device)[:, None]
        if not torch.all((ik == own).any(dim=1)):
            fail(f"{name}: a row did not find itself among its {k} nearest")
    ms = time_ms(lambda: fused_flat_search(*args, **kw), reps)
    plain_ms = time_ms(lambda: fused_flat_search_plain(*args, **kw), PLAIN_LAUNCHES)
    masks = 1 if kw.get("extra_mask") is None else 2
    moved = n * d * 2 + n * 4 + masks * n + b * d * q.element_size() + b * k * 8
    row = scan_row(name, variant, err, ms, plain_ms, moved, 2 * b * n * d, bw, flops,
                   b=b, k=k, n=n, d=d, tag=label)
    FUSED_SCAN.launches = held
    emit({"kernel_case": row})
    return row


def check_codes_call(label: str, call: tuple, bw: float, flops: float, reps: int) -> dict:
    """K2 against its plain version on the very arguments a path gave its
    wrapper, timed there beside its bound."""
    from longbow_tpu_torch.ops._kernels import FUSED_CODES_SCAN
    from longbow_tpu_torch.ops.scan import (
        fused_codes_search, fused_codes_search_plain, scan_variant,
    )

    held = FUSED_CODES_SCAN.launches
    args, kw = call
    qs, _, codes, _, _, k = args
    (b, d), n = qs.shape, codes.shape[0]
    name = f"{label} B={b} k={k} N={n} D={d}"
    variant = scan_variant(b, n, d, k, codes.data_ptr() % 16 == 0)
    plain_kw = {key: v for key, v in kw.items() if key != "variant"}
    dk, ik = fused_codes_search(*args, **kw)
    dp, ip_ = fused_codes_search_plain(*args, **plain_kw)
    torch.cuda.synchronize()
    err = compare(name, dk, ik, dp, ip_)
    ms = time_ms(lambda: fused_codes_search(*args, **kw), reps)
    plain_ms = time_ms(lambda: fused_codes_search_plain(*args, **plain_kw), PLAIN_LAUNCHES)
    masks = 1 if kw.get("extra_mask") is None else 2
    moved = n * d + n * 4 + masks * n + b * d * 4 + b * 4 + b * k * 8
    row = scan_row(name, variant, err, ms, plain_ms, moved, 2 * b * n * d, bw, flops,
                   b=b, k=k, n=n, d=d, tag=label)
    FUSED_CODES_SCAN.launches = held
    emit({"codes_kernel_case": row})
    return row


def phase_graph(bw: float, flops: float, reps: int) -> dict:
    import os

    from longbow_tpu_torch.index import graph_build
    from longbow_tpu_torch.index.graph_build import PAD_ROWS, SELF_KNN_QUERIES
    from longbow_tpu_torch.index.hnsw import HNSWConfig, HNSWIndex
    from longbow_tpu_torch.ops import _kernels
    from longbow_tpu_torch.ops.distance import Metric, exact_search
    from longbow_tpu_torch.query.parser import Filter
    from longbow_tpu_torch.store.vector_store import VectorStore

    out: dict = {}
    _kernels.reset_launch_counts()
    allv = make_corpus(N_STORE + N_QUERIES, D_STORE, seed=0)
    corpus, queries = allv[:N_STORE], allv[N_STORE:]
    ids = np.arange(N_STORE, dtype=np.int64)
    category = ids % 1000
    _, truth = exact_search(queries, corpus, 10, Metric.L2, device=DEVICE)
    truth = truth.cpu().numpy()

    # 7.1 the default store: flat -> background migration -> graph
    store = VectorStore(device=DEVICE)  # no kind named: "adaptive", bf16 rows
    t0 = time.perf_counter()
    for s in range(0, N_STORE, PUT_BATCH):
        e = min(s + PUT_BATCH, N_STORE)
        store.put("graph", ids[s:e], corpus[s:e], {"category": category[s:e]})
    puts_s = time.perf_counter() - t0
    ds = store.get("graph")
    idx = ds.index
    migrated = idx.wait_migration()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    if idx.migration_error is not None:
        fail(f"the migration thread failed: {idx.migration_error!r}")
    if not migrated or idx.kind != "hnsw":
        fail(f"after wait_migration the default dataset is of kind {idx.kind!r}, not 'hnsw'")
    ms = idx.migration_stats
    g = idx._graph
    d1 = {"puts_s": puts_s, "ingest_s": ingest_s, "ingest_rows_per_s": N_STORE / ingest_s,
          "relative_contrast": idx.last_contrast, "probe_s": ms["probe_s"],
          "bulk_build_s": ms["bulk_s"], "bulk_build_rows": ms["bulk_rows"],
          "catchup_rows": ms.get("catchup_rows", 0),
          "catchup_rows_per_s": ms.get("catchup_rows", 0) / ms["catchup_s"]
          if ms.get("catchup_s") else None,
          "rows": len(idx), "capacity": idx.capacity, "graph_state_bytes": g.device_bytes()}
    print(f"relative contrast {idx.last_contrast}", flush=True)
    if len(idx) != N_STORE:
        fail(f"the graph holds {len(idx)} rows, not {N_STORE}")
    for ef in (100, 150):
        served, _, _ = store.search("graph", queries, 10, ef_search=ef, use_cache=False)
        d1[f"iters_ef{ef}"] = g.last_search_iters
        d1[f"recall_at_10_ef{ef}"] = recall_at(served, truth)
        sec = timed(lambda: store.search("graph", queries, 10, ef_search=ef, use_cache=False), 3)
        d1[f"batch_1000_ef{ef}_ms"] = 1e3 * sec
        d1[f"qps_batch_1000_ef{ef}"] = N_QUERIES / sec
    if d1["recall_at_10_ef150"] < GRAPH_RECALL_GATE:
        fail(f"default store 1M x 128: recall@10 at ef 150 {d1['recall_at_10_ef150']} "
             f"< {GRAPH_RECALL_GATE}")
    lat = []
    for j in range(16):
        t = time.perf_counter()
        store.search("graph", queries[j:j + 1], 10)
        lat.append(time.perf_counter() - t)
    d1["p50_single_query_ms"] = 1e3 * statistics.median(lat)
    d1["iters_single_query"] = g.last_search_iters

    routes = []  # the `exact` each search reached the index with
    inner_search = idx.search

    def spy(q, k, **kw):
        routes.append(kw["exact"])
        return inner_search(q, k, **kw)

    idx.search = spy
    fids, _, fok = store.search("graph", queries[:100], 10, ef_search=150,
                                filters=[Filter("category", "<", "500")])
    wide = fids[fok].tolist()
    if not wide or any(x % 1000 >= 500 for x in wide):
        fail("a wide filter returned a row outside category < 500")
    fids, _, fok = store.search("graph", queries[:100], 10,
                                filters=[Filter("category", "eq", "3")])
    narrow = fids[fok].tolist()
    if not narrow or any(x % 1000 != 3 for x in narrow):
        fail("a narrow filter returned a row outside category == 3")
    del idx.search
    if routes != [False, True]:
        fail(f"filter routes {routes}: the wide filter must stay on the graph, the narrow "
             "one take the exact path")
    d1.update(wide_filter_hits=len(wide), narrow_filter_hits=len(narrow), filter_violations=0)

    rng = np.random.default_rng(1)
    dead = rng.choice(N_STORE, 1000, replace=False)
    if store.delete("graph", dead) != 1000:
        fail("delete did not remove 1000 ids")
    did, _, dok = store.search("graph", corpus[dead], 10, ef_search=150)
    if set(did[dok].tolist()) & set(dead.tolist()):
        fail("deleted ids came back from the graph")
    d1["deleted_returned"] = 0
    eids, _, eok = store.search("graph", queries, 10, exact=True)
    if set(eids[eok].tolist()) & set(dead.tolist()):
        fail("deleted ids came back from the exact path")
    d1["recall_at_10_exact_after_migration"] = r = recall_at(eids, truth)
    if r < GRAPH_RECALL_GATE:
        fail(f"exact=True after migration: recall@10 {r} < {GRAPH_RECALL_GATE}")
    out["default_store_1m_x_128"] = d1
    emit({"graph_default_store": d1})
    store.drop("graph")
    del store, ds, idx, g
    torch.cuda.empty_cache()

    # 7.2 the bulk build alone, on the device tensor
    os.environ["LONGBOW_BUILD_DEBUG"] = "1"
    graph_build.stage_log.clear()
    rows_dev = torch.from_numpy(corpus).to(DEVICE).to(torch.bfloat16)
    bulk = HNSWIndex(D_STORE, Metric.L2, HNSWConfig(m=32, m_max=48, ef_search=100),
                     dtype=torch.bfloat16, edge_dtype=torch.bfloat16, capacity=N_STORE,
                     device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bulk.add(rows_dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    os.environ.pop("LONGBOW_BUILD_DEBUG")
    d2 = {"build_s": build_s, "rows_per_s": N_STORE / build_s,
          "stages_s": {lab: s for tag, _, lab, s in graph_build.stage_log if tag == "rp-build"},
          "graph_state_bytes": bulk.device_bytes()}
    if not d2["stages_s"]:
        fail("the 1M-row add did not go through bulk_build_rp")
    q128, t128 = queries[:BULK_QUERIES], truth[:BULK_QUERIES]
    for label, (mu, ex) in (("default", (0, 4)), ("fast", (32, 8))):
        bulk.config.search_m_max, bulk.config.search_expand = mu, ex
        _, rows = bulk.search(q128, 10, ef_search=150)
        rec = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                             for a, b in zip(rows, t128)]))
        sec = timed(lambda: bulk.search(queries, 10, ef_search=150), 3)
        d2[label] = {"recall_at_10_ef150_128q": rec, "qps_batch_1000_ef150": N_QUERIES / sec,
                     "iters": bulk.last_search_iters}
    if d2["default"]["recall_at_10_ef150_128q"] < GRAPH_RECALL_GATE:
        fail(f"bulk build 1M x 128: recall@10 {d2['default']['recall_at_10_ef150_128q']} "
             f"< {GRAPH_RECALL_GATE}")
    out["bulk_build_1m_x_128"] = d2
    emit({"graph_bulk_build": d2})
    del bulk, rows_dev
    torch.cuda.empty_cache()

    # 7.3 K1 inside the build: a 100,000-row dataset of kind "hnsw"
    store = VectorStore(device=DEVICE)
    sub, sub_ids = corpus[:N_SMALL], ids[:N_SMALL]
    store.get_or_create("g100k", D_STORE, index_kind="hnsw")
    before = _kernels.FUSED_SCAN.launches
    call = recorded_self_knn(lambda: store.put("g100k", sub_ids, sub))
    torch.cuda.synchronize()
    built = _kernels.FUSED_SCAN.launches - before
    # one launch per SELF_KNN_QUERIES rows of the padded row count
    want_launches = -(-(-(-N_SMALL // PAD_ROWS) * PAD_ROWS) // SELF_KNN_QUERIES)
    if store.get("g100k").index.kind != "hnsw":
        fail("the 100,000-row dataset of kind hnsw did not build its graph")
    if built != want_launches:
        fail(f"the 100,000-row build launched K1 {built} times, the self-kNN alone "
             f"needs {want_launches}")
    got, _, _ = store.search("g100k", queries, 10, ef_search=100)
    if _kernels.FUSED_SCAN.launches - before != built:
        fail("a graph search launched K1")
    _, t100 = exact_search(queries, sub, 10, Metric.L2, device=DEVICE)
    d3 = {"k1_launches_in_build": built, "recall_at_10_ef100": recall_at(got, t100.cpu().numpy())}
    scans = [check_build_scan("self_knn_l2", call, bw, flops, reps)]
    del call
    if d3["recall_at_10_ef100"] < GRAPH_RECALL_GATE:
        fail(f"100k hnsw dataset: recall@10 {d3['recall_at_10_ef100']} < {GRAPH_RECALL_GATE}")
    out["k1_in_build_100k"] = d3

    # 7.4 small graphs: cosine, dot, sq8 storage; uniform rows stay flat
    d4: dict = {}
    for name, metric, params in (("cosine", Metric.COSINE, None), ("dot", Metric.DOT, None),
                                 ("sq8", Metric.L2, {"storage": "sq8"})):
        sds = store.get_or_create(f"g_{name}", D_STORE, metric, index_kind="hnsw",
                                  index_params=params)
        call = recorded_self_knn(lambda: store.put(f"g_{name}", sub_ids, sub))
        if sds.index.kind != "hnsw":
            fail(f"{name}: the dataset of kind hnsw did not build its graph")
        scans.append(check_build_scan(f"self_knn_{name}", call, bw, flops, reps))
        del call
        got, _, _ = store.search(f"g_{name}", queries, 10, ef_search=100)
        want, _, _ = store.search(f"g_{name}", queries, 10, exact=True)
        d4[f"recall_at_10_{name}_vs_exact"] = r = recall_at(got, want)
        if r < SMALL_GRAPH_GATE:
            fail(f"{name} graph: recall@10 {r} against exact search < {SMALL_GRAPH_GATE}")
    uniform = np.random.default_rng(2).standard_normal((N_SMALL, D_STORE)).astype(np.float32)
    ustore = VectorStore(device=DEVICE, migration_threshold=50_000)
    for s in range(0, N_SMALL, PUT_BATCH):
        ustore.put("uniform", sub_ids[s:s + PUT_BATCH], uniform[s:s + PUT_BATCH])
    uidx = ustore.get("uniform").index
    if uidx.wait_migration() or uidx.kind != "flat" or uidx.migration_error is not None:
        fail("uniform Gaussian rows left the flat tier")
    if uidx.last_contrast is None or not uidx.last_contrast < 2.0:
        fail(f"uniform Gaussian rows: relative contrast {uidx.last_contrast}, expected < 2.0")
    got, _, _ = ustore.search("uniform", uniform[:100], 1)
    if got[:, 0].tolist() != list(range(100)):
        fail("the flat tier of the uniform dataset does not return its own rows")
    d4["uniform_relative_contrast"] = uidx.last_contrast
    out["small_graphs_100k"] = d4
    out["self_knn_cases"] = scans

    torch.cuda.synchronize()
    out["launches"] = {k.name: k.launches for k in _kernels.KERNELS}
    if _kernels.FUSED_SCAN.launches == 0:
        fail("kernel fused_scan was not launched on the graph tier's path")
    emit({"graph_tier": {k: v for k, v in out.items()
                         if k not in ("default_store_1m_x_128", "bulk_build_1m_x_128",
                                      "self_knn_cases")}})
    return out


# -- 8. index kinds (this slice's path) -----------------------------------------

def kind_stats(store, name: str, queries, truth, n: int, ingest_s: float) -> dict:
    """recall@10 against `truth`, queries/s of one 1,000-query batch (median
    of 3), p50 of 16 single-query searches, ingest rows/s, and the index's
    device (and host) bytes per row."""
    ds = store.get(name)
    ds.warm()
    lat = []
    for j in range(16):
        t = time.perf_counter()
        store.search(name, queries[j:j + 1], 10, use_cache=False)
        lat.append(time.perf_counter() - t)
    served, _, _ = store.search(name, queries, 10, use_cache=False)
    batch = timed(lambda: store.search(name, queries, 10, use_cache=False), 3)
    stats = ds.stats()
    return {"rows": n, "recall_at_10": recall_at(served, truth),
            "qps_batch_1000": len(queries) / batch, "batch_1000_ms": 1e3 * batch,
            "p50_single_query_ms": 1e3 * statistics.median(lat),
            "ingest_rows_per_s": n / ingest_s,
            "device_bytes_per_row": ds.index.device_bytes() / n,
            "host_bytes_per_row": stats["host_bytes"] / n}


def put_all(store, name: str, ids, vecs, category=None, batch=PUT_BATCH) -> float:
    """Put the rows in `batch`-row puts; -> seconds to the device's end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, len(ids), batch):
        e = min(s + batch, len(ids))
        cols = None if category is None else {"category": category[s:e]}
        store.put(name, ids[s:e], vecs[s:e], cols)
    flush = getattr(store.get(name).index, "flush", None)  # a flat tier's host stage
    if flush is not None:
        flush()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def gate(label: str, value: float, floor: float) -> None:
    if value < floor:
        fail(f"{label}: recall@10 {value} < {floor}")


def filter_and_delete(store, name: str, corpus, queries, seed: int) -> dict:
    """A filtered search (category == 3) and 1,000 deletes: the run fails
    on a violation or a deleted id that comes back."""
    from longbow_tpu_torch.query.parser import Filter

    fids, _, fok = store.search(name, queries[:100], 10, filters=[Filter("category", "eq", "3")])
    hits = fids[fok].tolist()
    violations = sum(1 for x in hits if x % 10 != 3)
    if not hits or violations:
        fail(f"{name}: {violations} filter violations in {len(hits)} hits")
    dead = np.random.default_rng(seed).choice(len(corpus), 1000, replace=False)
    if store.delete(name, dead) != 1000:
        fail(f"{name}: delete did not remove 1000 ids")
    did, _, dok = store.search(name, corpus[dead], 10)
    back = set(did[dok].tolist()) & set(dead.tolist())
    if back:
        fail(f"{name}: {len(back)} deleted ids came back")
    return {"filtered_hits": len(hits), "filter_violations": 0, "deleted_returned": 0}


def phase_index_kinds(bw: float, flops: float, reps: int) -> dict:
    """8. pq, bq, ivf, disk and the graph's storage="pq" through VectorStore
    on phase 4's rows; K1 (the IVF spill segment, the PQ graph's build)
    and K2 (the disk tier's scan) held against their plain versions on
    the arguments these paths gave them."""
    import tempfile

    from longbow_tpu_torch.index import sq8
    from longbow_tpu_torch.ops import _kernels, scan
    from longbow_tpu_torch.ops.distance import Metric, exact_search
    from longbow_tpu_torch.store.vector_store import VectorStore

    out: dict = {}
    t_phase = time.perf_counter()
    allv = make_corpus(N_STORE + N_QUERIES, D_STORE, seed=0)
    corpus, queries = allv[:N_STORE], allv[N_STORE:]
    ids = np.arange(N_STORE, dtype=np.int64)
    category = ids % 10
    _, truth = exact_search(queries, corpus, 10, Metric.L2, device=DEVICE)
    truth = truth.cpu().numpy()
    sub, sub_ids = corpus[:N_SMALL], ids[:N_SMALL]
    store = VectorStore(device=DEVICE)
    _kernels.reset_launch_counts()

    # 8.1 pq with the exact re-rank; the first put trains the books. The
    # default pq_m 16 (8-dim subvectors) cannot rank rows inside one of
    # the recipe's clusters (about 1,000 rows each at 1M, against a pool
    # of 160): measured at 1M, gated at 200,000 rows. pq_m 64 (2-dim
    # subvectors) is gated at 1M.
    for pq_m in (16, PQ_M):
        name = f"pq_m{pq_m}"
        store.get_or_create(name, D_STORE, index_kind="pq",
                            index_params={"pq_m": pq_m, "rerank": True})
        secs = put_all(store, name, ids, corpus, category)
        row = kind_stats(store, name, queries, truth, N_STORE, secs)
        if pq_m == PQ_M:
            gate(f"pq (pq_m {pq_m}) 1M x 128", row["recall_at_10"], PQ_GATE)
            row.update(filter_and_delete(store, name, corpus, queries, 11))
        if pq_m == 16:
            # the same configuration on 200,000 rows (about 200 a cluster),
            # where 8-dim subvectors and a pool of 160 reach into a cluster
            name16 = "pq_m16_200k"
            store.get_or_create(name16, D_STORE, index_kind="pq",
                                index_params={"pq_m": 16, "rerank": True})
            secs = put_all(store, name16, ids[:N_BASIS], corpus[:N_BASIS])
            _, want = exact_search(queries, corpus[:N_BASIS], 10, Metric.L2, device=DEVICE)
            row[name16] = small = kind_stats(store, name16, queries, want.cpu().numpy(),
                                             N_BASIS, secs)
            gate("pq (pq_m 16) 200k x 128", small["recall_at_10"], PQ_GATE)
            store.drop(name16)
        out[name] = row
        emit({f"index_kind_{name}": row})
        store.drop(name)
        torch.cuda.empty_cache()

    # 8.2 bq: l2 on the 1M rows, measured, not gated: 128 sign bits a row
    # cannot rank inside a cluster of about 1,000 rows against a pool of
    # 320; l2 and cosine on 100,000 rows (about 100 a cluster), gated
    store.get_or_create("bq", D_STORE, index_kind="bq")
    secs = put_all(store, "bq", ids, corpus, category)
    row = kind_stats(store, "bq", queries, truth, N_STORE, secs)
    store.drop("bq")
    for metric in (Metric.L2, Metric.COSINE):
        name = f"bq_{metric}_100k"
        store.get_or_create(name, D_STORE, metric, index_kind="bq")
        secs = put_all(store, name, sub_ids, sub)
        _, want = exact_search(queries, sub, 10, metric, device=DEVICE)
        row[name] = small = kind_stats(store, name, queries, want.cpu().numpy(), N_SMALL, secs)
        gate(f"bq {metric} 100k", small["recall_at_10"], BQ_GATE)
        store.drop(name)
    out["bq"] = row
    emit({"index_kind_bq": row})
    torch.cuda.empty_cache()

    # 8.3 ivf: n_probe 8, the 1M rows in one put; rows past a cell's cap
    # spill to a flat segment that K1 scans
    store.get_or_create("ivf", D_STORE, index_kind="ivf", index_params={"n_probe": 8})
    secs = put_all(store, "ivf", ids, corpus, category, batch=N_STORE)
    inner = store.get("ivf").index._inner
    row = kind_stats(store, "ivf", queries, truth, N_STORE, secs)
    row.update(n_cells=inner.n_cells, cap=inner.cells.shape[1], spill_rows=inner.spill_rows)
    print(f"ivf: {inner.n_cells} cells x cap {inner.cells.shape[1]}, "
          f"{inner.spill_rows} rows in the spill segment", flush=True)
    gate("ivf 1M x 128", row["recall_at_10"], IVF_GATE)
    row.update(filter_and_delete(store, "ivf", corpus, queries, 12))
    spill_store = "ivf"
    if inner.spill_rows == 0:
        print("ivf: no spill at 1M rows in one put; forcing one with 100,000 rows in "
              f"{IVF_FORCE_PUT}-row puts", flush=True)
        store.get_or_create("ivf_spill", D_STORE, index_kind="ivf")
        put_all(store, "ivf_spill", sub_ids, sub, batch=IVF_FORCE_PUT)
        row["forced_spill_rows"] = store.get("ivf_spill").index._inner.spill_rows
        spill_store = "ivf_spill"
    spill_call = first_call(scan, "fused_flat_search",
                            lambda: store.search(spill_store, queries, 10, use_cache=False),
                            "the ivf search")
    # the same rows in PUT_BATCH-row puts: cells are sized on the first
    # put alone, so most rows spill (measured, not gated)
    store.get_or_create("ivf_puts", D_STORE, index_kind="ivf", index_params={"n_probe": 8})
    secs = put_all(store, "ivf_puts", ids, corpus, batch=PUT_BATCH)
    puts = store.get("ivf_puts").index._inner
    row["ivf_puts"] = dict(kind_stats(store, "ivf_puts", queries, truth, N_STORE, secs),
                           n_cells=puts.n_cells, cap=puts.cells.shape[1],
                           spill_rows=puts.spill_rows)
    print(f"ivf in {PUT_BATCH}-row puts: {puts.n_cells} cells x cap {puts.cells.shape[1]}, "
          f"{puts.spill_rows} rows in the spill segment", flush=True)
    store.drop("ivf_puts")
    del puts
    out["ivf"] = row
    emit({"index_kind_ivf": row})

    # 8.4 disk: int8 codes on the card (K2), f32 rows in an mmap file
    with tempfile.TemporaryDirectory(prefix="longbow_disk_") as tmp:
        store.get_or_create("disk", D_STORE, index_kind="disk",
                            index_params={"path": f"{tmp}/rows.f32"})
        secs = put_all(store, "disk", ids, corpus, category)
        row = kind_stats(store, "disk", queries, truth, N_STORE, secs)
        gate("disk 1M x 128", row["recall_at_10"], DISK_GATE)
        disk = store.get("disk").index
        row.update(device_bytes=disk.device_bytes(), host_bytes=disk.host_bytes())
        row.update(filter_and_delete(store, "disk", corpus, queries, 13))
        disk_call = first_call(sq8, "fused_codes_search",
                               lambda: store.search("disk", queries, 10, use_cache=False),
                               "the disk search")
        out["disk"] = row
        emit({"index_kind_disk": row})
        store.drop("disk")
        del disk

    # 8.5 graphs with storage="pq", 100,000 rows: the default pq_m (dim / 4
    # = 32) measured for l2, pq_m 64 gated for l2 and cosine
    for metric, pq_m in ((Metric.L2, 0), (Metric.L2, PQ_M), (Metric.COSINE, PQ_M)):
        name = f"hnsw_pq{pq_m or 'default'}_{metric}"
        store.get_or_create(name, D_STORE, metric, index_kind="hnsw",
                            index_params={"storage": "pq", "pq_m": pq_m})
        before = _kernels.FUSED_SCAN.launches
        secs = put_all(store, name, sub_ids, sub, batch=N_SMALL)
        built = _kernels.FUSED_SCAN.launches - before
        _, want = exact_search(queries, sub, 10, metric, device=DEVICE)
        row = kind_stats(store, name, queries, want.cpu().numpy(), N_SMALL, secs)
        g = store.get(name).index._graph
        row.update(k1_launches_in_build=built, pq_m=g.pq_m)
        print(f"{name}: the build launched K1 {built} times", flush=True)
        if pq_m:
            gate(f"graph storage=pq pq_m {pq_m} {metric} 100k", row["recall_at_10"],
                 PQ_GRAPH_GATE)
        out[name] = row
        emit({f"index_kind_{name}": row})
        store.drop(name)

    torch.cuda.synchronize()
    out["launches"] = {k.name: k.launches for k in _kernels.KERNELS}
    for kernel in _kernels.KERNELS:
        if kernel.launches == 0:
            fail(f"kernel {kernel.name} was not launched on the index kinds' path")
    # held against the plain versions after the counts are read
    out["k1_spill"] = check_build_scan("ivf_spill", spill_call, bw, flops, reps,
                                       finds_itself=False)
    out["k2_disk"] = check_codes_call("disk_scan", disk_call, bw, flops, reps)
    del spill_call, disk_call
    store.drop("ivf")
    store.drop("ivf_spill")
    out["seconds"] = time.perf_counter() - t_phase
    emit({"index_kinds": {k: v for k, v in out.items()
                          if k in ("launches", "k1_spill", "k2_disk", "seconds")}})
    return out


# -- 9. store services ------------------------------------------------------

VOCAB = 50_000          # text words w1 .. w50000
TEXT_WORDS = 12         # Zipf(1.1) words a row, beside its cluster word
BM25_QUERIES = 100
BM25_TOP = 30
BM25_RTOL = 1e-5
COMPACT_DELETE = 600_000
QUANT_COMPACT_GATE = 0.99   # sq8 after compaction, against its dequantized live rows


def zipf_words(rng, shape) -> np.ndarray:
    """Word numbers drawn from Zipf(1.1) over VOCAB words (draws past it
    redrawn uniformly)."""
    z = rng.zipf(1.1, shape)
    over = z > VOCAB
    z[over] = rng.integers(1, VOCAB + 1, int(over.sum()))
    return z


def bm25_brute_force(words, clusters, query_terms: list[set], top: int) -> list[np.ndarray]:
    """Top-`top` BM25 scores (k1 1.2, b 0.75, the idf of hybrid/bm25.py)
    of each query's term set, over a scipy.sparse term-document matrix
    of every row's 12 words and its cluster word."""
    import scipy.sparse as sp

    n = words.shape[0]
    k1, b = 1.2, 0.75
    cols = np.concatenate([words, VOCAB + 1 + clusters[:, None]], axis=1)
    rows = np.repeat(np.arange(n), cols.shape[1])
    m = sp.coo_matrix((np.ones(rows.size), (rows, cols.ravel())),
                      shape=(n, VOCAB + 1 + 1024)).tocsc()
    m.sum_duplicates()
    dl = np.asarray(m.sum(axis=1)).ravel()
    avg = dl.sum() / n
    out = []
    for terms in query_terms:
        scores = np.zeros(n)
        for t in terms:
            lo, hi = m.indptr[t], m.indptr[t + 1]
            docs, tf = m.indices[lo:hi], m.data[lo:hi]
            df = hi - lo
            if df == 0:
                continue
            idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5))
            scores[docs] += idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl[docs] / avg))
        best = np.sort(scores)[::-1][:top]
        out.append(best[best > 0])
    return out


def term_of(token: str) -> int:
    """A token's column in bm25_brute_force's matrix."""
    return int(token[1:]) if token[0] == "w" else VOCAB + 1 + int(token[1:])


def parse_metrics(text: str) -> dict:
    """{(sample name, ((label, value), ...)): value} of a Prometheus text
    exposition."""
    import re

    line_re = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
    label_re = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = line_re.match(line)
        if m is None:
            fail(f"metrics: cannot parse {line!r}")
        labels = tuple(sorted(label_re.findall(m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def metric_sum(samples: dict, name: str, **labels) -> float:
    """The sum of a sample over every label set that holds `labels`."""
    return sum(v for (n, ls), v in samples.items()
               if n == name and all(dict(ls).get(k) == val for k, val in labels.items()))


def in_catalog(name: str, catalog: dict) -> bool:
    if name in catalog:
        return True
    for sfx in ("_bucket", "_count", "_sum"):
        if name.endswith(sfx) and catalog.get(name[: -len(sfx)], ("",))[0] in (
                "histogram", "size_histogram"):
            return True
    if name.endswith("_created"):
        base = name[: -len("_created")]
        return base in catalog or base + "_total" in catalog
    return False


def p50_ms(fn, n: int = 16) -> float:
    lat = []
    for j in range(n):
        t = time.perf_counter()
        fn(j)
        lat.append(time.perf_counter() - t)
    return 1e3 * statistics.median(lat)


def phase_services(bw: float, flops: float, reps: int, flat_ingest_rows_per_s: float) -> dict:
    """9. the store's services through VectorStore on phase 4's rows: hybrid
    dense + BM25 search, the GraphRAG edge store, compaction of a flat (K1)
    and an sq8 (K2) dataset with searches served during it, memory
    backpressure with eviction, and the metrics registry's reading of it
    all."""
    import threading
    import urllib.request

    from longbow_tpu_torch.hybrid.bm25 import tokenize
    from longbow_tpu_torch.index import sq8
    from longbow_tpu_torch.metrics import get_registry
    from longbow_tpu_torch.metrics.registry import _CATALOG
    from longbow_tpu_torch.ops import _kernels, scan
    from longbow_tpu_torch.ops.distance import Metric, exact_search
    from longbow_tpu_torch.query.parser import Filter
    from longbow_tpu_torch.store import compaction
    from longbow_tpu_torch.store.vector_store import VectorStore

    out: dict = {}
    t_phase = time.perf_counter()
    allv, assign = make_corpus(N_STORE + N_QUERIES, D_STORE, seed=0, clusters=True)
    corpus, queries = allv[:N_STORE], allv[N_STORE:]
    clusters, qclusters = assign[:N_STORE], assign[N_STORE:]
    ids = np.arange(N_STORE, dtype=np.int64)
    rng = np.random.default_rng(9)
    words = zipf_words(rng, (N_STORE, TEXT_WORDS))
    texts = np.array([" ".join(f"w{w}" for w in row) + f" c{c}"
                      for row, c in zip(words.tolist(), clusters.tolist())])
    qwords = zipf_words(rng, (N_QUERIES, 2))
    qtexts = [f"c{c} w{a} w{b}" for c, (a, b) in zip(qclusters.tolist(), qwords.tolist())]

    # every store search of the phase is counted here (none is served
    # from the query cache: use_cache=False throughout), and which kernel
    # its index sends it to; every compaction too
    count_mu = threading.Lock()
    counts = {"searches": 0, "flat_fused": 0, "sq8_fused": 0, "compactions": 0}
    real_search, real_compact = VectorStore.search, compaction.compact_dataset

    def counted_search(self, dataset, q, k, **kw):
        kind = self.get(dataset).index.kind
        with count_mu:
            counts["searches"] += 1
            if not kw.get("exact") and k <= 64:
                if kind == "flat":
                    counts["flat_fused"] += 1
                elif kind == "sq8":
                    counts["sq8_fused"] += 1
        return real_search(self, dataset, q, k, **kw)

    def counted_compact(ds):
        with count_mu:
            counts["compactions"] += 1
        return real_compact(ds)

    reg = get_registry()
    before = parse_metrics(reg.text().decode())
    VectorStore.search, compaction.compact_dataset = counted_search, counted_compact
    _kernels.reset_launch_counts()
    try:
        out.update(services_hybrid(corpus, queries, ids, clusters, words, texts, qtexts,
                                   flat_ingest_rows_per_s, tokenize, Filter, VectorStore,
                                   counts))
        hstore = out.pop("_store")
        svc_call = first_call(scan, "fused_flat_search",
                              lambda: hstore.search("hybrid", queries, 10, use_cache=False),
                              "the hybrid dataset's search")
        out.update(services_compaction(corpus, queries, ids, Metric, exact_search,
                                       compaction, VectorStore, _kernels))
        cstore, sstore = out.pop("_cstore"), out.pop("_sstore")
        codes_call = first_call(sq8, "fused_codes_search",
                                lambda: sstore.search("compact_sq8", queries, 10, use_cache=False),
                                "the compacted sq8 search")
        out.update(services_backpressure(cstore, corpus, queries, compaction))
        torch.cuda.synchronize()
    finally:
        VectorStore.search, compaction.compact_dataset = real_search, real_compact
    out["launches"] = {k.name: k.launches for k in _kernels.KERNELS}
    for kernel in _kernels.KERNELS:
        if kernel.launches == 0:
            fail(f"kernel {kernel.name} was not launched on the services' path")

    # 9.6 the registry's reading of the phase
    t0 = time.perf_counter()
    text = reg.text().decode()
    after = parse_metrics(text)
    bad = sorted({n for n, _ in after if not in_catalog(n, _CATALOG)})
    if bad:
        fail(f"metrics: samples outside the catalog: {bad[:5]}")
    live = {"hybrid": hstore, "compact_flat": cstore, "compact_sq8": sstore}
    hbm = {}
    for name, st in live.items():
        got = after.get(("longbow_tpu_hbm_bytes_in_use", (("dataset", name),)))
        want = st.get(name).device_bytes()
        if got != want:
            fail(f"metrics: longbow_tpu_hbm_bytes_in_use{{dataset={name}}} {got} != {want}")
        hbm[name] = want

    def delta(name, **labels):
        return metric_sum(after, name, **labels) - metric_sum(before, name, **labels)

    readings = {
        "searches": (delta("longbow_vector_search_latency_seconds_count"), counts["searches"]),
        "cuda_fused": (delta("longbow_simd_dispatch_total", implementation="cuda_fused"),
                       counts["flat_fused"]),
        "cuda_sq8_fused": (delta("longbow_simd_dispatch_total", implementation="cuda_sq8_fused"),
                           counts["sq8_fused"]),
        "compactions_ok": (delta("longbow_compaction_operations_total", status="ok"),
                           counts["compactions"]),
        "bm25_documents": (delta("longbow_bm25_documents_indexed_total"), N_STORE),
    }
    for key, (got, want) in readings.items():
        if got != want:
            fail(f"metrics: {key} rose by {got}, the phase made {want}")
    if out["launches"]["fused_scan"] < counts["flat_fused"]:
        fail("metrics: K1 launched fewer times than the searches counted as cuda_fused")
    port = reg.serve(0, host="127.0.0.1")
    try:
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30).read()
    finally:
        reg.close()
    out["metrics"] = {"readings": {k: v[0] for k, v in readings.items()},
                      "hbm_bytes_in_use": hbm, "samples": len(after),
                      "debug_mux_metrics_bytes": len(body), "seconds": time.perf_counter() - t0}
    emit({"services_metrics": out["metrics"]})

    # held against the plain versions after the counts are read
    out["k1_services"] = check_build_scan("hybrid_dense", svc_call, bw, flops, reps,
                                          finds_itself=False)
    out["k2_services"] = check_codes_call("compacted_sq8", codes_call, bw, flops, reps)
    del svc_call, codes_call
    for st, name in ((hstore, "hybrid"), (cstore, "compact_flat"), (sstore, "compact_sq8")):
        st.drop(name)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"services": {k: out[k] for k in ("launches", "k1_services", "k2_services", "seconds")}})
    return out


def services_hybrid(corpus, queries, ids, clusters, words, texts, qtexts, flat_rate,
                    tokenize, Filter, VectorStore, counts) -> dict:
    """9.1 hybrid search and 9.2 the graph store, on a flat dataset of the
    1M rows with a `category` and a `text` column."""
    t0 = time.perf_counter()
    store = VectorStore(device=DEVICE, dtype=torch.bfloat16, default_index_kind="flat")
    category = ids % 1000
    torch.cuda.synchronize()
    t = time.perf_counter()
    for s in range(0, N_STORE, PUT_BATCH):
        e = min(s + PUT_BATCH, N_STORE)
        store.put("hybrid", ids[s:e], corpus[s:e],
                  {"category": category[s:e], "text": texts[s:e]})
    ds = store.get("hybrid")
    ds.index.flush()
    torch.cuda.synchronize()
    row: dict = {"ingest_rows_per_s_with_bm25": N_STORE / (time.perf_counter() - t),
                 "ingest_rows_per_s_without_bm25": flat_rate,
                 "bm25_documents": len(ds.bm25)}
    print(f"hybrid ingest: {row['ingest_rows_per_s_with_bm25']:.0f} rows/s with BM25, "
          f"{flat_rate:.0f} without (phase 4)", flush=True)
    ds.warm()
    counts["flat_fused"] += 1  # the warm-up: the index's own search, not the store's

    # BM25 against a brute force over a scipy.sparse term-document matrix
    t = time.perf_counter()
    terms = [{term_of(tok) for tok in tokenize(qt)} for qt in qtexts[:BM25_QUERIES]]
    want = bm25_brute_force(words, clusters, terms, BM25_TOP)
    worst = 0.0
    for j, w in enumerate(want):
        got = np.array([sc for _, sc in ds.bm25.search(qtexts[j], BM25_TOP)])
        if got.shape != w.shape:
            fail(f"bm25 query {j}: {len(got)} hits, brute force {len(w)}")
        rel = np.abs(got - w) / np.maximum(np.abs(w), 1e-30)
        worst = max(worst, float(rel.max()) if rel.size else 0.0)
    if worst > BM25_RTOL:
        fail(f"bm25: scores {worst} off the brute force (relative), gate {BM25_RTOL}")
    row["bm25_max_rel_err"] = worst
    row["bm25_check_seconds"] = time.perf_counter() - t

    # rrf against the formula over the store's own two halves
    for j in range(20):
        q = queries[j:j + 1]
        d_ids, _, d_ok = store.search("hybrid", q, 30, use_cache=False)
        lists = [[x for x, ok in zip(d_ids[0], d_ok[0]) if ok],
                 [doc for doc, _ in ds.bm25.search(qtexts[j], 30)]]
        score: dict = {}
        for lst in lists:
            for r, doc in enumerate(lst):
                score[doc] = score.get(doc, 0.0) + 1.0 / (60 + r + 1)
        want_rrf = sorted(score.items(), key=lambda kv: -kv[1])[:10]
        h_ids, h_sc, h_ok = store.hybrid_search("hybrid", q, 10, text_query=qtexts[j],
                                                fusion="rrf")
        got_rrf = [(x, float(sc)) for x, sc, ok in zip(h_ids[0], h_sc[0], h_ok[0]) if ok]
        if [x for x, _ in got_rrf] != [x for x, _ in want_rrf] or any(
                abs(a[1] - b[1]) > 1e-7 for a, b in zip(got_rrf, want_rrf)):
            fail(f"hybrid rrf query {j}: {got_rrf[:3]} against the formula's {want_rrf[:3]}")
    row["rrf_checked_queries"] = 20

    # a category filter through both halves
    violations = hits = 0
    for j in range(BM25_QUERIES):
        f_ids, _, f_ok = store.hybrid_search("hybrid", queries[j:j + 1], 10, text_query=qtexts[j],
                                             fusion="rrf", filters=[Filter("category", "eq", "3")])
        got = f_ids[f_ok].tolist()
        hits += len(got)
        violations += sum(1 for x in got if x % 1000 != 3)
    if violations or not hits:
        fail(f"hybrid: {violations} filter violations in {hits} hits")
    row.update(filtered_hits=hits, filter_violations=0)

    # 1% of the ids deleted: neither half returns one, queried by their own
    # vectors and texts
    dead = np.random.default_rng(10).choice(N_STORE, N_STORE // 100, replace=False)
    if store.delete("hybrid", dead) != len(dead):
        fail("hybrid: delete did not remove every id")
    dead_set = set(dead.tolist())
    back = 0
    for x in dead[:100].tolist():
        h_ids, _, h_ok = store.hybrid_search("hybrid", corpus[x:x + 1], 10, text_query=texts[x])
        back += len(set(h_ids[h_ok].tolist()) & dead_set)
        back += len({doc for doc, _ in ds.bm25.search(texts[x], 30)} & dead_set)
    d_ids, _, d_ok = store.search("hybrid", corpus[dead[:1000]], 10, use_cache=False)
    back += len(set(d_ids[d_ok].tolist()) & dead_set)
    if back:
        fail(f"hybrid: {back} deleted ids came back")
    row["deleted_returned"] = 0

    for mode in ("linear", "rrf", "cascade"):
        row[f"p50_single_query_{mode}_ms"] = p50_ms(lambda j: store.hybrid_search(
            "hybrid", queries[j:j + 1], 10, text_query=qtexts[j], fusion=mode))
    # the two halves of one hybrid query, alone: the dense search of its
    # 30 candidates (K1) and BM25's
    row["p50_dense_half_ms"] = p50_ms(lambda j: store.search(
        "hybrid", queries[j:j + 1], 30, use_cache=False))
    row["p50_bm25_half_ms"] = p50_ms(lambda j: ds.bm25.search(qtexts[j], 30))
    row["batch_1000_one_text_ms"] = 1e3 * timed(lambda: store.hybrid_search(
        "hybrid", queries, 10, text_query=qtexts[0]), 3)
    row["seconds"] = time.perf_counter() - t0
    emit({"services_hybrid": row})

    # 9.2 an edge from every live id to one seeded random live id of its cluster
    t0 = time.perf_counter()
    live_mask = np.ones(N_STORE, bool)
    live_mask[dead] = False
    live = ids[live_mask]
    order = live[np.argsort(clusters[live], kind="stable")]
    counts_c = np.bincount(clusters[live], minlength=1024)
    start = np.concatenate([[0], np.cumsum(counts_c)[:-1]])
    pick = np.random.default_rng(11).random(len(live))
    dst = order[start[clusters[live]] + (pick * counts_c[clusters[live]]).astype(np.int64)]
    t = time.perf_counter()
    for a, b in zip(live.tolist(), dst.tolist()):
        store.add_edge("hybrid", a, b)
    g = {"edges": len(live), "edges_per_s": len(live) / (time.perf_counter() - t)}
    g["p50_traverse_bfs_2_hops_ms"] = p50_ms(
        lambda j: store.traverse_graph("hybrid", int(live[j * 997]), max_hops=2))
    reached = [node for j in range(16)
               for node, _ in store.traverse_graph("hybrid", int(live[j * 997]), max_hops=2)]
    g["p50_hybrid_graph_alpha_0_3_ms"] = p50_ms(lambda j: store.hybrid_search(
        "hybrid", queries[j:j + 1], 10, text_query=qtexts[j], graph_alpha=0.3))
    for j in range(16):
        h_ids, _, h_ok = store.hybrid_search("hybrid", queries[j:j + 1], 10,
                                             text_query=qtexts[j], graph_alpha=0.3)
        reached += h_ids[h_ok].tolist()
    if not reached or not all(live_mask[x] for x in reached):
        fail("graph: a traversal or a graph re-rank returned an id that is not live")
    g["graph_stats"] = store.graph_stats("hybrid")
    g["seconds"] = time.perf_counter() - t0
    emit({"services_graph": g})
    return {"hybrid": row, "graph": g, "_store": store}


def services_compaction(corpus, queries, ids, Metric, exact_search, compaction, VectorStore,
                        _kernels) -> dict:
    """9.3 compaction of a flat dataset (K1) while a second thread searches
    it, against a fresh dataset of the same live rows; 9.4 the same for sq8
    (K2), whose codes must not change."""
    import threading

    out: dict = {}
    dead = np.random.default_rng(12).choice(N_STORE, COMPACT_DELETE, replace=False)
    live_mask = np.ones(N_STORE, bool)
    live_mask[dead] = False
    live = ids[live_mask]
    category = ids % 1000
    _, truth = exact_search(queries, corpus[live], 10, Metric.L2, device=DEVICE)
    truth_ids = live[truth.cpu().numpy()]

    # 9.3 flat
    t0 = time.perf_counter()
    cstore = VectorStore(device=DEVICE, dtype=torch.bfloat16, default_index_kind="flat")
    put_all(cstore, "compact_flat", ids, corpus, category)
    ds = cstore.get("compact_flat")
    cstore.delete("compact_flat", dead)
    tracker = compaction.FragmentationTracker()
    if not tracker.needs_compaction(ds):
        fail(f"compaction: ratio {tracker.ratio(ds)} does not ask for a compaction")
    row: dict = {"fragmentation": tracker.ratio(ds), "capacity_before": ds.index.capacity,
                 "device_bytes_before": ds.device_bytes()}
    done, lat, errors = threading.Event(), [], []

    def serve():
        j = 0
        while not done.is_set():
            t = time.perf_counter()
            try:
                cstore.search("compact_flat", queries[j % N_QUERIES:j % N_QUERIES + 1], 10,
                              use_cache=False)
            except Exception as e:  # counted, and the run fails below
                errors.append(repr(e))
            lat.append(time.perf_counter() - t)
            j += 1

    k1_before = _kernels.FUSED_SCAN.launches
    reader = threading.Thread(target=serve, name="searcher")
    reader.start()
    try:
        st = compaction.compact_dataset(ds)
    finally:
        done.set()
        reader.join(timeout=120)
    torch.cuda.synchronize()
    row.update(st, compaction_seconds=st["seconds"])
    row.update(searches_during=len(lat), max_search_ms_during=1e3 * max(lat, default=0.0),
               capacity_after=ds.index.capacity, device_bytes_after=ds.device_bytes())
    print(f"flat compaction: {st['reclaimed_rows']} rows reclaimed in {st['seconds']:.3f} s, "
          f"{len(lat)} searches served meanwhile (max {row['max_search_ms_during']:.1f} ms); "
          f"capacity {row['capacity_before']} -> {row['capacity_after']}, device bytes "
          f"{row['device_bytes_before']} -> {row['device_bytes_after']}", flush=True)
    if errors or reader.is_alive():
        fail(f"compaction: {len(errors)} searches failed during it: {errors[:2]}")
    if st["reclaimed_rows"] != COMPACT_DELETE or st["live_rows"] != len(live):
        fail(f"compaction: reclaimed {st['reclaimed_rows']}, live {st['live_rows']}")
    ratio = row["device_bytes_after"] / row["device_bytes_before"]
    if row["capacity_after"] != row["capacity_before"] // 2 or abs(ratio - 0.5) > 0.01:
        fail(f"compaction: capacity {row['capacity_after']}, bytes ratio {ratio}")
    put_all(cstore, "fresh_flat", live, corpus[live], category[live])
    got = cstore.search("compact_flat", queries, 10, use_cache=False)
    want = cstore.search("fresh_flat", queries, 10, use_cache=False)
    if not (got[2].all() and want[2].all()):
        fail("compaction: a search returned fewer than 10 ids")
    diff = np.abs(got[1] - want[1])
    if not np.all(diff <= 1e-6 * np.maximum(1.0, np.abs(want[1]))):
        fail(f"compaction: distances {diff.max()} off a fresh index of the live rows")
    apart = np.ones(want[1].shape, bool)  # ids must agree where no distance ties
    apart[:, 1:] &= np.diff(want[1], axis=1) > 0
    apart[:, :-1] &= np.diff(want[1], axis=1) > 0
    if not np.array_equal(got[0][apart], want[0][apart]):
        fail("compaction: ids differ from a fresh index of the live rows")
    row.update(distances_bit_equal=bool(np.array_equal(got[1], want[1])),
               max_distance_diff=float(diff.max()),
               recall_at_10=recall_at(got[0], truth_ids))
    gate("compacted flat 400k x 128", row["recall_at_10"], RECALL_GATE)
    if _kernels.FUSED_SCAN.launches <= k1_before:
        fail("compaction: K1's launch count did not rise")
    cstore.drop("fresh_flat")
    row["seconds"] = time.perf_counter() - t0
    out["compaction_flat"] = row
    emit({"services_compaction_flat": row})

    # 9.4 sq8
    t0 = time.perf_counter()
    sstore = VectorStore(device=DEVICE)
    sstore.get_or_create("compact_sq8", D_STORE, index_kind="sq8")
    put_all(sstore, "compact_sq8", ids, corpus, category)
    ds = sstore.get("compact_sq8")
    live_t = torch.as_tensor(live, device=DEVICE)
    before = ds.index._inner.codes[torch.as_tensor(
        [ds._id_to_row[x] for x in live.tolist()], device=DEVICE)]
    sstore.delete("compact_sq8", dead)
    k2_before = _kernels.FUSED_CODES_SCAN.launches
    st = compaction.compact_dataset(ds)
    rows_after = np.asarray([ds._id_to_row[x] for x in live.tolist()])
    after = ds.index._inner.codes[torch.as_tensor(rows_after, device=DEVICE)]
    if not torch.equal(before, after):
        fail(f"sq8 compaction: {int((before != after).any(dim=1).sum())} rows changed codes")
    deq = ds.index.get_vectors_device(rows_after)
    _, qt = exact_search(queries, deq, 10, Metric.L2, device=DEVICE)
    served, _, _ = sstore.search("compact_sq8", queries, 10, use_cache=False)
    row = dict(st, compaction_seconds=st["seconds"], codes_bit_equal=True,
               recall_at_10_vs_dequantized=recall_at(served, live[qt.cpu().numpy()]),
               recall_at_10=recall_at(served, truth_ids),
               device_bytes_after=ds.device_bytes())
    gate("compacted sq8 400k x 128 (dequantized rows)", row["recall_at_10_vs_dequantized"],
         QUANT_COMPACT_GATE)
    if _kernels.FUSED_CODES_SCAN.launches <= k2_before:
        fail("sq8 compaction: K2's launch count did not rise")
    del before, after, deq, live_t
    row["seconds"] = time.perf_counter() - t0
    out["compaction_sq8"] = row
    emit({"services_compaction_sq8": row})
    return dict(out, _cstore=cstore, _sstore=sstore)


def services_backpressure(cstore, corpus, queries, compaction) -> dict:
    """9.5 memory backpressure on the compacted flat dataset: soft limit at
    half the store's device bytes, hard limit just under them; eviction by
    the least recently read rows of an EvictionManager."""
    from longbow_tpu_torch.metrics import get_registry

    t0 = time.perf_counter()
    reg = get_registry()
    ds = cstore.get("compact_flat")
    used = compaction.MemoryBackpressureController.total_bytes(cstore)
    ev = compaction.EvictionManager()
    live = np.asarray(sorted(ds._id_to_row), dtype=np.int64)
    for chunk in np.array_split(np.random.default_rng(13).permutation(live), 8):
        ev.record_access(chunk.tolist())  # eight read times, coldest first
    ctrl = compaction.MemoryBackpressureController(soft_bytes=used // 2, hard_bytes=used - 1,
                                                  eviction=ev)
    cstore.backpressure = ctrl
    probe = corpus[:1] + 0.5

    def pressure() -> float:
        return parse_metrics(reg.text().decode())[("longbow_memory_pressure_level", ())]

    try:
        cstore.put("compact_flat", [N_STORE], probe)
    except compaction.MemoryPressureError:
        pass
    else:
        fail("backpressure: a put above the hard limit was admitted")
    level_over = pressure()
    evicted = ctrl.enforce(cstore)
    used_after = ctrl.total_bytes(cstore)
    survivors = set(ds._id_to_row)
    gone = np.asarray([x for x in live.tolist() if x not in survivors], dtype=np.int64)
    if used_after > ctrl.soft_bytes or len(gone) != evicted or not evicted:
        fail(f"backpressure: {used_after} bytes after evicting {evicted} (soft {ctrl.soft_bytes})")
    last = ev._last_access
    if max(last[x] for x in gone.tolist()) > min(last[x] for x in survivors):
        fail("backpressure: an evicted row was read more recently than a survivor")
    g_ids, _, g_ok = cstore.search("compact_flat", corpus[gone[:1000]], 10, use_cache=False)
    if set(g_ids[g_ok].tolist()) & set(gone.tolist()):
        fail("backpressure: an evicted id came back")
    cstore.put("compact_flat", [N_STORE], probe)  # admitted again
    level_after = pressure()
    if (level_over, level_after) != (2.0, 0.0):
        fail(f"backpressure: pressure level read {level_over} then {level_after}, not 2 then 0")
    cstore.backpressure = None
    row = {"device_bytes_before": used, "soft_bytes": ctrl.soft_bytes,
           "hard_bytes": ctrl.hard_bytes, "rejected": ctrl.rejected_total, "evicted": evicted,
           "device_bytes_after": used_after, "pressure_levels": [level_over, level_after],
           "evicted_returned": 0, "seconds": time.perf_counter() - t0}
    emit({"services_backpressure": row})
    return {"backpressure": row}


def recorded_fields(prefix: str, row: dict) -> dict:
    """A kernel's check on a path's recorded arguments, for the kernels line."""
    return {f"{prefix}_{key}": row[src] for key, src in (
        ("shape", "case"), ("variant", "variant"), ("ms", "ms"), ("plain_ms", "plain_ms"),
        ("bound_ms", "bound_ms"), ("bound_by", "bound_by"))}


def main() -> int:
    card, bw, flops = phase_device()
    import longbow_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    kern = phase_kernels(bw, flops, TIMED_LAUNCHES)
    store = phase_store()
    codes = phase_codes_kernels(bw, flops, TIMED_LAUNCHES)
    torch.cuda.empty_cache()
    quant, deep_index, deep_queries = phase_quantized_store()
    sq8r_stages(deep_index, deep_queries)
    del deep_index
    torch.cuda.empty_cache()
    graph = phase_graph(bw, flops, TIMED_LAUNCHES)
    knn = graph["self_knn_cases"][0]  # the l2 build's first launch
    torch.cuda.empty_cache()
    kinds = phase_index_kinds(bw, flops, TIMED_LAUNCHES)
    torch.cuda.empty_cache()
    services = phase_services(bw, flops, TIMED_LAUNCHES, store["ingest_rows_per_s"])

    served = next(c for c in kern["cases"] if c["tag"] == "served_batch")
    served2 = next(c for c in codes["cases"] if c["tag"] == "served_batch")
    emit({"kernels": [{
        "name": "fused_scan",
        "route": "cuda",
        "source": "longbow_tpu_torch/csrc/fused_scan.cu",
        "replaces": "longbow_tpu/ops/pallas_scan.py:256",
        "launches": store["launches"]["fused_scan"],
        "launches_graph_tier": graph["launches"]["fused_scan"],
        "launches_index_kinds": kinds["launches"]["fused_scan"],
        "launches_services": services["launches"]["fused_scan"],
        "max_abs_err": max(c["max_abs_err"] for c in
                           kern["cases"] + graph["self_knn_cases"] + [kinds["k1_spill"]]
                           + [services["k1_services"]]),
        "graph_tier_shape": knn["case"],
        "graph_tier_variant": knn["variant"],
        "graph_tier_ms": knn["ms"],
        "graph_tier_plain_ms": knn["plain_ms"],
        "graph_tier_bound_ms": knn["bound_ms"],
        "graph_tier_bound_by": knn["bound_by"],
        **recorded_fields("index_kinds", kinds["k1_spill"]),
        **recorded_fields("services", services["k1_services"]),
        "ms": served["ms"],
        "variant": served["variant"],
        "prev_ms": served["prev_ms"],
        "plain_ms": served["plain_ms"],
        "bound_ms": served["bound_ms"],
        "bound_by": served["bound_by"],
        "library_ms": None,
        "matmul_topk_ms": served["matmul_topk_ms"],
        "shape": served["case"],
    }, {
        "name": "fused_codes_scan",
        "route": "cuda",
        "source": "longbow_tpu_torch/csrc/fused_codes_scan.cu",
        "replaces": "longbow_tpu/ops/pallas_scan.py:444",
        "launches": quant["launches"]["fused_codes_scan"],
        "launches_graph_tier": graph["launches"]["fused_codes_scan"],
        "launches_index_kinds": kinds["launches"]["fused_codes_scan"],
        "launches_services": services["launches"]["fused_codes_scan"],
        "max_abs_err": max(c["max_abs_err"] for c in
                           codes["cases"] + [kinds["k2_disk"], services["k2_services"]]),
        **recorded_fields("index_kinds", kinds["k2_disk"]),
        **recorded_fields("services", services["k2_services"]),
        "ms": served2["ms"],
        "variant": served2["variant"],
        "prev_ms": served2["prev_ms"],
        "plain_ms": served2["plain_ms"],
        "bound_ms": served2["bound_ms"],
        "bound_by": served2["bound_by"],
        "library_ms": None,
        "addmm_topk_ms": served2["addmm_topk_ms"],
        "shape": served2["case"],
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
