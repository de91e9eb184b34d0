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
               9.1 hybrid search on a flat dataset of the first 250,000 rows with
               a `category` and a `text` column (12 Zipf(1.1) words over 50,000
               and the row's cluster word):
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
               the compacted sq8 dataset's search;
 10. persistence - VectorStore(persist_dir=...) on phase 4's rows and queries, in a
               temp directory removed at the end: 10.1 a child process
               (longbow_tpu_torch.tools.persist_child, wal_sync "batch") puts the
               1,000,000 rows as a flat bf16 dataset in 65,536-row puts with a
               `category` column, deletes 10,000 ids, snapshots, writes a WAL tail
               (100,000 rows, half of them upserts; 5,000 deletes; a second dataset
               put and dropped; an edge), flushes the WAL, saves its top 10 of the
               1,000 queries and a filtered search, and SIGKILLs itself (logged
               ingest rows/s against phase 4's, WAL bytes a row, snapshot seconds
               and bytes); 10.2 a fresh store recovers on the card (snapshot read,
               index import and WAL replay timed): distances within rtol 1e-6 of the
               child's and ids equal where no distance ties, recall@10 >= 0.95
               against the f32 oracle over the live rows, no filter violation, no
               deleted or dropped id back, the first search's latency, and every
               search on K1 (its launches and longbow_simd_dispatch_total{cuda_fused}
               rise by the searches made); 10.3 an sq8 dataset of the rows is put,
               snapshotted and restored into a fresh store: codes bit for bit,
               results equal to before, recall@10 >= 0.99 against its dequantized
               rows, on K2; 10.4 phase 7's graph store is snapshotted by a
               StorageEngine and restored: adjacency bit for bit, no build (no K1
               launch, no graph_build call), recall@10 at ef 150 equal to before and
               >= 0.95, the restore's seconds beside phase 7's; the file, O_DIRECT
               and io_uring WAL backends asked for and which served; 10.5
               longbow_wal_writes_total equal to the child's frames, the snapshot
               histogram's count equal to the snapshots taken, warm-up at 100.
               Launch counts are set to 0 just before the phase and read just after
               it; then K1 is held against its plain version on the recovered flat
               dataset's search arguments and K2 on the restored sq8 dataset's;
 11. serving core - on phase 4's rows and queries, k = 10, phase 4's flat dataset
               put again the same way: 11.1 64 threads send 16 single-query
               searches each (the 1,000 queries and 24 more; every fourth with a
               category filter of three values) through SearchCoalescer(store):
               each answer equal to the same query searched alone (scores within
               rtol 1e-6, ids where no score ties), recall@10 >= 0.95, no filter
               violation, K1 launched once a dispatch and fewer times than the
               requests; requests/s against the same requests one by one, p50 and
               p99 of a request, the mean group; 11.3 load_config() under a
               deployment's environment in the reference's own names (Go
               durations, byte sizes, an address) builds 11.2's store; 11.2 the
               rows in 65,536-row jobs from 4 threads through IngestQueue, then
               drain: 1,000,000 rows, answers equal to the direct dataset's, the
               queue-depth gauge at 0, rows/s against direct puts; HealthManager
               with the store, storage and device checkers healthy on the card.
               Launch counts are set to 0 just before the phase and read just
               after it; then K1 is held against its plain version on the
               arguments of the largest coalesced dispatch;
 12. mesh tier - on the same rows and queries, k = 10: 12.1 mesh_flat through
               the store on the host's mesh (one shard here), and a mesh_flat
               dataset on 8 logical shards of the card (Mesh((cuda:0,) * 8)):
               answers equal to phase 11's flat dataset (rtol 1e-6, ids where
               untied), recall@10 >= 0.95, K1 launched once a shard a search,
               longbow_hnsw_parallel_search_splits_total up by 8 a search on the
               8 shards, no filter violation, 10,000 deletes none of which comes
               back; 1,000-query and single-query times against the flat
               dataset's, ingest rows/s; on 8 shards K1 held against its plain
               version on one shard's arguments (the variant scan_variant picks
               at that size), the merge's time and the local searches'; 12.2 a
               StorageEngine snapshot of the store, restored in a new store:
               shard_counts, valid, norms and rows bit for bit, answers equal;
               12.3 mesh_graph on 8 logical shards, 1,000,000 rows: build
               seconds a shard, K1 launched in the builds, recall@10 at ef 100
               and 150 (gate 0.95 at 150), 1,000-query and single-query times
               beside phase 7's graph, 20,000 rows added live (the interim
               segment) each finding itself first; the store's mesh_graph (one
               shard) at 100,000 rows, recall@10 >= 0.90. Launch counts are set
               to 0 just before the phase and read just after it;
 13. Flight edge - the serving process's runtime (longbow_tpu_torch.serve.build_runtime,
               from a Config read from the environment: a temporary data path, the
               default kind held flat, async ingest, the coalescer, a 5 s periodic
               snapshot, the middleware chain) and its FlightHandlers, driven with
               requests as the wire carries them (put batches, answers and scan
               batches across the port's Arrow IPC codec; tickets, exchange
               commands and actions as longbow_tpu's client writes them), on phase
               4's rows and queries, k = 10: 13.1 16 DoPut streams of 65,536 rows
               (id, vector as FixedSizeList<f32>[128], category = id mod 1000) through
               the ingest queue, check_readiness polled until not BUSY, rows/s
               against phase 4's; 13.2 the 1,000 queries as one ticket (equal to
               store.search: scores rtol 1e-6, ids where untied; query_index right;
               recall@10 >= 0.95) and as 1,000 single tickets from 64 threads through
               the coalescer (a quarter with a category filter of three values: 0
               violations; each equal to the query searched alone), requests/s, p50
               and p99 a ticket, the mean group, K1's launches and variant;
               include_vectors f32 (equal to get_vectors), f16 (its f16 cast) and
               quantized (within vector_scale / 2) on 100 queries; 13.3 DoExchange
               with the queries in 8 batches, equal to 13.2; 13.4 a full scan in
               ~2 MB batches through the host mirror (every id once, every vector bit
               for bit the device's stored row), GB/s of the f32 payload, a filtered
               scan with a limit, 1% of the ids deleted by the delete action (none
               back from searches or a scan); 13.5 every single-node action, answers
               held to what the phase did, ForceSnapshot ok, at least one periodic
               snapshot, then a second runtime on the same data path answers equal
               with no deleted id; 13.6 100,000 int8 rows as FixedSizeList<int8>: an
               identity sq8 dataset (the codes are the bytes put), searched through
               K2, recall@10 >= 0.99 against exact search over the codes; 13.7 a rate
               limiter refusing a burst's excess as unavailable, and a breaker that
               opens after 3 failures and closes after its cooldown. Launch counts
               are set to 0 just before the phase and read just after it; then K1 is
               held against its plain version on the largest coalesced ticket group's
               arguments and K2 on the int8 dataset's; 13.8, where pyarrow.flight
               imports, the gRPC binding over loopback with the port's client
               (answers equal to the handlers', a scan bit for bit, puts, an
               unknown dataset's error); where it does not, a line says why;
               13.5 also asks region-summary, merkle-state and export-delta;
 14. cluster   - `python -m longbow_tpu_torch.serve` node processes, all on the one
               card, configured by the reference's environment names, talked to
               with the port's client over loopback gRPC (pyarrow.flight must
               import, or the phase fails); each node logs to a file whose last
               40 lines are printed on a failure, and every node is SIGKILLed at
               the end. 14.1 partitioned placement on 8 nodes (BASELINE.json
               configs[4]): phase 4's 1,000,000 x 128 rows (category = id mod
               1000) through node 0 in 65,536-row DoPut batches, forwarded to
               their ring owners; rows/s until every count is stable; each
               node's ids (a scan) exactly those of a plain recomputation of the
               ring; the 1,000 queries through node 0 as one DoExchange batch and
               as 256 single tickets from 16 threads (a quarter with a category
               filter of three values: 0 violations): recall@10 >= 0.95, and
               against one flat dataset of the same rows in this process: scores
               of shared ids within rtol 1e-6, top-10 overlap >= 0.99; p50/p99 a
               ticket, the batch's time; 10,000 ids deleted through node 0 (a
               broadcast) come back 0 times; K1 launched on every node over
               those searches (its longbow_kernel_launches_total, read from its
               metrics port just before and just after them); the mean fan-out;
               14.2 100,000 rows with phase 9's text column: 100 hybrid queries
               through node 0, each equal to fuse_rrf (k 60) of the nodes' own
               local_only answers; then node 7 SIGKILLed: the seconds until node
               0 calls it dead, then consistency ALL refused, QUORUM answers,
               and best-effort answers hold no id of its share and recall@10
               >= 0.95 against the live rows; 14.3 a replicated 3-node cluster
               (scripts/start_local_cluster.sh: async replication, anti-entropy
               every 2 s, a WAL each): the 1M rows through node 0, rows/s
               acknowledged, the seconds until node 2 holds them all, equal
               Merkle roots on the three, nodes 1's and 2's answers equal node
               0's; node 2 SIGKILLed, 10,000 new rows, 10,000 upserts and 1,000
               deletes through node 0 (node 1's Merkle root must then equal node
               0's: a replicated delete carries its origin's time), node 2
               restarted on its WAL: the seconds
               from its readiness until its root equals node 0's, synced rows
               under 5x the 21,000 divergent ones, answers equal, no deleted id
               back, the upserted vectors bit for bit node 0's, a checkpoint
               with both peers prepared and committed; K1 launched on every node
               over 14.3's searches (its launch counter);
 15. leftovers - LONGBOW_FLAT_COARSE=1 on phase 4's rows: the flat tier's int8
               shadow (K2 for a pool of 64, the f32 re-rank), recall@10 >= 0.95,
               the pool's containment of the true top-10, K2 launched on every
               search and K1 on none, times beside phase 4's K1 path, K2 held
               against its plain version on the shadow's first launch; a dot
               dataset with the variable set stays on K1; 100,000 complex64 rows
               of D = 64 through exact_search equal to their [real, imag]
               widening, float64 equal to float32;
 16. operators - the operator entry points of longbow_tpu_torch/tools/, each run as
               a subprocess the way an operator runs it (`python -m
               longbow_tpu_torch.tools.<name>`), against `python -m
               longbow_tpu_torch.serve` nodes on the card; each node's kernel
               launches are read from its launch counter just before and just
               after each part. 16.1 one node (a WAL) and the ops CLI: every
               command; 100,000 x 128 rows put by the CLI, its searches (3 seeded
               queries) equal to an in-process flat store of the same rows (rtol
               1e-6, ids where untied), `ns-create --index sq8`, a snapshot
               while it is empty, then a put and a search whose top-1 is the
               query's own row on K2 (this node checks for compaction every 5 s
               at fragmentation 0.1); 16.2 bench_tool
               against that node, 8 s a mode: ingest of f32 rows into a flat
               dataset and of int8 rows (an identity sq8 dataset), search, hybrid
               (on the int8 dataset) and scan, each with 0 errors, K1 and K2
               launched on the node; then micro on the card; 16.3 soak_mixed
               against that node for 30 s:
               0 search errors, every kept acknowledged write found first, no
               deleted id in the final scan, at least one compaction counted;
               16.4 chaos_soak: three replicated nodes, 128-d rows, 1,000 a write,
               262,144 seed rows of phase 4's recipe, 60 s with node 1 killed at
               25% and restarted at 55%: HEALED, every acknowledged row live on all
               three nodes with equal Merkle roots, K1 launched on every node;
               node 1's seconds from readiness to node 0's root, the rows synced
               and the delta pulls.
The last line of standard output is {"ok": true, "device": {...}}.

Imports torch, numpy and longbow_tpu_torch only.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
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
PLAIN_LAUNCHES = 3                  # the plain versions are slow and gate nothing
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

def first_call(module, attr: str, run, what: str, largest: bool = False) -> tuple:
    """Run `run` and keep the arguments of the first call it makes to
    module.attr, a kernel's wrapper (the calls themselves go through);
    largest: of the call with the most queries instead."""
    calls = []
    real = getattr(module, attr)

    def record(*args, **kw):
        if not calls or largest and args[0].shape[0] > calls[0][0][0].shape[0]:
            calls[:] = [(args, kw)]
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
    out["_store"] = store  # phase 10 snapshots it and restores it
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
                                      "self_knn_cases", "_store")}})
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
# rows of 9.1's hybrid dataset (the first of phase 4's): BM25 indexes a
# document at a time on the host, about 18,000 rows/s on the H100's host,
# so 1M rows cost a minute of the script; 9.3-9.5 keep all 1M
N_TEXT = 250_000
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
    from longbow_tpu_torch.metrics.registry import _CATALOG, PORT_METRICS
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
    words = zipf_words(rng, (N_STORE, TEXT_WORDS))[:N_TEXT]
    texts = np.array([" ".join(f"w{w}" for w in row) + f" c{c}"
                      for row, c in zip(words.tolist(), clusters[:N_TEXT].tolist())])
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
        out.update(services_hybrid(corpus[:N_TEXT], queries, ids[:N_TEXT], clusters[:N_TEXT],
                                   words, texts, qtexts,
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
    bad = sorted({n for n, _ in after if not in_catalog(n, {**_CATALOG, **PORT_METRICS})})
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
        "bm25_documents": (delta("longbow_bm25_documents_indexed_total"), N_TEXT),
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
    first N_TEXT rows with a `category` and a `text` column."""
    t0 = time.perf_counter()
    n = len(ids)
    store = VectorStore(device=DEVICE, dtype=torch.bfloat16, default_index_kind="flat")
    category = ids % 1000
    torch.cuda.synchronize()
    t = time.perf_counter()
    for s in range(0, n, PUT_BATCH):
        e = min(s + PUT_BATCH, n)
        store.put("hybrid", ids[s:e], corpus[s:e],
                  {"category": category[s:e], "text": texts[s:e]})
    ds = store.get("hybrid")
    ds.index.flush()
    torch.cuda.synchronize()
    row: dict = {"rows": n, "ingest_rows_per_s_with_bm25": n / (time.perf_counter() - t),
                 "ingest_rows_per_s_without_bm25": flat_rate,
                 "bm25_documents": len(ds.bm25)}
    print(f"hybrid ingest: {n} rows at {row['ingest_rows_per_s_with_bm25']:.0f} rows/s with BM25, "
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
    dead = np.random.default_rng(10).choice(n, n // 100, replace=False)
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
    live_mask = np.ones(n, bool)
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


# -- 10. persistence (this slice's path) ---------------------------------------

PERSIST_GATE = 0.95          # the recovered flat dataset against the f32 oracle
CHILD_TIMEOUT_S = 600
WAL_TRY_FRAMES = 4           # 65,536-row put frames appended a backend


def dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def ids_where_untied(ids, dist) -> np.ndarray:
    """True where a slot's distance differs from both its neighbours in the
    row: there the id is fixed; among equal distances any order is right."""
    same_prev = np.zeros(dist.shape, bool)
    same_prev[:, 1:] = dist[:, 1:] == dist[:, :-1]
    same_next = np.zeros(dist.shape, bool)
    same_next[:, :-1] = dist[:, :-1] == dist[:, 1:]
    return ~(same_prev | same_next)


def dispatch_count(reg, label: str) -> float:
    return reg.counter("longbow_simd_dispatch_total", ("implementation",)).labels(
        implementation=label).value


def snapshot_count(reg) -> int:
    return sum(reg.histogram("longbow_snapshot_duration_seconds")._only().counts)


def count_snapshots(engine, taken: list) -> None:
    """Append to `taken` for every snapshot the engine completes, explicit
    or started by the WAL's size."""
    real = engine.snapshot

    def snapshot(store):
        real(store)
        taken.append(engine.dir)

    engine.snapshot = snapshot


def phase_persistence(bw: float, flops: float, reps: int, card: str, flat_rate: float,
                      graph_store, graph_stats: dict) -> dict:
    """10. persistence through VectorStore(persist_dir=...) on phase 4's rows:
    a writer that crashes (a child process), recovery on the card (K1), an
    sq8 dataset restored (K2), phase 7's graph snapshotted and restored
    with no build, the WAL's backends and the metrics."""
    import shutil
    import signal
    import tempfile
    from pathlib import Path

    from longbow_tpu_torch.index import hnsw as hnsw_mod
    from longbow_tpu_torch.index import sq8
    from longbow_tpu_torch.metrics import get_registry
    from longbow_tpu_torch.ops import _kernels, scan
    from longbow_tpu_torch.ops.distance import Metric, exact_search
    from longbow_tpu_torch.query.parser import Filter
    from longbow_tpu_torch.storage import engine as storage_engine
    from longbow_tpu_torch.storage.wal import WAL
    from longbow_tpu_torch.store.vector_store import VectorStore
    from longbow_tpu_torch.tools.persist_child import DROPPED_IDS, scenario

    out: dict = {"card": card}
    t_phase = time.perf_counter()
    reg = get_registry()
    root = Path(tempfile.mkdtemp(prefix="longbow_persist_"))
    sc = scenario(N_STORE, N_QUERIES)
    queries = sc["queries"]
    snaps0 = snapshot_count(reg)
    taken: list = []  # the snapshots this process completes
    _kernels.reset_launch_counts()
    try:
        # 10.1 the writer: puts, a snapshot, a WAL tail, then SIGKILL
        flat_dir = root / "flat"
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "longbow_tpu_torch.tools.persist_child", str(flat_dir),
             "--rows", str(N_STORE), "--queries", str(N_QUERIES), "--device", DEVICE],
            capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
            cwd=str(Path(__file__).resolve().parent),
        )
        child_s = time.perf_counter() - t0
        if res.returncode != -signal.SIGKILL:
            fail(f"persist_child exited {res.returncode}, not by SIGKILL: {res.stderr[-3000:]}")
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith('{"persist_child"')]
        if not lines:
            fail(f"persist_child printed no result: {res.stderr[-3000:]}")
        child = json.loads(lines[-1])["persist_child"]
        child["process_s"] = child_s
        child["unlogged_ingest_rows_per_s_phase4"] = flat_rate
        out["writer"] = child
        print(f"10.1 logged ingest {child['logged_ingest_rows_per_s']:.0f} rows/s against "
              f"{flat_rate:.0f} unlogged (phase 4); {child['wal_bytes_per_row']:.1f} WAL bytes a "
              f"row; snapshot {child['snapshot_s']:.3f} s, {child['snapshot_bytes']} bytes; "
              f"WAL backend {child['wal_backend']}", flush=True)
        emit({"persistence_writer": child})

        # 10.2 recovery on the card
        t0 = time.perf_counter()
        store = VectorStore(persist_dir=flat_dir, device=DEVICE)
        torch.cuda.synchronize()
        rec = dict(store.engine.recovery_stats, recovery_s=time.perf_counter() - t0)
        rec["replay_rows_per_s"] = rec["rows_replayed"] / rec["wal_replay_s"]
        if reg.gauge("longbow_warmup_progress_percent")._only().value != 100:
            fail("longbow_warmup_progress_percent is not 100 after the recovery")
        if store.list_datasets() != ["sift"]:
            fail(f"recovered datasets {store.list_datasets()}, want ['sift'] (one was dropped)")
        if rec["frames"] != child["tail_frames"]:
            fail(f"recovery replayed {rec['frames']} frames, the child wrote "
                 f"{child['tail_frames']} after its snapshot")
        ds = store.get("sift")
        if ds.live_count != len(sc["live_ids"]) or ds.index.kind != "flat":
            fail(f"recovered {ds.live_count} live rows of kind {ds.index.kind}, "
                 f"want {len(sc['live_ids'])} flat")
        k1_0 = _kernels.FUSED_SCAN.launches
        disp0 = dispatch_count(reg, "cuda_fused")
        searches = 0
        t0 = time.perf_counter()
        store.search("sift", queries[:1], 10, use_cache=False)
        rec["first_search_ms"] = 1e3 * (time.perf_counter() - t0)
        searches += 1
        ids, dist, ok = store.search("sift", queries, 10, use_cache=False)
        searches += 1
        with np.load(flat_dir / "child.npz") as z:
            c_ids, c_dist, c_fids = z["ids"], z["dist"], z["filtered_ids"]
        got = np.where(ok, ids, -1).astype(np.int64)
        if not np.array_equal(ok, c_ids >= 0):
            fail("the recovered search fills other slots than the writer's")
        if not np.allclose(dist[ok], c_dist[ok], rtol=1e-6, atol=0):
            fail(f"recovered distances differ from the writer's by up to "
                 f"{np.max(np.abs(dist[ok] - c_dist[ok]))}")
        untied = ids_where_untied(got, c_dist) & ok
        if not np.array_equal(got[untied], c_ids[untied]):
            fail("recovered ids differ from the writer's where no distance ties")
        rec["untied_slots"] = int(untied.sum())
        _, truth = exact_search(queries, sc["live_rows"], 10, Metric.L2, device=DEVICE)
        rec["recall_at_10"] = recall_at(ids, sc["live_ids"][truth.cpu().numpy()])
        gate("recovered flat 1M x 128", rec["recall_at_10"], PERSIST_GATE)
        fids, _, fok = store.search("sift", queries[:100], 10, use_cache=False,
                                    filters=[Filter("category", "eq", "3")])
        searches += 1
        hits = fids[fok].tolist()
        if not hits or any(x % 10 != 3 for x in hits):
            fail("a filtered search after recovery returned a row outside category == 3")
        rec["filtered_hits"] = len(hits)
        rec["filtered_equal_to_writer"] = bool(np.array_equal(
            np.where(fok, fids, -1).astype(np.int64), c_fids))
        dead = np.concatenate([sc["dead1"], sc["dead2"]])
        probe = sc["corpus"][sc["dead1"][:N_QUERIES]]
        did, _, dok = store.search("sift", probe, 10, use_cache=False)
        searches += 1
        returned = set(did[dok].tolist()) | set(ids[ok].tolist()) | set(hits)
        if returned & set(dead.tolist()) or returned & set(DROPPED_IDS.tolist()):
            fail("a deleted or dropped id came back after the recovery")
        rec["deleted_returned"] = 0
        flat_call = first_call(scan, "fused_flat_search",
                               lambda: store.search("sift", queries, 10, use_cache=False),
                               "the recovered flat search")
        searches += 1
        torch.cuda.synchronize()
        rec["k1_launches"] = _kernels.FUSED_SCAN.launches - k1_0
        rec["cuda_fused_dispatches"] = dispatch_count(reg, "cuda_fused") - disp0
        if rec["k1_launches"] != searches or rec["cuda_fused_dispatches"] != searches:
            fail(f"{searches} searches after the recovery: K1 launched {rec['k1_launches']} "
                 f"times, cuda_fused counted {rec['cuda_fused_dispatches']}")
        print(f"10.2 recovery {rec['recovery_s']:.3f} s: snapshot read "
              f"{rec['snapshot_read_s']:.3f}, index import {rec['index_import_s']:.3f}, WAL "
              f"replay {rec['wal_replay_s']:.3f} ({rec['replay_rows_per_s']:.0f} rows/s); first "
              f"search {rec['first_search_ms']:.3f} ms; recall@10 {rec['recall_at_10']:.4f}",
              flush=True)
        out["recovery"] = rec
        emit({"persistence_recovery": rec})
        store.engine.close()
        del store, ds
        shutil.rmtree(flat_dir)

        # 10.3 sq8 (K2): put, snapshot, restore into a fresh store
        q_dir = root / "sq8"
        corpus, ids = sc["corpus"], np.arange(N_STORE, dtype=np.int64)
        qstore = VectorStore(persist_dir=q_dir, device=DEVICE, default_index_kind="sq8")
        count_snapshots(qstore.engine, taken)
        t0 = time.perf_counter()
        put_batches(qstore, "q8", ids, corpus, ids % 10)
        torch.cuda.synchronize()
        d3 = {"logged_ingest_rows_per_s": N_STORE / (time.perf_counter() - t0)}
        inner = qstore.get("q8").index._inner
        before = qstore.search("q8", queries, 10, use_cache=False)
        d3["snapshots_during_ingest"] = len(taken)
        if qstore.engine._snap_bg is not None:
            qstore.engine._snap_bg.join()  # a WAL-triggered snapshot still writing
        t0 = time.perf_counter()
        qstore.snapshot()
        d3["snapshot_s"] = time.perf_counter() - t0
        d3["snapshot_bytes"] = dir_bytes(q_dir / "snapshot")
        qstore.engine.close()
        t0 = time.perf_counter()
        restored = VectorStore(persist_dir=q_dir, device=DEVICE)
        torch.cuda.synchronize()
        d3["restore_s"] = time.perf_counter() - t0
        d3.update({f"restore_{k}": v for k, v in restored.engine.recovery_stats.items()})
        rinner = restored.get("q8").index._inner
        if restored.get("q8").index.kind != "sq8" or rinner.count != inner.count:
            fail("the restored sq8 dataset is not the one snapshotted")
        for name in ("codes", "lo", "hi", "valid"):
            a, b = getattr(inner, name), getattr(rinner, name)
            n = inner.count if name in ("codes", "valid") else a.shape[0]
            if not torch.equal(a[:n], b[:n]):
                fail(f"sq8 {name} differ after the restore")
        k2_0 = _kernels.FUSED_CODES_SCAN.launches
        disp0 = dispatch_count(reg, "cuda_sq8_fused")
        after = restored.search("q8", queries, 10, use_cache=False)
        for a, b, what in zip(before, after, ("ids", "distances", "ok")):
            if not np.array_equal(a, b):
                fail(f"sq8: {what} differ from before the restore")
        truth = dequantized_truth(restored.get("q8").index, queries, N_STORE, 10, Metric.L2)
        d3["recall_at_10_vs_dequantized"] = recall_at(after[0], truth)
        gate("restored sq8 1M x 128 (dequantized rows)", d3["recall_at_10_vs_dequantized"],
             QUANT_RECALL_GATE)
        codes_call = first_call(sq8, "fused_codes_search",
                                lambda: restored.search("q8", queries, 10, use_cache=False),
                                "the restored sq8 search")
        torch.cuda.synchronize()
        d3["k2_launches"] = _kernels.FUSED_CODES_SCAN.launches - k2_0
        d3["cuda_sq8_fused_dispatches"] = dispatch_count(reg, "cuda_sq8_fused") - disp0
        if d3["k2_launches"] != 2 or d3["cuda_sq8_fused_dispatches"] != 2:
            fail(f"2 searches of the restored sq8 dataset: K2 launched {d3['k2_launches']} "
                 f"times, cuda_sq8_fused counted {d3['cuda_sq8_fused_dispatches']}")
        print(f"10.3 sq8: snapshot {d3['snapshot_s']:.3f} s, {d3['snapshot_bytes']} bytes; "
              f"restore {d3['restore_s']:.3f} s; codes bit for bit; recall@10 "
              f"{d3['recall_at_10_vs_dequantized']:.4f} against its dequantized rows", flush=True)
        out["sq8"] = d3
        emit({"persistence_sq8": d3})
        restored.engine.close()
        del qstore, restored, inner, rinner
        shutil.rmtree(q_dir)

        # 10.4 the default kind after migration: phase 7's graph, restored
        g_dir = root / "graph"
        d4: dict = {}
        gds = graph_store.get("graph")
        g = gds.index._graph
        live = np.fromiter(gds._id_to_row, np.int64)
        _, gtruth = exact_search(queries, sc["corpus"][live], 10, Metric.L2, device=DEVICE)
        gtruth = live[gtruth.cpu().numpy()]
        before = graph_store.search("graph", queries, 10, ef_search=150, use_cache=False)
        d4["recall_at_10_ef150_before"] = recall_at(before[0], gtruth)
        eng = storage_engine.StorageEngine(g_dir, sync="never")
        count_snapshots(eng, taken)
        t0 = time.perf_counter()
        eng.snapshot(graph_store)
        d4["snapshot_s"] = time.perf_counter() - t0
        d4["snapshot_bytes"] = dir_bytes(g_dir / "snapshot")
        eng.close()
        builds = []
        real = {fn: getattr(hnsw_mod, fn) for fn in
                ("bulk_build_rp", "bulk_build_clustered", "bulk_build_edges", "insert_batch")}
        for fn, f in real.items():
            setattr(hnsw_mod, fn, lambda *a, _fn=fn, _f=f, **kw: builds.append(_fn) or _f(*a, **kw))
        k1_0 = _kernels.FUSED_SCAN.launches
        try:
            t0 = time.perf_counter()
            gr = VectorStore(persist_dir=g_dir, device=DEVICE)
            torch.cuda.synchronize()
            d4["restore_s"] = time.perf_counter() - t0
        finally:
            for fn, f in real.items():
                setattr(hnsw_mod, fn, f)
        d4.update({f"restore_{k}": v for k, v in gr.engine.recovery_stats.items()})
        d4["k1_launches_in_restore"] = _kernels.FUSED_SCAN.launches - k1_0
        if builds or d4["k1_launches_in_restore"]:
            fail(f"the graph's restore built: {builds}, K1 launched "
                 f"{d4['k1_launches_in_restore']} times")
        rg = gr.get("graph").index._graph
        if gr.get("graph").index.kind != "hnsw" or rg.count != g.count:
            fail("the restored graph is not the one snapshotted")
        for name in ("nbrs", "nbr_count", "valid"):
            if not torch.equal(getattr(g.state, name)[:g.count], getattr(rg.state, name)[:g.count]):
                fail(f"the graph's {name} differ after the restore")
        after = gr.search("graph", queries, 10, ef_search=150, use_cache=False)
        d4["recall_at_10_ef150_after"] = recall_at(after[0], gtruth)
        d4["results_equal"] = all(np.array_equal(a, b) for a, b in zip(before, after))
        if d4["recall_at_10_ef150_after"] != d4["recall_at_10_ef150_before"]:
            fail(f"graph recall@10 {d4['recall_at_10_ef150_after']} after the restore, "
                 f"{d4['recall_at_10_ef150_before']} before")
        gate("restored graph 1M x 128, ef 150", d4["recall_at_10_ef150_after"], GRAPH_RECALL_GATE)
        d4["phase7_ingest_and_migration_s"] = graph_stats["ingest_s"]
        d4["phase7_bulk_build_s"] = graph_stats["bulk_build_s"]
        print(f"10.4 graph: snapshot {d4['snapshot_s']:.3f} s, {d4['snapshot_bytes']} bytes; "
              f"restore {d4['restore_s']:.3f} s against {graph_stats['ingest_s']:.3f} s of puts "
              f"and migration in phase 7; adjacency bit for bit, no build; recall@10 "
              f"{d4['recall_at_10_ef150_after']:.4f}", flush=True)
        out["graph"] = d4
        emit({"persistence_graph": d4})
        gr.engine.close()
        del gr, rg, g, gds
        shutil.rmtree(g_dir)

        torch.cuda.synchronize()
        out["launches"] = {k.name: k.launches for k in _kernels.KERNELS}

        # the WAL's append backends: which one serves, at what rate
        wal_try: dict = {}
        frame = storage_engine._put_table(ids[:PUT_BATCH], corpus[:PUT_BATCH],
                                          {"category": ids[:PUT_BATCH] % 10})
        for label, kw in (("fs", {}), ("direct", {"direct_io": True}),
                          ("io_uring", {"io_uring": True})):
            path = root / f"try_{label}.log"
            w = WAL(path, sync="always", **kw)
            served = w.backend_name
            t0 = time.perf_counter()
            for _ in range(WAL_TRY_FRAMES):
                w.append_batch("t", frame)
            sec = time.perf_counter() - t0
            w.close()
            if len(list(WAL.replay(path))) != WAL_TRY_FRAMES:
                fail(f"the {served} WAL backend lost frames")
            wal_try[label] = {"served": served, "mb_per_s": path.stat().st_size / sec / 1e6}
            path.unlink()
        out["wal_backends"] = wal_try
        print("10 WAL backends asked for -> served: " + ", ".join(
            f"{k} -> {v['served']} ({v['mb_per_s']:.0f} MB/s, fsync each frame)"
            for k, v in wal_try.items()), flush=True)

        # 10.5 the metrics
        m = {"child_wal_writes_total": child["wal_writes_total"], "child_frames": child["frames"],
             "child_last_seq": child["last_seq"], "child_snapshots": child["snapshots"],
             "child_snapshot_histogram_count": child["snapshot_histogram_count"],
             "parent_snapshots": len(taken),
             "parent_snapshot_histogram_count": snapshot_count(reg) - snaps0}
        if not m["child_wal_writes_total"] == m["child_frames"] == m["child_last_seq"]:
            fail(f"longbow_wal_writes_total {m['child_wal_writes_total']}, the child appended "
                 f"{m['child_frames']} frames (last seq {m['child_last_seq']})")
        if m["child_snapshot_histogram_count"] != m["child_snapshots"] or \
                m["parent_snapshot_histogram_count"] != m["parent_snapshots"]:
            fail(f"longbow_snapshot_duration_seconds counted {m['child_snapshot_histogram_count']}"
                 f" and {m['parent_snapshot_histogram_count']} snapshots, taken "
                 f"{m['child_snapshots']} and {m['parent_snapshots']}")
        out["metrics"] = m
        emit({"persistence_metrics": m})
    finally:
        shutil.rmtree(root, ignore_errors=True)

    out["k1_persistence"] = check_build_scan("recovered_flat", flat_call, bw, flops, reps,
                                             finds_itself=False)
    out["k2_persistence"] = check_codes_call("restored_sq8", codes_call, bw, flops, reps)
    del flat_call, codes_call
    out["seconds"] = time.perf_counter() - t_phase
    emit({"persistence": {k: out[k] for k in ("launches", "k1_persistence", "k2_persistence",
                                              "seconds")}})
    return out


# -- 11. the serving core (this slice's path) -----------------------------------

SERVE_THREADS, SERVE_PER_THREAD = 64, 16   # 1,024 single-query requests
SERVE_RTOL = 1e-6                          # coalesced against alone, and mesh against flat
INGEST_JOBS_THREADS = 4
# a deployment's environment in the reference's own names: Go durations and
# byte sizes beside longbow's names
REFERENCE_ENV = {
    "LONGBOW_INDEX_KIND": "flat",
    "LONGBOW_STORAGE_DTYPE": "bfloat16",
    "LONGBOW_INGEST_QUEUE_DEPTH": "64",
    "LONGBOW_AUTO_SHARDING_THRESHOLD": "200000",
    "LONGBOW_MAX_MEMORY": "64GiB",
    "LONGBOW_MAX_WAL_SIZE": "100MB",
    "LONGBOW_TTL": "1h",
    "LONGBOW_SNAPSHOT_INTERVAL": "30m",
    "LONGBOW_LISTEN_ADDR": "127.0.0.1:3000",
}


def same_answers(label: str, got, want) -> dict:
    """Two stores' (ids, scores, ok) for the same queries: the same slots
    filled, scores within SERVE_RTOL, ids equal wherever no score ties."""
    gi, gs, gok = got
    wi, ws, wok = want
    if not np.array_equal(gok, wok):
        fail(f"{label}: different slots filled")
    if not np.allclose(gs[wok], ws[wok], rtol=SERVE_RTOL, atol=0):
        worst = np.max(np.abs(gs[wok] - ws[wok]) / np.maximum(np.abs(ws[wok]), 1e-30))
        fail(f"{label}: scores differ by {worst} relative (limit {SERVE_RTOL})")
    sure = ids_where_untied(wi, ws) & wok
    if not np.array_equal(gi[sure], wi[sure]):
        fail(f"{label}: {int((gi[sure] != wi[sure]).sum())} untied ids differ")
    return {"slots": int(wok.sum()), "untied_slots": int(sure.sum())}


def serving_requests(queries: np.ndarray):
    """The 1,024 requests of 11.1: the 1,000 held-out queries and the first
    24 moved by N(0, 0.05^2) noise; every fourth carries a category filter
    (three values, so that groups split by the filter's cache key)."""
    from longbow_tpu_torch.query.parser import Filter

    rng = np.random.default_rng(11)
    n = SERVE_THREADS * SERVE_PER_THREAD
    extra = queries[: n - len(queries)] + rng.normal(0, 0.05, (n - len(queries), queries.shape[1]))
    qs = np.concatenate([queries, extra.astype(np.float32)])
    filters = [[Filter("category", "eq", str(i % 3))] if i % 4 == 0 else None for i in range(n)]
    return qs, filters


def phase_serving(bw: float, flops: float, reps: int, flat_rate: float) -> dict:
    """11. the serving core on phase 4's rows: concurrent callers through
    the coalescer, puts through the ingest queue, health and config."""
    import os

    from longbow_tpu_torch.config import load_config
    from longbow_tpu_torch.index.hnsw import HNSWConfig
    from longbow_tpu_torch.metrics import get_registry
    from longbow_tpu_torch.ops import _kernels
    from longbow_tpu_torch.ops import scan as scan_mod
    from longbow_tpu_torch.ops.distance import Metric, exact_search
    from longbow_tpu_torch.serving.coalescer import SearchCoalescer
    from longbow_tpu_torch.serving.ingest import IngestQueue
    from longbow_tpu_torch.store.vector_store import VectorStore
    from longbow_tpu_torch.utils.health import (
        HealthManager, device_checker, storage_checker, store_checker,
    )

    t_phase = time.perf_counter()
    allv = make_corpus(N_STORE + N_QUERIES, D_STORE, seed=0)
    corpus, queries = allv[:N_STORE], allv[N_STORE:]
    ids = np.arange(N_STORE, dtype=np.int64)
    category = ids % 10
    out: dict = {}
    _kernels.reset_launch_counts()

    # phase 4's flat dataset, put the same way (direct 65,536-row puts)
    store = VectorStore(device=DEVICE, dtype=torch.bfloat16, default_index_kind="flat")
    t0 = time.perf_counter()
    for s in range(0, N_STORE, PUT_BATCH):
        store.put("sift", ids[s:s + PUT_BATCH], corpus[s:s + PUT_BATCH],
                  {"category": category[s:s + PUT_BATCH]})
    store.get("sift").index.flush()
    torch.cuda.synchronize()
    out["direct_ingest_rows_per_s"] = N_STORE / (time.perf_counter() - t0)
    store.get("sift").warm()

    # 11.1 the coalescer: 64 threads x 16 single-query requests
    qs, filters = serving_requests(queries)
    n_req = len(qs)
    alone = []
    t0 = time.perf_counter()
    for i in range(n_req):
        alone.append(store.search("sift", qs[i:i + 1], 10, filters=filters[i], use_cache=False))
    serial_s = time.perf_counter() - t0
    store.query_cache.clear()
    co = SearchCoalescer(store)
    got: dict = {}
    lat: list = []
    errors: list = []
    lock = threading.Lock()

    def caller(t: int) -> None:
        try:
            for j in range(SERVE_PER_THREAD):
                i = t * SERVE_PER_THREAD + j
                t1 = time.perf_counter()
                r = co.search("sift", qs[i:i + 1], 10, filters=filters[i], timeout=60)
                dt = time.perf_counter() - t1
                with lock:
                    got[i] = r
                    lat.append(dt)
        except Exception as e:  # reported below: the phase fails
            errors.append(repr(e))

    k1_0 = _kernels.FUSED_SCAN.launches
    threads = [threading.Thread(target=caller, args=(t,)) for t in range(SERVE_THREADS)]

    def run_callers():
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)

    t0 = time.perf_counter()
    call = first_call(scan_mod, "fused_flat_search", run_callers, "the coalesced searches",
                      largest=True)
    concurrent_s = time.perf_counter() - t0
    co.stop()
    k1_served = _kernels.FUSED_SCAN.launches - k1_0
    if errors or any(th.is_alive() for th in threads) or len(got) != n_req:
        fail(f"coalescer: {len(got)} of {n_req} answered; errors {errors[:3]}")
    d1 = {"requests": n_req, "dispatches": co.dispatches, "coalesced": co.coalesced,
          "mean_group": n_req / co.dispatches, "k1_launches": k1_served}
    if k1_served >= n_req or k1_served != co.dispatches:
        fail(f"coalescer: K1 launched {k1_served} times for {n_req} requests in "
             f"{co.dispatches} dispatches")
    merged = tuple(np.concatenate([got[i][j] for i in range(n_req)]) for j in range(3))
    alone_all = tuple(np.concatenate([a[j] for a in alone]) for j in range(3))
    d1.update(same_answers("coalesced against alone", merged, alone_all))
    _, truth = exact_search(qs[:N_QUERIES], corpus, 10, Metric.L2, device=DEVICE)
    plain_rows = [i for i in range(N_QUERIES) if filters[i] is None]
    d1["recall_at_10"] = recall_at(merged[0][plain_rows], truth.cpu().numpy()[plain_rows])
    gate("coalesced 1M x 128", d1["recall_at_10"], RECALL_GATE)
    violations = sum(int(x) % 10 != int(f[0].value)
                     for i, f in enumerate(filters) if f is not None
                     for x in merged[0][i][merged[2][i]])
    if violations:
        fail(f"coalescer: {violations} filter violations")
    d1.update(filter_violations=0, concurrent_s=concurrent_s, serial_s=serial_s,
              requests_per_s=n_req / concurrent_s, serial_requests_per_s=n_req / serial_s,
              p50_ms=1e3 * float(np.percentile(lat, 50)),
              p99_ms=1e3 * float(np.percentile(lat, 99)))
    print(f"11.1 coalescer: {n_req} requests from {SERVE_THREADS} threads in {co.dispatches} "
          f"dispatches (mean group {d1['mean_group']:.2f}, K1 {k1_served} launches); "
          f"{d1['requests_per_s']:.0f} requests/s against {d1['serial_requests_per_s']:.0f} one "
          f"by one; p50 {d1['p50_ms']:.3f} ms, p99 {d1['p99_ms']:.3f} ms; recall@10 "
          f"{d1['recall_at_10']:.4f}", flush=True)
    out["coalescer"] = d1

    # 11.3 the config: a reference-style environment read into the Config
    # that builds 11.2's store
    saved = {k: os.environ.get(k) for k in REFERENCE_ENV}
    os.environ.update(REFERENCE_ENV)
    try:
        cfg = load_config()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    want = {"index_kind": "flat", "hbm_hard_limit_mb": 65536, "max_wal_mb": 95,
            "dataset_ttl_s": 3600.0, "snapshot_interval_s": 1800.0, "host": "127.0.0.1",
            "data_port": 3000, "migration_threshold": 200_000, "ingest_queue_depth": 64}
    wrong = {k: getattr(cfg, k) for k, v in want.items() if getattr(cfg, k) != v}
    if wrong:
        fail(f"load_config under the reference's environment: {wrong}")
    qstore = VectorStore(
        device=DEVICE, dtype=getattr(torch, cfg.storage_dtype),
        default_index_kind=cfg.index_kind, migration_threshold=cfg.migration_threshold,
        query_cache_size=cfg.query_cache_size, query_cache_ttl=cfg.query_cache_ttl_s,
        hnsw_config=HNSWConfig(m=cfg.hnsw_m, m_max=cfg.hnsw_m_max,
                               ef_construction=cfg.hnsw_ef_construction,
                               ef_search=cfg.hnsw_ef_search),
    )

    # 11.2 the ingest queue: 65,536-row jobs from 4 submitting threads
    q = IngestQueue(qstore, max_depth=cfg.ingest_queue_depth)
    jobs = list(range(0, N_STORE, PUT_BATCH))
    sub_errors: list = []

    def submitter(t: int) -> None:
        try:
            for s in jobs[t::INGEST_JOBS_THREADS]:
                q.submit("queued", ids[s:s + PUT_BATCH], corpus[s:s + PUT_BATCH],
                         {"category": category[s:s + PUT_BATCH]}, None, None)
        except Exception as e:  # reported below: the phase fails
            sub_errors.append(repr(e))

    t0 = time.perf_counter()
    subs = [threading.Thread(target=submitter, args=(t,)) for t in range(INGEST_JOBS_THREADS)]
    for th in subs:
        th.start()
    for th in subs:
        th.join(300)
    drained = q.drain(timeout_s=300)
    qstore.get("queued").index.flush()
    torch.cuda.synchronize()
    queue_s = time.perf_counter() - t0
    q.close()
    depth = get_registry().gauge("longbow_index_queue_depth")._only().value
    if sub_errors or not drained or q.errors or depth != 0:
        fail(f"ingest queue: drained {drained}, errors {sub_errors[:2]} {q.errors[:2]}, "
             f"depth metric {depth}")
    live = qstore.get("queued").live_count
    if live != N_STORE:
        fail(f"ingest queue: {live} rows, not {N_STORE}")
    d2 = {"rows": live, "seconds": queue_s, "rows_per_s": N_STORE / queue_s,
          "direct_rows_per_s": out["direct_ingest_rows_per_s"],
          "phase4_rows_per_s": flat_rate, "depth_metric": depth}
    d2.update(same_answers("queued against direct puts",
                           qstore.search("queued", queries, 10, use_cache=False),
                           store.search("sift", queries, 10, use_cache=False)))
    print(f"11.2 ingest queue: {N_STORE} rows in {queue_s:.3f} s ({d2['rows_per_s']:.0f} rows/s "
          f"against {d2['direct_rows_per_s']:.0f} by direct puts here, {flat_rate:.0f} in "
          f"phase 4); answers equal to the direct dataset's", flush=True)
    out["ingest_queue"] = d2

    hm = HealthManager()
    hm.register("store", store_checker(qstore))
    hm.register("storage", storage_checker(qstore))
    hm.register("device", device_checker())
    health = hm.check()
    if health["status"] != "healthy" or \
            health["checks"]["device"]["devices"][0] != torch.cuda.get_device_name(0):
        fail(f"health: {health}")
    out["health"] = {"status": health["status"], "devices": health["checks"]["device"]["devices"]}
    out["config"] = {k: getattr(cfg, k) for k in want}
    print(f"11.3 health {health['status']} on {health['checks']['device']['devices']}; the "
          f"config read the reference's environment ({len(REFERENCE_ENV)} names)", flush=True)

    torch.cuda.synchronize()
    out["launches"] = {k.name: k.launches for k in _kernels.KERNELS}
    out["k1_serving"] = check_build_scan("serving coalesced group", call, bw, flops, reps,
                                         finds_itself=False)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"serving": out})
    out["_store"] = store  # phase 12 compares the mesh kinds with its flat dataset
    return out


# -- 12. the mesh tier (this slice's path) -------------------------------------------

MESH_SHARDS = 8          # logical shards on the one card
MESH_DELETES = 10_000
MESH_GRAPH_ADD = 20_000  # rows added after the build: the interim segment
MESH_GRAPH_STORE_ROWS = 100_000


def mesh_dataset(store, name: str, mesh, dim: int):
    """A mesh_flat dataset whose index lies on an explicit mesh (the store
    makes its mesh with make_mesh, which never repeats a card)."""
    from longbow_tpu_torch.index.factory import _MeshAdapter
    from longbow_tpu_torch.parallel.sharded import ShardedFlatIndex
    from longbow_tpu_torch.query.filters import ColumnStore

    ds = store.get_or_create(name, dim, index_kind="mesh_flat")
    ds.index = _MeshAdapter(ShardedFlatIndex(dim, mesh, "l2", dtype=torch.bfloat16), "mesh_flat")
    ds.columns = ColumnStore(ds.index.capacity, device=ds.device)
    return ds


def phase_mesh(bw: float, flops: float, reps: int, flat_store, graph_store,
               graph_stats: dict) -> dict:
    """12. the mesh tier on phase 4's rows: mesh_flat through the store (the
    host's mesh) and on 8 logical shards of the card, a snapshot of the
    store's mesh_flat dataset, mesh_graph on 8 logical shards."""
    import shutil
    import tempfile
    from pathlib import Path

    from longbow_tpu_torch.device import resolve_device
    from longbow_tpu_torch.index.hnsw import HNSWConfig, HNSWIndex
    from longbow_tpu_torch.metrics import get_registry
    from longbow_tpu_torch.ops import _kernels
    from longbow_tpu_torch.ops import scan as scan_mod
    from longbow_tpu_torch.ops.distance import Metric, exact_search
    from longbow_tpu_torch.ops.scan import scan_variant
    from longbow_tpu_torch.parallel import sharded_graph
    from longbow_tpu_torch.parallel.mesh import Mesh
    from longbow_tpu_torch.parallel.sharded import merge_shards
    from longbow_tpu_torch.query.parser import Filter
    from longbow_tpu_torch.storage.engine import StorageEngine
    from longbow_tpu_torch.store.vector_store import VectorStore

    t_phase = time.perf_counter()
    allv = make_corpus(N_STORE + N_QUERIES, D_STORE, seed=0)
    corpus, queries = allv[:N_STORE], allv[N_STORE:]
    ids = np.arange(N_STORE, dtype=np.int64)
    category = ids % 10
    _, truth = exact_search(queries, corpus, 10, Metric.L2, device=DEVICE)
    truth = truth.cpu().numpy()
    reg = get_registry()
    splits = reg.counter("longbow_hnsw_parallel_search_splits_total", ("dataset",))
    out: dict = {}
    _kernels.reset_launch_counts()
    flat_ms = 1e3 * timed(lambda: flat_store.search("sift", queries, 10, use_cache=False), 5)
    flat_answer = flat_store.search("sift", queries, 10, use_cache=False)
    mesh8 = Mesh((resolve_device(DEVICE),) * MESH_SHARDS)
    store = VectorStore(device=DEVICE, dtype=torch.bfloat16)

    # 12.1 mesh_flat: the host's mesh through the store, then 8 logical shards
    rows_1 = None
    for name, n_shards in (("mesh1", None), ("mesh8", MESH_SHARDS)):
        if n_shards is None:
            ds = store.get_or_create(name, D_STORE, index_kind="mesh_flat")
        else:
            ds = mesh_dataset(store, name, mesh8, D_STORE)
        n_shards = ds.index.n_shards
        t0 = time.perf_counter()
        for s in range(0, N_STORE, PUT_BATCH):
            store.put(name, ids[s:s + PUT_BATCH], corpus[s:s + PUT_BATCH],
                      {"category": category[s:s + PUT_BATCH]})
        torch.cuda.synchronize()
        d = {"n_shards": n_shards, "ingest_rows_per_s": N_STORE / (time.perf_counter() - t0)}
        d["shard_capacity"] = ds.index._inner.shard_capacity
        ds.warm()
        k1_0, sp_0 = _kernels.FUSED_SCAN.launches, splits.labels(dataset=name).value
        served = store.search(name, queries, 10, use_cache=False)
        d["k1_launches_per_search"] = _kernels.FUSED_SCAN.launches - k1_0
        d["splits_per_search"] = splits.labels(dataset=name).value - sp_0
        if d["k1_launches_per_search"] != n_shards:
            fail(f"{name}: K1 launched {d['k1_launches_per_search']} times in one search "
                 f"over {n_shards} shards")
        if d["splits_per_search"] != (n_shards if n_shards > 1 else 0):
            fail(f"{name}: the search splits counter rose by {d['splits_per_search']}")
        d.update(same_answers(f"{name} against the flat dataset", served, flat_answer))
        d["recall_at_10"] = recall_at(served[0], truth)
        gate(f"{name} 1M x 128", d["recall_at_10"], RECALL_GATE)
        d["batch_1000_ms"] = 1e3 * timed(
            lambda: store.search(name, queries, 10, use_cache=False), 5)
        d["flat_batch_1000_ms"] = flat_ms
        lat = [timed(lambda j=j: store.search(name, queries[j:j + 1], 10, use_cache=False), 1)
               for j in range(16)]
        d["p50_single_query_ms"] = 1e3 * statistics.median(lat)
        fids, _, fok = store.search(name, queries[:100], 10,
                                    filters=[Filter("category", "eq", "3")], use_cache=False)
        if not fok.any() or any(x % 10 != 3 for x in fids[fok].tolist()):
            fail(f"{name}: the category filter let another category through")
        d["filter_violations"] = 0
        if n_shards > 1:
            # K1 on one shard's arguments: the variant scan_variant picks at
            # the shard's size, and the merge alone
            inner = ds.index._inner
            call = first_call(scan_mod, "fused_flat_search",
                              lambda: inner.search(queries, 10), "the sharded search")
            d["k1_shard"] = check_build_scan(f"mesh_flat shard of {n_shards}", call, bw, flops,
                                             reps, finds_itself=False)
            d["shard_variant"] = scan_variant(N_QUERIES, inner.shard_capacity, D_STORE, 64, True)
            q_t = torch.from_numpy(queries).to(DEVICE)
            with inner._mu:
                parts = [inner.local_search(j, q_t, 10, None, "l2", False)
                         for j in range(n_shards)]
            ds_, rs_ = [p[0] for p in parts], [p[1] for p in parts]
            d["merge_ms"] = time_ms(lambda: merge_shards(ds_, rs_, 10), reps)
            held = _kernels.FUSED_SCAN.launches  # timing launches do not count
            with inner._mu:
                d["local_searches_ms"] = time_ms(
                    lambda: [inner.local_search(j, q_t, 10, None, "l2", False)
                             for j in range(n_shards)], 3)
            _kernels.FUSED_SCAN.launches = held
        dead = np.random.default_rng(2).choice(N_STORE, MESH_DELETES, replace=False)
        if store.delete(name, dead) != MESH_DELETES:
            fail(f"{name}: delete did not remove {MESH_DELETES} ids")
        did, _, dok = store.search(name, corpus[dead[:1000]], 10, use_cache=False)
        if set(did[dok].tolist()) & set(dead.tolist()):
            fail(f"{name}: deleted ids came back")
        d["deleted_returned"] = 0
        extra = "" if n_shards == 1 else (
            f"; K1 a shard {d['k1_shard']['ms']:.3f} ms ({d['shard_variant']}), merge "
            f"{d['merge_ms']:.3f} ms, the {n_shards} local searches {d['local_searches_ms']:.3f} ms")
        print(f"12.1 {name}: {n_shards} shard(s), 1,000 queries {d['batch_1000_ms']:.3f} ms "
              f"(flat {flat_ms:.3f} ms), p50 1 query {d['p50_single_query_ms']:.3f} ms, recall@10 "
              f"{d['recall_at_10']:.4f}, ingest {d['ingest_rows_per_s']:.0f} rows/s{extra}",
              flush=True)
        out[name] = d
        emit({"mesh_flat": d})
    store.drop("mesh8")  # a snapshot of it would need 8 cards to restore

    # 12.2 a snapshot of the store's mesh_flat dataset, restored in a new store
    root = Path(tempfile.mkdtemp(prefix="longbow_mesh_"))
    try:
        before = store.search("mesh1", queries, 10, use_cache=False)
        st_before = store.get("mesh1").index.export_state()
        eng = StorageEngine(root, sync="never")
        t0 = time.perf_counter()
        eng.snapshot(store)
        snap_s = time.perf_counter() - t0
        eng.close()
        t0 = time.perf_counter()
        restored = VectorStore(persist_dir=root, device=DEVICE)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        st_after = restored.get("mesh1").index.export_state()
        for key in ("shard_counts", "valid", "norms_sq", "vectors"):
            if not np.array_equal(st_before[key], st_after[key]):
                fail(f"mesh1 snapshot: {key} differ after the restore")
        after = restored.search("mesh1", queries, 10, use_cache=False)
        out["snapshot"] = {"snapshot_s": snap_s, "restore_s": restore_s,
                           "bytes": dir_bytes(root / "snapshot"), "state_bit_for_bit": True,
                           **same_answers("mesh1 after its restore", after, before)}
        print(f"12.2 mesh1 snapshot {snap_s:.3f} s, {out['snapshot']['bytes']} bytes (every "
              f"dataset of the store); restore {restore_s:.3f} s; shard_counts, valid, rows "
              f"and results equal", flush=True)
        restored.engine.close()
        del restored
    finally:
        shutil.rmtree(root, ignore_errors=True)
    store.drop("mesh1")
    torch.cuda.empty_cache()

    # 12.3 mesh_graph: 8 logical shards of the card, 1M rows
    graph = sharded_graph.ShardedGraphIndex(D_STORE, mesh8, "l2", config=HNSWConfig(),
                                            dtype=torch.bfloat16)
    shard_s: list = []
    real_add = HNSWIndex.add

    def timed_add(self, vecs):
        t1 = time.perf_counter()
        r = real_add(self, vecs)
        torch.cuda.synchronize()
        shard_s.append(time.perf_counter() - t1)
        return r

    graph.add(corpus)
    k1_0 = _kernels.FUSED_SCAN.launches
    HNSWIndex.add = timed_add
    try:
        t0 = time.perf_counter()
        graph.build()
        build_s = time.perf_counter() - t0
    finally:
        HNSWIndex.add = real_add
    d3 = {"shards": MESH_SHARDS, "build_s": build_s, "build_s_per_shard": shard_s,
          "k1_launches_in_build": _kernels.FUSED_SCAN.launches - k1_0,
          "shard_rows": graph.shard_rows}
    if d3["k1_launches_in_build"] == 0:
        fail("the 8 shard builds did not launch K1")
    for ef in (100, 150):
        dist, rows = graph.search(queries, 10, ef_search=ef)
        d3[f"recall_at_10_ef{ef}"] = recall_at(rows, truth)
        d3[f"batch_1000_ef{ef}_ms"] = 1e3 * timed(
            lambda: graph.search(queries, 10, ef_search=ef), 3)
        d3[f"p50_single_query_ef{ef}_ms"] = 1e3 * statistics.median(
            [timed(lambda j=j: graph.search(queries[j:j + 1], 10, ef_search=ef), 1)
             for j in range(16)])
        d3[f"phase7_p50_single_query_ef{ef}_ms"] = 1e3 * statistics.median(
            [timed(lambda j=j: graph_store.search("graph", queries[j:j + 1], 10, ef_search=ef,
                                                  use_cache=False), 1) for j in range(16)])
        d3[f"phase7_batch_1000_ef{ef}_ms"] = graph_stats[f"batch_1000_ef{ef}_ms"]
    gate("mesh_graph 8 shards 1M x 128, ef 150", d3["recall_at_10_ef150"], GRAPH_RECALL_GATE)
    rng = np.random.default_rng(12)
    extra = corpus[rng.integers(0, N_STORE, MESH_GRAPH_ADD)] + \
        0.1 * rng.standard_normal((MESH_GRAPH_ADD, D_STORE)).astype(np.float32)
    t0 = time.perf_counter()
    new_rows = graph.add(extra)
    torch.cuda.synchronize()
    d3["interim_add_rows_per_s"] = MESH_GRAPH_ADD / (time.perf_counter() - t0)
    if graph.built_count != N_STORE or graph._interim is None:
        fail("the live add folded the interim segment")
    found = 0
    for s in range(0, MESH_GRAPH_ADD, 2000):
        _, r = graph.search(extra[s:s + 2000], 1, ef_search=10)
        found += int((r[:, 0] == new_rows[s:s + 2000]).sum())
    if found != MESH_GRAPH_ADD:
        fail(f"mesh_graph: {MESH_GRAPH_ADD - found} of the {MESH_GRAPH_ADD} rows added live "
             "did not find themselves first")
    d3["interim_rows_found"] = found
    print(f"12.3 mesh_graph {MESH_SHARDS} shards: build {build_s:.3f} s (a shard "
          f"{statistics.median(shard_s):.3f} s, K1 {d3['k1_launches_in_build']} launches); "
          f"recall@10 ef 100 {d3['recall_at_10_ef100']:.4f}, ef 150 "
          f"{d3['recall_at_10_ef150']:.4f}; 1,000 queries ef 100 / 150 "
          f"{d3['batch_1000_ef100_ms']:.3f} / {d3['batch_1000_ef150_ms']:.3f} ms (phase 7 "
          f"{d3['phase7_batch_1000_ef100_ms']:.3f} / {d3['phase7_batch_1000_ef150_ms']:.3f}); "
          f"1 query {d3['p50_single_query_ef100_ms']:.3f} / {d3['p50_single_query_ef150_ms']:.3f}"
          f" ms (phase 7's graph {d3['phase7_p50_single_query_ef100_ms']:.3f} / "
          f"{d3['phase7_p50_single_query_ef150_ms']:.3f}); {found} live rows found", flush=True)
    out["mesh_graph_8"] = d3
    emit({"mesh_graph": d3})
    del graph
    torch.cuda.empty_cache()

    # the store's mesh_graph (the host's mesh) at 100,000 rows
    n = MESH_GRAPH_STORE_ROWS
    store.get_or_create("mg", D_STORE, index_kind="mesh_graph")
    store.put("mg", ids[:n], corpus[:n])
    _, small_truth = exact_search(queries, corpus[:n], 10, Metric.L2, device=DEVICE)
    got, _, _ = store.search("mg", queries, 10, use_cache=False)
    d4 = {"rows": n, "n_shards": store.get("mg").index.n_shards,
          "recall_at_10": recall_at(got, small_truth.cpu().numpy())}
    gate("store mesh_graph 100k", d4["recall_at_10"], SMALL_GRAPH_GATE)
    print(f"12.3 store mesh_graph: {n} rows on {d4['n_shards']} shard(s), recall@10 "
          f"{d4['recall_at_10']:.4f}", flush=True)
    out["store_mesh_graph"] = d4
    store.drop("mg")

    torch.cuda.synchronize()
    out["launches"] = {k.name: k.launches for k in _kernels.KERNELS}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"mesh": {k: v for k, v in out.items() if k in ("launches", "seconds")}})
    return out


# -- 13. the Flight edge's handlers (this slice's path) ------------------------------

FLIGHT_THREADS = 64            # callers of the single-query tickets
FLIGHT_EXCHANGE_BATCHES = 8
FLIGHT_VECTORS = 100           # queries of the include_vectors checks
FLIGHT_DELETES = N_STORE // 100
FLIGHT_DEADLINE_S = 300.0      # every wait of the phase
INT8_GATE = 0.99               # against exact search over the stored codes (PERF.md §2)
FLIGHT_ENV = {
    "LONGBOW_STORAGE_DTYPE": "bfloat16",
    # the default kind, held on its flat tier: an int8 put then makes the
    # identity sq8 dataset of 13.6
    "LONGBOW_INDEX_KIND": "adaptive",
    "LONGBOW_AUTOSHARD_THRESHOLD": str(10 * N_STORE),
    "LONGBOW_ASYNC_INGEST": "1",
    "LONGBOW_SEARCH_COALESCE": "1",
    "LONGBOW_SNAPSHOT_INTERVAL": "5s",
    "LONGBOW_METRICS_PORT": "0",
}


def wire(table):
    """A Table across the port's Arrow IPC codec, as a client would see it."""
    from longbow_tpu_torch.storage.arrow_ipc import decode_stream, encode_stream

    return decode_stream(encode_stream(table))


def ticket_search(name: str, q: np.ndarray, k: int = 10, **extra) -> bytes:
    """A search ticket as longbow_tpu/serving/client.py writes it."""
    body = {"dataset": name, "k": k, **extra}
    if q.ndim == 2:
        body["vectors"] = q.tolist()
    else:
        body["vector"] = q.tolist()
    return json.dumps({"search": body}).encode()


def answer_arrays(tbl, b: int, k: int) -> tuple:
    """A search answer's columns -> (ids [b, k] object, scores, ok), checking
    query_index: ascending, each query's rows in rank order."""
    qi = np.asarray(tbl.column("query_index"), np.int64)
    if len(qi) and (np.any(np.diff(qi) < 0) or qi.min() < 0 or qi.max() >= b):
        fail("a search answer's query_index is not ascending within [0, B)")
    pos = np.arange(len(qi)) - np.searchsorted(qi, qi, side="left")
    if len(pos) and pos.max() >= k:
        fail(f"a search answer has more than k = {k} rows for one query")
    ids = np.empty((b, k), dtype=object)
    scores = np.zeros((b, k), np.float32)
    ok = np.zeros((b, k), bool)
    ids[qi, pos] = np.asarray(tbl.column("id"), np.int64)
    scores[qi, pos] = tbl.column("score")
    ok[qi, pos] = True
    return ids, scores, ok


def flight_put(handlers, name, ids, vecs, category=None) -> None:
    from longbow_tpu_torch.storage.arrow_ipc import Table

    cols = {"id": ids, "vector": vecs}
    if category is not None:
        cols["category"] = category
    tbl = wire(Table(cols, {"longbow.metric": "l2"}))
    handlers.do_put(name, tbl.schema_metadata, [tbl])


def wait_ready(handlers, what: str) -> float:
    """Polls check_readiness until the ingest queue has drained."""
    t0 = time.perf_counter()
    while True:
        r = json.loads(handlers.do_action("check_readiness", b"{}")[0])
        if r["status"] != "BUSY":
            if r.get("index_queue_depth", 0) != 0 or r["status"] != "READY":
                fail(f"{what}: readiness {r}")
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > FLIGHT_DEADLINE_S:
            fail(f"{what}: still BUSY after {FLIGHT_DEADLINE_S} s")
        time.sleep(0.05)


def flight_scan(handlers, ticket: bytes, dim: int) -> tuple:
    """A DoGet table scan's ids, vectors and columns, every batch across
    the codec; the seconds spent pulling batches and in the codec."""
    from longbow_tpu_torch.serving.flight_handlers import ScanStream

    stream = handlers.do_get(ticket)
    if not isinstance(stream, ScanStream):
        fail("a scan ticket did not answer with a stream")
    ids, vecs, cats, sizes = [], [], [], []
    t_pull = t_codec = 0.0
    it = iter(stream.batches)
    while True:
        t0 = time.perf_counter()
        b = next(it, None)
        t1 = time.perf_counter()
        t_pull += t1 - t0
        if b is None:
            break
        b = wire(b)
        t_codec += time.perf_counter() - t1
        v = b.column("vector")
        if v.dtype != np.float32 or v.shape[1] != dim:
            fail(f"scan batch vector column {v.dtype} {v.shape}")
        ids.append(b.column("id"))
        vecs.append(v)
        cats.append(b.column("category"))
        sizes.append(v.nbytes)
    return (np.concatenate(ids), np.concatenate(vecs), np.concatenate(cats),
            {"batches": len(sizes), "max_batch_bytes": max(sizes), "pull_s": t_pull,
             "codec_s": t_codec})


def record_snapshots(engine) -> list:
    """Wraps a storage engine's snapshot() to keep each snapshot's (start,
    end) on the host clock: a snapshot's capture holds every dataset's lock,
    and the phase reports which requests ran beside one."""
    spans: list = []
    real = engine.snapshot

    def timed(store):
        span = [time.perf_counter(), float("inf")]  # running until it returns
        spans.append(span)
        try:
            return real(store)
        finally:
            span[1] = time.perf_counter()

    engine.snapshot = timed
    return spans


def beside(windows, spans) -> np.ndarray:
    """For each (start, end) window, whether a snapshot overlapped it."""
    return np.asarray([any(a < e and s < b for a, b in list(spans)) for s, e in windows], bool)


def split_p50(lat, windows, spans) -> dict:
    """p50 of the requests that ran beside a snapshot and of the others."""
    lat, hit = np.asarray(lat), beside(windows, spans)
    return {"beside_snapshot": int(hit.sum()),
            "p50_beside_ms": 1e3 * float(np.median(lat[hit])) if hit.any() else None,
            "p50_clear_ms": 1e3 * float(np.median(lat[~hit])) if (~hit).any() else None}


def fmt_ms(x) -> str:
    return "none" if x is None else f"{x:.3f} ms"


def flight_binding(rt, name: str, corpus, queries, spans) -> dict:
    """13.8 the gRPC binding over loopback, where pyarrow.flight imports:
    the port's client against serving/flight_server.py over the runtime's
    handlers, answers held to the handlers' own."""
    try:
        import pyarrow.flight  # noqa: F401
    except ImportError as e:
        return {"ran": False, "why": f"pyarrow is not installed on this host ({e})"}
    import pyarrow as pa

    from longbow_tpu_torch.serving.client import LongbowClient
    from longbow_tpu_torch.serving.flight_server import serve, to_table

    h = rt.handlers
    handle = serve(rt.store, data_port=0, meta_port=0, host="127.0.0.1", handlers=h)
    c = LongbowClient("127.0.0.1", handle.data_server.port, handle.meta_server.port,
                      call_timeout_s=120.0).connect()
    try:
        out: dict = {"ran": True, "pyarrow": pa.__version__}
        n_q = len(queries)
        want = answer_arrays(wire(h.do_get(ticket_search(name, queries))), n_q, 10)
        t0 = time.perf_counter()
        got = answer_arrays(to_table(c.search(name, queries, k=10)), n_q, 10)  # via DoExchange
        t1 = time.perf_counter()
        out["first_batch_ms"] = 1e3 * (t1 - t0)  # the connection's first DoExchange
        out["first_batch_beside_snapshot"] = bool(beside([(t0, t1)], spans)[0])
        same_answers("13.8 the client's batch against the handlers'", got, want)
        moved = queries + np.float32(1e-3)  # not in the query cache
        t0 = time.perf_counter()
        c.search(name, moved, k=10)
        t1 = time.perf_counter()
        out["batch_ms"] = 1e3 * (t1 - t0)
        out["batch_beside_snapshot"] = bool(beside([(t0, t1)], spans)[0])
        lat, windows = [], []
        for i in range(100):
            t0 = time.perf_counter()
            one = answer_arrays(to_table(c.search(name, queries[i], k=10)), 1, 10)
            lat.append(time.perf_counter() - t0)
            windows.append((t0, t0 + lat[-1]))
            same_answers("13.8 a single query over gRPC", one, tuple(a[i:i + 1] for a in want))
        out["p50_single_ms"] = 1e3 * statistics.median(lat)
        out["single"] = split_p50(lat, windows, spans)
        t0 = time.perf_counter()
        scanned = c.scan(name)
        scan_s = time.perf_counter() - t0
        out["scan_beside_snapshot"] = bool(beside([(t0, t0 + scan_s)], spans)[0])
        live = rt.store.get(name).live_count
        if scanned.num_rows != live:
            fail(f"13.8: the scan over gRPC returned {scanned.num_rows} of {live} rows")
        sv = np.asarray(scanned.column("vector").combine_chunks().flatten()).reshape(-1, corpus.shape[1])
        sid = scanned.column("id").to_numpy()
        pick = np.random.default_rng(15).choice(len(sid), 1000, replace=False)
        ds = rt.store.get(name)
        rows = np.asarray([ds._id_to_row[int(i)] for i in sid[pick]])
        if not np.array_equal(sv[pick].view(np.uint32),
                              ds.index.get_vectors_device(rows).cpu().numpy().view(np.uint32)):
            fail("13.8: scanned vectors over gRPC differ from the stored rows")
        out["scan_gb_per_s"] = sv.nbytes / scan_s / 1e9
        n_put = PUT_BATCH
        t0 = time.perf_counter()
        c.write("wire", np.arange(n_put), corpus[:n_put], columns={"category": np.arange(n_put) % 1000})
        while c.check_readiness()["status"] == "BUSY":
            if time.perf_counter() - t0 > FLIGHT_DEADLINE_S:
                fail("13.8: the put over gRPC never drained")
            time.sleep(0.05)
        out["put_rows_per_s"] = n_put / (time.perf_counter() - t0)
        q8 = queries[:300]  # past the client's 256: through DoExchange
        same_answers("13.8 rows put over gRPC",
                     answer_arrays(to_table(c.search("wire", q8, k=10)), len(q8), 10),
                     rt.store.search("wire", q8, 10, use_cache=False))
        try:
            c.search("nope", queries[0], k=10)
            fail("13.8: an unknown dataset answered")
        except pyarrow.flight.FlightServerError as e:
            if "not found:" not in str(e):
                raise
        out["scan_rows"] = int(scanned.num_rows)
        return out
    finally:
        c.close()
        handle.shutdown()


def phase_flight(bw: float, flops: float, reps: int, flat_rate: float) -> dict:
    """13. the Flight edge's handlers on phase 4's rows: a serve runtime
    built from the environment, requests as the wire carries them."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from longbow_tpu_torch.config import load_config
    from longbow_tpu_torch.index import sq8 as sq8_mod
    from longbow_tpu_torch.ops import _kernels
    from longbow_tpu_torch.ops import scan as scan_mod
    from longbow_tpu_torch.ops.distance import Metric, exact_search
    from longbow_tpu_torch.query.parser import parse_ticket
    from longbow_tpu_torch.serve import build_runtime
    from longbow_tpu_torch.serving.errors import UnavailableError
    from longbow_tpu_torch.serving.flight_handlers import (
        CollectingWriter, ExchangeChunk, FlightHandlers,
    )
    from longbow_tpu_torch.serving.middleware import MiddlewareChain
    from longbow_tpu_torch.storage import native
    from longbow_tpu_torch.storage.arrow_ipc import Table

    t_phase = time.perf_counter()
    allv = make_corpus(N_STORE + N_QUERIES, D_STORE, seed=0)
    corpus, queries = allv[:N_STORE], allv[N_STORE:]
    ids = np.arange(N_STORE, dtype=np.int64)
    category = ids % 1000
    name = "flight"
    out: dict = {}
    root = Path(tempfile.mkdtemp(prefix="longbow_flight_"))
    saved = {k: os.environ.get(k) for k in FLIGHT_ENV}
    os.environ.update(FLIGHT_ENV, LONGBOW_DATA_PATH=str(root / "data"))
    saved.setdefault("LONGBOW_DATA_PATH", None)
    rt = rt2 = None
    try:
        cfg = load_config()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rt = build_runtime(cfg, device=DEVICE)
        out["build_runtime_s"] = time.perf_counter() - t0
        spans = record_snapshots(rt.store.engine)
        h = rt.handlers
        ds_snap0 = rt.snapshots_taken

        # 13.1 puts: 65,536-row DoPut streams through the ingest queue
        t0 = time.perf_counter()
        for s in range(0, N_STORE, PUT_BATCH):
            flight_put(h, name, ids[s:s + PUT_BATCH], corpus[s:s + PUT_BATCH],
                       category[s:s + PUT_BATCH])
        acked_s = time.perf_counter() - t0
        drain_s = wait_ready(h, "13.1 puts")
        ds = rt.store.get(name)
        ds.index.flush()
        torch.cuda.synchronize()
        put_s = time.perf_counter() - t0
        if ds.live_count != N_STORE or ds.index.kind != "flat":
            fail(f"13.1: {ds.live_count} rows of kind {ds.index.kind}")
        d1 = {"streams": -(-N_STORE // PUT_BATCH), "rows": N_STORE, "acked_s": acked_s,
              "drained_after_s": drain_s, "seconds": put_s, "rows_per_s": N_STORE / put_s,
              "phase4_rows_per_s": flat_rate, "snapshots": len(spans),
              "snapshot_s": sum(min(b, time.perf_counter()) - a for a, b in spans)}
        print(f"13.1 puts: {d1['streams']} DoPut streams, {N_STORE} rows in {put_s:.3f} s "
              f"({d1['rows_per_s']:.0f} rows/s with the WAL, against {flat_rate:.0f} by direct "
              f"puts in phase 4); acknowledged after {acked_s:.3f} s; {len(spans)} snapshots "
              f"({d1['snapshot_s']:.3f} s) meanwhile", flush=True)
        out["puts"] = d1

        # 13.2 DoGet: the 1,000 queries as one ticket, then as single tickets
        want = rt.store.search(name, queries, 10, use_cache=False)
        got = answer_arrays(wire(h.do_get(ticket_search(name, queries))), N_QUERIES, 10)
        d2 = dict(same_answers("13.2 batch ticket against store.search", got, want))
        _, truth = exact_search(queries, corpus, 10, Metric.L2, device=DEVICE)
        truth = truth.cpu().numpy()
        d2["recall_at_10"] = recall_at(got[0], truth)
        gate("13.2 batch ticket", d2["recall_at_10"], RECALL_GATE)
        batch_answer = got

        tickets, flts = [], []
        for i in range(N_QUERIES):
            extra = {}
            if i % 4 == 0:
                vals = [str((i + j) % 1000) for j in (0, 7, 13)]
                extra["filters"] = [{"field": "category", "op": "in", "value": vals}]
            tickets.append(ticket_search(name, queries[i], **extra))
            flts.append(set(int(v) for v in extra["filters"][0]["value"]) if extra else None)
        alone = [rt.store.search(name, queries[i:i + 1], 10,
                                 filters=parse_ticket(tickets[i]).search.filters, use_cache=False)
                 for i in range(N_QUERIES)]
        rt.store.query_cache.clear()
        answers: dict = {}
        lat: list = []
        windows: list = []
        errors: list = []
        lock = threading.Lock()

        def caller(t: int) -> None:
            try:
                for i in range(t, N_QUERIES, FLIGHT_THREADS):
                    t1 = time.perf_counter()
                    a = wire(h.do_get(tickets[i]))
                    dt = time.perf_counter() - t1
                    with lock:
                        answers[i] = a
                        lat.append(dt)
                        windows.append((t1, t1 + dt))
            except Exception as e:  # reported below: the phase fails
                errors.append(repr(e))

        threads = [threading.Thread(target=caller, args=(t,)) for t in range(FLIGHT_THREADS)]

        def run_callers():
            for th in threads:
                th.start()
            for th in threads:
                th.join(FLIGHT_DEADLINE_S)

        k1_0, disp0 = _kernels.FUSED_SCAN.launches, rt.coalescer.dispatches
        t0 = time.perf_counter()
        k1_call = first_call(scan_mod, "fused_flat_search", run_callers,
                             "the single-query tickets", largest=True)
        conc_s = time.perf_counter() - t0
        if errors or any(th.is_alive() for th in threads) or len(answers) != N_QUERIES:
            fail(f"13.2: {len(answers)} of {N_QUERIES} tickets answered; errors {errors[:3]}")
        k1_n = _kernels.FUSED_SCAN.launches - k1_0
        dispatches = rt.coalescer.dispatches - disp0
        single = [answer_arrays(answers[i], 1, 10) for i in range(N_QUERIES)]
        merged = tuple(np.concatenate([s[j] for s in single]) for j in range(3))
        alone_all = tuple(np.concatenate([a[j] for a in alone]) for j in range(3))
        d2["single_tickets"] = same_answers("13.2 single tickets against store.search",
                                            merged, alone_all)
        plain = [i for i in range(N_QUERIES) if flts[i] is None]
        d2["single_recall_at_10"] = recall_at(merged[0][plain], truth[plain])
        gate("13.2 single tickets", d2["single_recall_at_10"], RECALL_GATE)
        violations = sum(int(x) % 1000 not in flts[i]
                         for i in range(N_QUERIES) if flts[i] is not None
                         for x in merged[0][i][merged[2][i]])
        if violations:
            fail(f"13.2: {violations} filter violations")
        q, cpu_k = k1_call[0][0], k1_call[0][4]
        variant = scan_mod.scan_variant(q.shape[0], k1_call[0][1].shape[0], q.shape[1], cpu_k,
                                        k1_call[0][1].data_ptr() % 16 == 0)
        d2.update(filter_violations=0, requests=N_QUERIES, seconds=conc_s,
                  requests_per_s=N_QUERIES / conc_s,
                  p50_ms=1e3 * float(np.percentile(lat, 50)),
                  p99_ms=1e3 * float(np.percentile(lat, 99)),
                  dispatches=dispatches, mean_group=N_QUERIES / max(dispatches, 1),
                  k1_launches=k1_n, k1_largest_group=int(q.shape[0]), k1_variant=variant,
                  **split_p50(lat, windows, spans))
        if k1_n == 0 or k1_n >= N_QUERIES:
            fail(f"13.2: K1 launched {k1_n} times for {N_QUERIES} tickets")

        # one ticket at a time, stage by stage (host clocks; queries moved off
        # the query cache): the ticket's JSON parse, the store's search alone,
        # the whole handler (parse, coalescer, search, answer columns), the
        # answer across the codec
        stages: dict = {"parse": [], "store_search": [], "do_get": [], "codec": []}
        for i in range(1, min(N_QUERIES, 400), 4):
            tk = ticket_search(name, queries[i] + np.float32(1e-3))
            t0 = time.perf_counter()
            parse_ticket(tk)
            t1 = time.perf_counter()
            rt.store.search(name, queries[i:i + 1] + np.float32(2e-3), 10, use_cache=False)
            t2 = time.perf_counter()
            a = h.do_get(tk)
            t3 = time.perf_counter()
            wire(a)
            t4 = time.perf_counter()
            for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                stages[key].append(dt)
        d2["one_ticket_ms"] = {k: 1e3 * statistics.median(v) for k, v in stages.items()}

        fmts = {}
        for fmt in ("f32", "f16", "quantized"):
            tbl = wire(h.do_get(ticket_search(name, queries[:FLIGHT_VECTORS],
                                              include_vectors=True, vector_format=fmt)))
            rows = np.asarray([ds._id_to_row[int(i)] for i in tbl.column("id")])
            stored = ds.get_vectors_by_rows(rows)
            v = tbl.column("vector")
            if fmt == "f32":
                good = v.dtype == np.float32 and np.array_equal(v, stored)
            elif fmt == "f16":
                good = v.dtype == np.float16 and np.array_equal(v, stored.astype(np.float16))
            else:
                scale = tbl.column("vector_scale")
                err = np.abs(v.astype(np.float32) * scale[:, None] - stored)
                good = v.dtype == np.int8 and bool(np.all(err <= scale[:, None] * (0.5 + 1e-5)))
            if not good:
                fail(f"13.2 include_vectors {fmt}: the vectors are not the stored rows")
            fmts[fmt] = int(tbl.num_rows)
        d2["include_vectors_rows"] = fmts
        print(f"13.2 DoGet: the batch ticket equal to store.search ({d2['untied_slots']} untied "
              f"slots), recall@10 {d2['recall_at_10']:.4f}; {N_QUERIES} single tickets from "
              f"{FLIGHT_THREADS} threads: {d2['requests_per_s']:.0f} requests/s, p50 "
              f"{d2['p50_ms']:.3f} ms, p99 {d2['p99_ms']:.3f} ms ({d2['beside_snapshot']} beside a "
              f"snapshot, p50 {fmt_ms(d2['p50_beside_ms'])}; the rest p50 "
              f"{fmt_ms(d2['p50_clear_ms'])}), "
              f"{dispatches} dispatches (mean "
              f"group {d2['mean_group']:.2f}), K1 {k1_n} launches ({variant} at the largest group, "
              f"B = {d2['k1_largest_group']}); answers equal to each query alone; "
              f"include_vectors f32/f16/quantized right; one ticket at a time (median ms): "
              f"{', '.join(f'{k} {v:.3f}' for k, v in d2['one_ticket_ms'].items())}", flush=True)
        out["doget"] = d2

        # 13.3 DoExchange: the same queries in 8 batches
        per = -(-N_QUERIES // FLIGHT_EXCHANGE_BATCHES)
        reader = [ExchangeChunk(wire(Table({"vector": queries[s:s + per]})))
                  for s in range(0, N_QUERIES, per)]
        w = CollectingWriter()
        cmd = json.dumps({"protocol": "search", "dataset": name, "k": 10}).encode()
        t0 = time.perf_counter()
        h.do_exchange(cmd, None, reader, w)
        ex_s = time.perf_counter() - t0
        parts = []
        for j, b in enumerate(w.batches):
            b = wire(b)
            if np.any(b.column("batch_index") != j):
                fail("13.3: a result batch carries another batch's index")
            parts.append(answer_arrays(b, len(reader[j].data.column("vector")), 10))
        if len(parts) != len(reader) or w.schema.schema_metadata.get("longbow.metric") != "l2":
            fail(f"13.3: {len(parts)} result batches for {len(reader)}")
        ex = tuple(np.concatenate([p[j] for p in parts]) for j in range(3))
        d3 = {"batches": len(parts), "seconds": ex_s,
              **same_answers("13.3 exchange against the batch ticket", ex, batch_answer)}
        print(f"13.3 DoExchange: {len(parts)} batches in {ex_s * 1e3:.3f} ms, answers equal to "
              f"13.2's", flush=True)
        out["exchange"] = d3

        # 13.4 scans, through the host mirror
        if ds.index.mirror_rows(np.arange(1)) is None:
            fail("13.4: the flat dataset has no host scan mirror")
        t0 = time.perf_counter()
        s_ids, s_vecs, s_cats, sinfo = flight_scan(h, json.dumps({"name": name}).encode(),
                                                   D_STORE)
        scan_s = time.perf_counter() - t0
        order = np.argsort(s_ids)
        if not np.array_equal(s_ids[order], ids):
            fail("13.4: the full scan did not return every id exactly once")
        if not np.array_equal(s_cats, s_ids % 1000):
            fail("13.4: the scan's category column is not the rows' own")
        rows = np.fromiter((ds._id_to_row[int(i)] for i in s_ids), np.int64, len(s_ids))
        dev = ds.index.get_vectors_device(rows).cpu().numpy()
        if not np.array_equal(s_vecs.view(np.uint32), dev.view(np.uint32)):
            fail("13.4: scanned vectors differ from the device's stored rows")
        del dev
        # the mirror's native rounding against the card's own cast on every
        # class of value: zeros, subnormals, infinities, ties, NaNs
        rng = np.random.default_rng(14)
        bits = np.concatenate([np.array(
            [0, 0x80000000, 0x7F800000, 0xFF800000, 0x00000001, 0x807FFFFF, 0x00008000,
             0x00018000, 0x3F808000, 0x3F818000, 0x7F7FFFFF, 0xFF7F8000, 0x7F800001,
             0xFFC00001, 0x7FFFFFFF], np.uint32),
            rng.integers(0, 2**32, 1 << 20, dtype=np.uint64).astype(np.uint32)])
        x = bits.view(np.float32)
        host = native.f32_to_bf16_bits(x)
        card = torch.from_numpy(x).to(DEVICE).to(torch.bfloat16).view(torch.int16).cpu().numpy()
        card = card.view(np.uint16)
        nan = np.isnan(x)
        card_nan_bits = sorted({f"{int(b):#06x}" for b in card[nan]})
        if not np.array_equal(host[~nan], card[~nan]) or \
                not np.all((card[nan] & 0x7F80) == 0x7F80) or not np.all(card[nan] & 0x7F):
            fail(f"13.4: the native bf16 rounding differs from the card's on "
                 f"{int(np.sum(host[~nan] != card[~nan]))} non-NaN values, or a NaN is not one")
        f_ids, _, f_cats, _ = flight_scan(h, json.dumps(
            {"name": name, "limit": 500,
             "filters": [{"field": "category", "op": "eq", "value": "7"}]}).encode(), D_STORE)
        if len(f_ids) != min(500, int(np.sum(category == 7))) or np.any(f_cats != 7) or \
                np.any(f_ids % 1000 != 7):
            fail(f"13.4: the filtered scan gave {len(f_ids)} rows, categories {set(f_cats)}")
        payload = N_STORE * D_STORE * 4
        d4 = {"rows": len(s_ids), "seconds": scan_s, **sinfo,
              "gb_per_s_pull": payload / sinfo["pull_s"] / 1e9,
              "gb_per_s_with_codec": payload / (sinfo["pull_s"] + sinfo["codec_s"]) / 1e9,
              "filtered_rows": len(f_ids), "rounding_values": len(x),
              "card_nan_bits": card_nan_bits}

        rng = np.random.default_rng(13)
        dead = rng.choice(N_STORE, FLIGHT_DELETES, replace=False)
        r = json.loads(h.do_action("delete", json.dumps(
            {"dataset": name, "ids": dead.tolist()}).encode())[0])
        if r != {"deleted": FLIGHT_DELETES}:
            fail(f"13.4: delete answered {r}")
        dead_set = set(dead.tolist())
        after = answer_arrays(wire(h.do_get(ticket_search(name, queries))), N_QUERIES, 10)
        own = answer_arrays(wire(h.do_get(ticket_search(name, corpus[dead[:N_QUERIES]]))),
                            min(N_QUERIES, FLIGHT_DELETES), 10)
        back = {int(x) for a in (after, own) for x in a[0][a[2]]} & dead_set
        a_ids, _, _, _ = flight_scan(h, json.dumps({"name": name}).encode(), D_STORE)
        back |= set(a_ids.tolist()) & dead_set
        if back or len(a_ids) != N_STORE - FLIGHT_DELETES:
            fail(f"13.4: {len(back)} deleted ids came back; the scan has {len(a_ids)} rows")
        d4.update(deleted=FLIGHT_DELETES, deleted_returned=0)
        same_answers("13.4 after the deletes against store.search", after,
                     rt.store.search(name, queries, 10, use_cache=False))
        print(f"13.4 scan: {len(s_ids)} rows in {sinfo['batches']} batches (largest "
              f"{sinfo['max_batch_bytes']} bytes) through the mirror, "
              f"{d4['gb_per_s_pull']:.3f} GB/s of f32 pulled ({d4['gb_per_s_with_codec']:.3f} "
              f"with the codec); bit for bit the device's rows; the native rounding equal to the "
              f"card's cast on {len(x)} values (the card's NaN bits {card_nan_bits[:4]}); "
              f"a filtered scan of {len(f_ids)}; "
              f"{FLIGHT_DELETES} deletes, none back", flush=True)
        out["scan"] = d4

        # 13.5 actions
        called: set = set()

        def act(action: str, body=None):
            called.add(action)
            return json.loads(h.do_action(action, json.dumps(body or {}).encode())[0])

        def one_query(resp) -> tuple:
            k = len(resp["ids"])
            return (np.asarray(resp["ids"], dtype=object)[None], np.asarray(
                resp["scores"], np.float32)[None], np.ones((1, k), bool))

        d5: dict = {}
        checks = {
            "check_readiness": lambda a: a["status"] == "READY" and a["index_queue_depth"] == 0,
            "health": lambda a: a["status"] == "healthy"
            and a["checks"]["device"]["devices"][0] == torch.cuda.get_device_name(0),
            "cluster-status": lambda a: a["datasets"][name]["live_rows"] == N_STORE - FLIGHT_DELETES
            and a["self"] == {"id": "local", "status": "alive"},
            "gossip-probe": lambda a: a == {"ok": True},
            "MeshStatus": lambda a: a == {"self": None, "members": []},
            "MeshIdentity": lambda a: a == {"id": "", "status": "alive"},
            "DiscoveryStatus": lambda a: a == {"provider": "none", "peers": []},
            "list-datasets": lambda a: a == [name],
        }
        for action, check in checks.items():
            a = act(action)
            if not check(a):
                fail(f"13.5 {action}: {a}")
        if act("CreateNamespace", {"name": "tenant/declared"}) != {"created": "tenant/declared"}:
            fail("13.5 CreateNamespace")
        act("CreateNamespace", {"name": "tenant/eager", "dim": D_STORE, "index": "flat"})
        ns = act("ListNamespaces")
        if ns != {"namespaces": ["default", "tenant"], "count": 2} or \
                act("GetTotalNamespaceCount") != {"count": 2} or \
                act("GetNamespaceDatasetCount", {"name": "tenant"}) != {"namespace": "tenant",
                                                                          "count": 1}:
            fail(f"13.5 namespaces: {ns}")
        if [f.name for f in h.list_flights()] != [name, "tenant/eager", "tenant/declared"] or \
                h.get_flight_info(name).total_records != N_STORE - FLIGHT_DELETES or \
                h.get_schema(name).column("vector").shape != (0, D_STORE):
            fail("13.5 list_flights / get_flight_info / get_schema")
        if act("delete-dataset", {"name": "tenant/eager"}) != {"dropped": True}:
            fail("13.5 delete-dataset")
        vs = act("VectorSearch", {"dataset": name, "vector": queries[1].tolist(), "k": 10})
        if vs["metric"] != "l2":
            fail(f"13.5 VectorSearch: metric {vs['metric']!r}")
        same_answers("13.5 VectorSearch against the batch ticket", one_query(vs),
                     tuple(a[1:2] for a in after))
        live = next(i for i in range(N_STORE) if i not in dead_set)
        by_id = act("VectorSearchByID", {"dataset": name, "id": live, "k": 10})
        hy = act("HybridSearch", {"dataset": name, "vector": queries[1].tolist(), "k": 10,
                                  "alpha": 1.0, "text_query": ""})
        if by_id["ids"][0] != live or sorted(hy["ids"]) != sorted(vs["ids"]):
            fail(f"13.5 VectorSearchByID {by_id['ids'][:1]} / HybridSearch {hy['ids']}")
        act("add-edge", {"dataset": name, "from": live, "to": live + 1, "type": "next"})
        if act("traverse-graph", {"dataset": name, "from": live, "to": live + 1}) != \
                {"path": [live, live + 1]} or act("GetGraphStats", {"dataset": name}) is None:
            fail("13.5 graph actions")
        act("graph-analytics", {"dataset": name})
        if act("delete", {"dataset": name, "id": str(live)}) != {"deleted": 1}:
            fail("13.5 delete of one stringified id")
        dead_set.add(live)
        t0 = time.perf_counter()
        for action, want_ans in (("checkpoint-prepare", {"ready": True, "epoch": 1}),
                                 ("checkpoint-commit", {"committed": True, "epoch": 1}),
                                 ("checkpoint", {"ok": True, "local": True}),
                                 ("ForceSnapshot", {"ok": True})):
            a = act(action, {"epoch": 1})
            if a != want_ans:
                fail(f"13.5 {action}: {a}")
        d5["snapshot_actions_s"] = time.perf_counter() - t0
        # the spatial summary answers on a single node too (merkle-state and
        # export-delta: phase 14.3)
        region = act("region-summary", {"datasets": [name]})["regions"][name]
        if region["n"] != 4096 or len(region["centroid"]) != D_STORE:
            fail(f"13.5 region-summary: {region['n']} rows")
        d5["actions"] = len(h.list_actions())
        d5["periodic_snapshots"] = rt.snapshots_taken - ds_snap0
        if d5["periodic_snapshots"] < 1:
            fail("13.5: no periodic snapshot was taken during the phase")
        final = answer_arrays(wire(h.do_get(ticket_search(name, queries))), N_QUERIES, 10)
        t0 = time.perf_counter()
        rt.close()
        d5["close_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rt2 = build_runtime(cfg, device=DEVICE)
        d5["restore_s"] = time.perf_counter() - t0
        spans2 = record_snapshots(rt2.store.engine)
        d5["warmed"] = rt2.warmed
        h2 = rt2.handlers
        again = answer_arrays(wire(h2.do_get(ticket_search(name, queries))), N_QUERIES, 10)
        d5["restored"] = same_answers("13.5 the restored runtime against the first", again, final)
        back = {int(x) for x in again[0][again[2]]} & dead_set
        if back or rt2.store.get(name).live_count != N_STORE - FLIGHT_DELETES - 1:
            fail(f"13.5 restored: {len(back)} deleted ids back")
        d5["actions_called"] = len(called)
        print(f"13.5 actions: {len(called)} answered as the phase left the store; "
              f"{d5['periodic_snapshots']} periodic snapshots; snapshot actions "
              f"{d5['snapshot_actions_s']:.3f} s; close {d5['close_s']:.3f} s; a second runtime "
              f"restored in {d5['restore_s']:.3f} s and answers equal, no deleted id", flush=True)
        out["actions"] = d5

        # 13.6 an int8 dataset over the wire: identity sq8 codes, K2
        n8 = N_SMALL
        scale = 127.0 / float(np.abs(corpus[:n8]).max())
        codes = np.clip(np.round(corpus[:n8] * scale), -127, 127).astype(np.int8)
        t0 = time.perf_counter()
        for s in range(0, n8, PUT_BATCH):
            flight_put(h2, "int8", ids[s:min(s + PUT_BATCH, n8)], codes[s:s + PUT_BATCH])
        wait_ready(h2, "13.6 int8 puts")
        i8 = rt2.store.get("int8")
        inner = getattr(i8.index, "_inner", i8.index)
        stored = inner.codes[:n8].cpu().numpy() if hasattr(inner.codes, "cpu") else inner.codes
        if i8.index.kind != "sq8" or not np.array_equal(np.asarray(stored), codes):
            fail(f"13.6: kind {i8.index.kind}; codes not the bytes put")
        put8_s = time.perf_counter() - t0
        qcodes = np.clip(np.round(queries * scale), -127, 127).astype(np.float32)
        k2_0 = _kernels.FUSED_CODES_SCAN.launches
        res: dict = {}

        def run_int8():
            res["a"] = answer_arrays(wire(h2.do_get(ticket_search("int8", qcodes))), N_QUERIES, 10)

        k2_call = first_call(sq8_mod, "fused_codes_search", run_int8, "the int8 tickets")
        _, t8 = exact_search(qcodes, codes.astype(np.float32), 10, Metric.L2, device=DEVICE)
        d6 = {"rows": n8, "seconds": put8_s, "rows_per_s": n8 / put8_s,
              "recall_at_10_vs_exact_codes": recall_at(res["a"][0], t8.cpu().numpy()),
              "k2_launches": _kernels.FUSED_CODES_SCAN.launches - k2_0}
        gate("13.6 int8", d6["recall_at_10_vs_exact_codes"], INT8_GATE)
        if d6["k2_launches"] == 0:
            fail("13.6: the int8 searches did not launch K2")
        print(f"13.6 int8: {n8} rows as FixedSizeList<int8>, identity sq8 (codes = the bytes "
              f"put), {d6['rows_per_s']:.0f} rows/s; recall@10 {d6['recall_at_10_vs_exact_codes']:.4f}"
              f" against exact search over the codes; K2 {d6['k2_launches']} launches", flush=True)
        out["int8"] = d6

        # 13.7 admission: the rate limiter and the breaker
        burst = 40
        rl = FlightHandlers(rt2.store, middleware_chain=MiddlewareChain(
            rate_limit_rps=5.0, rate_limit_burst=5))
        refused = 0
        t0 = time.perf_counter()
        for i in range(burst):
            try:
                rl.do_get(ticket_search(name, queries[i]))
            except UnavailableError as e:
                if str(e) != "rate limit exceeded":
                    raise
                refused += 1
        burst_s = time.perf_counter() - t0
        if not 0 < refused <= burst - 5 or refused < burst - 5 - int(5 * burst_s) - 1:
            fail(f"13.7: {refused} of a burst of {burst} refused in {burst_s:.3f} s")

        class Broken:
            def search(self, *a, **kw):
                raise RuntimeError("a failing dispatch")

        br = FlightHandlers(rt2.store, middleware_chain=MiddlewareChain(
            breaker_threshold=3, breaker_cooldown_s=1.0), coalescer=Broken())
        for _ in range(3):
            try:
                br.do_get(ticket_search(name, queries[0]))
            except RuntimeError:
                pass
        try:
            br.do_get(ticket_search(name, queries[0]))
            fail("13.7: the breaker did not open after 3 failures")
        except UnavailableError as e:
            opened = str(e)
        time.sleep(1.05)
        br.coalescer = None
        wire(br.do_get(ticket_search(name, queries[0])))
        if br.middleware.breaker.state != "closed":
            fail(f"13.7: breaker {br.middleware.breaker.state} after its cooldown")
        d7 = {"burst": burst, "refused": refused, "burst_s": burst_s, "breaker_refusal": opened}
        print(f"13.7 admission: {refused} of {burst} tickets refused by the rate limiter "
              f"(5/s, burst 5); the breaker opened after 3 failures ({opened!r}) and closed "
              f"after its 1 s cooldown", flush=True)
        out["admission"] = d7

        d8 = flight_binding(rt2, name, corpus, queries, spans2)
        if d8["ran"]:
            print(f"13.8 gRPC binding (pyarrow {d8['pyarrow']}): the port's client over loopback, "
                  f"answers equal to the handlers'; {len(queries)} queries {d8['batch_ms']:.3f} ms "
                  f"through DoExchange (beside a snapshot: {d8['batch_beside_snapshot']}; the "
                  f"connection's first {d8['first_batch_ms']:.3f} ms), one query p50 "
                  f"{d8['p50_single_ms']:.3f} ms ({d8['single']['beside_snapshot']} of 100 beside "
                  f"a snapshot), a scan of "
                  f"{d8['scan_rows']} rows at {d8['scan_gb_per_s']:.3f} GB/s (beside a snapshot: "
                  f"{d8['scan_beside_snapshot']}), puts "
                  f"{d8['put_rows_per_s']:.0f} rows/s", flush=True)
        else:
            print(f"13.8 the gRPC binding (longbow_tpu_torch/serving/flight_server.py) is not run: "
                  f"{d8['why']}", flush=True)
        out["grpc_binding"] = d8

        torch.cuda.synchronize()
        out["launches"] = {k.name: k.launches for k in _kernels.KERNELS}
        if out["launches"]["fused_scan"] == 0 or out["launches"]["fused_codes_scan"] == 0:
            fail(f"13: a kernel of the path was not launched: {out['launches']}")
    finally:
        for r in (rt2, rt):
            if r is not None:
                try:
                    r.close()
                except Exception as e:  # the phase's own failure is the one reported
                    print(f"13: closing a runtime raised {e!r}", file=sys.stderr)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    out["k1_flight"] = check_build_scan("flight largest coalesced group", k1_call, bw, flops,
                                        reps, finds_itself=False)
    out["k2_flight"] = check_codes_call("flight int8 dataset", k2_call, bw, flops, reps)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"flight": out})
    return out


# -- 14. the cluster tier ---------------------------------------------------

CLUSTER_NODES = 8          # BASELINE.json configs[4]: 8 consistent-hash shards
REPLICAS = 3               # scripts/start_local_cluster.sh: a replicated 3-node cluster
CLUSTER_THREADS, CLUSTER_TICKETS = 16, 256
CLUSTER_DELETES = 10_000
CLUSTER_OVERLAP_GATE = 0.99  # the merged top-10 against one flat dataset of the same rows
CLUSTER_FILTER = [3, 7, 11]  # a category filter of three values
N_HYBRID, HYBRID_QUERIES = 100_000, 100
HEAL_ROWS, HEAL_DELETES = 10_000, 1_000  # new rows and upserts; deletes (node 2 down)
HEAL_SYNC_FACTOR = 5       # synced rows stay under this many times the divergent rows
HEAL_CHECK_S = 30.0        # the longest between two asks for node 2's and node 0's roots
CLUSTER_DEADLINE_S = 300.0  # every wait of the phase
CLUSTER_LOG_TAIL = 40


def free_ports(n: int) -> list:
    """Ports for node processes that must name each other before they start
    (a static peer list): bound to 0 and released here, on a sealed host."""
    import socket

    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class NodeSet:
    """The node processes of one cluster: `python -m longbow_tpu_torch.serve`
    each, configured by the reference's environment names, all on the one
    card (LONGBOW_FORCE_CPU=1 when DEVICE is the CPU). Each logs to a file;
    tails() prints the last lines of every log and close() SIGKILLs every
    node."""

    def __init__(self, n: int, root, env: dict, persist: bool = False):
        from pathlib import Path

        self.n, self.root, self.env, self.persist = n, Path(root), dict(env), persist
        self.root.mkdir(parents=True, exist_ok=True)
        ports = free_ports(3 * n)
        self.ports = [tuple(ports[3 * i: 3 * i + 3]) for i in range(n)]
        self.ids = [f"127.0.0.1:{p[0]}" for p in self.ports]
        self.specs = [f"127.0.0.1:{p[0]}:{p[1]}" for p in self.ports]
        self.logs = [self.root / f"node{i}.log" for i in range(n)]
        self.procs: list = [None] * n
        self._clients: list = [None] * n

    def start(self, i: int) -> None:
        import os
        from pathlib import Path

        repo = Path(__file__).resolve().parent
        env = {k: v for k, v in os.environ.items() if not k.startswith("LONGBOW_")}
        dp, mp, xp = self.ports[i]
        env.update(self.env, LONGBOW_HOST="127.0.0.1", LONGBOW_DATA_PORT=str(dp),
                   LONGBOW_META_PORT=str(mp), LONGBOW_METRICS_PORT=str(xp),
                   LONGBOW_NODE_ID=self.ids[i],
                   PYTHONPATH=str(repo) + os.pathsep + env.get("PYTHONPATH", ""))
        if self.n > 1:  # a lone node is no cluster
            env["LONGBOW_PEERS"] = ",".join(self.specs)
        if self.persist:
            env["LONGBOW_DATA_DIR"] = str(self.root / f"data{i}")
        if DEVICE == "cpu":
            env["LONGBOW_FORCE_CPU"] = "1"
        with open(self.logs[i], "a") as log:
            self.procs[i] = subprocess.Popen(
                [sys.executable, "-m", "longbow_tpu_torch.serve"], env=env, cwd=repo,
                stdout=log, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL)

    def client(self, i: int):
        from longbow_tpu_torch.serving.client import LongbowClient

        if self._clients[i] is None:
            dp, mp, _ = self.ports[i]
            self._clients[i] = LongbowClient("127.0.0.1", dp, mp,
                                             call_timeout_s=CLUSTER_DEADLINE_S)
        return self._clients[i]

    def new_client(self, i: int):
        from longbow_tpu_torch.serving.client import LongbowClient

        dp, mp, _ = self.ports[i]
        return LongbowClient("127.0.0.1", dp, mp, call_timeout_s=CLUSTER_DEADLINE_S)

    def wait_ready(self, idxs, what: str) -> float:
        """Polls check_readiness on each node until it answers and its ingest
        queue is empty; a node process that exits fails the phase."""
        t0 = time.perf_counter()
        for i in idxs:
            while True:
                if self.procs[i] is not None and self.procs[i].poll() is not None:
                    fail(f"{what}: node {i} exited with {self.procs[i].returncode}")
                try:
                    if self.client(i).check_readiness()["status"] == "READY":
                        break
                except Exception:
                    self.drop_client(i)
                if time.perf_counter() - t0 > CLUSTER_DEADLINE_S:
                    fail(f"{what}: node {i} not ready after {CLUSTER_DEADLINE_S} s")
                time.sleep(0.1)
        return time.perf_counter() - t0

    def drop_client(self, i: int) -> None:
        c, self._clients[i] = self._clients[i], None
        if c is not None:
            try:
                c.close()
            except Exception:
                pass

    def live_rows(self, i: int, name: str) -> int:
        ds = self.client(i).cluster_status()["datasets"].get(name)
        return 0 if ds is None else ds["live_rows"]

    def metrics(self, i: int) -> dict:
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{self.ports[i][2]}/metrics",
                                    timeout=60) as r:
            return parse_metrics(r.read().decode())

    def kill(self, i: int) -> None:
        self.drop_client(i)
        p = self.procs[i]
        if p is not None and p.poll() is None:
            p.kill()
        if p is not None:
            p.wait(timeout=60)

    def tails(self) -> None:
        for i, path in enumerate(self.logs):
            try:
                lines = path.read_text(errors="replace").splitlines()[-CLUSTER_LOG_TAIL:]
            except OSError:
                continue
            print(f"--- node {i} ({self.ids[i]}), last {len(lines)} lines of {path}",
                  file=sys.stderr)
            for line in lines:
                print(line, file=sys.stderr)

    def close(self) -> None:
        for i in range(self.n):
            try:
                self.kill(i)
            except Exception as e:  # every node is still killed
                print(f"14: stopping node {i}: {e!r}", file=sys.stderr)


def ring_owners(nodes: list, keys) -> np.ndarray:
    """The node index owning each key on the partitioned placement's ring,
    recomputed from docs/DISTRIBUTED.md ("SHA-256 consistent-hash ring, 20
    vnodes/node"): a vnode "<node>#<v>" and a key str(id) hash to the first
    8 bytes of their SHA-256, big-endian; a key belongs to the first vnode
    clockwise past its hash."""
    import hashlib

    def h(s: str) -> int:
        return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")

    vh = np.asarray([h(f"{node}#{v}") for node in nodes for v in range(20)], np.uint64)
    vo = np.repeat(np.arange(len(nodes)), 20)
    order = np.argsort(vh, kind="stable")
    vh, vo = vh[order], vo[order]
    kh = np.fromiter((h(str(k)) for k in keys), np.uint64, len(keys))
    return vo[np.searchsorted(vh, kh, side="right") % len(vh)]


KERNEL_NAMES = ("fused_scan", "fused_codes_scan")


def launch_counts(ns, idxs) -> dict:
    """Each node's kernel launches so far, from its own launch counter
    (longbow_kernel_launches_total{kernel} on its metrics port, which
    the kernel's wrapper bumps where it launches)."""
    out = {}
    for i in idxs:
        m = ns.metrics(i)
        out[i] = {k: metric_sum(m, "longbow_kernel_launches_total", kernel=k)
                  for k in KERNEL_NAMES}
    return out


def launches_between(before: dict, after: dict) -> dict:
    """{kernel: [launches of each node between the two readings]}."""
    return {k: [after[i][k] - before[i][k] for i in sorted(before)] for k in KERNEL_NAMES}


def arrow_answer(tbl, b: int, k: int = 10) -> tuple:
    """A pyarrow search answer -> (ids [b, k] object, scores, ok)."""
    from longbow_tpu_torch.storage.arrow_ipc import Table

    return answer_arrays(Table({n: tbl.column(n).to_numpy(zero_copy_only=False)
                                for n in ("id", "score", "query_index")}), b, k)


def held_to_flat(label: str, got, flat) -> dict:
    """A merged answer against one flat dataset of the same rows: where both
    hold an id its scores agree to SERVE_RTOL, the top-10 lists overlap at
    least CLUSTER_OVERLAP_GATE, and the slots where the merged distance is
    larger than the flat one's are counted (the merge draws a pool from each
    node's share, so it can only find as good or better rows)."""
    gi, gs, gok = got
    fi, fs, fok = flat
    shared = worse = 0
    for r in range(gi.shape[0]):
        gmap = {gi[r, j]: gs[r, j] for j in range(gi.shape[1]) if gok[r, j]}
        for j in range(fi.shape[1]):
            if fok[r, j] and fi[r, j] in gmap:
                shared += 1
                a, b = gmap[fi[r, j]], fs[r, j]
                if abs(a - b) > SERVE_RTOL * abs(b):
                    fail(f"{label}: id {fi[r, j]} scored {a} merged and {b} flat")
        worse += int(np.sum(gs[r][gok[r] & fok[r]] > fs[r][gok[r] & fok[r]]))
    overlap = shared / max(int(fok.sum()), 1)
    if overlap < CLUSTER_OVERLAP_GATE:
        fail(f"{label}: top-10 overlap {overlap:.4f} with the flat dataset "
             f"< {CLUSTER_OVERLAP_GATE}")
    return {"overlap_with_flat": overlap, "slots_worse_than_flat": worse}


def phase_cluster(card: str) -> dict:
    """14. the cluster tier through `python -m longbow_tpu_torch.serve` node
    processes on the one card: 14.1 partitioned placement over 8 nodes
    (BASELINE.json configs[4]), 14.2 its hybrid global search, 14.3 a
    replicated 3-node cluster with anti-entropy (scripts/start_local_cluster.sh)."""
    import shutil
    import tempfile
    from pathlib import Path

    try:
        import pyarrow.flight as flight
    except ImportError as e:
        fail(f"14: pyarrow.flight does not import ({e!r}): the cluster tier has no transport")
    from longbow_tpu_torch.ops.distance import Metric, exact_search
    from longbow_tpu_torch.store.vector_store import VectorStore

    t_phase = time.perf_counter()
    allv, assign = make_corpus(N_STORE + N_QUERIES, D_STORE, seed=0, clusters=True)
    corpus, queries = allv[:N_STORE], allv[N_STORE:]
    ids = np.arange(N_STORE, dtype=np.int64)
    _, truth = exact_search(queries, corpus, 10, Metric.L2, device=DEVICE)
    truth = truth.cpu().numpy()
    # one flat dataset of the same rows, searched in this process
    flat = VectorStore(device=DEVICE, dtype=torch.bfloat16, default_index_kind="flat")
    for s in range(0, N_STORE, PUT_BATCH):
        flat.put("docs", ids[s:s + PUT_BATCH], corpus[s:s + PUT_BATCH])
    flat_ans = flat.search("docs", queries, 10, use_cache=False)
    out = {"card": card, "note": "node processes share one card: the tier's costs, "
                                 "not a scale-out"}
    root = Path(tempfile.mkdtemp(prefix="longbow_cluster_"))
    sets: list = []
    try:
        out["partitioned"] = cluster_partitioned(sets, root, corpus, queries, truth, flat_ans,
                                                 assign, flight)
        flat.drop("docs")
        del flat
        torch.cuda.empty_cache()
        out["replicated"] = cluster_replicated(sets, root, corpus, queries, flight)
    except BaseException:
        for s in sets:
            s.tails()
        raise
    finally:
        for s in sets:
            s.close()
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"cluster": out})
    return out


def cluster_partitioned(sets, root, corpus, queries, truth, flat_ans, assign, flight) -> dict:
    from longbow_tpu_torch.hybrid.fusion import fuse_rrf
    from longbow_tpu_torch.ops.distance import Metric, exact_search

    name, n = "docs", N_STORE
    ids = np.arange(n, dtype=np.int64)
    category = ids % 1000
    ns = NodeSet(CLUSTER_NODES, root / "partitioned",
                 {"LONGBOW_PLACEMENT": "partitioned", "LONGBOW_INDEX_KIND": "flat"})
    sets.append(ns)
    t0 = time.perf_counter()
    for i in range(ns.n):
        ns.start(i)
    start_s = ns.wait_ready(range(ns.n), "14.1 start")
    d: dict = {"nodes": ns.n, "start_s": start_s}
    print(f"14.1 partitioned: {ns.n} node processes ready in {start_s:.3f} s", flush=True)

    # puts through node 0, which forwards each row to its ring owner
    c0 = ns.client(0)
    t0 = time.perf_counter()
    for s in range(0, n, PUT_BATCH):
        e = min(s + PUT_BATCH, n)
        c0.write(name, ids[s:e], corpus[s:e], {"category": category[s:e]}, metric="l2")
    acked_s = time.perf_counter() - t0
    while True:
        counts = [ns.live_rows(i, name) for i in range(ns.n)]
        if sum(counts) == n:
            break
        if time.perf_counter() - t0 > CLUSTER_DEADLINE_S:
            fail(f"14.1: node counts {counts} never summed to {n}")
        time.sleep(0.05)
    ns.wait_ready(range(ns.n), "14.1 ingest")
    stable_s = time.perf_counter() - t0
    owners = ring_owners(ns.ids, ids)
    for i in range(ns.n):
        held = np.sort(ns.client(i).scan(name).column("id").to_numpy())
        if not np.array_equal(held, ids[owners == i]):
            fail(f"14.1: node {i} holds {len(held)} rows, the ring assigns it "
                 f"{int(np.sum(owners == i))} (or other ids)")
    d.update(acked_s=acked_s, stable_s=stable_s, rows_per_s=n / stable_s, counts=counts)
    # every node's kernel launches are read just before 14.1's searches and
    # just after them
    count0 = launch_counts(ns, range(ns.n))
    label = "cuda_fused" if DEVICE == "cuda" else "torch"
    disp0 = {i: metric_sum(ns.metrics(i), "longbow_simd_dispatch_total", implementation=label)
             for i in range(ns.n)}
    print(f"14.1 puts: {n} rows through node 0 in {PUT_BATCH}-row DoPut batches, acknowledged "
          f"after {acked_s:.3f} s, every count stable after {stable_s:.3f} s "
          f"({n / stable_s:.0f} rows/s); shares {counts}, each exactly the ring's", flush=True)

    # the 1,000 queries as one DoExchange batch, and as single tickets
    def batch():
        return arrow_answer(c0.search(name, queries, k=10), len(queries))

    merged = batch()
    batch_s = []
    for _ in range(3):
        t = time.perf_counter()
        batch()
        batch_s.append(time.perf_counter() - t)
    d["batch_ms"] = 1e3 * statistics.median(batch_s)
    d["recall_at_10"] = recall_at(merged[0], truth)
    gate("14.1 merged batch", d["recall_at_10"], RECALL_GATE)
    d["batch_vs_flat"] = held_to_flat("14.1 merged batch", merged, flat_ans)
    per_thread = CLUSTER_TICKETS // CLUSTER_THREADS
    lat = [0.0] * CLUSTER_TICKETS
    answers: list = [None] * CLUSTER_TICKETS
    errors: list = []

    def caller(t: int) -> None:
        c = ns.new_client(0)
        try:
            for j in range(t * per_thread, (t + 1) * per_thread):
                kw = {}
                if j % 4 == 0:
                    kw["filters"] = [{"field": "category", "op": "in", "value": CLUSTER_FILTER}]
                t1 = time.perf_counter()
                tbl = c.search(name, queries[j], k=10, **kw)
                lat[j] = time.perf_counter() - t1
                answers[j] = arrow_answer(tbl, 1)
        except Exception as e:  # reported by the main thread
            errors.append(e)
        finally:
            c.close()

    threads = [threading.Thread(target=caller, args=(t,)) for t in range(CLUSTER_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=CLUSTER_DEADLINE_S)
    tickets_s = time.perf_counter() - t0
    if errors or any(a is None for a in answers):
        fail(f"14.1 tickets: {errors[:1] or 'a ticket did not answer'}")
    violations = sum(int(np.sum(~np.isin(np.asarray(a[0][a[2]], np.int64) % 1000,
                                         CLUSTER_FILTER)))
                     for j, a in enumerate(answers) if j % 4 == 0)
    if violations:
        fail(f"14.1: {violations} filtered ticket answers outside the category filter")
    plain = [j for j in range(CLUSTER_TICKETS) if j % 4]
    tk = tuple(np.concatenate([answers[j][x] for j in plain]) for x in range(3))
    d["tickets"] = {"n": CLUSTER_TICKETS, "threads": CLUSTER_THREADS, "seconds": tickets_s,
                    "p50_ms": 1e3 * float(np.percentile(lat, 50)),
                    "p99_ms": 1e3 * float(np.percentile(lat, 99)),
                    "filter_violations": 0,
                    "recall_at_10": recall_at(tk[0], truth[plain]),
                    **held_to_flat("14.1 tickets", tk, tuple(a[plain] for a in flat_ans))}
    gate("14.1 tickets", d["tickets"]["recall_at_10"], RECALL_GATE)

    rng = np.random.default_rng(14)
    dead = rng.choice(n, CLUSTER_DELETES, replace=False)
    c0.delete(name, dead.tolist())
    total = sum(ns.live_rows(i, name) for i in range(ns.n))
    if total != n - CLUSTER_DELETES:
        fail(f"14.1: {total} rows after deleting {CLUSTER_DELETES} through node 0")
    back = arrow_answer(c0.search(name, corpus[dead], k=10), len(dead))
    came_back = int(np.isin(np.asarray(back[0][back[2]], np.int64), dead).sum())
    if came_back:
        fail(f"14.1: {came_back} deleted ids came back")
    d["deleted"] = {"ids": CLUSTER_DELETES, "came_back": 0}
    launched = launches_between(count0, launch_counts(ns, range(ns.n)))
    searches = [metric_sum(ns.metrics(i), "longbow_simd_dispatch_total",
                           implementation=label) - disp0[i] for i in range(ns.n)]
    if DEVICE == "cuda" and min(launched["fused_scan"]) == 0:
        fail(f"14.1: K1 was not launched on every node: {launched['fused_scan']}")
    m0 = ns.metrics(0)
    fan = metric_sum(m0, "longbow_global_search_fanout_size_sum") / max(
        metric_sum(m0, "longbow_global_search_fanout_size_count"), 1)
    d.update(k1_launches_by_node=launched["fused_scan"],
             k2_launches_by_node=launched["fused_codes_scan"],
             scan_dispatches_by_node=searches, mean_fanout=fan)
    print(f"14.1 search: 1,000 queries as one DoExchange batch {d['batch_ms']:.3f} ms, recall@10 "
          f"{d['recall_at_10']:.4f}, top-10 overlap with one flat dataset "
          f"{d['batch_vs_flat']['overlap_with_flat']:.4f} (slots worse than flat: "
          f"{d['batch_vs_flat']['slots_worse_than_flat']}); {CLUSTER_TICKETS} single tickets from "
          f"{CLUSTER_THREADS} threads p50 {d['tickets']['p50_ms']:.3f} ms p99 "
          f"{d['tickets']['p99_ms']:.3f} ms, recall@10 {d['tickets']['recall_at_10']:.4f}, "
          f"0 filter violations; {CLUSTER_DELETES} broadcast deletes, 0 back; K1 launches by "
          f"node {d['k1_launches_by_node']} (K2 {d['k2_launches_by_node']}; {label} dispatches "
          f"{searches}); mean fan-out {fan:.2f}", flush=True)

    d["hybrid"] = cluster_hybrid(ns, corpus, queries, assign, fuse_rrf, flight)

    # node 7 killed: once node 0 calls it dead, ALL is refused (its share
    # cannot answer) and QUORUM (7 of 8) answers
    ticket = json.loads(ticket_search(name, queries[0]))
    ns.kill(7)
    t_kill = time.perf_counter()
    while True:
        st = {m["id"]: m["status"] for m in c0.cluster_status()["members"]}
        if st[ns.ids[7]] == "dead":
            break
        if time.perf_counter() - t_kill > CLUSTER_DEADLINE_S:
            fail(f"14.1: node 7 still {st[ns.ids[7]]} after {CLUSTER_DEADLINE_S} s")
        time.sleep(0.05)
    dead_s = time.perf_counter() - t_kill

    def level(cons: str):
        body = dict(ticket["search"], consistency=cons)
        return c0._dc().do_get(flight.Ticket(json.dumps({"search": body}).encode()),
                               options=c0._opts).read_all()

    try:
        level("ALL")
        fail("14.1: consistency ALL answered with node 7 dead")
    except flight.FlightUnavailableError as e:
        all_refusal = str(e).split(". Detail:")[0]
    quorum = arrow_answer(level("QUORUM"), 1)
    if not quorum[2].any():
        fail("14.1: consistency QUORUM gave no answer with 7 of 8 nodes up")
    live = (owners != 7)
    live[dead] = False
    best = arrow_answer(c0.search(name, queries, k=10), len(queries))
    got = np.asarray(best[0][best[2]], np.int64)
    if np.any(owners[got] == 7):
        fail(f"14.1: {int(np.sum(owners[got] == 7))} ids of node 7's share after its death")
    live_idx = np.nonzero(live)[0]
    _, lt = exact_search(queries, corpus[live_idx], 10, Metric.L2, device=DEVICE)
    live_recall = recall_at(best[0], live_idx[lt.cpu().numpy()])
    gate("14.1 seven live shares", live_recall, RECALL_GATE)
    d["node7_killed"] = {"view_at_the_all_query": "dead", "all_refusal": all_refusal,
                         "quorum_answered": True, "seconds_to_dead": dead_s,
                         "recall_at_10_live_rows": live_recall}
    print(f"14.1 node 7 SIGKILLed: dead in node 0's view after {dead_s:.3f} s; then "
          f"consistency ALL refused ({all_refusal!r}), QUORUM answered, and best-effort "
          f"answers from 7 shares hold none of its ids, recall@10 {live_recall:.4f} against "
          f"the live rows", flush=True)
    ns.close()
    sets.remove(ns)
    return d


def cluster_hybrid(ns, corpus, queries, assign, fuse_rrf, flight) -> dict:
    """14.2: a text dataset on the 8 nodes; a hybrid query through node 0
    must equal fuse_rrf (k 60) over every node's own local_only answer, in
    node 0's fan-out order (itself, then its peers as listed)."""
    name, n = "hybrid", min(N_HYBRID, N_STORE)
    rng = np.random.default_rng(9)
    words = zipf_words(rng, (n, TEXT_WORDS))
    texts = np.array([" ".join(f"w{w}" for w in row) + f" c{c}"
                      for row, c in zip(words.tolist(), assign[:n].tolist())])
    ids = np.arange(n, dtype=np.int64)
    c0 = ns.client(0)
    t0 = time.perf_counter()
    for s in range(0, n, PUT_BATCH):
        e = min(s + PUT_BATCH, n)
        c0.write(name, ids[s:e], corpus[s:e], {"text": texts[s:e]}, metric="l2")
    while sum(ns.live_rows(i, name) for i in range(ns.n)) != n:
        if time.perf_counter() - t0 > CLUSTER_DEADLINE_S:
            fail("14.2: the text rows never all arrived")
        time.sleep(0.05)
    ns.wait_ready(range(ns.n), "14.2 ingest")
    put_s = time.perf_counter() - t0
    qwords = zipf_words(rng, (HYBRID_QUERIES, 2))
    qclusters = assign[N_STORE:N_STORE + HYBRID_QUERIES]
    qtexts = [f"c{c} w{a} w{b}" for c, (a, b) in zip(qclusters.tolist(), qwords.tolist())]
    lat = []
    for j in range(HYBRID_QUERIES):
        kw = dict(text_query=qtexts[j], alpha=0.5)
        t = time.perf_counter()
        got = c0.search(name, queries[j], k=10, **kw).column("id").to_pylist()
        lat.append(time.perf_counter() - t)
        lists = []
        for i in range(ns.n):
            tbl = ns.client(i)._dc().do_get(flight.Ticket(ticket_search(
                name, queries[j], text_query=qtexts[j], alpha=0.5, local_only=True)),
                options=ns.client(i)._opts).read_all()
            lists.append(tbl.column("id").to_pylist())
        want = [uid for uid, _ in fuse_rrf(lists, 10)]
        if got != want:
            fail(f"14.2 query {j}: {got} through node 0, fuse_rrf of the nodes' answers {want}")
    d = {"rows": n, "put_s": put_s, "queries": HYBRID_QUERIES,
         "p50_ms": 1e3 * statistics.median(lat), "equal_to_fuse_rrf": HYBRID_QUERIES}
    print(f"14.2 hybrid: {n} rows with text over {ns.n} nodes in {put_s:.3f} s; "
          f"{HYBRID_QUERIES} text+vector queries through node 0 each equal to fuse_rrf (k 60) of "
          f"the nodes' local answers; p50 {d['p50_ms']:.3f} ms", flush=True)
    return d


def merkle_roots(ns, idxs, name: str) -> list:
    """merkle-state roots of the nodes, asked in parallel."""
    roots: dict = {}

    def ask(i):
        c = ns.new_client(i)
        try:
            roots[i] = c._action("merkle-state", {"dataset": name})["root"]
        except Exception:  # a node still starting: no root yet
            roots[i] = None
        finally:
            c.close()

    threads = [threading.Thread(target=ask, args=(i,)) for i in idxs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=CLUSTER_DEADLINE_S)
    return [roots.get(i) for i in idxs]


def local_answer(ns, i: int, name: str, q: np.ndarray) -> tuple:
    """Node i's own answer (local_only) to a query batch, by DoExchange."""
    tbl = ns.client(i).exchange_search(name, [q], 10, local_only=True)[0]
    return arrow_answer(tbl, len(q))


def cluster_replicated(sets, root, corpus, queries, flight) -> dict:
    """14.3: 3 nodes, async replication, anti-entropy every 2 s, a WAL each."""
    name, n = "docs", N_STORE
    ids = np.arange(n, dtype=np.int64)
    rs = NodeSet(REPLICAS, root / "replicated",
                 {"LONGBOW_PLACEMENT": "replicated", "LONGBOW_REPLICATION": "async",
                  "LONGBOW_SYNC_INTERVAL_S": "2", "LONGBOW_INDEX_KIND": "flat"}, persist=True)
    sets.append(rs)
    for i in range(rs.n):
        rs.start(i)
    start_s = rs.wait_ready(range(rs.n), "14.3 start")
    c0 = rs.client(0)
    t0 = time.perf_counter()
    for s in range(0, n, PUT_BATCH):
        e = min(s + PUT_BATCH, n)
        c0.write(name, ids[s:e], corpus[s:e], {"category": ids[s:e] % 1000}, metric="l2")
    acked_s = time.perf_counter() - t0
    reach = {}
    while len(reach) < rs.n:
        for i in range(rs.n):
            if i not in reach and rs.live_rows(i, name) == n:
                reach[i] = time.perf_counter() - t0
        if time.perf_counter() - t0 > CLUSTER_DEADLINE_S:
            fail(f"14.3: counts {[rs.live_rows(i, name) for i in range(rs.n)]} after "
                 f"{CLUSTER_DEADLINE_S} s")
        time.sleep(0.05)
    rs.wait_ready(range(rs.n), "14.3 ingest")
    t1 = time.perf_counter()
    roots = merkle_roots(rs, range(rs.n), name)
    merkle_s = time.perf_counter() - t1
    while len(set(roots)) != 1:
        if time.perf_counter() - t0 > CLUSTER_DEADLINE_S:
            fail(f"14.3: Merkle roots never agreed: {roots}")
        time.sleep(0.5)
        roots = merkle_roots(rs, range(rs.n), name)
    d = {"nodes": rs.n, "start_s": start_s, "acked_s": acked_s,
         "rows_per_s_acked": n / acked_s, "node_reaches_all_s": [reach[i] for i in range(rs.n)],
         "merkle_state_s_at_1m_parallel": merkle_s}
    # every node's kernel launches are read just before 14.3's searches and
    # just after them, once before node 2 is killed and once after its heal
    count0 = launch_counts(rs, range(rs.n))
    a0 = local_answer(rs, 0, name, queries)
    d["node2_equal_node0"] = same_answers("14.3 node 2 against node 0",
                                         local_answer(rs, 2, name, queries), a0)
    d["node1_equal_node0"] = same_answers("14.3 node 1 against node 0",
                                         local_answer(rs, 1, name, queries), a0)
    before_kill = launches_between(count0, launch_counts(rs, range(rs.n)))
    print(f"14.3 replicated: {rs.n} nodes ready in {start_s:.3f} s; {n} rows through node 0 "
          f"acknowledged at {d['rows_per_s_acked']:.0f} rows/s (WAL on); node 2 held them all "
          f"after {reach[2]:.3f} s; Merkle roots equal on all three "
          f"(merkle-state {merkle_s:.3f} s, in parallel); nodes 1 and 2 answer as node 0 does",
          flush=True)

    # the heal: node 2 misses new rows, upserts and deletes while it is down
    rs.kill(2)
    rng = np.random.default_rng(15)
    new_ids = np.arange(n, n + HEAL_ROWS, dtype=np.int64)
    new_vecs = make_corpus(HEAL_ROWS, D_STORE, seed=16)
    up_ids = rng.choice(n, HEAL_ROWS, replace=False)
    up_vecs = (corpus[up_ids] + rng.normal(0, 0.5, (HEAL_ROWS, D_STORE))).astype(np.float32)
    gone = rng.choice(np.setdiff1d(np.arange(n), up_ids), HEAL_DELETES, replace=False)
    c0.write(name, new_ids, new_vecs, {"category": new_ids % 1000}, metric="l2")
    c0.write(name, up_ids, up_vecs, {"category": up_ids % 1000}, metric="l2")
    c0.delete(name, gone.tolist())
    rs.wait_ready([0, 1], "14.3 writes with node 2 down")
    # node 1 took the deletes from node 0's replication at node 0's time, so
    # its root equals node 0's once the async queue has delivered them. The
    # deletes come last, so node 1 holds node 0's count once all arrived; the
    # roots (seconds of each node's Python at 1M rows) are asked from then on
    t1 = time.perf_counter()
    want, r0, r1 = n + HEAL_ROWS - HEAL_DELETES, None, None
    while True:
        if rs.live_rows(1, name) == want:
            r0, r1 = merkle_roots(rs, [0, 1], name)
            if r0 is not None and r0 == r1:
                break
        if time.perf_counter() - t1 > CLUSTER_DEADLINE_S:
            fail(f"14.3: node 1's root {r1} never equalled node 0's {r0} after the deletes "
                 f"(node 1 holds {rs.live_rows(1, name)} rows of {want})")
        time.sleep(0.2)
    d["node1_root_equal_node0_after_deletes_s"] = time.perf_counter() - t1
    t0 = time.perf_counter()
    rs.start(2)
    rs.wait_ready([2], "14.3 restart")
    restart_s = time.perf_counter() - t0
    # the heal is timed from node 2's readiness: its anti-entropy rounds
    # start with its server
    t0 = time.perf_counter()
    # a root at 1M rows is seconds of a node's Python, so the roots are
    # asked for when one of node 2's sync rounds has moved: its synced
    # count changed (the round applied rows) or it found a peer's root
    # equal to its own (its longbow_mesh_merkle_match_total{result=
    # "match"}); and every HEAL_CHECK_S otherwise
    trace, last, t_check = [], None, 0.0
    while True:
        synced = rs.client(2).cluster_status().get("anti_entropy", {}).get("synced_rows", -1)
        matches = metric_sum(rs.metrics(2), "longbow_mesh_merkle_match_total", result="match")
        now = time.perf_counter()
        if (synced, matches) != last or now - t_check > HEAL_CHECK_S:
            if (synced, matches) != last:
                trace.append((now - t0, synced, matches))
            last, t_check = (synced, matches), now
            r0, r2 = merkle_roots(rs, [0, 2], name)
            if r0 is not None and r0 == r2 and synced > 0:
                break
        if now - t0 > CLUSTER_DEADLINE_S:
            fail(f"14.3: node 2's root never reached node 0's ({r2} against {r0})")
        time.sleep(0.5)
    heal_s = time.perf_counter() - t0
    divergent = 2 * HEAL_ROWS + HEAL_DELETES
    m2 = rs.metrics(2)
    rounds = {"merkle_compares": metric_sum(m2, "longbow_mesh_merkle_match_total"),
              "merkle_matches": metric_sum(m2, "longbow_mesh_merkle_match_total",
                                           result="match"),
              "delta_pulls": metric_sum(m2, "longbow_mesh_sync_deltas_total"),
              "seconds_synced_matches": trace}
    if not 0 < synced < HEAL_SYNC_FACTOR * divergent:
        fail(f"14.3: node 2 synced {synced} rows for {divergent} divergent ones")
    count1 = launch_counts(rs, range(rs.n))
    d["node2_equal_node0_after_heal"] = same_answers(
        "14.3 node 2 against node 0 after the heal", local_answer(rs, 2, name, queries),
        local_answer(rs, 0, name, queries))
    back = local_answer(rs, 2, name, corpus[gone])
    if np.isin(np.asarray(back[0][back[2]], np.int64), gone).any():
        fail("14.3: a deleted id came back on node 2")
    for s in range(0, HEAL_ROWS, 2_000):  # tickets of 2,000 queries (the cap is 4,096)
        vec = []
        for i in (0, 2):
            tbl = rs.client(i)._dc().do_get(flight.Ticket(ticket_search(
                name, up_vecs[s:s + 2_000], k=1, include_vectors=True, local_only=True)),
                options=rs.client(i)._opts).read_all()
            if tbl.column("id").to_pylist() != up_ids[s:s + 2_000].tolist():
                fail(f"14.3: node {i} does not find every upserted row first")
            vec.append(np.stack(tbl.column("vector").to_numpy(zero_copy_only=False)))
        if not np.array_equal(vec[0].view(np.uint32), vec[1].view(np.uint32)):
            fail("14.3: the upserted rows' vectors on node 2 are not node 0's")
    after_heal = launches_between(count1, launch_counts(rs, range(rs.n)))
    launched = {k: [a + b for a, b in zip(before_kill[k], after_heal[k])] for k in KERNEL_NAMES}
    if DEVICE == "cuda" and min(launched["fused_scan"]) == 0:
        fail(f"14.3: K1 was not launched on every node: {launched['fused_scan']}")
    d.update(k1_launches_by_node=launched["fused_scan"],
             k2_launches_by_node=launched["fused_codes_scan"])
    cp = c0._action("checkpoint", {})
    peers = sorted(rs.ids[1:])
    if not (cp.get("ok") and sorted(cp.get("prepared", [])) == peers
            and sorted(cp.get("committed", [])) == peers and cp.get("local")):
        fail(f"14.3: checkpoint answered {cp}")
    d.update(restart_s=restart_s, heal_s=heal_s, divergent_rows=divergent,
             synced_rows=synced, node2_sync=rounds, checkpoint=cp)
    print(f"14.3 heal: node 2 SIGKILLed, {HEAL_ROWS} new rows, {HEAL_ROWS} upserts and "
          f"{HEAL_DELETES} deletes through node 0; node 1's root equal to node 0's "
          f"{d['node1_root_equal_node0_after_deletes_s']:.3f} s after them; "
          f"restarted on its WAL in {restart_s:.3f} s; "
          f"its root equal to node 0's {heal_s:.3f} s after it was ready, {synced} rows synced "
          f"for {divergent} divergent (node 2's (seconds, synced rows, root matches): {trace}; "
          f"{rounds['merkle_compares']:.0f} root compares, {rounds['delta_pulls']:.0f} delta "
          f"pulls); answers equal, no deleted id back, upserted vectors bit "
          f"for bit node 0's; K1 launches by node {launched['fused_scan']} (K2 "
          f"{launched['fused_codes_scan']}); checkpoint ok, both peers prepared and committed",
          flush=True)
    rs.close()
    sets.remove(rs)
    return d


# -- 15. the coarse int8 shadow and complex / f64 inputs -----------------------

N_COMPLEX, D_COMPLEX = 100_000, 64


def phase_leftovers(bw: float, flops: float, reps: int, store_out: dict) -> dict:
    """15. LONGBOW_FLAT_COARSE=1 on phase 4's rows (K2 for the pool, the f32
    re-rank), a dot dataset that keeps K1, and complex64 / float64 inputs of
    exact_search."""
    import os

    from longbow_tpu_torch.ops import _kernels
    from longbow_tpu_torch.ops import scan as scan_mod
    from longbow_tpu_torch.ops.distance import Metric, exact_search
    from longbow_tpu_torch.store.vector_store import VectorStore

    t_phase = time.perf_counter()
    allv = make_corpus(N_STORE + N_QUERIES, D_STORE, seed=0)
    corpus, queries = allv[:N_STORE], allv[N_STORE:]
    ids = np.arange(N_STORE, dtype=np.int64)
    out: dict = {}
    saved = os.environ.get("LONGBOW_FLAT_COARSE")
    os.environ["LONGBOW_FLAT_COARSE"] = "1"
    try:
        store = VectorStore(device=DEVICE, dtype=torch.bfloat16, default_index_kind="flat")
        t0 = time.perf_counter()
        for s in range(0, N_STORE, PUT_BATCH):
            store.put("coarse", ids[s:s + PUT_BATCH], corpus[s:s + PUT_BATCH])
        ds = store.get("coarse")
        ds.index.flush()
        for s in range(0, N_SMALL, PUT_BATCH):
            e = min(s + PUT_BATCH, N_SMALL)
            store.put("coarse_dot", ids[s:e], corpus[s:e], metric="dot")
        store.get("coarse_dot").index.flush()
    finally:
        if saved is None:
            os.environ.pop("LONGBOW_FLAT_COARSE", None)
        else:
            os.environ["LONGBOW_FLAT_COARSE"] = saved
    torch.cuda.synchronize()
    out["ingest_rows_per_s"] = N_STORE / (time.perf_counter() - t0)
    if ds.index._flat._coarse_codes is None or \
            store.get("coarse_dot").index._flat._coarse_enabled:
        fail("15: the shadow is missing on the l2 dataset or built on the dot one")

    _kernels.reset_launch_counts()
    searches = 0
    res: dict = {}

    def run_batch():
        res["a"] = store.search("coarse", queries, 10, use_cache=False)

    k2_call = first_call(scan_mod, "fused_codes_search", run_batch, "the coarse search")
    searches += 1
    batch_s = []
    for _ in range(5):
        t = time.perf_counter()
        store.search("coarse", queries, 10, use_cache=False)
        batch_s.append(time.perf_counter() - t)
        searches += 1
    lat = []
    for j in range(16):
        t = time.perf_counter()
        store.search("coarse", queries[j:j + 1], 10, use_cache=False)
        lat.append(time.perf_counter() - t)
        searches += 1
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _kernels.KERNELS}
    if launches["fused_codes_scan"] != searches or launches["fused_scan"] != 0:
        fail(f"15: {searches} coarse searches launched {launches}")
    _, truth = exact_search(queries, corpus, 10, Metric.L2, device=DEVICE)
    truth = truth.cpu().numpy()
    out["recall_at_10"] = recall_at(res["a"][0], truth)
    gate("15 coarse shadow", out["recall_at_10"], RECALL_GATE)
    _, pool = scan_mod.fused_codes_search(*k2_call[0], **k2_call[1])
    pool = pool.cpu().numpy()
    _kernels.FUSED_CODES_SCAN.launches = launches["fused_codes_scan"]
    out["pool_contains_true_top10"] = float(np.mean(
        [len(set(truth[r]) & set(pool[r])) / 10 for r in range(len(truth))]))
    out.update(batch_1000_ms=1e3 * statistics.median(batch_s),
               p50_single_query_ms=1e3 * statistics.median(lat),
               k1_batch_1000_ms=store_out["batch_1000_ms"],
               k1_p50_single_query_ms=store_out["p50_single_query_ms"],
               searches=searches, launches=launches)

    held = dict(launches)
    got_dot, _, _ = store.search("coarse_dot", queries, 10, use_cache=False)
    want_dot, _, _ = store.search("coarse_dot", queries, 10, exact=True, use_cache=False)
    torch.cuda.synchronize()
    dot_k1 = _kernels.FUSED_SCAN.launches - held["fused_scan"]
    dot_k2 = _kernels.FUSED_CODES_SCAN.launches - held["fused_codes_scan"]
    if dot_k1 != 1 or dot_k2 != 0:
        fail(f"15: the dot dataset launched K1 {dot_k1} and K2 {dot_k2} times")
    out["dot"] = {"rows": N_SMALL, "k1_launches": dot_k1, "k2_launches": 0,
                  "recall_at_10_vs_exact": recall_at(got_dot, want_dot)}
    gate("15 dot with the shadow asked for", out["dot"]["recall_at_10_vs_exact"], RECALL_GATE)
    out["launches"] = {k.name: k.launches for k in _kernels.KERNELS}

    # complex64 rows as their [real, imag] widening; float64 as float32
    rng = np.random.default_rng(15)
    cc = (rng.standard_normal((N_COMPLEX, D_COMPLEX))
          + 1j * rng.standard_normal((N_COMPLEX, D_COMPLEX))).astype(np.complex64)
    qc = cc[:100] + np.complex64(0.01)
    for metric in (Metric.L2, Metric.COSINE, Metric.DOT):
        dc, ic = exact_search(qc, cc, 10, metric, device=DEVICE)
        dw, iw = exact_search(np.concatenate([qc.real, qc.imag], 1),
                              np.concatenate([cc.real, cc.imag], 1), 10, metric, device=DEVICE)
        if not (torch.equal(dc, dw) and torch.equal(ic, iw)):
            fail(f"15: complex64 exact_search ({metric}) differs from its widening")
    d64, i64 = exact_search(queries.astype(np.float64), corpus[:N_SMALL].astype(np.float64), 10,
                            Metric.L2, device=DEVICE)
    d32, i32 = exact_search(queries, corpus[:N_SMALL], 10, Metric.L2, device=DEVICE)
    if not (torch.equal(d64, d32) and torch.equal(i64, i32)):
        fail("15: float64 exact_search differs from the float32 call")
    out["complex"] = {"rows": N_COMPLEX, "dim": D_COMPLEX, "equal_to_widening": True,
                      "f64_equal_to_f32": True}
    print(f"15 coarse shadow: {N_STORE} bf16 rows with int8 codes beside them, recall@10 "
          f"{out['recall_at_10']:.4f}, the pool of 64 holds {out['pool_contains_true_top10']:.4f} "
          f"of the true top-10; K2 launched on each of {searches} searches, K1 on none; "
          f"1,000 queries {out['batch_1000_ms']:.3f} ms (K1 path, phase 4: "
          f"{out['k1_batch_1000_ms']:.3f} ms), one query p50 {out['p50_single_query_ms']:.3f} ms "
          f"(K1: {out['k1_p50_single_query_ms']:.3f} ms); a dot dataset with the variable set "
          f"stays on K1; complex64 ({N_COMPLEX} x {D_COMPLEX}) equal to its [real, imag] "
          f"widening and float64 to float32", flush=True)
    store.drop("coarse")
    store.drop("coarse_dot")
    del store, ds
    torch.cuda.empty_cache()
    out["k2_coarse"] = check_codes_call("coarse shadow", k2_call, bw, flops, reps)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"leftovers": out})
    return out


# -- 16. the operator entry points ----------------------------------------------

OPS_ROWS, OPS_DIM = 100_000, 128  # the rows the ops CLI puts
OPS_SEARCH_SEEDS = (11, 12, 13)   # the CLI's query seeds (not the put's: no query is a row)
# 16.2's modes, 16.3's soak and 16.4's run, cut from 10, 60 and 90 s for the phase's 300 s: on a
# slow host the script took 1,109.1 s and this phase 296.1 s (H100 80GB HBM3, 700 W)
BENCH_S = 8.0                     # each bench_tool mode against the node
SOAK_S = 30                       # soak_mixed against the node
# the node checks for compaction every 5 s at fragmentation 0.05 (the defaults, 30 s and 0.3, are
# for the reference's 1,200 s soak): the soak's upserts, about 1,100 dead rows a second over
# 100,000 seeded, cross 0.05 about every 5 s, so a host at half the rate still compacts
SOAK_COMPACTION = {"LONGBOW_COMPACTION_INTERVAL_S": "5", "LONGBOW_COMPACTION_FRAG_THRESHOLD": "0.05"}
CHAOS_S = 45                      # chaos_soak's run, node 1 killed at 25% and restarted at 55%
CHAOS_DIM, CHAOS_BATCH = 128, 1_000
CHAOS_SEED_ROWS = 262_144         # cut from phase 4's 1M for the script's time (14.3 heals 1M)
TOOL_TIMEOUT_S = 600.0


def run_tool(name: str, *args) -> list:
    """`python -m longbow_tpu_torch.tools.<name> args` from the repo root, as an
    operator runs it; its output is printed and returned as lines, and an exit
    other than 0 fails the phase."""
    import os
    from pathlib import Path

    repo = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items() if not k.startswith("LONGBOW_")}
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-m", f"longbow_tpu_torch.tools.{name}", *map(str, args)],
                         cwd=repo, env=env, capture_output=True, text=True,
                         timeout=TOOL_TIMEOUT_S, stdin=subprocess.DEVNULL)
    if res.returncode != 0:
        print(res.stdout[-6000:], res.stderr[-6000:], sep="\n", file=sys.stderr)
        fail(f"16: {name} {' '.join(map(str, args))} exited with {res.returncode}")
    return res.stdout.splitlines()


def last_json(lines: list) -> dict:
    return json.loads(lines[-1])


def phase_operators(card: str) -> dict:
    """16. the operator entry points against node processes on the card."""
    import shutil
    import tempfile
    from pathlib import Path

    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="longbow_operators_"))
    sets: list = []
    out: dict = {"card": card}
    try:
        ns = NodeSet(1, root / "node", SOAK_COMPACTION, persist=True)
        sets.append(ns)
        ns.start(0)
        out["node_ready_s"] = ns.wait_ready([0], "16 start")
        out["ops"] = operators_ops(ns)
        out["bench_tool"] = operators_bench(ns)
        out["soak_mixed"] = operators_soak(ns)
        ns.close()
        sets.remove(ns)
        out["chaos_soak"] = operators_chaos()
    except BaseException:
        for s in sets:
            s.tails()
        raise
    finally:
        for s in sets:
            s.close()
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {k: sum(out[part]["launches"][k] for part in
                              ("ops", "bench_tool", "soak_mixed", "chaos_soak"))
                       for k in KERNEL_NAMES}
    out["seconds"] = time.perf_counter() - t_phase
    emit({"operators": out})
    return out


def node_launches(ns, before: dict) -> dict:
    """The node set's launches of each kernel since `before`, summed."""
    return {k: int(sum(v)) for k, v in
            launches_between(before, launch_counts(ns, range(ns.n))).items()}


def operators_ops(ns) -> dict:
    """16.1: every ops command against one node; search answers against an
    in-process flat store of the same rows; an sq8 namespace on K2."""
    from longbow_tpu_torch.store.vector_store import VectorStore

    t0 = time.perf_counter()
    dp, mp, _ = ns.ports[0]
    addr = ("--host", "127.0.0.1", "--data-port", dp, "--meta-port", mp)

    calls = []

    def ops(*args) -> dict:
        calls.append(args[0])
        return last_json(run_tool("ops", *args, *addr))

    before = launch_counts(ns, [0])
    answers: dict = {}
    answers["readiness"] = ops("readiness")
    put = ops("put", "--rows", OPS_ROWS, "--dim", OPS_DIM)
    if put["written"] != OPS_ROWS:
        fail(f"16.1: put answered {put}")
    rows = np.random.default_rng(0).standard_normal((OPS_ROWS, OPS_DIM), dtype=np.float32)
    flat = VectorStore(device=DEVICE, dtype=torch.bfloat16, default_index_kind="flat")
    flat.put("ops_test", np.arange(OPS_ROWS), rows)
    searched = []
    for seed in OPS_SEARCH_SEEDS:
        got = ops("search", "--k", 10, "--seed", seed)
        q = np.random.default_rng(seed).standard_normal((OPS_DIM,), dtype=np.float32)
        want = flat.search("ops_test", q[None], 10, use_cache=False)
        ids = np.asarray(got["ids"], np.int64)[None]
        searched.append(same_answers(f"16.1 ops search (seed {seed})",
                                     (ids, np.asarray(got["scores"], np.float32)[None],
                                      np.ones(ids.shape, bool)),
                                     (np.asarray(want[0], np.int64), want[1], want[2])))
    flat.drop("ops_test")
    del flat
    answers["hybrid"] = ops("search", "--k", 10, "--seed", 11, "--text", "anything")
    got = ops("get", "--limit", 10)
    if got["rows"] != 10 or got["first_ids"] != list(range(10)):
        fail(f"16.1: get answered {got}")
    info = ops("info")
    if info["total_records"] != OPS_ROWS or f"[{OPS_DIM}]" not in info["schema"]:
        fail(f"16.1: info answered {info}")
    if ops("delete", "--ids", "1,2,3") != {"deleted": 3}:
        fail("16.1: delete did not remove 3 rows")
    if ops("ns-create", "--dataset", "q8", "--dim", OPS_DIM, "--index", "sq8") != {"created": "q8"}:
        fail("16.1: ns-create refused")
    # a snapshot while the sq8 namespace holds no row (its quantizer untrained)
    answers["snapshot"] = ops("snapshot")
    ops("put", "--dataset", "q8", "--rows", OPS_ROWS, "--dim", OPS_DIM, "--seed", 5)
    q8 = ops("search", "--dataset", "q8", "--k", 10, "--seed", 5)  # the query is row 0
    if q8["ids"][0] != 0:
        fail(f"16.1: the sq8 namespace's top-1 for its own row 0 is {q8['ids'][:3]}")
    names = ops("ns-list")
    if sorted(names) != ["ops_test", "q8"]:
        fail(f"16.1: ns-list answered {names}")
    status = ops("status")
    kinds = {n: (d["index_kind"], d["live_rows"]) for n, d in status["datasets"].items()}
    if kinds != {"ops_test": ("flat", OPS_ROWS - 3), "q8": ("sq8", OPS_ROWS)}:
        fail(f"16.1: status holds {kinds}")
    answers["mesh"] = ops("mesh")
    health = ops("health")
    if DEVICE == "cuda" and health["status"] != "healthy":
        fail(f"16.1: health answered {health}")
    if ops("edge", "--src", 4, "--dst", 5) != {"edge": [4, 5]}:
        fail("16.1: edge refused")
    path = ops("traverse", "--src", 4, "--dst", 5)["path"]
    if path[0] != 4 or path[-1] != 5:
        fail(f"16.1: traverse answered {path}")
    if ops("drop", "--dataset", "q8") != {"dropped": True}:
        fail("16.1: drop refused")
    launched = node_launches(ns, before)
    if DEVICE == "cuda" and min(launched.values()) == 0:
        fail(f"16.1: a kernel was not launched on the node: {launched}")
    secs = time.perf_counter() - t0
    print(f"16.1 ops: {len(calls)} calls of {len(set(calls))} commands in {secs:.3f} s; "
          f"{OPS_ROWS} x {OPS_DIM} rows put by the CLI, "
          f"{len(OPS_SEARCH_SEEDS)} searches equal to an in-process flat store; an sq8 "
          f"namespace finds its own row first; launches on the node {launched}", flush=True)
    return {"seconds": secs, "calls": len(calls), "commands": sorted(set(calls)),
            "search_equal": searched, "launches": launched,
            "health": health["status"], "snapshot": answers["snapshot"]}


def operators_bench(ns) -> dict:
    """16.2: bench_tool's modes against the node, 0 errors each, then micro."""
    dp, mp, _ = ns.ports[0]
    addr = ("--host", "127.0.0.1", "--data-port", dp, "--meta-port", mp,
            "--duration", BENCH_S, "--dim", OPS_DIM)
    runs = (("ingest_f32", ("--mode", "ingest", "--dataset", "bench", "--index", "flat")),
            ("ingest_i8", ("--mode", "ingest", "--dataset", "bench_i8", "--dtype", "i8")),
            ("search", ("--mode", "search", "--dataset", "bench")),
            ("hybrid", ("--mode", "hybrid", "--dataset", "bench_i8")),
            ("scan", ("--mode", "scan", "--dataset", "bench")))
    before = launch_counts(ns, [0])
    out: dict = {}
    for label, args in runs:
        res = last_json(run_tool("bench_tool", *args, *addr))
        print(f"16.2 bench_tool {label}: {json.dumps(res)}", flush=True)
        if res["errors"] or not res["ops"]:
            fail(f"16.2: bench_tool {label} answered {res}")
        out[label] = res
    kinds = {n: d["index_kind"] for n, d in ns.client(0).cluster_status()["datasets"].items()}
    if kinds.get("bench") != "flat" or kinds.get("bench_i8") != "sq8":
        fail(f"16.2: the datasets are {kinds}")
    out["launches"] = node_launches(ns, before)
    if DEVICE == "cuda" and min(out["launches"].values()) == 0:
        fail(f"16.2: a kernel was not launched on the node: {out['launches']}")
    micro = ("--mode", "micro") + (("--device", "cpu") if DEVICE == "cpu" else ())
    out["micro"] = last_json(run_tool("bench_tool", *micro))
    print(f"16.2 bench_tool micro on the {DEVICE}: {json.dumps(out['micro'])}; launches on "
          f"the node over the modes {out['launches']}", flush=True)
    return out


def operators_soak(ns) -> dict:
    """16.3: soak_mixed against the node for SOAK_S seconds."""
    dp, mp, xp = ns.ports[0]
    before = launch_counts(ns, [0])
    compacted = metric_sum(ns.metrics(0), "longbow_compaction_operations_total")
    t0 = time.perf_counter()
    lines = run_tool("soak_mixed", SOAK_S, "--host", "127.0.0.1", "--data-port", dp,
                     "--meta-port", mp, "--metrics-port", xp)
    secs = time.perf_counter() - t0
    res = last_json(lines)
    compactions = metric_sum(ns.metrics(0), "longbow_compaction_operations_total") - compacted
    launched = node_launches(ns, before)
    for line in lines[-4:-1]:
        print(f"16.3 soak_mixed: {line}", flush=True)
    if not res["ok"] or res["serr"] or res["werr"] or not res["checked"] \
            or res["top1_self_match"] != res["checked"] or res["deleted_ids_back"]:
        fail(f"16.3: soak_mixed answered {res}")
    if compactions < 1:
        fail("16.3: no compaction ran during the soak")
    if DEVICE == "cuda" and launched["fused_scan"] == 0:
        fail(f"16.3: K1 was not launched on the node: {launched}")
    print(f"16.3 soak_mixed: {secs:.3f} s; {res['writes']} rows written, {res['searches']} "
          f"searches (p50 {res['search_p50_ms']:.3f}, p99 {res['search_p99_ms']:.3f} ms), "
          f"{res['deletes']} deletes; {res['top1_self_match']}/{res['checked']} kept writes "
          f"found first, no deleted id back; {compactions:.0f} compactions; launches {launched}",
          flush=True)
    return {**res, "seconds": secs, "compactions": compactions, "launches": launched}


def operators_chaos() -> dict:
    """16.4: chaos_soak on three replicated nodes at 128-d."""
    args = ["--dim", CHAOS_DIM, "--batch", CHAOS_BATCH, "--seed-rows", CHAOS_SEED_ROWS,
            "--duration", CHAOS_S]
    if DEVICE == "cpu":
        args += ["--device", "cpu"]
    t0 = time.perf_counter()
    lines = run_tool("chaos_soak", *args)
    secs = time.perf_counter() - t0
    res = last_json(lines)
    for line in lines[:-1]:
        print(f"16.4 chaos_soak: {line}", flush=True)
    if "HEALED" not in lines or not res["every_row_on_every_node"] or res["heal_s"] is None:
        fail(f"16.4: chaos_soak answered {res}")
    launched = {k: [n[k] for n in res["kernel_launches_by_node"]] for k in KERNEL_NAMES}
    if DEVICE == "cuda" and min(launched["fused_scan"]) == 0:
        fail(f"16.4: K1 was not launched on every node: {launched['fused_scan']}")
    print(f"16.4 chaos_soak: {secs:.3f} s; {res['rows_acked']} rows acknowledged, all live on "
          f"the three nodes with equal roots; node 1's root equal to node 0's "
          f"{res['heal_s']:.3f} s after its readiness, {res['synced_rows']} rows synced, "
          f"{res['delta_pulls']:.0f} delta pulls; K1 launches by node {launched['fused_scan']}",
          flush=True)
    return {**res, "seconds": secs,
            "launches": {k: int(sum(v)) for k, v in launched.items()}}


def cluster_launches(cluster: dict, kernel: str) -> int:
    """A kernel's launches in phase 14's node processes, summed over nodes."""
    return int(sum(sum(cluster[part][f"{kernel}_launches_by_node"])
                   for part in ("partitioned", "replicated")))


def recorded_fields(prefix: str, row: dict) -> dict:
    """A kernel's check on a path's recorded arguments, for the kernels line."""
    return {f"{prefix}_{key}": row[src] for key, src in (
        ("shape", "case"), ("variant", "variant"), ("ms", "ms"), ("plain_ms", "plain_ms"),
        ("bound_ms", "bound_ms"), ("bound_by", "bound_by"))}


def main() -> int:
    card, bw, flops = phase_device()
    import longbow_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    took: dict = {}  # host seconds by phase, printed before the kernels line

    def run(label: str, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        took[label] = time.perf_counter() - t
        return out

    run("2 build", phase_build)
    kern = run("3 kernels", phase_kernels, bw, flops, TIMED_LAUNCHES)
    store = run("4 store", phase_store)
    codes = run("5 codes", phase_codes_kernels, bw, flops, TIMED_LAUNCHES)
    torch.cuda.empty_cache()
    quant, deep_index, deep_queries = run("6 quantized store", phase_quantized_store)
    run("6 sq8r stages", sq8r_stages, deep_index, deep_queries)
    del deep_index
    torch.cuda.empty_cache()
    graph = run("7 graph", phase_graph, bw, flops, TIMED_LAUNCHES)
    graph_store = graph.pop("_store")
    knn = graph["self_knn_cases"][0]  # the l2 build's first launch
    torch.cuda.empty_cache()
    kinds = run("8 index kinds", phase_index_kinds, bw, flops, TIMED_LAUNCHES)
    torch.cuda.empty_cache()
    services = run("9 services", phase_services, bw, flops, TIMED_LAUNCHES,
                   store["ingest_rows_per_s"])
    torch.cuda.empty_cache()
    persist = run("10 persistence", phase_persistence, bw, flops, TIMED_LAUNCHES, card,
                  store["ingest_rows_per_s"], graph_store, graph["default_store_1m_x_128"])
    torch.cuda.empty_cache()
    serving = run("11 serving", phase_serving, bw, flops, TIMED_LAUNCHES,
                  store["ingest_rows_per_s"])
    flat_store = serving.pop("_store")
    mesh = run("12 mesh", phase_mesh, bw, flops, TIMED_LAUNCHES, flat_store, graph_store,
               graph["default_store_1m_x_128"])
    graph_store.drop("graph")
    del graph_store, flat_store
    torch.cuda.empty_cache()
    flight = run("13 flight", phase_flight, bw, flops, TIMED_LAUNCHES,
                 store["ingest_rows_per_s"])
    torch.cuda.empty_cache()
    cluster = run("14 cluster", phase_cluster, card)
    leftovers = run("15 leftovers", phase_leftovers, bw, flops, TIMED_LAUNCHES, store)
    operators = run("16 operators", phase_operators, card)
    emit({"phase_seconds": took})

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
        "launches_persistence": persist["launches"]["fused_scan"],
        "launches_serving": serving["launches"]["fused_scan"],
        "launches_mesh": mesh["launches"]["fused_scan"],
        "launches_flight": flight["launches"]["fused_scan"],
        # the node processes' own launch counters over 14.1's and 14.3's searches
        "launches_cluster": cluster_launches(cluster, "k1"),
        "launches_coarse": leftovers["launches"]["fused_scan"],
        # the node processes' own launch counters over phase 16's tools
        "launches_operators": operators["launches"]["fused_scan"],
        "max_abs_err": max(c["max_abs_err"] for c in
                           kern["cases"] + graph["self_knn_cases"] + [kinds["k1_spill"]]
                           + [services["k1_services"], persist["k1_persistence"],
                              serving["k1_serving"], mesh["mesh8"]["k1_shard"],
                              flight["k1_flight"]]),
        "graph_tier_shape": knn["case"],
        "graph_tier_variant": knn["variant"],
        "graph_tier_ms": knn["ms"],
        "graph_tier_plain_ms": knn["plain_ms"],
        "graph_tier_bound_ms": knn["bound_ms"],
        "graph_tier_bound_by": knn["bound_by"],
        **recorded_fields("index_kinds", kinds["k1_spill"]),
        **recorded_fields("services", services["k1_services"]),
        **recorded_fields("persistence", persist["k1_persistence"]),
        **recorded_fields("serving", serving["k1_serving"]),
        **recorded_fields("mesh", mesh["mesh8"]["k1_shard"]),
        **recorded_fields("flight", flight["k1_flight"]),
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
        "launches_persistence": persist["launches"]["fused_codes_scan"],
        "launches_serving": serving["launches"]["fused_codes_scan"],
        "launches_mesh": mesh["launches"]["fused_codes_scan"],
        "launches_flight": flight["launches"]["fused_codes_scan"],
        "launches_cluster": cluster_launches(cluster, "k2"),
        "launches_coarse": leftovers["launches"]["fused_codes_scan"],
        "launches_operators": operators["launches"]["fused_codes_scan"],
        "max_abs_err": max(c["max_abs_err"] for c in
                           codes["cases"] + [kinds["k2_disk"], services["k2_services"],
                                             persist["k2_persistence"], flight["k2_flight"],
                                             leftovers["k2_coarse"]]),
        **recorded_fields("index_kinds", kinds["k2_disk"]),
        **recorded_fields("services", services["k2_services"]),
        **recorded_fields("persistence", persist["k2_persistence"]),
        **recorded_fields("flight", flight["k2_flight"]),
        **recorded_fields("coarse", leftovers["k2_coarse"]),
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
