// The wgmma main loop shared by the fused scans: K1 (fused_scan.cu, bf16
// rows; replaces longbow_tpu/ops/pallas_scan.py::fused_flat_search) and K2
// (fused_codes_scan.cu, int8 codes; replaces ::fused_codes_search), on an
// H100, for any batch with K <= 64, D a multiple of 16 from 64 to 1,024
// and 16-byte aligned rows (ops/scan.py::scan_variant sends every other
// shape to the mma.sync variants). D of 64, 96 or 128 stages whole tiles
// (below); every other width runs the chunked loop at the end of this note.
//
// What bounds the scans is, at a few queries, the bytes of the corpus
// (1M x 128 bf16 rows: 0.08 ms at 3.35 TB/s) and, at hundreds, the
// tensor-core work and one pass over the corpus per query block. The
// mma.sync variants lost most of each tile's time to the copy latency (one
// tile in flight), a barrier per tile, the int8 conversion repeated by four
// warps, and selection. Here a block takes NQ queries (16, 32, 64 or 128:
// ops/scan.py::wgmma_width, the narrowest that holds the batch, else
// blocks of 128) and one split of the corpus. A narrow block keeps the same
// loop with NQ / 2 accumulators a thread and smaller query and candidate
// buffers, so it takes more ring stages (up to 8). It has three consumer
// warpgroups, a copy warp and a group-term warp, and no block-wide barrier
// inside its loop over the tiles:
//   - the copy warp's first lane fills a ring of 128-row tiles (3 to 8
//     stages, as shared memory allows) with one cp.async.bulk per tile and
//     one for the tile's 128 row terms; each stage has a "full" mbarrier,
//     which the copy completes, and an "empty" one, at which every
//     consumer warp arrives once its fragments are in registers;
//   - the product is turned round: A is 64 corpus rows, a slab (half a
//     tile; the warpgroups take the slabs in turn), read from the stage
//     into registers (int8 codes are converted to bf16 there, once per
//     warpgroup), B is the block's NQ queries, staged once in shared
//     memory in the K-major 128-byte-swizzled layout, and
//     wgmma.mma_async m64nNQk16 accumulates [64 rows x NQ queries] in
//     f32 registers. The warpgroups run free of each other, so one's
//     epilogue overlaps another's wgmma;
//   - a thread reads 16 bytes of a row at a time, which are not the k
//     positions the A fragment of its lane wants; the wrapper lays the
//     queries' columns down in the matching order (wgmma_k_order in
//     ops/scan.py), so every dot product is unchanged;
//   - the group term gt [B, N / 128] is read 8 tiles at a time (16 bytes
//     of bf16 or 32 of f32 per query) by the group-term warp into a ring
//     of two slots that already holds qn + gt;
//   - selection is a threshold filter with one buffer of `cap` slots per
//     query, shared by the warpgroups: a score below the query's
//     threshold reserves a slot with atomicAdd and writes (score, row)
//     there; a thread that finds the buffer full keeps its score in a
//     pending list, and its warp sorts the buffer under a per-query lock
//     (waiting until every reserved slot is written), cuts it to K and
//     lowers the threshold; the warp then tries again. A sort stalls only
//     the warps that have a score for that very query. The splits of a
//     query share a bound through device memory (shared_bound), so that
//     each does not warm up a whole top-K of its own;
//   - the warm start, where every split's best row alone makes that bound
//     (S >= K: batches of up to 256 over enough rows): the first slot of
//     the ring scans tile 0 only to publish each query's best row of it,
//     the group-term warp (free without a group term; else each consumer
//     warp, once) lowers the thresholds once the bound exists, and tile 0
//     comes again as the last slot. Measured at B = 48 over 1M x 128
//     rows on an H100 (tools/probe_scan_stages.py --k1-ring): appends a
//     launch 1,083,766 -> 276,728, sorts 27,097 -> 151.
// Wide rows (KS = 0: D = 80, 112 and 144 to 1,024; GIST-1M is 960, text
// embeddings 768). At D = 960 a whole 128-row tile is 245,760 bytes of bf16
// and 128 staged queries as much again, over the 232,448 a block may use,
// and the A fragments of all D / 16 k-steps would take 240 registers. So a
// ring stage is one (tile, chunk) piece: 128 rows x 128 bytes (64 bf16 or
// 128 int8 dims, 16 KB), copied by one 2-D TMA load (cp.async.bulk.tensor,
// a tensor map over [N, D]: rows past N and dims past D arrive as zeros,
// so a ragged tile or a last chunk narrower than 128 bytes needs no other
// care). A consumer loads its slab's fragments 64 dims (4 k-steps) at a
// time and waits for their wgmmas before the next load (the other two
// warpgroups' loads and epilogues fill the wait); the accumulators carry
// across the chunks: scoring and selection run once a tile. The queries
// stay resident in shared memory, zero-padded to whole chunks, so a block
// takes at most 128 of them up to D = 320 and 64 up to 1,024 (ops/scan.py
// wgmma_width): a 1,000-query batch at D = 960 is 16 query blocks, each
// streaming the rows through L2 (30.7 GB at 1M x 960), which is the bound
// of this design above a few hundred queries; at small batches it is the
// 1.92 GB of rows over device memory, as for narrow rows. One instantiation
// a block width serves every wide D (the chunk count is a runtime bound).
// The whole-tile loop stays for D = 64, 96 and 128: forced through the
// chunked loop (LONGBOW_PROBE_CHUNKED; tools/probe_scan_variants.py
// --chunked-narrow, H100 SXM at 700 W), K1 over 1M x 128 rows took 0.96 to
// 1.01 times its whole-tile time at B = 1, 48 and 1,000, but K2 over
// 10,240,000 x 96 codes 1.35 times at B = 1 and 1.21 at 1,000: 96 int8 dims
// fill only 96 of a chunk's 128 bytes, and the wgmmas run all 128.
// With 14 warps a thread may use 144 registers, and the kernels need 125 at
// most (NQ = 128; 70 to 112 narrower), so setmaxnreg is not needed. The
// LONGBOW_PROBE_* names compile stages of the loop out, or count appends
// and sorts, for tools/probe_scan_stages.py (LONGBOW_PROBE_CHUNKED sends
// every width to the chunked loop, for probe_scan_variants.py);
// LONGBOW_WGROUPS (2 or 3) and LONGBOW_WCAP are its knobs.
#pragma once

#include <cuda.h>            // CUtensorMap
#include <cudaTypedefs.h>    // PFN_cuTensorMapEncodeTiled_v12000

#include "scan_common.cuh"

namespace {

constexpr int kWT = 128;          // corpus rows per tile (one group of the group term)
constexpr int kWMaxK = 64;        // largest K this variant takes
#ifndef LONGBOW_WGROUPS
#define LONGBOW_WGROUPS 3
#endif
constexpr int kWGroups = LONGBOW_WGROUPS;       // consumer warpgroups
constexpr int kWCopyWarp = 4 * kWGroups;        // then the group-term (or bound) warp
constexpr int kWThreads = 32 * (4 * kWGroups + 2);
// the warm start's longest wait for the other splits' first slots (they all
// run in one wave, so it ends sooner; this bounds a launch that does not)
constexpr long long kWBoundWaitCycles = 200000;
constexpr int kWMaxStages = 8;
constexpr int kWPieceRow = 128;             // bytes of a row in a wide stage (one chunk)
constexpr int kWPiece = kWT * kWPieceRow;   // a wide stage: 16 KB
constexpr int kWMaxDim = 1024;              // widest D the chunked loop is sized for
constexpr int kWWide = 0;                   // the KS of the chunked loop
#ifndef LONGBOW_WCAP
#define LONGBOW_WCAP 128
#endif
constexpr int kWCapMost = LONGBOW_WCAP;   // most candidate slots per query (a multiple of 8, <= 128)
constexpr int kWGtTiles = 8;      // tiles per slot of the group-term ring
constexpr int kWLocked = 1 << 30; // a buffer's count while it is being sorted
constexpr int kWMaxSplits = 256;  // splits a query's shared bound is taken over
constexpr unsigned kFullWarp = 0xffffffffu;

#ifdef LONGBOW_PROBE_COUNT
// timing probe: appends and sorts of every launch, read by the probe tool
__device__ unsigned long long g_probe_counts[2];
#endif

struct WScanArgs {
  CUtensorMap rows_map; // the chunked loop's tensor map over rows [N, D] (box 128 x 128 bytes)
  const void* q;        // [B, D] bf16, columns in wgmma_k_order (chunked: [B, Dp], wgmma_layout)
  const float* qn;      // [B]
  const void* rows;     // [N, D] int8 or bf16
  const float* vn;      // [ceil(N / 128) * 128] row terms, MASKED past N
  const void* gt;       // [B, G] f32 (gt_kind 1) or bf16 (2), unused when 0
  int gt_kind, G, B, N, K, rows_per_split, stages, cap;
  int Dp;               // the chunked loop's query width: D padded to whole chunks
  float alpha;          // score = qn + alpha q.v + vn (+ gt)
  unsigned split_guard; // ordered_bits(MASKED_GUARD): split_best's fill
  unsigned* split_best; // [B, S], ordered_bits(MASKED_GUARD) at launch: see shared_bound;
                        // then one counter a query block, at the same value:
                        // consumer warps past the warm start's first slot
  float* out_d;         // [B, S, K]
  int* out_i;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait until the barrier has left the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global to shared; completes on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A box of the 2-D tensor map at (column c0, row c1) into shared memory;
// completes on `bar` with the box's full bytes (out-of-bounds parts are
// zero-filled)
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// 128 threads of one warpgroup: D[64 x NQ] (+)= A[64 x 16] B[16 x NQ] for
// NQ = 2 x (the accumulator's length) in {16, 32, 64, 128}, A from this
// thread's registers (the A fragment of mma.sync m16n8k16 for its warp's
// 16 rows), B from shared memory through a descriptor
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Descriptor of a K-major operand in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1,024 bytes apart, start address 1,024-aligned
// (+ 32 bytes per k-step inside the 128-byte row).
__device__ __forceinline__ uint64_t swizzled_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// The A fragments of all KS k-steps for this lane: p0 and p1 point at its
// two rows (g and g + 8 of the warp's 16) in the stage, t = lane & 3.
// int8 rows: a 16-byte load covers four k-steps (word s holds dims
// 16 t + 4 s .. + 3 of a 64-dim block), an 8-byte load two, a 4-byte load
// one. Register 0 / 2 of a k-step take the word's lower / upper pair.
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const int8_t* p0, const int8_t* p1,
                                       int t) {
#pragma unroll
  for (int b = 0; b < KS / 4; ++b) {
    const uint4 w0 = *reinterpret_cast<const uint4*>(p0 + 64 * b + 16 * t);
    const uint4 w1 = *reinterpret_cast<const uint4*>(p1 + 64 * b + 16 * t);
    bytes_to_bf16(w0.x, a[4 * b][0], a[4 * b][2]);
    bytes_to_bf16(w1.x, a[4 * b][1], a[4 * b][3]);
    bytes_to_bf16(w0.y, a[4 * b + 1][0], a[4 * b + 1][2]);
    bytes_to_bf16(w1.y, a[4 * b + 1][1], a[4 * b + 1][3]);
    bytes_to_bf16(w0.z, a[4 * b + 2][0], a[4 * b + 2][2]);
    bytes_to_bf16(w1.z, a[4 * b + 2][1], a[4 * b + 2][3]);
    bytes_to_bf16(w0.w, a[4 * b + 3][0], a[4 * b + 3][2]);
    bytes_to_bf16(w1.w, a[4 * b + 3][1], a[4 * b + 3][3]);
  }
  if constexpr (KS % 4 >= 2) {
    constexpr int k0 = KS / 4 * 4;
    const uint2 w0 = *reinterpret_cast<const uint2*>(p0 + 16 * k0 + 8 * t);
    const uint2 w1 = *reinterpret_cast<const uint2*>(p1 + 16 * k0 + 8 * t);
    bytes_to_bf16(w0.x, a[k0][0], a[k0][2]);
    bytes_to_bf16(w1.x, a[k0][1], a[k0][3]);
    bytes_to_bf16(w0.y, a[k0 + 1][0], a[k0 + 1][2]);
    bytes_to_bf16(w1.y, a[k0 + 1][1], a[k0 + 1][3]);
  }
  if constexpr (KS % 2 == 1) {
    constexpr int k0 = KS - 1;
    bytes_to_bf16(*reinterpret_cast<const uint32_t*>(p0 + 16 * k0 + 4 * t), a[k0][0], a[k0][2]);
    bytes_to_bf16(*reinterpret_cast<const uint32_t*>(p1 + 16 * k0 + 4 * t), a[k0][1], a[k0][3]);
  }
}

// bf16 rows: a 16-byte load covers two k-steps (words 2 s, 2 s + 1 hold
// dims 8 t + 4 s .. + 3 of a 32-dim block), an 8-byte load one.
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const __nv_bfloat16* p0,
                                       const __nv_bfloat16* p1, int t) {
#pragma unroll
  for (int b = 0; b < KS / 2; ++b) {
    const uint4 w0 = *reinterpret_cast<const uint4*>(p0 + 32 * b + 8 * t);
    const uint4 w1 = *reinterpret_cast<const uint4*>(p1 + 32 * b + 8 * t);
    a[2 * b][0] = w0.x, a[2 * b][2] = w0.y, a[2 * b + 1][0] = w0.z, a[2 * b + 1][2] = w0.w;
    a[2 * b][1] = w1.x, a[2 * b][3] = w1.y, a[2 * b + 1][1] = w1.z, a[2 * b + 1][3] = w1.w;
  }
  if constexpr (KS % 2 == 1) {
    constexpr int k0 = KS - 1;
    const uint2 w0 = *reinterpret_cast<const uint2*>(p0 + 16 * k0 + 4 * t);
    const uint2 w1 = *reinterpret_cast<const uint2*>(p1 + 16 * k0 + 4 * t);
    a[k0][0] = w0.x, a[k0][2] = w0.y, a[k0][1] = w1.x, a[k0][3] = w1.y;
  }
}

// A candidate is one 64-bit word: the score's bits above the row id.
__device__ __forceinline__ unsigned long long pack_candidate(float sc, int row) {
  return (static_cast<unsigned long long>(__float_as_uint(sc)) << 32) |
         static_cast<unsigned int>(row);
}

// Per-query selection state in shared memory.
struct WSelect {
  unsigned long long* buf;   // [NQ, cap]
  float* thr;                // a score must lie below it to enter
  int* cnt;                  // slots reserved (kWLocked and above while sorting)
  int* wr;                   // slots written
  int* lock;
  int cap, K;
  unsigned* split_best;      // this block's queries' rows of WScanArgs::split_best
  int S, split;
};

// Reserve a slot of query q's buffer and write (score, row) there; false
// when the buffer is full or being sorted.
__device__ __forceinline__ bool try_append(const WSelect& s, int q, float sc, int row) {
  const int pos = atomicAdd(&s.cnt[q], 1);
  if (pos >= s.cap) return false;
  s.buf[q * s.cap + pos] = pack_candidate(sc, row);
  __threadfence_block();
  atomicAdd(&s.wr[q], 1);
#ifdef LONGBOW_PROBE_COUNT
  atomicAdd(&g_probe_counts[0], 1ull);
#endif
  return true;
}

// One warp sorts the first n <= 32 E entries of a buffer ascending.
template <int E>
__device__ __forceinline__ void sort_candidates(unsigned long long* b, int n, int lane) {
  float v[E];
  int id[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = r * 32 + lane;
    v[r] = __int_as_float(0x7f800000);
    id[r] = -1;
    if (i < n) {
      const unsigned long long w = b[i];
      v[r] = __uint_as_float(static_cast<unsigned int>(w >> 32));
      id[r] = static_cast<int>(static_cast<unsigned int>(w));
    }
  }
  bitonic_regs<E>(v, id, lane);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = r * 32 + lane;
    if (i < n) b[i] = pack_candidate(v[r], id[r]);
  }
  __syncwarp();
}

__device__ __forceinline__ void warp_sort128(unsigned long long* b, int n, int lane) {
  if (n <= 32) return sort_candidates<1>(b, n, lane);
  if (n <= 64) return sort_candidates<2>(b, n, lane);
  sort_candidates<4>(b, n, lane);
}

// A float's bits in an order that unsigned comparison keeps.
__device__ __forceinline__ unsigned ordered_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// The m-th smallest (1-based, m <= S <= 32 E) of a query's S published
// values (ordered bits): one warp builds the bits from the top, keeping a
// bit when fewer than m values lie below the prefix with it set (a count
// and a warp sum a bit).
template <int E>
__device__ unsigned mth_smallest(const volatile unsigned* best, int S, int m, int lane) {
  unsigned v[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = r * 32 + lane;
    v[r] = i < S ? best[i] : 0xffffffffu;
  }
  unsigned x = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned t = x | (1u << bit);
    int below = 0;
#pragma unroll
    for (int r = 0; r < E; ++r) below += v[r] < t;
    if (__reduce_add_sync(kFullWarp, below) < m) x = t;
  }
  return x;
}

// The bound on query q's K-th best of the whole corpus that its S splits
// share. Each split publishes its r-th best so far, r = ceil(K / S), in
// split_best[q][split] (as ordered bits, by atomicMin, so a value never
// grows); at least r rows of a split score at or below its value, so with
// m = ceil(K / r) the m-th smallest of the S values has at least m r >= K
// rows at or below it, and nothing above it can be among the K best. Until
// m splits have published it is MASKED_GUARD. Where r = 1 (S >= K, as at
// B = 1 over 1M rows: S = 131, m = 64, about the median split's best row
// so far, far below a split's own 64th best) the warp searches for it;
// where r > 1 it takes the largest value (m r >= K holds for m = S too), a
// warp maximum, as before the search was added: with the search there,
// rare launches on an H100 ran far slower than their median (300 and 384
// queries over 131,072 int8 codes).
// A stale read is only a looser bound.
__device__ float shared_bound(const WSelect& s, int q, int lane) {
  const int r = (s.K + s.S - 1) / s.S, m = (s.K + r - 1) / r;
  const volatile unsigned* best = s.split_best + (size_t)q * s.S;
  unsigned x;
  if (r > 1 || m == s.S) {
    x = 0;
    for (int i = lane; i < s.S; i += 32) x = max(x, best[i]);
    x = __reduce_max_sync(kFullWarp, x);
  } else if (s.S <= 128) {
    x = mth_smallest<4>(best, s.S, m, lane);
  } else {
    x = mth_smallest<kWMaxSplits / 32>(best, s.S, m, lane);
  }
  return from_ordered_bits(x);
}

// The calling warp takes query q's lock if it is free, closes the buffer
// to appends, waits until every reserved slot is written, sorts, keeps K,
// publishes its r-th best and lowers the threshold to the smaller of this
// split's own K-th best and the splits' shared bound (shared_bound).
__device__ void try_sort(const WSelect& s, int q, int lane) {
  int got = 0;
  if (lane == 0) got = atomicCAS(&s.lock[q], 0, 1) == 0;
  if (!__shfl_sync(kFullWarp, got, 0)) return;
#ifdef LONGBOW_PROBE_COUNT
  if (lane == 0) atomicAdd(&g_probe_counts[1], 1ull);
#endif
  int old = 0;
  if (lane == 0) old = atomicExch(&s.cnt[q], kWLocked);  // appends fail from here on
  const int n = min(__shfl_sync(kFullWarp, old, 0), s.cap);
  const int kept = min(n, s.K);
  while (*reinterpret_cast<volatile int*>(&s.wr[q]) < n) {
  }
  __threadfence_block();
  unsigned long long* b = s.buf + q * s.cap;
  warp_sort128(b, n, lane);
  float bound = kept == s.K ? __uint_as_float(static_cast<unsigned int>(b[s.K - 1] >> 32)) : kGuard;
  if (s.S > 1) {
    const int r = (s.K + s.S - 1) / s.S;
    const float mine = kept >= r ? __uint_as_float(static_cast<unsigned int>(b[r - 1] >> 32)) : kGuard;
    if (lane == 0 && mine < kGuard)
      atomicMin(s.split_best + (size_t)q * s.S + s.split, ordered_bits(mine));
    __syncwarp();
    bound = fminf(bound, shared_bound(s, q, lane));
  }
  if (lane == 0) {
    if (bound < *reinterpret_cast<volatile float*>(&s.thr[q]))
      *reinterpret_cast<volatile float*>(&s.thr[q]) = bound;
    *reinterpret_cast<volatile int*>(&s.wr[q]) = kept;
    __threadfence_block();
    atomicExch(&s.cnt[q], kept);
    atomicExch(&s.lock[q], 0);
  }
  __syncwarp();
}

// The warm start: wait (one warp, converged) until every consumer warp of
// the query block's S splits has published its first slot, or
// kWBoundWaitCycles have passed.
__device__ void wait_for_splits(const volatile unsigned* counter, unsigned want, int lane) {
  const long long t0 = clock64();
  while (!__shfl_sync(kFullWarp, *counter == want || clock64() - t0 > kWBoundWaitCycles, 0))
    __nanosleep(100);
  __threadfence();   // the publishes the count stood for are seen before the bound is read
}

// Elem is int8_t (K2) or __nv_bfloat16 (K1); KS = D / 16 k-steps, or
// kWWide for the chunked loop (D runtime); NQ queries per block (16, 32,
// 64 or 128).
template <class Elem, int KS, int NQ>
__global__ void __launch_bounds__(kWThreads, 1)
    scan_wgmma_kernel(const __grid_constant__ WScanArgs p) {
  static_assert(NQ == 16 || NQ == 32 || NQ == 64 || NQ == 128,
                "a width wgmma_rs is written for");
  constexpr bool kWide = KS == kWWide;
  constexpr int kElem = static_cast<int>(sizeof(Elem));
  constexpr int kCE = kWPieceRow / kElem;         // dims a chunk (wide): 64 bf16, 128 int8
  constexpr int KSR = kWide ? 4 : KS;             // k-steps of one register load (wide: 64 dims)
  constexpr int kSub = kWide ? kCE / 64 : 1;      // register loads a stage: 1 bf16, 2 int8
  const int D = kWide ? p.Dp : KS * 16;           // the query operand's width
  const int nch = kWide ? p.Dp / kCE : 1;         // pieces (chunks) a tile
  const int nsub = nch * kSub;                    // register loads a tile
  const int kTileBytes = kWide ? kWPiece : kWT * KS * 16 * kElem;   // a ring stage
  const int kQBlocks = (D / 16 + 3) / 4;          // 64-dim blocks of the query operand
  constexpr int kQBlockBytes = NQ * 128;          // a multiple of 1,024: each block stays aligned
  constexpr int kAcc = NQ / 2;                    // accumulators a thread

  extern __shared__ unsigned char smem_raw[];
  // the swizzled operand wants its base 1,024-aligned
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* q_s = smem;
  unsigned char* ring = q_s + kQBlocks * kQBlockBytes;
  float* vn_ring = reinterpret_cast<float*>(ring + p.stages * kTileBytes);
  float* qg_ring = vn_ring + p.stages * kWT;      // [2][kWGtTiles][NQ], qn + gt
  unsigned long long* buf =
      reinterpret_cast<unsigned long long*>(qg_ring + (p.gt_kind ? 2 * kWGtTiles * NQ : 0));
  float* qn_s = reinterpret_cast<float*>(buf + NQ * p.cap);
  float* thr_s = qn_s + NQ;
  int* cnt_s = reinterpret_cast<int*>(thr_s + NQ);
  int* wr_s = cnt_s + NQ;
  int* lock_s = wr_s + NQ;
  float* qg0_s = reinterpret_cast<float*>(lock_s + NQ);  // qn + tile 0's group term
  int* flags = reinterpret_cast<int*>(qg0_s + NQ);  // [0] the warm start's bound is in place, [1] consumer warps done
  uint64_t* bars = reinterpret_cast<uint64_t*>(flags + 2);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kWMaxStages;
  const uint32_t gt_full0 = empty0 + 8 * kWMaxStages, gt_empty0 = gt_full0 + 16;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * NQ;
  const int S = gridDim.y, split = blockIdx.y;
  const int row_begin = split * p.rows_per_split;
  const int row_end = min(p.N, row_begin + p.rows_per_split);
  const int ntiles = row_end > row_begin ? (row_end - row_begin + kWT - 1) / kWT : 0;
  const int grp0 = row_begin / kWT;               // the first tile's group
  // The warm start, where shared_bound's r is 1 (S >= K): the ring's first
  // slot is tile 0 scanned only to publish each query's best row of it, so
  // that the splits share a bound before any of them appends; tile 0 comes
  // again as the last slot, an ordinary tile then (a score is published one
  // ulp above its row's, so that row passes the strict threshold test).
#ifdef LONGBOW_PROBE_NO_WARM
  const bool warm = false;
#else
  const bool warm = S >= p.K && ntiles > 0;
#endif
  const int nslots = ntiles + (warm ? 1 : 0);    // slot i holds tile (i < ntiles ? i : 0)
  // the query block's count of consumer warps past the first slot (it
  // starts at ordered_bits(MASKED_GUARD), the fill of split_best; the 8
  // warps of the first slot's two slabs count in each split)
  unsigned* const split_counter = p.split_best + (size_t)p.B * S + blockIdx.x;
  const unsigned counted_splits = p.split_guard + 8u * S;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * kWGroups);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(gt_full0 + 8 * s, 1);
      mbar_init(gt_empty0 + 8 * s, 8 * kWGtTiles);  // a warp arrives once per slab
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the block's queries, 16 bytes at a time, into the swizzled layout:
  // chunk c of row n lies at chunk (c ^ (n & 7)) of its 128-byte row
  for (int idx = tid; idx < NQ * (D / 8); idx += kWThreads) {
    const int n = idx / (D / 8), c = idx % (D / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + n < p.B)
      v = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.q) +
                                          (size_t)(q0 + n) * D + c * 8);
    *reinterpret_cast<uint4*>(q_s + (c / 8) * kQBlockBytes + n * 128 +
                              (((c & 7) ^ (n & 7)) << 4)) = v;
  }
  for (int r = tid; r < NQ; r += kWThreads) {
    const bool real = q0 + r < p.B;
    qn_s[r] = real ? p.qn[q0 + r] : 0.0f;
    thr_s[r] = real ? kGuard : -kMasked;   // a padding query takes no score
    cnt_s[r] = 0;
    wr_s[r] = 0;
    lock_s[r] = 0;
  }
  if (tid < 2) flags[tid] = 0;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma reads q_s
  __syncthreads();

  if (warp == kWCopyWarp) {
    // ---- the copy warp: one lane keeps the ring full
    if (lane == 0) {
      const Elem* rows = static_cast<const Elem*>(p.rows);
      // piece = slot * nch + chunk; a tile's row terms come with its first chunk
      for (int piece = 0; piece < nslots * nch; ++piece) {
        const int s = piece % p.stages, slot = piece / nch, c = piece % nch;
        if (piece >= p.stages) mbar_wait(empty0 + 8 * s, ((piece / p.stages) - 1) & 1);
        const int row0 = row_begin + (slot < ntiles ? slot : 0) * kWT;
        if constexpr (kWide) {
          mbar_expect_tx(full0 + 8 * s, kWPiece + (c == 0 ? kWT * 4 : 0));
          tma_load_2d(smem_u32(ring + s * kTileBytes), &p.rows_map, c * kCE, row0, full0 + 8 * s);
        } else {
          const int bytes = min(kWT, p.N - row0) * KS * 16 * kElem;  // the ragged last tile copies less
          mbar_expect_tx(full0 + 8 * s, bytes + kWT * 4);
          bulk_copy(smem_u32(ring + s * kTileBytes), rows + (size_t)row0 * D, bytes, full0 + 8 * s);
        }
        if (c == 0) bulk_copy(smem_u32(vn_ring + s * kWT), p.vn + row0, kWT * 4, full0 + 8 * s);
      }
    }
  } else if (warp == kWCopyWarp + 1) {
    // ---- the group-term warp: qn + gt of the split's tiles
    // 8 i .. 8 i + 7 into slot i & 1; a lane takes every 32nd query and reads
    // each one's eight values with one or two 16-byte loads where the
    // addresses allow (wgmma_plan makes a split start at a multiple of 8
    // groups), else one by one.
    // Without a group term it is the bound warp (the warm start): once
    // every split of the query block has published its first slot
    // (wait_for_splits) it lowers each query's threshold to the splits'
    // shared bound and tells the consumers, who wait for that before their
    // second slot; then it lowers them again every few microseconds until
    // the consumers are done.
    if (!p.gt_kind) {
      if (warm) {
        const WSelect sel{buf, thr_s, cnt_s, wr_s, lock_s, p.cap, p.K,
                          p.split_best + (size_t)q0 * S, S, split};
        volatile int* vflags = flags;
        wait_for_splits(split_counter, counted_splits, lane);
        // every decision below is lane 0's, so the warp stays converged
        for (bool first = true; first || __shfl_sync(kFullWarp, vflags[1], 0) < 4 * kWGroups;
             first = false) {
          for (int ql = 0; ql < NQ && q0 + ql < p.B; ++ql) {
            const float x = shared_bound(sel, ql, lane);
            if (lane == 0 && x < *reinterpret_cast<volatile float*>(&thr_s[ql]))
              *reinterpret_cast<volatile float*>(&thr_s[ql]) = x;
          }
          __syncwarp();
          if (first && lane == 0) vflags[0] = 1;
          __nanosleep(2000);
        }
      }
    } else {
      const int esize = p.gt_kind == 1 ? 4 : 2;
      const bool vec = ((size_t)p.G * esize) % 16 == 0 && grp0 % kWGtTiles == 0 &&
                       reinterpret_cast<uintptr_t>(p.gt) % 16 == 0;
      const int nchunks = (ntiles + kWGtTiles - 1) / kWGtTiles;
      for (int i = 0; i < nchunks; ++i) {
        const int slot = i & 1;
        if (i >= 2) mbar_wait(gt_empty0 + 8 * slot, ((i >> 1) - 1) & 1);
        const int gbase = grp0 + i * kWGtTiles;
        float* dst = qg_ring + slot * kWGtTiles * NQ;
#pragma unroll
        for (int q = lane; q < NQ; q += 32) {
          float v[kWGtTiles];
#pragma unroll
          for (int j = 0; j < kWGtTiles; ++j) v[j] = 0.0f;
          if (q0 + q < p.B) {
            const size_t at = (size_t)(q0 + q) * p.G + gbase;
            if (vec && gbase + kWGtTiles <= p.G) {
              if (p.gt_kind == 1) {
                const float4* src = reinterpret_cast<const float4*>(
                    static_cast<const float*>(p.gt) + at);
                const float4 lo = __ldg(src), hi = __ldg(src + 1);
                v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
                v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
              } else {
                const uint4 w = __ldg(reinterpret_cast<const uint4*>(
                    static_cast<const __nv_bfloat16*>(p.gt) + at));
                const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  v[2 * j] = __uint_as_float(ws[j] << 16);
                  v[2 * j + 1] = __uint_as_float(ws[j] & 0xffff0000u);
                }
              }
            } else {
#pragma unroll
              for (int j = 0; j < kWGtTiles; ++j) {
                if (gbase + j < p.G)
                  v[j] = p.gt_kind == 1
                             ? static_cast<const float*>(p.gt)[at + j]
                             : __bfloat162float(static_cast<const __nv_bfloat16*>(p.gt)[at + j]);
              }
            }
          }
          const float qn = qn_s[q];
#pragma unroll
          for (int j = 0; j < kWGtTiles; ++j) dst[j * NQ + q] = qn + v[j];
          if (i == 0) qg0_s[q] = qn + v[0];  // for the warm start's last slot
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(gt_full0 + 8 * slot);
      }
    }
  } else {
    // ---- the consumers. A tile is two 64-row slabs; slab number
    // 2 tile + half goes to warpgroup (slab % kWGroups). This lane holds
    // rows r0 and r1 of its slab against queries 8 j + 2 t, 8 j + 2 t + 1
    // (j < NQ / 8): acc[4 j + 2 (row) + (query)]
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const WSelect sel{buf, thr_s, cnt_s, wr_s, lock_s, p.cap, p.K,
                      p.split_best + (size_t)q0 * S, S, split};
    const uint64_t desc0 = swizzled_desc(smem_u32(q_s));
    int gt_chunk = -1;   // the last slot-sized chunk of tiles whose group term was waited for
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

    for (int slot = 0; slot < nslots; ++slot) {
      const int tile = slot < ntiles ? slot : 0;
      const bool publish = warm && slot == 0, revisit = slot == ntiles;
      if (warm && slot == 1) {
        if (!p.gt_kind) {
          // the bound warp has lowered the thresholds (or given up waiting)
          while (!*reinterpret_cast<volatile int*>(&flags[0])) __nanosleep(100);
        } else {
          // beside a group term no warp is free to: each consumer warp waits
          // for the splits itself and lowers its own queries' thresholds
          wait_for_splits(split_counter, counted_splits, lane);
          for (int ql = warp; ql < NQ; ql += 4 * kWGroups) {
            if (q0 + ql >= p.B) continue;
            const float x = shared_bound(sel, ql, lane);
            if (lane == 0 && x < *reinterpret_cast<volatile float*>(&thr_s[ql]))
              *reinterpret_cast<volatile float*>(&thr_s[ql]) = x;
          }
          __syncwarp();
        }
      }
      // every warp waits for every piece of a slot and arrives at its
      // "empty" barrier, whether or not its warpgroup has a slab there: a
      // stage is not filled again before every thread has seen this phase
      // of it
      const int half = (wg + kWGroups - (2 * slot) % kWGroups) % kWGroups;
      if (half > 1) {
        for (int piece = slot * nch; piece < (slot + 1) * nch; ++piece) {
          const int s = piece % p.stages;
          mbar_wait(full0 + 8 * s, (piece / p.stages) & 1);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * s);
        }
        continue;
      }
      const int r0 = half * 64 + (warp & 3) * 16 + g, r1 = r0 + 8;
      float vn0 = 0.0f, vn1 = 0.0f;
      // Register load u of the slot's tile (the whole tile when not wide;
      // else 64 dims, one block of the query operand, kSub of them a
      // piece): wait for its piece, take the fragments into registers, free
      // the stage after its last load, run the wgmmas of its k-steps. The
      // accumulators carry across the loads. A wide load waits for its
      // wgmmas before the registers are loaded again: two register sets
      // with a group left in flight across the loop (wait_group 1) gave
      // some queries wrong products (K1, D = 144 to 960, B >= 100, H100).
      uint32_t a[KSR][4];
      for (int u = 0; u < nsub; ++u) {
        const int piece = slot * nch + u / kSub, s = piece % p.stages, j = u % kSub;
        if (j == 0) mbar_wait(full0 + 8 * s, (piece / p.stages) & 1);
        if (u == 0) vn0 = vn_ring[s * kWT + r0], vn1 = vn_ring[s * kWT + r1];
        const Elem* st = reinterpret_cast<const Elem*>(ring + s * kTileBytes) + j * 64;
        const int pitch = kWide ? kCE : D;
        load_a<KSR>(a, st + r0 * pitch, st + r1 * pitch, t);
        // Free the stage only after the last of its loads (K2 loads an int8
        // stage twice): freed before the second had read it, the stage's
        // next piece landed in those 64 dims first (wrong K2 scores at
        // D = 768 and 896, B >= 100, on the H100).
        if (j == kSub - 1) {   // this warp's part of the stage is in registers
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * s);
        }
#ifdef LONGBOW_PROBE_NO_MMA
#pragma unroll
        for (int ks = 0; ks < KSR; ++ks)
          acc[ks] = __uint_as_float(a[ks][0] ^ a[ks][1] ^ a[ks][2] ^ a[ks][3]);
#else
        const uint64_t desc = desc0 + ((u * kQBlockBytes) >> 4);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KSR; ++ks)
          wgmma_rs(acc, a[ks], desc + (((ks / 4) * kQBlockBytes + (ks % 4) * 32) >> 4),
                   u > 0 || ks > 0);
        wgmma_commit();
        if (kWide) wgmma_wait_all();
#endif
      }

      // qn (+ the tile's group term) per query; the revisited tile 0 has
      // its own copy, its ring slot long refilled
      const float* qg = p.gt_kind && revisit ? qg0_s : qn_s;
      const int chunk = tile / kWGtTiles;
      if (p.gt_kind && !revisit) {
        if (chunk != gt_chunk) mbar_wait(gt_full0 + 8 * (chunk & 1), (chunk >> 1) & 1);
        gt_chunk = chunk;
        qg = qg_ring + ((chunk & 1) * kWGtTiles + tile % kWGtTiles) * NQ;
      }
#ifndef LONGBOW_PROBE_NO_MMA
      wgmma_wait_all();
#endif
#pragma unroll
      for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(acc[i])::"memory");
      const int rbase = row_begin + tile * kWT;
      if (rbase + kWT > p.N) {
        // the ragged last tile: rows past N hold what the stage held before
#pragma unroll
        for (int i = 0; i < kAcc; ++i)
          if (rbase + ((i & 2) ? r1 : r0) >= p.N) acc[i] = 0.0f;
      }

      // Scores against thresholds, four at a time (two queries x two
      // rows). The few that pass go to this thread's pending list, which
      // lives in local memory and is touched on that path only, so that the
      // accumulators stay in registers and the common path stays short
      // (appending from each of the 64 places at NQ = 128, inline or
      // through a call, measured four times slower).
      int npend = 0;
      float pend_sc[kAcc];
      int pend_at[kAcc];   // (row in the tile << 8) | query
#ifdef LONGBOW_PROBE_NO_EPILOGUE
      {   // timing probe: the products stay live, nothing is selected
        float keep = vn0 + vn1 + qg[lane];
#pragma unroll
        for (int i = 0; i < kAcc; ++i) keep += acc[i];
        if (keep == 1.2345e-30f) thr_s[0] = keep;
      }
#else
      if (publish) {
        // the warm start's first slot: each query's best row of the warp's
        // 16, published by the g = 0 lanes
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j) {
          const float2 qq = *reinterpret_cast<const float2*>(qg + 8 * j + 2 * t);
          float best2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float qe = e ? qq.y : qq.x;
            best2[e] = fminf(fmaf(p.alpha, acc[4 * j + e], qe) + vn0,
                             fmaf(p.alpha, acc[4 * j + 2 + e], qe) + vn1);
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
              best2[e] = fminf(best2[e], __shfl_xor_sync(kFullWarp, best2[e], off));
            const int q = 8 * j + 2 * t + e;
            // one ulp above the row's score, so that the strict threshold
            // test of the last slot still takes the row
            if (g == 0 && q0 + q < p.B && best2[e] < kGuard)
              atomicMin(sel.split_best + (size_t)q * S + split,
                        ordered_bits(nextafterf(best2[e], kMasked)));
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j) {
          const float2 qq = *reinterpret_cast<const float2*>(qg + 8 * j + 2 * t);
          const float2 th = *reinterpret_cast<const float2*>(thr_s + 8 * j + 2 * t);
          float sc[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[e] = fmaf(p.alpha, acc[4 * j + e], (e & 1) ? qq.y : qq.x) + ((e & 2) ? vn1 : vn0);
          bool hit = fminf(sc[0], sc[2]) < th.x || fminf(sc[1], sc[3]) < th.y;
#ifdef LONGBOW_PROBE_NO_SELECT
          if (sc[0] + sc[1] + sc[2] + sc[3] == 1.2345e-30f) thr_s[0] = sc[0];
          hit = false;
#endif
          if (__builtin_expect(hit, 0)) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (sc[e] < ((e & 1) ? th.y : th.x)) {
#ifdef LONGBOW_PROBE_NO_APPEND   // timing probe: the test is made, nothing is kept
                thr_s[NQ - 1] = sc[e];
#else
                pend_sc[npend] = sc[e];
                pend_at[npend++] = (((e & 2) ? r1 : r0) << 8) | (8 * j + 2 * t + (e & 1));
#endif
              }
            }
          }
        }
      }
#endif
      if (p.gt_kind && !revisit) {
        __syncwarp();
        if (lane == 0) mbar_arrive(gt_empty0 + 8 * (chunk & 1));
      }
      if (publish) {   // this warp's first slot is published
        __syncwarp();
        if (lane == 0) {
          __threadfence();
          atomicAdd(split_counter, 1u);
        }
      }

      // Each pending score reserves a slot of its query's buffer. One that
      // finds the buffer full (or being sorted) stays pending; the warp
      // then sorts the full buffers (or waits for the warp that does) and
      // tries again.
      for (bool again = false; __any_sync(kFullWarp, npend != 0); again = true) {
        if (again) {
          for (int qb = 0; qb < NQ; qb += 32) {
            unsigned fullq = __ballot_sync(
                kFullWarp,
                qb + lane < NQ && *reinterpret_cast<volatile int*>(&cnt_s[qb + lane]) >= p.cap);
            while (fullq) {
              const int q = qb + __ffs(fullq) - 1;
              fullq &= fullq - 1;
              try_sort(sel, q, lane);
            }
          }
        }
        int left = 0;
        for (int i = 0; i < npend; ++i) {
          const float sc = pend_sc[i];
          const int at = pend_at[i], q = at & 255;
          if (sc < *reinterpret_cast<volatile float*>(&thr_s[q]) &&
              !try_append(sel, q, sc, rbase + (at >> 8))) {
            pend_sc[left] = sc;
            pend_at[left++] = at;
          }
        }
        npend = left;
      }
    }

    if (lane == 0) atomicAdd(&flags[1], 1);   // the bound warp may stop
    // every consumer is done with every buffer: each warp finishes its queries
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWGroups * 128) : "memory");
    for (int ql = warp; ql < NQ; ql += 4 * kWGroups) {
      if (q0 + ql >= p.B) continue;
      const int n = min(cnt_s[ql], p.cap);
      const int kept = min(n, p.K);
      const unsigned long long* b = buf + ql * p.cap;
      warp_sort128(buf + ql * p.cap, n, lane);
      const size_t base = ((size_t)(q0 + ql) * S + split) * p.K;
      for (int j = lane; j < p.K; j += 32) {
        p.out_d[base + j] =
            j < kept ? __uint_as_float(static_cast<unsigned int>(b[j] >> 32)) : kMasked;
        p.out_i[base + j] = j < kept ? static_cast<int>(static_cast<unsigned int>(b[j])) : -1;
      }
    }
  }
}

// Shared memory of a block of `nq` queries with `q_blocks` 64-dim blocks
// of them, `stages` ring stages of `stage_bytes` (and 128 row terms each)
// and `cap` slots per query.
inline int wscan_smem(int q_blocks, int nq, int stages, int stage_bytes, int cap, int has_gt) {
  return 1024 + q_blocks * nq * 128 + stages * (stage_bytes + kWT * 4) +
         (has_gt ? 2 * kWGtTiles * nq * 4 : 0) + nq * cap * 8 + nq * 24 + 8 +
         (2 * kWMaxStages + 4) * 8;
}

// cuTensorMapEncodeTiled from the driver, looked up once (no -lcuda)
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f)
               : nullptr;
  }();
  return fn;
}

// The chunked loop's tensor map over rows [N, D]: boxes of 128 rows x
// 128 bytes, no swizzle, zeros out of bounds. Returns 0 or -3.
template <class Elem>
int encode_rows_map(CUtensorMap* map, const void* rows, int N, int D) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return -3;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(N > 0 ? N : 1)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * sizeof(Elem)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kWPieceRow / sizeof(Elem)),
                             static_cast<cuuint32_t>(kWT)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, sizeof(Elem) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(rows), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

// Choose stages and cap and launch. Returns a cudaError_t, -1 when the
// shape is not one of this variant's, -2 when shared memory is too small,
// -3 when the chunked loop's tensor map cannot be made.
template <class Elem, int KS, int NQ>
int wscan_launch(WScanArgs a, int D, int device, int S, cudaStream_t stream) {
  constexpr bool kWide = KS == kWWide;
  float guard = kGuard;   // ordered_bits(kGuard) on the host: a positive float
  std::memcpy(&a.split_guard, &guard, sizeof(guard));
  a.split_guard |= 0x80000000u;
  int max_smem = 0;
  cudaError_t e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  const int chunk_dims = kWPieceRow / static_cast<int>(sizeof(Elem));
  a.Dp = kWide ? (D + chunk_dims - 1) / chunk_dims * chunk_dims : D;
  const int q_blocks = (a.Dp / 16 + 3) / 4;
  const int stage_bytes = kWide ? kWPiece : kWT * D * static_cast<int>(sizeof(Elem));
  if (kWide) {
    const int err = encode_rows_map<Elem>(&a.rows_map, a.rows, a.N, D);
    if (err != 0) return err;
  }
  // the roomiest buffers that leave a ring of four stages, else of three
  // (measured at 10,240,000 x 96, B = 1,000: 128 slots and 4 stages beat
  // 112 and 5, which beat 96 and 6; a sort retires cap - K appends); a
  // narrow block's buffers are small, so it keeps 128 slots and takes up
  // to kWMaxStages stages
  bool found = false;
  for (int want = 4; want >= 3 && !found; --want) {
    a.stages = 0;
    for (int cap = kWCapMost; cap >= a.K + 16 && a.stages < want; cap -= 8) {
      const int fixed = wscan_smem(q_blocks, NQ, 0, stage_bytes, cap, a.gt_kind != 0);
      const int stages = (max_smem - fixed) / (stage_bytes + kWT * 4);
      a.cap = cap;
      a.stages = stages < kWMaxStages ? stages : kWMaxStages;
    }
    found = a.stages >= want;
  }
  if (!found) return -2;
  const int smem = wscan_smem(q_blocks, NQ, a.stages, stage_bytes, a.cap, a.gt_kind != 0);
  auto kern = scan_wgmma_kernel<Elem, KS, NQ>;
  e = allow_smem(reinterpret_cast<const void*>(kern), device, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.B + NQ - 1) / NQ, S);
  kern<<<grid, kWThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class Elem, int KS>
int wscan_width(const WScanArgs& a, int D, int nq, int device, int S, cudaStream_t stream) {
  switch (nq) {
    case 16: return wscan_launch<Elem, KS, 16>(a, D, device, S, stream);
    case 32: return wscan_launch<Elem, KS, 32>(a, D, device, S, stream);
    case 64: return wscan_launch<Elem, KS, 64>(a, D, device, S, stream);
    case 128: return wscan_launch<Elem, KS, 128>(a, D, device, S, stream);
    default: return -1;
  }
}

// D must be a multiple of 16 from 64 to kWMaxDim (64, 96 and 128 stage
// whole tiles, every other width runs the chunked loop) and nq 16, 32, 64
// or 128 (the instantiated widths).
template <class Elem>
int wscan_dispatch(const WScanArgs& a, int D, int nq, int device, int S, cudaStream_t stream) {
  if (a.K < 1 || a.K > kWMaxK || a.rows_per_split % kWT != 0 || S < 1 || S > kWMaxSplits ||
      D % 16 != 0 || D < 64 || D > kWMaxDim)
    return -1;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
#ifdef LONGBOW_PROBE_CHUNKED   // timing probe: every width through the chunked loop
  return wscan_width<Elem, kWWide>(a, D, nq, device, S, stream);
#endif
  switch (D) {
    case 64: return wscan_width<Elem, 4>(a, D, nq, device, S, stream);
    case 96: return wscan_width<Elem, 6>(a, D, nq, device, S, stream);
    case 128: return wscan_width<Elem, 8>(a, D, nq, device, S, stream);
    default: return wscan_width<Elem, kWWide>(a, D, nq, device, S, stream);
  }
}

}  // namespace
