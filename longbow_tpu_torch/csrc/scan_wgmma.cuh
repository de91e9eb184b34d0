// The wgmma main loop shared by the fused scans: K1 (fused_scan.cu, bf16
// rows; replaces longbow_tpu/ops/pallas_scan.py::fused_flat_search) and K2
// (fused_codes_scan.cu, int8 codes; replaces ::fused_codes_search), for
// batches on an H100: B > 16, K <= 64, D of 64, 96 or 128, 16-byte aligned
// rows (ops/scan.py::scan_variant sends every other shape to the mma.sync
// variants).
//
// What bounds the scans at these shapes is the tensor-core work and, before
// it, one pass over the corpus per query block. The mma.sync variants lost
// most of each tile's time to the copy latency (one tile in flight), a
// barrier per tile, the int8 conversion repeated by four warps, and
// selection. Here a block takes 128 queries (half the passes) and one
// split of the corpus. It has three consumer warpgroups, a copy warp and a
// group-term warp, and no block-wide barrier inside its loop over the
// tiles:
//   - the copy warp's first lane fills a ring of 128-row tiles (3 to 8
//     stages, as shared memory allows) with one cp.async.bulk per tile and
//     one for the tile's 128 row terms; each stage has a "full" mbarrier,
//     which the copy completes, and an "empty" one, at which every
//     consumer warp arrives once its fragments are in registers;
//   - the product is turned round: A is 64 corpus rows, a slab (half a
//     tile; the warpgroups take the slabs in turn), read from the stage
//     into registers (int8 codes are converted to bf16 there, once per
//     warpgroup), B is the block's 128 queries, staged once in shared
//     memory in the K-major 128-byte-swizzled layout, and
//     wgmma.mma_async m64n128k16 accumulates [64 rows x 128 queries] in
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
//     query share a bound through device memory (try_sort), so that each
//     does not warm up a whole top-K of its own.
// With 14 warps a thread may use 144 registers, and the kernels need 125 at
// most, so setmaxnreg is not needed. The LONGBOW_PROBE_* names compile
// stages of the loop out for tools/probe_scan_stages.py; LONGBOW_WGROUPS
// and LONGBOW_WCAP are its knobs.
#pragma once

#include "scan_common.cuh"

namespace {

constexpr int kWQ = 128;          // queries per block
constexpr int kWT = 128;          // corpus rows per tile (one group of the group term)
constexpr int kWMaxK = 64;        // largest K this variant takes
#ifndef LONGBOW_WGROUPS
#define LONGBOW_WGROUPS 3
#endif
constexpr int kWGroups = LONGBOW_WGROUPS;       // consumer warpgroups
constexpr int kWCopyWarp = 4 * kWGroups;        // then the group-term warp
constexpr int kWThreads = 32 * (4 * kWGroups + 2);
constexpr int kWMaxStages = 8;
#ifndef LONGBOW_WCAP
#define LONGBOW_WCAP 128
#endif
constexpr int kWCapMost = LONGBOW_WCAP;   // most candidate slots per query (a multiple of 8, <= 128)
constexpr int kWGtTiles = 8;      // tiles per slot of the group-term ring
constexpr int kWLocked = 1 << 30; // a buffer's count while it is being sorted
constexpr unsigned kFullWarp = 0xffffffffu;

struct WScanArgs {
  const void* q;        // [B, D] bf16, columns in wgmma_k_order
  const float* qn;      // [B]
  const void* rows;     // [N, D] int8 or bf16
  const float* vn;      // [ceil(N / 128) * 128] row terms, MASKED past N
  const void* gt;       // [B, G] f32 (gt_kind 1) or bf16 (2), unused when 0
  int gt_kind, G, B, N, K, rows_per_split, stages, cap;
  float alpha;          // score = qn + alpha q.v + vn (+ gt)
  float* split_best;    // [B, S], MASKED_GUARD at launch: see try_sort
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

// 128 threads of one warpgroup: D[64 x 128] (+)= A[64 x 16] B[16 x 128],
// A from this thread's registers (the A fragment of mma.sync m16n8k16 for
// its warp's 16 rows), B from shared memory through a descriptor
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
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
  unsigned long long* buf;   // [128, cap]
  float* thr;                // a score must lie below it to enter
  int* cnt;                  // slots reserved (kWLocked and above while sorting)
  int* wr;                   // slots written
  int* lock;
  int cap, K;
  float* split_best;         // this block's queries' rows of WScanArgs::split_best
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

// The calling warp takes query q's lock if it is free, closes the buffer
// to appends, waits until every reserved slot is written, sorts, keeps K
// and lowers the threshold.
//
// The threshold is the smaller of two bounds on the K-th best of the whole
// corpus. One is this split's own K-th best. The other comes from all S
// splits of the query: each publishes its r-th best so far, r = ceil(K / S),
// in split_best[q][split]; once every split has, at least S r >= K rows
// score at or below the largest of those values, so nothing above it can
// be among the K best. The splits see like rows at a like pace, so this
// bound is near the K-th best of all rows seen so far by all of them, and
// a split appends and sorts several times less than on its own bound. A
// stale read is only a looser bound: a split's value never grows.
__device__ void try_sort(const WSelect& s, int q, int lane) {
  int got = 0;
  if (lane == 0) got = atomicCAS(&s.lock[q], 0, 1) == 0;
  if (!__shfl_sync(kFullWarp, got, 0)) return;
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
    volatile float* best = s.split_best + (size_t)q * s.S;
    float most = mine;
    for (int i = lane; i < s.S; i += 32)
      if (i != s.split) most = fmaxf(most, best[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      most = fmaxf(most, __shfl_xor_sync(kFullWarp, most, off));
    if (lane == 0 && mine < kGuard) best[s.split] = mine;
    bound = fminf(bound, most);
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

// Elem is int8_t (K2) or __nv_bfloat16 (K1); KS = D / 16 k-steps.
template <class Elem, int KS>
__global__ void __launch_bounds__(kWThreads, 1) scan_wgmma_kernel(const WScanArgs p) {
  constexpr int D = KS * 16;
  constexpr int kRowBytes = D * static_cast<int>(sizeof(Elem));
  constexpr int kTileBytes = kWT * kRowBytes;
  constexpr int kQBlocks = (KS + 3) / 4;          // 64-dim blocks of the query operand
  constexpr int kQBlockBytes = kWQ * 128;

  extern __shared__ unsigned char smem_raw[];
  // the swizzled operand wants its base 1,024-aligned
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* q_s = smem;
  unsigned char* ring = q_s + kQBlocks * kQBlockBytes;
  float* vn_ring = reinterpret_cast<float*>(ring + p.stages * kTileBytes);
  float* qg_ring = vn_ring + p.stages * kWT;      // [2][kWGtTiles][128], qn + gt
  unsigned long long* buf =
      reinterpret_cast<unsigned long long*>(qg_ring + (p.gt_kind ? 2 * kWGtTiles * kWQ : 0));
  float* qn_s = reinterpret_cast<float*>(buf + kWQ * p.cap);
  float* thr_s = qn_s + kWQ;
  int* cnt_s = reinterpret_cast<int*>(thr_s + kWQ);
  int* wr_s = cnt_s + kWQ;
  int* lock_s = wr_s + kWQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(lock_s + kWQ);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kWMaxStages;
  const uint32_t gt_full0 = empty0 + 8 * kWMaxStages, gt_empty0 = gt_full0 + 16;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kWQ;
  const int S = gridDim.y, split = blockIdx.y;
  const int row_begin = split * p.rows_per_split;
  const int row_end = min(p.N, row_begin + p.rows_per_split);
  const int ntiles = row_end > row_begin ? (row_end - row_begin + kWT - 1) / kWT : 0;
  const int grp0 = row_begin / kWT;               // the first tile's group

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
  for (int idx = tid; idx < kWQ * (D / 8); idx += kWThreads) {
    const int n = idx / (D / 8), c = idx % (D / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + n < p.B)
      v = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.q) +
                                          (size_t)(q0 + n) * D + c * 8);
    *reinterpret_cast<uint4*>(q_s + (c / 8) * kQBlockBytes + n * 128 +
                              (((c & 7) ^ (n & 7)) << 4)) = v;
  }
  for (int r = tid; r < kWQ; r += kWThreads) {
    const bool real = q0 + r < p.B;
    qn_s[r] = real ? p.qn[q0 + r] : 0.0f;
    thr_s[r] = real ? kGuard : -kMasked;   // a padding query takes no score
    cnt_s[r] = 0;
    wr_s[r] = 0;
    lock_s[r] = 0;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma reads q_s
  __syncthreads();

  if (warp == kWCopyWarp) {
    // ---- the copy warp: one lane keeps the ring full
    if (lane == 0) {
      const Elem* rows = static_cast<const Elem*>(p.rows);
      for (int tile = 0; tile < ntiles; ++tile) {
        const int s = tile % p.stages;
        if (tile >= p.stages) mbar_wait(empty0 + 8 * s, ((tile / p.stages) - 1) & 1);
        const int row0 = row_begin + tile * kWT;
        const int bytes = min(kWT, p.N - row0) * kRowBytes;  // the ragged last tile copies less
        mbar_expect_tx(full0 + 8 * s, bytes + kWT * 4);
        bulk_copy(smem_u32(ring + s * kTileBytes), rows + (size_t)row0 * D, bytes, full0 + 8 * s);
        bulk_copy(smem_u32(vn_ring + s * kWT), p.vn + row0, kWT * 4, full0 + 8 * s);
      }
    }
  } else if (warp == kWCopyWarp + 1) {
    // ---- the group-term warp: qn + gt of the split's tiles
    // 8 i .. 8 i + 7 into slot i & 1; a lane takes four queries and reads
    // each one's eight values with one or two 16-byte loads where the
    // addresses allow (wgmma_plan makes a split start at a multiple of 8
    // groups), else one by one
    if (p.gt_kind) {
      const int esize = p.gt_kind == 1 ? 4 : 2;
      const bool vec = ((size_t)p.G * esize) % 16 == 0 && grp0 % kWGtTiles == 0 &&
                       reinterpret_cast<uintptr_t>(p.gt) % 16 == 0;
      const int nchunks = (ntiles + kWGtTiles - 1) / kWGtTiles;
      for (int i = 0; i < nchunks; ++i) {
        const int slot = i & 1;
        if (i >= 2) mbar_wait(gt_empty0 + 8 * slot, ((i >> 1) - 1) & 1);
        const int gbase = grp0 + i * kWGtTiles;
        float* dst = qg_ring + slot * kWGtTiles * kWQ;
#pragma unroll
        for (int qi = 0; qi < kWQ / 32; ++qi) {
          const int q = lane + 32 * qi;
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
          for (int j = 0; j < kWGtTiles; ++j) dst[j * kWQ + q] = qn + v[j];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(gt_full0 + 8 * slot);
      }
    }
  } else {
    // ---- the consumers. A tile is two 64-row slabs; slab number
    // 2 tile + half goes to warpgroup (slab % kWGroups). This lane holds
    // rows r0 and r1 of its slab against queries 8 j + 2 t, 8 j + 2 t + 1
    // (j < 16): acc[4 j + 2 (row) + (query)]
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const WSelect sel{buf, thr_s, cnt_s, wr_s, lock_s, p.cap, p.K,
                      p.split_best + (size_t)q0 * S, S, split};
    const uint64_t desc0 = swizzled_desc(smem_u32(q_s));
    int gt_chunk = -1;   // the last slot-sized chunk of tiles whose group term was waited for
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

    for (int tile = 0; tile < ntiles; ++tile) {
      const int s = tile % p.stages;
      // every warp waits for every tile and arrives at its "empty" barrier,
      // whether or not its warpgroup has a slab there: a stage is not
      // filled again before every thread has seen this phase of it
      mbar_wait(full0 + 8 * s, (tile / p.stages) & 1);
      const int half = (wg + kWGroups - (2 * tile) % kWGroups) % kWGroups;
      if (half > 1) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
        continue;
      }
      const int r0 = half * 64 + (warp & 3) * 16 + g, r1 = r0 + 8;
      const Elem* st = reinterpret_cast<const Elem*>(ring + s * kTileBytes);
      uint32_t a[KS][4];
      load_a<KS>(a, st + r0 * D, st + r1 * D, t);
      const float vn0 = vn_ring[s * kWT + r0], vn1 = vn_ring[s * kWT + r1];
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp's part of the stage is in registers

#ifdef LONGBOW_PROBE_NO_MMA
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        acc[ks] = __uint_as_float(a[ks][0] ^ a[ks][1] ^ a[ks][2] ^ a[ks][3]);
#else
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_m64n128k16_rs(acc, a[ks],
                            desc0 + (((ks / 4) * kQBlockBytes + (ks % 4) * 32) >> 4), ks > 0);
      wgmma_commit();
#endif

      // qn (+ the tile's group term) per query
      const float* qg = qn_s;
      const int chunk = tile / kWGtTiles;
      if (p.gt_kind) {
        if (chunk != gt_chunk) mbar_wait(gt_full0 + 8 * (chunk & 1), (chunk >> 1) & 1);
        gt_chunk = chunk;
        qg = qg_ring + ((chunk & 1) * kWGtTiles + tile % kWGtTiles) * kWQ;
      }
#ifndef LONGBOW_PROBE_NO_MMA
      wgmma_wait_all();
#endif
#pragma unroll
      for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
      const int rbase = row_begin + tile * kWT;
      if (rbase + kWT > p.N) {
        // the ragged last tile: rows past N hold what the stage held before
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (rbase + ((i & 2) ? r1 : r0) >= p.N) acc[i] = 0.0f;
      }

      // Scores against thresholds, four at a time (two queries x two
      // rows). The few that pass go to this thread's pending list, which
      // lives in local memory and is touched on that path only, so that the
      // accumulators stay in registers and the common path stays short
      // (appending from each of the 64 places, inline or through a call,
      // measured four times slower).
      int npend = 0;
      float pend_sc[64];
      int pend_at[64];   // (row in the tile << 8) | query
#ifdef LONGBOW_PROBE_NO_EPILOGUE
      {   // timing probe: the products stay live, nothing is selected
        float keep = vn0 + vn1 + qg[lane];
#pragma unroll
        for (int i = 0; i < 64; ++i) keep += acc[i];
        if (keep == 1.2345e-30f) thr_s[0] = keep;
      }
#else
#pragma unroll
      for (int j = 0; j < 16; ++j) {
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
              thr_s[kWQ - 1] = sc[e];
#else
              pend_sc[npend] = sc[e];
              pend_at[npend++] = (((e & 2) ? r1 : r0) << 8) | (8 * j + 2 * t + (e & 1));
#endif
            }
          }
        }
      }
#endif
      if (p.gt_kind) {
        __syncwarp();
        if (lane == 0) mbar_arrive(gt_empty0 + 8 * (chunk & 1));
      }

      // Each pending score reserves a slot of its query's buffer. One that
      // finds the buffer full (or being sorted) stays pending; the warp
      // then sorts the full buffers (or waits for the warp that does) and
      // tries again.
      for (bool again = false; __any_sync(kFullWarp, npend != 0); again = true) {
        if (again) {
          for (int qb = 0; qb < kWQ; qb += 32) {
            unsigned fullq = __ballot_sync(
                kFullWarp, *reinterpret_cast<volatile int*>(&cnt_s[qb + lane]) >= p.cap);
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

    // every consumer is done with every buffer: each warp finishes its queries
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWGroups * 128) : "memory");
    for (int ql = warp; ql < kWQ; ql += 4 * kWGroups) {
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

// Shared memory of a block with `stages` stages and `cap` slots per query.
inline int wscan_smem(int row_bytes, int ks, int stages, int cap, int has_gt) {
  return 1024 + (ks + 3) / 4 * kWQ * 128 + stages * (kWT * row_bytes + kWT * 4) +
         (has_gt ? 2 * kWGtTiles * kWQ * 4 : 0) + kWQ * cap * 8 + kWQ * 20 +
         (2 * kWMaxStages + 4) * 8;
}

// Choose stages and cap and launch. Returns a cudaError_t, -1 when the
// shape is not one of this variant's, -2 when shared memory is too small.
template <class Elem, int KS>
int wscan_launch(WScanArgs a, int device, int S, cudaStream_t stream) {
  int max_smem = 0;
  cudaError_t e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  const int row_bytes = KS * 16 * static_cast<int>(sizeof(Elem));
  // the roomiest buffers that leave a ring of four stages, else of three
  // (measured at 10,240,000 x 96, B = 1,000: 128 slots and 4 stages beat
  // 112 and 5, which beat 96 and 6; a sort retires cap - K appends)
  bool found = false;
  for (int want = 4; want >= 3 && !found; --want) {
    a.stages = 0;
    for (int cap = kWCapMost; cap >= a.K + 16 && a.stages < want; cap -= 8) {
      const int fixed = wscan_smem(row_bytes, KS, 0, cap, a.gt_kind != 0);
      const int stages = (max_smem - fixed) / (kWT * row_bytes + kWT * 4);
      a.cap = cap;
      a.stages = stages < kWMaxStages ? stages : kWMaxStages;
    }
    found = a.stages >= want;
  }
  if (!found) return -2;
  const int smem = wscan_smem(row_bytes, KS, a.stages, a.cap, a.gt_kind != 0);
  auto kern = scan_wgmma_kernel<Elem, KS>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.B + kWQ - 1) / kWQ, S);
  kern<<<grid, kWThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// D must be 64, 96 or 128 (the widths that are instantiated).
template <class Elem>
int wscan_dispatch(const WScanArgs& a, int D, int device, int S, cudaStream_t stream) {
  if (a.K < 1 || a.K > kWMaxK || a.rows_per_split % kWT != 0) return -1;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  switch (D) {
    case 64: return wscan_launch<Elem, 4>(a, device, S, stream);
    case 96: return wscan_launch<Elem, 6>(a, device, S, stream);
    case 128: return wscan_launch<Elem, 8>(a, device, S, stream);
    default: return -1;
  }
}

}  // namespace
