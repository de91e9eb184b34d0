// Fused flat scan for Hopper: bf16 distances + exact per-split top-K,
// without ever writing the [B, N] score matrix.
//
// Replaces longbow_tpu/ops/pallas_scan.py::_scan_kernel as launched by
// fused_flat_search (the pallas_call at pallas_scan.py:386). The Python
// wrapper is longbow_tpu_torch/ops/scan.py::fused_flat_search.
//
// What it computes, for queries q [B, D] (bf16), corpus [N, D] (bf16),
// qn [B] (f32, |q|^2 of the bf16 queries for l2, 0 for ip) and
// vn [N] (f32; |v|^2 (l2) or 0 (ip) for valid rows, MASKED otherwise):
//     l2:  s[b, n] = qn[b] - 2 q[b].v[n] + vn[n]
//     ip:  s[b, n] = vn[n] - q[b].v[n]
// and, for each query b and corpus split `split`, the K smallest s with
// their row ids, ascending, into out_d/out_i [B, S, K]. Unfilled slots
// are (MASKED, -1); rows whose score is at or above MASKED_GUARD (masked
// rows) never enter. The wrapper selects the final k from the S*K
// candidates with one torch.topk.
//
// What bounds it on an H100. Small B: reading the corpus, N*D*2 bytes
// (256 MiB at 1M x 128, 1.92 GB at GIST-1M's 1M x 960) over 3.35 TB/s.
// Large B: the 2*B*N*D bf16 multiply-adds over the tensor cores, and
// before that the passes over the corpus, one per query block (through
// L2: at D = 960 a block holds at most 64 queries, so 1,000 queries read
// the rows 16 times).
//
// Two variants; ops/scan.py::scan_variant picks one from the shape:
//   - "wgmma" (scan_wgmma.cuh, longbow_fused_scan_wgmma): K <= 64, D a
//     multiple of 16 from 64 to 1,024, a 16-byte aligned corpus, any
//     batch: the served shapes, single queries included. The main loop is
//     K2's: 16, 32, 64 or 128 queries per block, a ring filled by a copy
//     warp and handed over through mbarriers, the rows as the register
//     operand of wgmma.mma_async m64nNQk16 (read from the stage 16 bytes
//     per lane, so no swizzled corpus layout is needed), no block-wide
//     barrier per tile. At D = 64, 96 and 128 a stage is a whole 128-row
//     tile (one cp.async.bulk); at every other width it is 128 rows x 64
//     dims, one 2-D TMA load, and the accumulators carry across a tile's
//     chunks;
//   - "mma" (this file, longbow_fused_scan): every other shape: K up to
//     512, any D, unaligned rows. The LONGBOW_PROBE_* names compile stages
//     of its loop out for tools/probe_scan_stages.py.
//       - bytes: the grid is (ceil(B/QB), S), with S chosen from the
//         occupancy so that the blocks fill every SM in one wave (at B=1
//         two blocks per SM); each block streams its split through a ring
//         of two shared-memory stages filled by 16-byte cp.async copies,
//         with one barrier per tile;
//       - operations: scores come from mma.sync m16n8k16 (bf16 in, f32
//         accumulate) with the block's query fragments held in registers
//         across the whole scan (D <= 128) and corpus fragments read by
//         ldmatrix from padded shared memory without bank conflicts.
//     Selection there is a threshold filter: a score below the query's
//     current K-th best is appended to a shared-memory buffer of
//     CAP >= K + TN slots (CAP >= 2K + TN where shared memory allows, so
//     that a sort retires at least K appends); when the next tile could
//     overflow it, one warp bitonic-sorts the buffer in registers, keeps
//     K and tightens the threshold. The block waits for that sort at its
//     next barrier, so the sort is kept short.

#include "scan_common.cuh"
#include "scan_wgmma.cuh"

namespace {

constexpr int kCStride = kChunk + 8;   // +16 bytes: conflict-free fragment loads

// A fragments (16 queries x 128 dims of chunk c) for this lane.
__device__ __forceinline__ void load_a(uint32_t (&afr)[8][4], const __nv_bfloat16* q_s,
                                       int qstride, int row, int c, int tig) {
  const __nv_bfloat16* base = q_s + row * qstride + c * kChunk + tig * 2;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    afr[ks][0] = *reinterpret_cast<const uint32_t*>(base + ks * 16);
    afr[ks][1] = *reinterpret_cast<const uint32_t*>(base + 8 * qstride + ks * 16);
    afr[ks][2] = *reinterpret_cast<const uint32_t*>(base + ks * 16 + 8);
    afr[ks][3] = *reinterpret_cast<const uint32_t*>(base + 8 * qstride + ks * 16 + 8);
  }
}

// 8x8 b16 matrices from shared memory: lanes 8m..8m+7 give the row
// addresses of matrix m, and register m holds this lane's part of it.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

inline int smem_bytes(int qb, int tn, int stages, int nchunks, int cap) {
  return stages * tn * kCStride * 2            // corpus ring
         + stages * tn * 4                     // norm-row ring
         + qb * (nchunks * kChunk + 8) * 2     // the block's queries
         + qb * cap * 8                        // candidate buffers (d, idx)
         + qb * 12;                            // qn, threshold, count
}

template <int WM, int WN, int NT, int STAGES, int MAXE>
__global__ void __launch_bounds__(Cfg<WM, WN, NT, STAGES, MAXE>::THREADS, 1)
fused_scan_kernel(const __nv_bfloat16* __restrict__ q, const float* __restrict__ qn,
                  const __nv_bfloat16* __restrict__ corpus, const float* __restrict__ vn,
                  int B, int N, int D, int K, int cap, int rows_per_split, int l2,
                  int vec16, float* __restrict__ out_d, int* __restrict__ out_i) {
  using C = Cfg<WM, WN, NT, STAGES, MAXE>;
  static_assert(NT % 2 == 0, "ldmatrix.x4 loads two 8-row groups");
  constexpr int QB = C::QB, TN = C::TN, THREADS = C::THREADS;
  constexpr int NWARPS = THREADS / 32;
  const int nchunks = (D + kChunk - 1) / kChunk;
  const int qstride = nchunks * kChunk + 8;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* vn_s = reinterpret_cast<float*>(c_s + STAGES * TN * kCStride);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(vn_s + STAGES * TN);
  float* buf_d = reinterpret_cast<float*>(q_s + QB * qstride);
  int* buf_i = reinterpret_cast<int*>(buf_d + QB * cap);
  float* qn_s = reinterpret_cast<float*>(buf_i + QB * cap);
  float* thr_s = qn_s + QB;
  int* cnt_s = reinterpret_cast<int*>(thr_s + QB);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * QB;
  const int S = gridDim.y, split = blockIdx.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);

  const int qcols = nchunks * kChunk;
  for (int idx = tid; idx < QB * qcols; idx += THREADS) {
    const int r = idx / qcols, col = idx % qcols;
    __nv_bfloat16 v = __float2bfloat16(0.0f);
    if (q0 + r < B && col < D) v = q[(size_t)(q0 + r) * D + col];
    q_s[r * qstride + col] = v;
  }
  for (int r = tid; r < QB; r += THREADS) {
    qn_s[r] = (q0 + r < B) ? qn[q0 + r] : 0.0f;
    thr_s[r] = kGuard;
    cnt_s[r] = 0;
  }

  const int ntiles = row_end > row_begin ? (row_end - row_begin + TN - 1) / TN : 0;
  const int total = ntiles * nchunks;

  // Start the copies of (tile, chunk) number `it` of this split into ring
  // stage `stage`, and with a tile's last chunk its TN norms; rows past
  // the split and dims past D are zero-filled. The caller commits.
  auto fetch = [&](int it, int stage) {
    const int t = it / nchunks, c = it % nchunks;
    const int row0 = row_begin + t * TN;
    __nv_bfloat16* dst = c_s + stage * TN * kCStride;
    if (vec16) {
      for (int idx = tid; idx < TN * (kChunk / 8); idx += THREADS) {
        const int r = idx >> 4, v = idx & 15;
        const int row = row0 + r, dim = c * kChunk + v * 8;
        const bool ok = row < row_end && dim < D;
        cp_async16(dst + r * kCStride + v * 8, ok ? corpus + (size_t)row * D + dim : corpus,
                   ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < TN * kChunk; idx += THREADS) {
        const int r = idx / kChunk, col = idx % kChunk;
        const int row = row0 + r, dim = c * kChunk + col;
        dst[r * kCStride + col] = (row < row_end && dim < D)
                                      ? corpus[(size_t)row * D + dim]
                                      : __float2bfloat16(0.0f);
      }
    }
    if (c == nchunks - 1) {
      for (int idx = tid; idx < TN / 4; idx += THREADS) {
        const int row = row0 + idx * 4;
        const int left = N - row;  // rows of the norm array from `row` on
        const int bytes = left >= 4 ? 16 : max(0, left * 4);
        cp_async16(vn_s + stage * TN + idx * 4, bytes > 0 ? vn + row : vn, bytes);
      }
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) fetch(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  __syncthreads();  // queries, qn, thresholds and counts are in place

  uint32_t afr[8][4];
  if (nchunks == 1) load_a(afr, q_s, qstride, wm * 16 + g, 0, tig);
  const float alpha = l2 ? -2.0f : -1.0f;   // score = qn + alpha q.v + vn
  const int qa = wm * 16 + g, qb = qa + 8;  // this lane's two queries
  const bool qa_ok = q0 + qa < B, qb_ok = q0 + qb < B;
  const int lr0 = wn * NT * 8 + tig * 2;     // this lane's first row in a tile
  // this lane's ldmatrix row: row (lane & 7) of matrix (lane >> 3)
  const int ld_off = (wn * NT * 8 + ((lane >> 4) << 3) + (lane & 7)) * kCStride +
                     ((lane >> 3) & 1) * 8;

  for (int t = 0; t < ntiles; ++t) {
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

    for (int c = 0; c < nchunks; ++c) {
      const int it = t * nchunks + c;
      // chunk `it` has landed, and every thread is done with the stage
      // the next fetch refills (it was read in iteration it - 1)
      cp_async_wait<STAGES - 2>();
      __syncthreads();
#ifndef LONGBOW_PROBE_NO_FETCH
      if (it + STAGES - 1 < total) fetch(it + STAGES - 1, (it + STAGES - 1) % STAGES);
#endif
      asm volatile("cp.async.commit_group;\n" ::);
      if (nchunks > 1) load_a(afr, q_s, qstride, qa, c, tig);
#ifndef LONGBOW_PROBE_NO_MMA
      // B fragments of two 8-row groups per ldmatrix: matrices (rows,
      // dims) = (8 nt, ks*16 + 0..7), (8 nt, +8..15), (8 (nt+1), ..)
      const __nv_bfloat16* cs = c_s + (it % STAGES) * TN * kCStride + ld_off;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, cs + np * 16 * kCStride + ks * 16);
          mma_bf16(acc[2 * np], afr[ks], b[0], b[1]);
          mma_bf16(acc[2 * np + 1], afr[ks], b[2], b[3]);
        }
      }
#endif
    }

#ifdef LONGBOW_PROBE_NO_EPILOGUE
    // timing probe: the products stay live, nothing is scored or selected
    float keep = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) keep += acc[nt][e];
    if (keep == 1.2345e-30f) cnt_s[0] = 1;
    __syncthreads();
#else

    // epilogue: scores below the query's threshold join its buffer. The
    // tile's norms sit in the stage of its last chunk, which is refilled
    // only after the next iteration's barrier. Scores replace the
    // products in place (qn is 0 in ip mode), and the lane's smallest
    // score per query decides whether any of them is looked at again:
    // once the thresholds settle, almost no tile is.
    const float* vt = vn_s + ((t * nchunks + nchunks - 1) % STAGES) * TN;
    const float qn_a = qn_s[qa], qn_b = qn_s[qb];
    const float th_a = thr_s[qa], th_b = thr_s[qb];
    const int rbase = row_begin + t * TN;
    float mn_a = kMasked, mn_b = kMasked;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sc = fmaf(alpha, acc[nt][e], e >= 2 ? qn_b : qn_a) + vt[lr0 + nt * 8 + (e & 1)];
        acc[nt][e] = sc;
        if (e >= 2)
          mn_b = fminf(mn_b, sc);
        else
          mn_a = fminf(mn_a, sc);
      }
    }
#ifdef LONGBOW_PROBE_NO_SELECT   // timing probe: scored and tested, nothing kept
    if (mn_a + mn_b == 1.2345e-30f) cnt_s[0] = 1;
    if (false) {
#else
    if ((qa_ok && mn_a < th_a) || (qb_ok && mn_b < th_b)) {
#endif
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e >= 2;
          const int row = rbase + lr0 + nt * 8 + (e & 1);
          const float sc = acc[nt][e];
          if ((hi ? qb_ok : qa_ok) && row < row_end && sc < (hi ? th_b : th_a)) {
            const int ql = hi ? qb : qa;
            const int pos = atomicAdd(&cnt_s[ql], 1);
            buf_d[ql * cap + pos] = sc;
            buf_i[ql * cap + pos] = row;
          }
        }
      }
    }
    __syncthreads();
    // a buffer the next tile could overflow is sorted and cut to K; the
    // next tile's first barrier orders this before its epilogue
    for (int ql = warp; ql < QB; ql += NWARPS) {
      const int n = cnt_s[ql];
      if (q0 + ql >= B || n <= cap - TN) continue;
      warp_sort<MAXE>(buf_d + ql * cap, buf_i + ql * cap, n, lane);
      if (lane == 0) {
        const int kept = min(n, K);
        cnt_s[ql] = kept;
        if (kept == K) thr_s[ql] = buf_d[ql * cap + K - 1];
      }
      __syncwarp();
    }
#endif  // LONGBOW_PROBE_NO_EPILOGUE
  }

  // each warp finishes the queries it maintained
  for (int ql = warp; ql < QB; ql += NWARPS) {
    if (q0 + ql >= B) continue;
    const int n = cnt_s[ql];
    float* d = buf_d + ql * cap;
    int* ix = buf_i + ql * cap;
    warp_sort<MAXE>(d, ix, n, lane);
    const int kept = min(n, K);
    const size_t base = ((size_t)(q0 + ql) * S + split) * K;
    for (int j = lane; j < K; j += 32) {
      out_d[base + j] = j < kept ? d[j] : kMasked;
      out_i[base + j] = j < kept ? ix[j] : -1;
    }
  }
}

// Launch tiling C (passed as a tag) on `stream` of `device`.
template <int WM, int WN, int NT, int ST, int ME>
cudaError_t launch(Cfg<WM, WN, NT, ST, ME>, int device, const void* q, const void* qn, const void* corpus,
                   const void* vn, int B, int N, int D, int K, int l2, int S,
                   int rows_per_split, int cap, int smem, void* out_d, void* out_i,
                   cudaStream_t stream) {
  using C = Cfg<WM, WN, NT, ST, ME>;
  auto kern = fused_scan_kernel<WM, WN, NT, ST, ME>;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), device, smem);
  if (e != cudaSuccess) return e;
  const int vec16 = (D % 8 == 0) && (reinterpret_cast<uintptr_t>(corpus) % 16 == 0);
  dim3 grid((B + C::QB - 1) / C::QB, S);
  kern<<<grid, C::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(qn),
      static_cast<const __nv_bfloat16*>(corpus), static_cast<const float*>(vn), B, N, D, K, cap,
      rows_per_split, l2, vec16, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return cudaGetLastError();
}

// Blocks of tiling C that fit on one SM with `smem` bytes (0 if none).
template <int WM, int WN, int NT, int ST, int ME>
cudaError_t occupancy_of(Cfg<WM, WN, NT, ST, ME>, int device, int smem, int* nb) {
  auto kern = fused_scan_kernel<WM, WN, NT, ST, ME>;
  return blocks_per_sm(reinterpret_cast<const void*>(kern), device,
                       Cfg<WM, WN, NT, ST, ME>::THREADS, smem, nb);
}

}  // namespace

extern "C" {

// Choose the tiling and the corpus split for one call (choose_plan in
// scan_common.cuh). Returns a cudaError_t, or -1 when no tiling fits the
// shared memory of the device.
int longbow_fused_scan_plan(int device, int B, int N, int D, int K, int* plan) {
  const int nchunks = (D + kChunk - 1) / kChunk;
  auto smem_of = [nchunks](int cfg, int cap) {
    return cfg == 0 ? smem_bytes(Wide::QB, Wide::TN, Wide::STAGES_, nchunks, cap)
                    : smem_bytes(Narrow::QB, Narrow::TN, Narrow::STAGES_, nchunks, cap);
  };
  auto occupancy = [device](int cfg, int smem, int* nb) {
    return cfg == 0 ? occupancy_of(Wide{}, device, smem, nb)
                    : occupancy_of(Narrow{}, device, smem, nb);
  };
  return choose_plan(device, B, N, K, smem_of, occupancy, plan);
}

// Launch on `stream` with a plan from longbow_fused_scan_plan. Pointers
// are device pointers to contiguous q [B, D] bf16, qn [B] f32,
// corpus [N, D] bf16, vn [N] f32 (16-byte aligned), out_d [B, S, K] f32
// and out_i [B, S, K] int32. Returns cudaGetLastError() after the launch.
int longbow_fused_scan(int device, const void* q, const void* qn, const void* corpus,
                       const void* vn, int B, int N, int D, int K, int l2, int cfg, int S,
                       int rows_per_split, int cap, int smem, void* out_d, void* out_i,
                       void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cfg == 0)
    return launch(Wide{}, device, q, qn, corpus, vn, B, N, D, K, l2, S, rows_per_split, cap, smem, out_d,
                  out_i, st);
  return launch(Narrow{}, device, q, qn, corpus, vn, B, N, D, K, l2, S, rows_per_split, cap, smem,
                out_d, out_i, st);
}

// The wgmma variant (scan_wgmma.cuh): D a multiple of 16 from 64 to
// 1,024, K <= 64, nq (queries per block) in {16, 32, 64, 128} (at most 64
// past D = 320), corpus 16-byte aligned, vn padded to a multiple of 128
// rows with MASKED, q [B, Dp] in wgmma_layout (Dp = D at 64, 96 and 128,
// else D padded to a multiple of 64), rows_per_split a multiple of 128,
// S = ceil(N / rows_per_split) and split_best [B S + ceil(B / nq)] uint32
// filled with ordered_bits(MASKED_GUARD). Returns cudaGetLastError() after the
// launch, -1 for a shape it does not take, -2 when shared memory is too
// small, -3 when the rows' tensor map cannot be made.
int longbow_fused_scan_wgmma(int device, const void* q, const void* qn, const void* corpus,
                             const void* vn, int B, int N, int D, int K, int l2, int nq, int S,
                             int rows_per_split, void* split_best, void* out_d, void* out_i,
                             void* stream) {
  WScanArgs a{};
  a.q = q, a.qn = static_cast<const float*>(qn), a.rows = corpus;
  a.vn = static_cast<const float*>(vn), a.gt = nullptr, a.gt_kind = 0, a.G = 0;
  a.B = B, a.N = N, a.K = K, a.rows_per_split = rows_per_split, a.alpha = l2 ? -2.0f : -1.0f;
  a.split_best = static_cast<unsigned*>(split_best);
  a.out_d = static_cast<float*>(out_d), a.out_i = static_cast<int*>(out_i);
  return wscan_dispatch<__nv_bfloat16>(a, D, nq, device, S, static_cast<cudaStream_t>(stream));
}

#ifdef LONGBOW_PROBE_COUNT
// timing probe: the wgmma variant's appends and sorts since the last call
// (out[0], out[1]), then zero
int longbow_probe_counts(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_probe_counts, sizeof(g_probe_counts));
  if (e != cudaSuccess) return e;
  const unsigned long long zero[2] = {0, 0};
  return cudaMemcpyToSymbol(g_probe_counts, zero, sizeof(zero));
}
#endif

}  // extern "C"
