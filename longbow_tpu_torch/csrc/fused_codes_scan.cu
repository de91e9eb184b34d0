// Fused scan over int8 quantized codes for Hopper (kernel K2): bf16
// tensor-core distances + exact per-split top-K, without ever writing
// the [B, N] score matrix.
//
// Replaces longbow_tpu/ops/pallas_scan.py::_scan_kernel as launched by
// fused_codes_search (the pallas_call at pallas_scan.py:608, the has_gt
// branch and the int8 convert at :189). The Python wrapper is
// longbow_tpu_torch/ops/scan.py::fused_codes_search.
//
// What it computes, for query sides qs [B, D] (bf16), qn [B] (f32),
// codes [N, D] (int8: stored u8 - 128; the caller folds the affine into
// qs and qn), vn [N] (f32; the row term for valid rows, MASKED
// otherwise) and, when given, a group term gt [B, N / 128] (f32 or bf16):
//     s[b, n] = qn[b] - 2 qs[b].codes[n] + vn[n] (+ gt[b, n / 128])
// and, for each query b and corpus split, the K smallest s with their
// row ids, ascending, into out_d/out_i [B, S, K]. Unfilled slots are
// (MASKED, -1); rows whose score is at or above MASKED_GUARD (masked
// rows, which stay there after the group term is added) never enter.
// Scores are compared as floats, so the TPU kernel's positivity bias and
// its id bits packed into the score are not needed.
//
// What bounds it on an H100. Small B: reading the codes, N*D bytes
// (983 MB at 10,240,000 x 96, 768 MB at 1M x 768) over 3.35 TB/s. Large
// B: the 2*B*N*D multiply-adds over the bf16 tensor cores, and before
// that the passes over the codes, one per query block.
//
// Two variants; ops/scan.py::scan_variant picks one from the shape:
//   - "wgmma" (scan_wgmma.cuh, longbow_fused_codes_scan_wgmma): K <= 64,
//     D a multiple of 16 from 64 to 1,024, 16-byte aligned codes, any
//     batch: the served shapes. 16, 32, 64 or 128 queries per block (the
//     narrowest that holds the batch), a ring filled from one producer
//     lane (whole 128-row tiles by cp.async.bulk at D = 64, 96 and 128;
//     128 rows x 128 dims by a 2-D TMA load at other widths) and handed
//     over through mbarriers, the codes converted to bf16 in registers,
//     64 dims at a time, once per warpgroup, as the register operand of
//     wgmma.mma_async m64nNQk16, the group term read 8 tiles at a time
//     by a warp of its own, and no block-wide barrier per tile;
//   - "mma" (this file, longbow_fused_codes_scan): every other shape: K
//     up to 512, any D, unaligned rows. A grid of (query blocks, corpus splits) sized to fill the SMs
//     in one wave, a cp.async ring of two code tiles (16 codes per copy)
//     and their norm rows, query fragments held in registers for
//     D <= 128, mma.sync m16n8k16, one barrier per tile, and the shared
//     threshold-filter selection (scan_common.cuh). In this variant:
//       - ldmatrix moves 16-bit elements, so the B fragments are read
//         with one 32-bit shared load per lane (four codes of one row)
//         and converted to bf16 in registers, where -128..127 is exact.
//         The four codes are dims 4t..4t+3 of the k-step for lane group
//         t, which is not the fragment's k order (2t, 2t+1, 2t+8, 2t+9);
//         the query fragments are loaded in the same permuted order, so
//         the dot product is unchanged;
//       - k-steps past D are skipped (D = 96 runs 6 of 8);
//       - a tile is 128 rows, one group, so the group term is one value
//         per query and tile, read from device memory as f32 or bf16.
//     The LONGBOW_PROBE_* names compile stages of its loop out for
//     tools/probe_scan_stages.py, which times what each stage costs.

#include "scan_common.cuh"
#include "scan_wgmma.cuh"

namespace {

constexpr int kRowBytes = kChunk + 16;  // +16 bytes: conflict-free fragment loads

// A fragments (16 queries x 128 dims of chunk c) for this lane, in the
// permuted k order that matches bytes_to_bf16: registers 0/1 hold dims
// 4t, 4t+1 of rows g / g+8, registers 2/3 dims 4t+2, 4t+3.
__device__ __forceinline__ void load_a_perm(uint32_t (&afr)[8][4], const __nv_bfloat16* q_s,
                                            int qstride, int row, int c, int tig) {
  const __nv_bfloat16* base = q_s + row * qstride + c * kChunk + tig * 4;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    afr[ks][0] = *reinterpret_cast<const uint32_t*>(base + ks * 16);
    afr[ks][1] = *reinterpret_cast<const uint32_t*>(base + 8 * qstride + ks * 16);
    afr[ks][2] = *reinterpret_cast<const uint32_t*>(base + ks * 16 + 2);
    afr[ks][3] = *reinterpret_cast<const uint32_t*>(base + 8 * qstride + ks * 16 + 2);
  }
}

__device__ __forceinline__ float group_term(const void* gt, int gt_kind, size_t i) {
  return gt_kind == 1 ? static_cast<const float*>(gt)[i]
                      : __bfloat162float(static_cast<const __nv_bfloat16*>(gt)[i]);
}

inline int smem_bytes(int qb, int tn, int stages, int nchunks, int cap) {
  return stages * tn * kRowBytes               // code ring
         + stages * tn * 4                     // norm-row ring
         + qb * (nchunks * kChunk + 8) * 2     // the block's queries
         + qb * cap * 8                        // candidate buffers (d, idx)
         + qb * 12;                            // qn, threshold, count
}

template <int WM, int WN, int NT, int STAGES, int MAXE>
__global__ void __launch_bounds__(Cfg<WM, WN, NT, STAGES, MAXE>::THREADS, 1)
fused_codes_kernel(const __nv_bfloat16* __restrict__ qs, const float* __restrict__ qn,
                   const int8_t* __restrict__ codes, const float* __restrict__ vn,
                   const void* __restrict__ gt, int gt_kind, int G, int B, int N, int D, int K,
                   int cap, int rows_per_split, int vec16, float* __restrict__ out_d,
                   int* __restrict__ out_i) {
  using C = Cfg<WM, WN, NT, STAGES, MAXE>;
  static_assert(C::TN == 128, "a tile is one 128-row group of the group term");
  constexpr int QB = C::QB, TN = C::TN, THREADS = C::THREADS;
  constexpr int NWARPS = THREADS / 32;
  const int nchunks = (D + kChunk - 1) / kChunk;
  const int qstride = nchunks * kChunk + 8;

  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* c_s = reinterpret_cast<int8_t*>(smem);
  float* vn_s = reinterpret_cast<float*>(c_s + STAGES * TN * kRowBytes);
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
    if (q0 + r < B && col < D) v = qs[(size_t)(q0 + r) * D + col];
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
    int8_t* dst = c_s + stage * TN * kRowBytes;
    if (vec16) {
      for (int idx = tid; idx < TN * (kChunk / 16); idx += THREADS) {
        const int r = idx >> 3, v = idx & 7;
        const int row = row0 + r, dim = c * kChunk + v * 16;
        const bool ok = row < row_end && dim < D;
        cp_async16(dst + r * kRowBytes + v * 16, ok ? codes + (size_t)row * D + dim : codes,
                   ok ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < TN * kChunk; idx += THREADS) {
        const int r = idx / kChunk, col = idx % kChunk;
        const int row = row0 + r, dim = c * kChunk + col;
        dst[r * kRowBytes + col] =
            (row < row_end && dim < D) ? codes[(size_t)row * D + dim] : int8_t(0);
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
  if (nchunks == 1) load_a_perm(afr, q_s, qstride, wm * 16 + g, 0, tig);
  const int qa = wm * 16 + g, qb = qa + 8;  // this lane's two queries
  const bool qa_ok = q0 + qa < B, qb_ok = q0 + qb < B;
  const int lr0 = wn * NT * 8 + tig * 2;     // this lane's first row in a tile
  // this lane's B-fragment bytes: row g of each 8-row group, dims 4t..4t+3
  const int b_off = (wn * NT * 8 + g) * kRowBytes + tig * 4;

  for (int t = 0; t < ntiles; ++t) {
    // the tile's group term, loaded now so that it lands during the mmas
    const int grp = (row_begin + t * TN) / TN;
    float gt_a = 0.0f, gt_b = 0.0f;
    if (gt_kind) {
      if (qa_ok) gt_a = group_term(gt, gt_kind, (size_t)(q0 + qa) * G + grp);
      if (qb_ok) gt_b = group_term(gt, gt_kind, (size_t)(q0 + qb) * G + grp);
    }
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
      if (nchunks > 1) load_a_perm(afr, q_s, qstride, qa, c, tig);
#ifndef LONGBOW_PROBE_NO_MMA
      const int ks_end = min(8, (D - c * kChunk + 15) / 16);  // k-steps inside D
      const int8_t* cs = c_s + (it % STAGES) * TN * kRowBytes + b_off;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        if (ks < ks_end) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t b0, b1;
            bytes_to_bf16(*reinterpret_cast<const uint32_t*>(cs + nt * 8 * kRowBytes + ks * 16),
                          b0, b1);
            mma_bf16(acc[nt], afr[ks], b0, b1);
          }
        }
      }
#endif
    }

#ifdef LONGBOW_PROBE_NO_EPILOGUE
    // timing probe: the products stay live, nothing is selected
    float keep = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) keep += acc[nt][e];
    if (keep == 1.2345e-30f) cnt_s[0] = gt_a + gt_b > 0.0f;
#ifndef LONGBOW_PROBE_NO_BARRIER
    __syncthreads();
#endif
#else
    // epilogue (K1's): scores below the query's threshold join its
    // buffer; the lane's smallest score per query decides whether any of
    // them is looked at again
    const float* vt = vn_s + ((t * nchunks + nchunks - 1) % STAGES) * TN;
    const float qn_a = qn_s[qa] + gt_a, qn_b = qn_s[qb] + gt_b;
    const float th_a = thr_s[qa], th_b = thr_s[qb];
    const int rbase = row_begin + t * TN;
    float mn_a = kMasked, mn_b = kMasked;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sc = fmaf(-2.0f, acc[nt][e], e >= 2 ? qn_b : qn_a) + vt[lr0 + nt * 8 + (e & 1)];
        acc[nt][e] = sc;
        if (e >= 2)
          mn_b = fminf(mn_b, sc);
        else
          mn_a = fminf(mn_a, sc);
      }
    }
    if ((qa_ok && mn_a < th_a) || (qb_ok && mn_b < th_b)) {
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
cudaError_t launch(Cfg<WM, WN, NT, ST, ME>, int device, const void* qs, const void* qn, const void* codes,
                   const void* vn, const void* gt, int gt_kind, int G, int B, int N, int D, int K,
                   int S, int rows_per_split, int cap, int smem, void* out_d, void* out_i,
                   cudaStream_t stream) {
  using C = Cfg<WM, WN, NT, ST, ME>;
  auto kern = fused_codes_kernel<WM, WN, NT, ST, ME>;
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), device, smem);
  if (e != cudaSuccess) return e;
  const int vec16 = (D % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  dim3 grid((B + C::QB - 1) / C::QB, S);
  kern<<<grid, C::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qs), static_cast<const float*>(qn),
      static_cast<const int8_t*>(codes), static_cast<const float*>(vn), gt, gt_kind, G, B, N, D,
      K, cap, rows_per_split, vec16, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return cudaGetLastError();
}

// Blocks of tiling C that fit on one SM with `smem` bytes (0 if none).
template <int WM, int WN, int NT, int ST, int ME>
cudaError_t occupancy_of(Cfg<WM, WN, NT, ST, ME>, int device, int smem, int* nb) {
  auto kern = fused_codes_kernel<WM, WN, NT, ST, ME>;
  return blocks_per_sm(reinterpret_cast<const void*>(kern), device,
                       Cfg<WM, WN, NT, ST, ME>::THREADS, smem, nb);
}

}  // namespace

extern "C" {

// Choose the tiling and the corpus split for one call (choose_plan in
// scan_common.cuh). Returns a cudaError_t, or -1 when no tiling fits the
// shared memory of the device.
int longbow_fused_codes_scan_plan(int device, int B, int N, int D, int K, int* plan) {
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

// Launch on `stream` with a plan from longbow_fused_codes_scan_plan.
// Pointers are device pointers to contiguous qs [B, D] bf16, qn [B] f32,
// codes [N, D] int8, vn [N] f32 (16-byte aligned), gt [B, G] (f32 when
// gt_kind is 1, bf16 when 2, unused when 0; then G = N / 128),
// out_d [B, S, K] f32 and out_i [B, S, K] int32. Returns
// cudaGetLastError() after the launch.
int longbow_fused_codes_scan(int device, const void* qs, const void* qn, const void* codes,
                             const void* vn, const void* gt, int gt_kind, int G, int B, int N,
                             int D, int K, int cfg, int S, int rows_per_split, int cap, int smem,
                             void* out_d, void* out_i, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cfg == 0)
    return launch(Wide{}, device, qs, qn, codes, vn, gt, gt_kind, G, B, N, D, K, S, rows_per_split, cap,
                  smem, out_d, out_i, st);
  return launch(Narrow{}, device, qs, qn, codes, vn, gt, gt_kind, G, B, N, D, K, S, rows_per_split, cap,
                smem, out_d, out_i, st);
}

// The wgmma variant (scan_wgmma.cuh): D a multiple of 16 from 64 to
// 1,024, K <= 64, nq (queries per block) in {16, 32, 64, 128} (at most 64
// past D = 256), codes 16-byte aligned, vn padded to a multiple of 128 rows
// with MASKED, qs [B, Dp] in wgmma_layout (Dp = D at 64, 96 and 128, else
// D padded to a multiple of 128), rows_per_split a multiple of 128,
// S = ceil(N / rows_per_split) and split_best [B S + ceil(B / nq)] uint32
// filled with ordered_bits(MASKED_GUARD). Returns cudaGetLastError() after the
// launch, -1 for a shape it does not take, -2 when shared memory is too
// small, -3 when the codes' tensor map cannot be made.
int longbow_fused_codes_scan_wgmma(int device, const void* qs, const void* qn, const void* codes,
                                   const void* vn, const void* gt, int gt_kind, int G, int B,
                                   int N, int D, int K, int nq, int S, int rows_per_split,
                                   void* split_best, void* out_d, void* out_i, void* stream) {
  WScanArgs a{};
  a.q = qs, a.qn = static_cast<const float*>(qn), a.rows = codes;
  a.vn = static_cast<const float*>(vn), a.gt = gt, a.gt_kind = gt_kind, a.G = G;
  a.B = B, a.N = N, a.K = K, a.rows_per_split = rows_per_split, a.alpha = -2.0f;
  a.split_best = static_cast<unsigned*>(split_best);
  a.out_d = static_cast<float*>(out_d), a.out_i = static_cast<int*>(out_i);
  return wscan_dispatch<int8_t>(a, D, nq, device, S, static_cast<cudaStream_t>(stream));
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
