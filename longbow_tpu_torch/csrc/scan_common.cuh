// Device helpers shared by the fused scans, K1 (fused_scan.cu, bf16 rows;
// replaces longbow_tpu/ops/pallas_scan.py::fused_flat_search) and K2
// (fused_codes_scan.cu, int8 codes; replaces ::fused_codes_search), and
// the launch plan of their mma.sync variants. The wgmma variants' main
// loop is scan_wgmma.cuh.
//
// Every variant keeps, for each query block and corpus split, an exact
// top-K of the split: scores below the query's threshold are appended to
// a shared-memory buffer, and a full buffer is sorted by one warp
// (bitonic, in registers up to 1,024 entries) and cut to K, which lowers
// the threshold. The wrappers merge the S*K per-split candidates with one
// torch.topk.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr float kMasked = 3.0e38f;     // longbow_tpu_torch.ops.distance.MASKED
constexpr float kGuard = 1.0e37f;      // ... MASKED_GUARD
constexpr int kChunk = 128;            // dims per corpus chunk in shared memory

__host__ __device__ constexpr int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four signed bytes -> two packed bf16 pairs (bytes 0, 1 and 2, 3; the
// lower byte in the lower half). 0x4B000000 | u is the float 2^23 + u,
// so with u = s + 128 subtracting 2^23 + 128 gives s exactly.
__device__ __forceinline__ void bytes_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
#ifdef LONGBOW_PROBE_NO_CONVERT  // timing probe: wrong values, no conversion
  lo = w, hi = w ^ 0x01010101u;
  return;
#endif
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.0f;
  __nv_bfloat162 p0 = __floats2bfloat162_rn(f0, f1);
  __nv_bfloat162 p1 = __floats2bfloat162_rn(f2, f3);
  lo = *reinterpret_cast<uint32_t*>(&p0);
  hi = *reinterpret_cast<uint32_t*>(&p1);
}

// 16 bytes from global to shared; bytes past `src_bytes` are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t saddr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src),
               "r"(src_bytes));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bitonic sort, ascending, of 32*E (value, id) pairs held in registers:
// element r * 32 + lane is (v[r], id[r]). Partners closer than 32 are
// exchanged with shuffles, farther ones between this lane's registers.
template <int E>
__device__ __forceinline__ void bitonic_regs(float (&v)[E], int (&id)[E], int lane) {
#pragma unroll
  for (int kk = 2; kk <= 32 * E; kk <<= 1) {
#pragma unroll
    for (int j = kk >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
        const int jr = j >> 5;
#pragma unroll
        for (int r = 0; r < E; ++r) {
          if ((r & jr) == 0) {
            const int r2 = r | jr;
            const bool asc = ((r * 32) & kk) == 0;
            if ((v[r] > v[r2]) == asc) {
              const float tv = v[r];
              v[r] = v[r2];
              v[r2] = tv;
              const int ti = id[r];
              id[r] = id[r2];
              id[r2] = ti;
            }
          }
        }
      } else {
        const bool lower = (lane & j) == 0;
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const bool asc = ((r * 32 + lane) & kk) == 0;
          const float ov = __shfl_xor_sync(0xffffffffu, v[r], j);
          const int oi = __shfl_xor_sync(0xffffffffu, id[r], j);
          // the lower index of a pair keeps the smaller value when the
          // run is ascending
          if (lower == asc ? ov < v[r] : ov > v[r]) {
            v[r] = ov;
            id[r] = oi;
          }
        }
      }
    }
  }
}

template <int E>
__device__ void sort_in_regs(float* d, int* ix, int n, int lane) {
  const float inf = __int_as_float(0x7f800000);
  float v[E];
  int id[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = r * 32 + lane;
    v[r] = i < n ? d[i] : inf;
    id[r] = i < n ? ix[i] : -1;
  }
  bitonic_regs<E>(v, id, lane);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = r * 32 + lane;
    if (i < n) {
      d[i] = v[r];
      ix[i] = id[r];
    }
  }
  __syncwarp();
}

// One warp sorts the first n entries of a query's buffer ascending: in
// registers up to 32 * MAXE entries (a tiling instantiates only the
// sizes its CAP needs), else bitonic in shared memory over the next power
// of two (the padding sorts last).
template <int MAXE>
__device__ void warp_sort(float* d, int* ix, int n, int lane) {
  if (n <= 32) return sort_in_regs<1>(d, ix, n, lane);
  if (n <= 64) return sort_in_regs<2>(d, ix, n, lane);
  if (n <= 128) return sort_in_regs<4>(d, ix, n, lane);
  if (n <= 256) return sort_in_regs<(MAXE < 8 ? MAXE : 8)>(d, ix, n, lane);
  if (MAXE >= 16 && n <= 512) return sort_in_regs<(MAXE < 16 ? MAXE : 16)>(d, ix, n, lane);
  if (MAXE >= 32 && n <= 1024) return sort_in_regs<(MAXE < 32 ? MAXE : 32)>(d, ix, n, lane);
  const int m = next_pow2(n);
  const float inf = __int_as_float(0x7f800000);
  for (int i = n + lane; i < m; i += 32) {
    d[i] = inf;
    ix[i] = -1;
  }
  __syncwarp();
  for (int kk = 2; kk <= m; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < m; i += 32) {
        const int p = i ^ j;
        if (p > i) {
          const float a = d[i], b = d[p];
          const bool asc = (i & kk) == 0;
          if ((a > b) == asc) {
            d[i] = b;
            d[p] = a;
            const int t = ix[i];
            ix[i] = ix[p];
            ix[p] = t;
          }
        }
      }
      __syncwarp();
    }
  }
}

// Host side. cudaFuncSetAttribute and the occupancy query are CUDA API
// calls that cost more than a small scan's launch, so each is made once
// per kernel, device and size and remembered.
std::mutex g_launch_mu;
std::map<std::tuple<const void*, int>, int> g_smem_allowed;
std::map<std::tuple<const void*, int, int, int>, int> g_blocks_per_sm;

// Let `kern` launch with `smem` bytes of dynamic shared memory on `device`
// (the current device); a kernel allowed more already is left alone.
inline cudaError_t allow_smem(const void* kern, int device, int smem) {
  std::lock_guard<std::mutex> hold(g_launch_mu);
  int& allowed = g_smem_allowed[std::make_tuple(kern, device)];
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

// Blocks of `kern` (`threads` a block, `smem` bytes) that fit on one SM.
inline cudaError_t blocks_per_sm(const void* kern, int device, int threads, int smem, int* nb) {
  cudaError_t e = allow_smem(kern, device, smem);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> hold(g_launch_mu);
  const auto key = std::make_tuple(kern, device, threads, smem);
  const auto it = g_blocks_per_sm.find(key);
  if (it != g_blocks_per_sm.end()) {
    *nb = it->second;
    return cudaSuccess;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(nb, kern, threads, smem);
  if (e == cudaSuccess) g_blocks_per_sm[key] = *nb;
  return e;
}

template <int WM, int WN, int NT, int STAGES, int MAXE>
struct Cfg {
  static constexpr int QB = 16 * WM;          // queries per block
  static constexpr int TN = 8 * NT * WN;      // corpus rows per tile
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int STAGES_ = STAGES;     // depth of the cp.async ring
  static constexpr int MAXCAP = 32 * MAXE;   // largest candidate buffer
};

// Two tilings: "wide" (64 queries x 128 rows, 16 warps, 2 stages) for
// batches, and "narrow" (16 queries x 128 rows, 4 warps, 2 stages) for
// small batches, large K or wide rows, whose candidate buffers would not
// fit the wide one. Both are latency-bound at one or two blocks per SM:
// on an H100 the 16-warp wide tiling measured faster than 8-warp ones
// with 64 rows or 32 queries per tile and 2 to 4 stages.
using Wide = Cfg<4, 4, 4, 2, 8>;
using Narrow = Cfg<1, 4, 4, 2, 32>;

// Choose the tiling and the corpus split for one call. plan[0..4] =
// tiling (0 wide, 1 narrow), S, rows per split, CAP, shared-memory
// bytes. smem_of(cfg, cap) is the bytes a block of tiling `cfg` needs
// with candidate buffers of `cap` slots; occupancy(cfg, smem, &nb) sets
// how many such blocks fit on one SM. Returns a cudaError_t, or -1 when
// no tiling fits the shared memory of the device.
template <class SmemOf, class Occupancy>
int choose_plan(int device, int B, int N, int K, SmemOf smem_of, Occupancy occupancy,
                int* plan) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  int sms = 0, max_smem = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  const int wide_first = B > Narrow::QB && K <= 64;
  for (int o = 0; o < 2; ++o) {
    const int cfg = (o == 0) == wide_first ? 0 : 1;
    const int qb = cfg == 0 ? Wide::QB : Narrow::QB;
    const int tn = cfg == 0 ? Wide::TN : Narrow::TN;
    for (int roomy = 1; roomy >= 0; --roomy) {
      const int cap = next_pow2((roomy ? 2 * K : K) + tn);
      const int maxcap = cfg == 0 ? Wide::MAXCAP : Narrow::MAXCAP;
      const int smem = smem_of(cfg, cap);
      if (cap > maxcap || smem > max_smem) continue;
      int nb = 0;
      e = occupancy(cfg, smem, &nb);
      if (e != cudaSuccess) return e;
      if (nb < 1) continue;
      // one wave: as many splits as the resident block slots allow
      const int slots = nb * sms;
      const int qblocks = (B + qb - 1) / qb;
      const int ntiles = (N + tn - 1) / tn;
      int S = qblocks < slots ? slots / qblocks : 1;
      if (S > ntiles) S = ntiles;
      if (S < 1) S = 1;
      const int tiles_per_split = ntiles > 0 ? (ntiles + S - 1) / S : 1;
      S = ntiles > 0 ? (ntiles + tiles_per_split - 1) / tiles_per_split : 1;
      plan[0] = cfg;
      plan[1] = S;
      plan[2] = tiles_per_split * tn;
      plan[3] = cap;
      plan[4] = smem;
      return 0;
    }
  }
  return -1;
}

}  // namespace
