// Shared pieces of the MACH decode kernels (mach_decode.cu, mach_topk.cu,
// mach_candidates.cu).
//
// A decode block holds the R*B meta-probabilities of a few queries in
// shared memory and walks classes k: it hashes k into R bucket ids (from
// the (R, K) table, or inline multiply-shift), gathers the R values per
// query from shared memory and reduces them.  Results are ranked on the
// key (value descending, class id ascending), so tie order is lowest id
// first whatever order blocks and threads run in.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace mach {

constexpr int kThreads = 256;   // threads per block, all kernels
constexpr int kMaxR = 32;       // largest R the kernels take (registers)
constexpr int kWorstIdx = 0x7fffffff;

// (v1, i1) ranks before (v2, i2): larger value, then smaller class id.
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Bucket ids h_r(k) for r < r_count.  Table mode reads table[r*K + k]
// (neighbouring threads read neighbouring classes: coalesced, L2-resident
// at ODP's 10.5 MB); inline mode computes (a_r * k mod 2^32) >> shift.
template <bool kInline>
__device__ __forceinline__ void bucket_ids(int (&h)[kMaxR], int k, int r_count,
                                           int num_classes,
                                           const int* __restrict__ table,
                                           const uint32_t (&a)[kMaxR],
                                           int shift) {
#pragma unroll
  for (int j = 0; j < kMaxR; ++j) {
    if (j < r_count) {
      if (kInline) {
        h[j] = static_cast<int>((a[j] * static_cast<uint32_t>(k)) >> shift);
      } else {
        h[j] = __ldg(table + static_cast<size_t>(j) * num_classes + k);
      }
    }
  }
}

template <bool kInline>
__device__ __forceinline__ void load_coeffs(uint32_t (&a)[kMaxR], int r_count,
                                            const long long* __restrict__ coeffs) {
#pragma unroll
  for (int j = 0; j < kMaxR; ++j) {
    a[j] = (kInline && j < r_count) ? static_cast<uint32_t>(coeffs[j]) : 0u;
  }
}

// Sum over r in order r = 0..R-1 (the plain version's order).
__device__ __forceinline__ float gather_sum(const float* __restrict__ p,
                                            const int (&h)[kMaxR], int r_count,
                                            int b) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxR; ++j) {
    if (j < r_count) s = __fadd_rn(s, p[j * b + h[j]]);
  }
  return s;
}

// Median of g[0, r_count), the pads g[r_count, kMaxR) holding +inf: an
// ascending bitonic network over the kMaxR registers (every index is a
// compile-time constant once unrolled, so g stays in registers), then the
// midpoint of order statistics (R-1)/2 and R/2, as jnp.median.
__device__ __forceinline__ float sorted_median(float (&g)[kMaxR], int r_count) {
#pragma unroll
  for (int size = 2; size <= kMaxR; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const float x = g[i], y = g[j];
          const bool up = (i & size) == 0;
          g[i] = up ? fminf(x, y) : fmaxf(x, y);
          g[j] = up ? fmaxf(x, y) : fminf(x, y);
        }
      }
    }
  }
  const int lo = (r_count - 1) / 2, hi = r_count / 2;
  float v_lo = 0.f, v_hi = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxR; ++i) {
    if (i == lo) v_lo = g[i];
    if (i == hi) v_hi = g[i];
  }
  return __fmul_rn(__fadd_rn(v_lo, v_hi), 0.5f);
}

// Bitonic sort of n (a power of two) keys in shared memory, best key
// first.  All threads of the block take part; ends synchronised.
__device__ __forceinline__ void bitonic_sort_best_first(float* v, int* idx,
                                                        int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool best_first = (lo & size) == 0;
        const float va = v[lo], vb = v[hi];
        const int ia = idx[lo], ib = idx[hi];
        const bool swap = best_first ? better(vb, ib, va, ia)
                                     : better(va, ia, vb, ib);
        if (swap) {
          v[lo] = vb; v[hi] = va;
          idx[lo] = ib; idx[hi] = ia;
        }
      }
      __syncthreads();
    }
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory when asked.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (bytes > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace mach
