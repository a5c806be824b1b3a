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

// (value, id) as one 64-bit key, larger ranking first: the value's
// order-preserving bits above (-0.0 folded into +0.0, which the plain
// versions count equal and order by id), 2^32 - 1 - id below, so one
// unsigned compare ranks (value descending, id ascending).  Every real key
// is nonzero; 0 is the empty slot and ranks last.
using Key = unsigned long long;

__device__ __forceinline__ Key value_key(float v, int id) {
  uint32_t u = __float_as_uint(__fadd_rn(v, 0.0f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<Key>(u) << 32) |
         static_cast<Key>(0xffffffffu - static_cast<uint32_t>(id));
}

__device__ __forceinline__ int key_id(Key key) {
  return static_cast<int>(0xffffffffu - static_cast<uint32_t>(key));
}

__device__ __forceinline__ float key_value(Key key) {
  uint32_t u = static_cast<uint32_t>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

// Insert x into a lane's list, best first, keeping its kLen best keys.
template <int kLen>
__device__ __forceinline__ void keep_best(Key (&list)[kLen], Key x) {
  if (x > list[kLen - 1]) {
#pragma unroll
    for (int i = kLen - 1; i > 0; --i) {
      list[i] = x > list[i - 1] ? list[i - 1] : (x > list[i] ? x : list[i]);
    }
    list[0] = x > list[0] ? x : list[0];
  }
}

// One bitonic stage sequence over the 32 * kV keys a warp holds, key[j] of
// lane l at position p = l * kV + j: strides below kV pair two registers
// of one lane, larger ones the same register of lanes l and l ^ (stride /
// kV).  Every index is a compile-time constant once unrolled, so the keys
// stay in registers.  `size` is the length of the bitonic runs merged.
template <int kV>
__device__ __forceinline__ void warp_bitonic_stage(Key (&key)[kV], int lane,
                                                   int size) {
#pragma unroll
  for (int stride = 16 * kV; stride > 0; stride >>= 1) {
    if (stride >= size) continue;
    if (stride >= kV) {
      const int lanes = stride / kV;
      const bool lower = (lane & lanes) == 0;
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const Key other = __shfl_xor_sync(0xffffffffu, key[j], lanes);
        const bool best_first = ((lane * kV + j) & size) == 0;
        const bool keep_larger = lower == best_first;
        key[j] = (other > key[j]) == keep_larger ? other : key[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const int jj = j ^ stride;
        if (jj > j) {
          const bool best_first = ((lane * kV + j) & size) == 0;
          const Key x = key[j], y = key[jj];
          const bool swap = best_first ? y > x : x > y;
          key[j] = swap ? y : x;
          key[jj] = swap ? x : y;
        }
      }
    }
  }
}

// Bitonic sort, best first, of the 32 * kV keys a warp holds.
template <int kV>
__device__ __forceinline__ void warp_sort_desc(Key (&key)[kV], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * kV; size <<= 1) {
    warp_bitonic_stage<kV>(key, lane, size);
  }
}

// 4-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// Opt a kernel into more than 48 KB of shared memory when asked: the
// default limit holds the dynamic bytes and the kernel's static ones
// together, and the static ones here stay under 1 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 47 * 1024) return cudaSuccess;
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
