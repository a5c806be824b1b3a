// Shared pieces of the sparse fused-xent backwards (mach_fused_xent_gather.cu,
// mach_fused_xent_ell.cu): dbias as the column sums of the (N, R*B)
// dlogits, and dW written a row at a time from the batch in column order
// (colptr (d + 1) and, for each feature, its (row, val) pairs in
// ascending (row, slot) order) and the dlogits.  Every dW row is written
// once, zeros where the batch does not touch the feature, so dW needs no
// zero fill; every sum runs in a fixed order, so the same bits come back
// from run to run.
#pragma once

#include "mach_common.cuh"

namespace mach {

constexpr int kBiasCols = 32;                 // dbias columns a block sums
constexpr int kBiasSlices = kThreads / kBiasCols;

// dbias[c] = sum over n of dlogits[n, c]: thread (slice, column) sums a
// contiguous run of rows in order, then the slices are added in order.
__global__ void __launch_bounds__(kThreads)
dbias_kernel(const float* __restrict__ dlogits, int n, int cols,
             float* __restrict__ dbias) {
  __shared__ float part[kBiasSlices][kBiasCols];
  const int cx = threadIdx.x % kBiasCols, slice = threadIdx.x / kBiasCols;
  const int c = blockIdx.x * kBiasCols + cx;
  const int per = (n + kBiasSlices - 1) / kBiasSlices;
  const int n0 = slice * per, n1 = min(n, n0 + per);
  float acc = 0.f;
  if (c < cols) {
    for (int i = n0; i < n1; ++i) {
      acc += dlogits[static_cast<size_t>(i) * cols + c];
    }
  }
  part[slice][cx] = acc;
  __syncthreads();
  if (slice == 0 && c < cols) {
    float s = 0.f;
    for (int k = 0; k < kBiasSlices; ++k) s += part[k][cx];
    dbias[c] = s;
  }
}

constexpr int kHeavyTerms = 64;    // pairs above which a block shares a dW row
constexpr int kRowVecs = 8;        // vectors a lane holds of a dW row tile
constexpr int kHeavyWarps = 32;    // warps sharing one heavy row

template <int E> struct Vec;
template <> struct Vec<4> {
  using type = float4;
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void fma(float4& acc, float v,
                                             const float4& x) {
    acc.x = fmaf(v, x.x, acc.x);
    acc.y = fmaf(v, x.y, acc.y);
    acc.z = fmaf(v, x.z, acc.z);
    acc.w = fmaf(v, x.w, acc.w);
  }
  static __device__ __forceinline__ void add(float4& acc, const float4& x) {
    acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
  }
};
template <> struct Vec<1> {
  using type = float;
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ void fma(float& acc, float v, float x) {
    acc = fmaf(v, x, acc);
  }
  static __device__ __forceinline__ void add(float& acc, float x) {
    acc += x;
  }
};

// Backward launch 3a: warps stride over the dW rows, a row at a time.
// E floats a vector (4 when R*B is a multiple of 4, else 1); a lane holds
// kRowVecs vectors of a 32*kRowVecs*E-column tile.  The row's pairs are
// loaded 32 at a time, one a lane, and broadcast; a pair's kRowVecs loads
// of its dlogits row are in flight at once.
template <int E>
__global__ void __launch_bounds__(kThreads)
dw_rows_kernel(const int* __restrict__ colptr, const int* __restrict__ term_row,
               const float* __restrict__ term_val,
               const float* __restrict__ dlogits, int d, int cols,
               float* __restrict__ dw, int* __restrict__ heavy,
               int* __restrict__ heavy_count) {
  using V = typename Vec<E>::type;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int nv = cols / E;                    // vectors a row
  const int warps = gridDim.x * (kThreads / 32);
  for (int f = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); f < d;
       f += warps) {
    const int s = colptr[f], e = colptr[f + 1];
    if (e - s > kHeavyTerms) {
      if (lane == 0) heavy[atomicAdd(heavy_count, 1)] = f;
      continue;
    }
    V* dst = reinterpret_cast<V*>(dw + static_cast<size_t>(f) * cols);
    for (int v0 = 0; v0 < nv; v0 += 32 * kRowVecs) {
      V acc[kRowVecs];
#pragma unroll
      for (int q = 0; q < kRowVecs; ++q) acc[q] = Vec<E>::zero();
      for (int kb = s; kb < e; kb += 32) {
        const int mine = kb + lane;
        const int row = mine < e ? term_row[mine] : 0;
        const float val = mine < e ? term_val[mine] : 0.f;
        const int m = min(32, e - kb);
        for (int k = 0; k < m; ++k) {
          const int r = __shfl_sync(full, row, k);
          const V* x = reinterpret_cast<const V*>(
              dlogits + static_cast<size_t>(r) * cols) + v0;
          const float v = __shfl_sync(full, val, k);
          V y[kRowVecs];
#pragma unroll
          for (int q = 0; q < kRowVecs; ++q) {
            if (v0 + q * 32 + lane < nv) y[q] = x[q * 32 + lane];
          }
#pragma unroll
          for (int q = 0; q < kRowVecs; ++q) {
            if (v0 + q * 32 + lane < nv) Vec<E>::fma(acc[q], v, y[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kRowVecs; ++q) {
        if (v0 + q * 32 + lane < nv) dst[v0 + q * 32 + lane] = acc[q];
      }
    }
  }
}

// Backward launch 3b: one block a (column tile of 32*E columns, listed
// heavy row); blocks stride over the list.  Warp w sums the w-th of
// kHeavyWarps contiguous runs of the row's pairs, loading 32 pairs at a
// time, one a lane, with 8 pairs' dlogits loads in flight; the partial
// sums are added in warp order.
template <int E>
__global__ void __launch_bounds__(kHeavyWarps * 32)
dw_heavy_kernel(const int* __restrict__ colptr,
                const int* __restrict__ term_row,
                const float* __restrict__ term_val,
                const float* __restrict__ dlogits, int cols,
                const int* __restrict__ heavy,
                const int* __restrict__ heavy_count, float* __restrict__ dw) {
  using V = typename Vec<E>::type;
  __shared__ V part[kHeavyWarps][32];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = cols / E;
  const int iv = blockIdx.x * 32 + lane;      // this lane's vector
  const bool mine_col = iv < nv;
  const V* col = reinterpret_cast<const V*>(dlogits) + (mine_col ? iv : 0);
  const int count = *heavy_count;
  for (int hi = blockIdx.y; hi < count; hi += gridDim.y) {
    const int f = heavy[hi];
    const int s = colptr[f], e = colptr[f + 1];
    const int per = (e - s + kHeavyWarps - 1) / kHeavyWarps;
    const int k0 = min(e, s + warp * per), k1 = min(e, k0 + per);
    V acc = Vec<E>::zero();
    for (int kb = k0; kb < k1; kb += 32) {
      const int mine = kb + lane;
      const int row = mine < k1 ? term_row[mine] : 0;
      const float val = mine < k1 ? term_val[mine] : 0.f;
      const int m = min(32, k1 - kb);
#pragma unroll 8
      for (int k = 0; k < m; ++k) {
        const int r = __shfl_sync(full, row, k);
        const float v = __shfl_sync(full, val, k);
        if (mine_col) Vec<E>::fma(acc, v, col[static_cast<size_t>(r) * nv]);
      }
    }
    part[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && mine_col) {
      V sum = part[0][lane];
      for (int k = 1; k < kHeavyWarps; ++k) Vec<E>::add(sum, part[k][lane]);
      reinterpret_cast<V*>(dw + static_cast<size_t>(f) * cols)[iv] = sum;
    }
    __syncthreads();
  }
}

template <int E>
cudaError_t launch_dw(const int* colptr, const int* term_row,
                      const float* term_val, const float* dlogits, int d,
                      int cols, float* dw, int* heavy, int* heavy_count,
                      cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(heavy_count, 0, sizeof(int), s);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const int rows_per_block = kThreads / 32;
  const int blocks = (d + rows_per_block - 1) / rows_per_block;
  dw_rows_kernel<E><<<blocks < 4 * sms ? blocks : 4 * sms, kThreads, 0, s>>>(
      colptr, term_row, term_val, dlogits, d, cols, dw, heavy, heavy_count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = (cols / E + 31) / 32;
  // about 8 waves of 132 blocks; blocks past the list exit at once
  const dim3 grid(tiles, tiles < 1056 ? 1056 / tiles : 1);
  dw_heavy_kernel<E><<<grid, kHeavyWarps * 32, 0, s>>>(
      colptr, term_row, term_val, dlogits, cols, heavy, heavy_count, dw);
  return cudaGetLastError();
}

}  // namespace mach
