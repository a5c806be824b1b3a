// Fused projection + R-head cross-entropy on a padded-ELL sparse batch
// with many nonzeros a row (bag-of-words, nnz >= 512), forward and
// backward, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/mach_fused_xent.py::
// mach_fused_xent_gather_pallas.  The same function as
// mach_fused_xent_ell.cu: cols/vals (N, J) with padding col id d and val
// 0, W (d, R*B), optional bias, labels (N, R) -> loss (N,), lse (N, R);
// backward dW and dbias; vals get no gradient.
//
// The TPU kernel prefetched the ELL ids into scalar memory and let each
// grid step DMA one W row, so its per-step state stayed O(columns),
// independent of nnz and d.  Forward: a block owns one example row and
// one head group.  Its 8 warps split the row's slots (slot t goes to warp
// t mod 8); each lane accumulates v * W[col, c] for 4 columns of the
// 128-column chunk, reading 32 neighbouring floats of W[col] per warp
// (coalesced).  The 8 partial logits rows are summed in shared memory in
// warp order.  Block state is O(chunk), whatever nnz and d are.  Padded
// slots (col outside [0, d)) are skipped, so W[d] is never read.
//
// Backward, in three launches and torch.sort between the first two
// (kernels/mach_fused_xent.py::gather_bwd_cuda):
//   1. gather_dlogits_kernel re-gathers each logits chunk as the forward
//      does, forms dlogits = g * (softmax - onehot) from the saved lse and
//      writes them to an (N, R*B) float32 scratch (1.6 MB at ODP); it also
//      writes each slot's sort key (its col id, d for padding), and
//      dbias_kernel sums the scratch's columns over N in a fixed order.
//   2. The keys, sorted stably, put the batch in column order: for each
//      feature f (a row of W), its (example row, val) pairs in ascending
//      (row, slot) order, duplicates kept, padding last.  order_kernel
//      writes colptr (d + 1) by binary search and the pairs.
//   3. dw_rows_kernel gives each dW row to a warp, which sums
//      v * dlogits[row, :] over the row's pairs in that order in registers
//      and stores the R*B floats once (16-byte stores where R*B % 4 == 0);
//      rows the batch does not touch get zeros from the same store, so dW
//      needs no zero fill.  A row with more than kHeavyTerms pairs (a
//      popular feature) is listed instead, and dw_heavy_kernel gives it a
//      block per 128 columns: warp w sums the w-th of 32 contiguous runs
//      of its pairs, and the 32 partial sums are added in warp order.
// No float atomics touch dW or dbias, so the backward returns the same
// bits from run to run.
//
// What bounds it on this card: bytes — the W rows gathered (N*nnz*R*B*4
// = 1.68 GB at ODP with nnz = 1,024 if no row repeated, fewer after L2
// hits on popular features) forward and again in the backward's first
// launch; the backward adds the dense dW output (1.35 GB at ODP), written
// once.  The dlogits rows dW sums (N*nnz*R*B*4 bytes again) come from L2.
#include "mach_xent_common.cuh"

namespace mach {

constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = kChunk / 32;

// L[0][c] = sum_t vals[t] * W[cols[t]][cc + c] (+ bias) for one row.
// P: kWarps x kChunk partials.  Ends synchronised.
__device__ void gather_logits(const int* __restrict__ cs,
                              const float* __restrict__ vs, int j,
                              const float* __restrict__ w,
                              const float* __restrict__ bias, int d, int cols,
                              int cc, int cw, float* P, float* L) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) acc[q] = 0.f;
  for (int t = warp; t < j; t += kWarps) {
    const int col = cs[t];
    if (col < 0 || col >= d) continue;
    const float v = vs[t];
    const float* wr = w + static_cast<size_t>(col) * cols + cc;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int c = lane + 32 * q;
      if (c < cw) acc[q] = fmaf(v, wr[c], acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) P[warp * kChunk + lane + 32 * q] = acc[q];
  __syncthreads();
  for (int c = threadIdx.x; c < kChunk; c += blockDim.x) {
    float s = 0.f;
    if (c < cw) {
      for (int k = 0; k < kWarps; ++k) s += P[k * kChunk + c];
      if (bias != nullptr) s += bias[cc + c];
    }
    L[c] = s;
  }
  __syncthreads();
}

// grid (N, head groups); static shared memory.
__global__ void __launch_bounds__(kThreads)
gather_fwd_kernel(const int* __restrict__ ell_cols,
                  const float* __restrict__ ell_vals,
                  const float* __restrict__ w, const float* __restrict__ bias,
                  const int* __restrict__ labels, int j, int d, int r, int b,
                  int hpg, float* __restrict__ lse, float* __restrict__ nll) {
  __shared__ float P[kWarps * kChunk];
  __shared__ float L[kLd];
  __shared__ float sm[kMaxHeads], ss[kMaxHeads], sp[kMaxHeads];
  const int row = blockIdx.x;
  const Group grp = group_of(blockIdx.y, hpg, r, b);
  const int* cs = ell_cols + static_cast<size_t>(row) * j;
  const float* vs = ell_vals + static_cast<size_t>(row) * j;
  stats_init(sm, ss, sp, kMaxHeads);
  __syncthreads();
  for (int cc = grp.c_begin; cc < grp.c_end; cc += kChunk) {
    const int cw = min(kChunk, grp.c_end - cc);
    gather_logits(cs, vs, j, w, bias, d, r * b, cc, cw, P, L);
    online_update(L, 1, cc, cw, b, grp.h0,
                  labels + static_cast<size_t>(row) * r, r, sm, ss, sp);
  }
  flush_stats(sm, ss, sp, 1, row, grp.h0, grp.nh, r, lse, nll);
}

// Backward launch 1: dlogits of one example row and head group into the
// (N, R*B) scratch; the row's sort keys from the group-0 block.
__global__ void __launch_bounds__(kThreads)
gather_dlogits_kernel(const int* __restrict__ ell_cols,
                      const float* __restrict__ ell_vals,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      const int* __restrict__ labels,
                      const float* __restrict__ lse,
                      const float* __restrict__ g, int j, int d, int r, int b,
                      int hpg, float* __restrict__ dlogits,
                      int* __restrict__ keys) {
  __shared__ float P[kWarps * kChunk];
  __shared__ float L[kLd];
  const int row = blockIdx.x;
  const Group grp = group_of(blockIdx.y, hpg, r, b);
  const int cols = r * b;
  const int* cs = ell_cols + static_cast<size_t>(row) * j;
  const float* vs = ell_vals + static_cast<size_t>(row) * j;
  const size_t roff = static_cast<size_t>(row) * r;
  if (blockIdx.y == 0) {
    for (int t = threadIdx.x; t < j; t += blockDim.x) {
      const int col = cs[t];
      keys[static_cast<size_t>(row) * j + t] =
          (col >= 0 && col < d) ? col : d;
    }
  }
  for (int cc = grp.c_begin; cc < grp.c_end; cc += kChunk) {
    const int cw = min(kChunk, grp.c_end - cc);
    gather_logits(cs, vs, j, w, bias, d, cols, cc, cw, P, L);
    dlogits_in_place(L, 1, 1, cc, cw, b, labels + roff, lse + roff, g + row, r);
    float* out = dlogits + static_cast<size_t>(row) * cols + cc;
    for (int c = threadIdx.x; c < cw; c += blockDim.x) out[c] = L[c];
    // gather_logits writes L only after its own barrier: no sync here
  }
}

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

// Backward launch 2: from the stably sorted keys (m = N*J of them, the
// padding's key d last) and their slot indices, colptr[f] = the first
// position whose key is >= f (f = 0..d), and the pairs in column order:
// term_row = slot / J, term_val = vals[slot], for the valid positions.
__global__ void __launch_bounds__(kThreads)
order_kernel(const int* __restrict__ sorted_keys,
             const long long* __restrict__ slots,
             const float* __restrict__ ell_vals, int m, int j, int d,
             int* __restrict__ colptr, int* __restrict__ term_row,
             float* __restrict__ term_val) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i <= d) {
    int lo = 0, hi = m;                       // lower bound of i
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sorted_keys[mid] < i) lo = mid + 1; else hi = mid;
    }
    colptr[i] = lo;
  }
  if (i < m && sorted_keys[i] < d) {
    const long long slot = slots[i];
    term_row[i] = static_cast<int>(slot / j);
    term_val[i] = ell_vals[slot];
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

extern "C" {

// cols (n, j) int32, vals (n, j) f32 — padded ELL; w (d, r*b) f32; bias
// (r*b,) f32 or null; labels (n, r) int32; outputs lse (n, r), nll (n, r)
// scratch, loss (n,).
int fused_xent_gather_fwd_launch(const void* cols, const void* vals,
                                 const void* w, const void* bias,
                                 const void* labels, int n, int j, int d,
                                 int r, int b, void* lse, void* nll,
                                 void* loss, void* stream) {
  if (n < 1 || j < 1 || d < 1 || r < 1 || b < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int hpg = mach::heads_per_group(b);
  const dim3 grid(n, (r + hpg - 1) / hpg);
  mach::gather_fwd_kernel<<<grid, mach::kThreads, 0, s>>>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(labels), j, d, r, b, hpg,
      static_cast<float*>(lse), static_cast<float*>(nll));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(mach::launch_sum_heads(
      static_cast<const float*>(nll), n, r, static_cast<float*>(loss), s));
}

// Backward launch 1.  lse (n, r) from the forward; g (n,) f32 ->
// dlogits (n, r*b) f32 scratch, keys (n, j) int32 scratch (col id, d for
// padding), dbias (r*b,) or null (with bias null).
int fused_xent_gather_dlogits_launch(const void* cols, const void* vals,
                                     const void* w, const void* bias,
                                     const void* labels, const void* lse,
                                     const void* g, int n, int j, int d,
                                     int r, int b, void* dlogits, void* keys,
                                     void* dbias, void* stream) {
  if (n < 1 || j < 1 || d < 1 || r < 1 || b < 1 ||
      (bias == nullptr) != (dbias == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int hpg = mach::heads_per_group(b);
  const dim3 grid(n, (r + hpg - 1) / hpg);
  mach::gather_dlogits_kernel<<<grid, mach::kThreads, 0, s>>>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(g), j, d, r, b, hpg,
      static_cast<float*>(dlogits), static_cast<int*>(keys));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dbias == nullptr) return static_cast<int>(err);
  const int c = r * b;
  mach::dbias_kernel<<<(c + mach::kBiasCols - 1) / mach::kBiasCols,
                       mach::kThreads, 0, s>>>(
      static_cast<const float*>(dlogits), n, c, static_cast<float*>(dbias));
  return static_cast<int>(cudaGetLastError());
}

// Backward launch 2.  sorted_keys (m,) int32 sorted stably, slots (m,)
// int64 their positions in the (n, j) batch -> colptr (d + 1,) int32,
// term_row (m,) int32, term_val (m,) f32 (the first colptr[d] valid).
int fused_xent_gather_order_launch(const void* sorted_keys, const void* slots,
                                   const void* vals, int m, int j, int d,
                                   void* colptr, void* term_row,
                                   void* term_val, void* stream) {
  if (m < 1 || j < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int span = (m > d + 1 ? m : d + 1);
  mach::order_kernel<<<(span + mach::kThreads - 1) / mach::kThreads,
                       mach::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sorted_keys),
      static_cast<const long long*>(slots), static_cast<const float*>(vals), m,
      j, d, static_cast<int*>(colptr), static_cast<int*>(term_row),
      static_cast<float*>(term_val));
  return static_cast<int>(cudaGetLastError());
}

// Backward launch 3.  dW (d, cols) f32, every row written (no zero fill
// needed) from colptr / term_row / term_val and the dlogits scratch
// (n, cols).  heavy (at most d) and heavy_count (1) int32 scratch.
// vec4 == 1 needs cols % 4 == 0 and 16-byte aligned dlogits and dw.
int fused_xent_gather_dw_launch(const void* colptr, const void* term_row,
                                const void* term_val, const void* dlogits,
                                int d, int cols, int vec4, void* dw,
                                void* heavy, void* heavy_count, void* stream) {
  if (d < 1 || cols < 1 || (vec4 && cols % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto cp = static_cast<const int*>(colptr);
  auto tr = static_cast<const int*>(term_row);
  auto tv = static_cast<const float*>(term_val);
  auto dl = static_cast<const float*>(dlogits);
  auto out = static_cast<float*>(dw);
  auto hv = static_cast<int*>(heavy);
  auto hc = static_cast<int*>(heavy_count);
  const cudaError_t err =
      vec4 ? mach::launch_dw<4>(cp, tr, tv, dl, d, cols, out, hv, hc, s)
           : mach::launch_dw<1>(cp, tr, tv, dl, d, cols, out, hv, hc, s);
  return static_cast<int>(err);
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
