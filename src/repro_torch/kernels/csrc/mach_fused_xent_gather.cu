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
//   3. dw_rows_kernel (mach_xent_dw.cuh, with dbias_kernel; the ELL
//      backward shares both) gives each dW row to a warp, which sums
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
#include "mach_xent_dw.cuh"

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
