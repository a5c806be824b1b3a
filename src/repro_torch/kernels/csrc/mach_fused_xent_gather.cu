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
// independent of nnz and d.  Here a block owns one example row and one
// head group.  Its 8 warps split the row's slots (slot t goes to warp
// t mod 8); each lane accumulates v * W[col, c] for 4 columns of the
// 128-column chunk, reading 32 neighbouring floats of W[col] per warp
// (coalesced).  The 8 partial logits rows are summed in shared memory in
// warp order.  Block state is O(chunk), whatever nnz and d are.  Padded
// slots (col outside [0, d)) are skipped, so W[d] is never read.
//
// What bounds it on this card: bytes — the W rows gathered (N*nnz*R*B*4
// = 1.68 GB at ODP with nnz = 1,024 if no row repeated, fewer after L2
// hits on popular features) forward; backward adds the dense dW output
// (1.35 GB at ODP), zero-filled by the caller and read-modify-written
// with atomicAdd of v * dlogits.
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

__global__ void __launch_bounds__(kThreads)
gather_bwd_kernel(const int* __restrict__ ell_cols,
                  const float* __restrict__ ell_vals,
                  const float* __restrict__ w, const float* __restrict__ bias,
                  const int* __restrict__ labels,
                  const float* __restrict__ lse, const float* __restrict__ g,
                  int j, int d, int r, int b, int hpg, float* __restrict__ dw,
                  float* __restrict__ dbias) {
  __shared__ float P[kWarps * kChunk];
  __shared__ float L[kLd];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x;
  const Group grp = group_of(blockIdx.y, hpg, r, b);
  const int cols = r * b;
  const int* cs = ell_cols + static_cast<size_t>(row) * j;
  const float* vs = ell_vals + static_cast<size_t>(row) * j;
  const size_t roff = static_cast<size_t>(row) * r;
  for (int cc = grp.c_begin; cc < grp.c_end; cc += kChunk) {
    const int cw = min(kChunk, grp.c_end - cc);
    gather_logits(cs, vs, j, w, bias, d, cols, cc, cw, P, L);
    dlogits_in_place(L, 1, 1, cc, cw, b, labels + roff, lse + roff, g + row, r);
    add_dbias(L, 1, cc, cw, dbias);
    // scatter: dW[cols[t]][cc + c] += vals[t] * dlogits[c], slots by warp
    for (int t = warp; t < j; t += kWarps) {
      const int col = cs[t];
      if (col < 0 || col >= d) continue;
      const float v = vs[t];
      float* dr = dw + static_cast<size_t>(col) * cols + cc;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int c = lane + 32 * q;
        if (c < cw) atomicAdd(dr + c, v * L[c]);
      }
    }
    __syncthreads();
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

// lse (n, r) from the forward; g (n,) f32; dw (d, r*b) and dbias (r*b,)
// or null, zero-filled by the caller.
int fused_xent_gather_bwd_launch(const void* cols, const void* vals,
                                 const void* w, const void* bias,
                                 const void* labels, const void* lse,
                                 const void* g, int n, int j, int d, int r,
                                 int b, void* dw, void* dbias, void* stream) {
  if (n < 1 || j < 1 || d < 1 || r < 1 || b < 1 ||
      (bias == nullptr) != (dbias == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int hpg = mach::heads_per_group(b);
  const dim3 grid(n, (r + hpg - 1) / hpg);
  mach::gather_bwd_kernel<<<grid, mach::kThreads, 0, s>>>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(g), j, d, r, b, hpg, static_cast<float*>(dw),
      static_cast<float*>(dbias));
  return static_cast<int>(cudaGetLastError());
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
