// Fused projection + R-head cross-entropy on a padded-ELL sparse batch
// (the ODP default, nnz below 512), forward and backward, for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/mach_fused_xent.py::
// mach_fused_xent_sparse_pallas.  cols/vals (N, J) — row n's feature ids
// and weights, padded slots carrying col id d and val 0 — W (d, R*B),
// optional bias (R*B,), labels (N, R) -> loss (N,), lse (N, R); backward
// dW (d, R*B) and dbias.  vals get no gradient.
//
// The TPU kernel densified each (rows x d-block) activation slice in VMEM
// through a one-hot contraction, because its matrix unit needs dense
// tiles.  Here a block stages the ELL entries of up to 16 rows in shared
// memory and its threads own logits columns: for every valid slot a warp
// reads 32 neighbouring floats of the row W[col] (coalesced) and
// accumulates v * W[col, c].  Slots whose col id is outside [0, d) — the
// padding — are skipped, so W[d] is never read.  Duplicate ids sum.
//
// What bounds it on this card: bytes.  Forward, the W rows the batch
// touches (at ODP, N = 512, nnz = 120, R*B = 800: at most 197 MB if no
// row repeats; the Zipf-popular ones are served from L2).  Backward, the
// dense dW output (d*R*B*4 = 1.35 GB at ODP), which the caller zero-fills
// and the kernel read-modify-writes row by row with atomicAdd of
// v * dlogits (duplicates and repeated features sum in the atomics).
#include "mach_xent_common.cuh"

namespace mach {

constexpr int kMaxRows = 16;      // rows a block owns (fewer at large J)

// L[n][c] = sum_j vals[n][j] * W[cols[n][j]][cc + c] (+ bias) over the
// staged rows; two row parities over the 256 threads, one column each.
// Ends synchronised.
__device__ void ell_logits(const int* cs, const float* vs, int rows, int j,
                           const float* __restrict__ w,
                           const float* __restrict__ bias, int d, int cols,
                           int cc, int cw, float* L) {
  const int c = threadIdx.x % kChunk, parity = threadIdx.x / kChunk;
  for (int n = parity; n < rows; n += kThreads / kChunk) {
    float acc = 0.f;
    if (c < cw) {
      const float* wc = w + cc + c;
      for (int t = 0; t < j; ++t) {
        const int col = cs[n * j + t];
        if (col >= 0 && col < d)
          acc = fmaf(vs[n * j + t], wc[static_cast<size_t>(col) * cols], acc);
      }
      if (bias != nullptr) acc += bias[cc + c];
    }
    L[n * kLd + c] = acc;
  }
  __syncthreads();
}

__device__ void stage_rows(const int* __restrict__ ell_cols,
                           const float* __restrict__ ell_vals, int row0,
                           int rows, int j, int* cs, float* vs) {
  const size_t base = static_cast<size_t>(row0) * j;
  for (int i = threadIdx.x; i < rows * j; i += blockDim.x) {
    cs[i] = ell_cols[base + i];
    vs[i] = ell_vals[base + i];
  }
  __syncthreads();
}

// grid (ceil(N/rows_per_block), head groups); dynamic shared memory
// smem_bytes(rows_per_block, j).
__global__ void __launch_bounds__(kThreads)
ell_fwd_kernel(const int* __restrict__ ell_cols,
               const float* __restrict__ ell_vals, const float* __restrict__ w,
               const float* __restrict__ bias, const int* __restrict__ labels,
               int n, int j, int d, int r, int b, int hpg, int rows_per_block,
               float* __restrict__ lse, float* __restrict__ nll) {
  extern __shared__ float smem[];
  float* L = smem;                                // kMaxRows x kLd
  float* sm = L + kMaxRows * kLd;                 // 3 x kMaxRows x kMaxHeads
  float* ss = sm + kMaxRows * kMaxHeads;
  float* sp = ss + kMaxRows * kMaxHeads;
  float* vs = sp + kMaxRows * kMaxHeads;          // rows_per_block x j
  int* cs = reinterpret_cast<int*>(vs + rows_per_block * j);

  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n - row0);
  const Group grp = group_of(blockIdx.y, hpg, r, b);
  stage_rows(ell_cols, ell_vals, row0, rows, j, cs, vs);
  stats_init(sm, ss, sp, kMaxRows * kMaxHeads);
  for (int cc = grp.c_begin; cc < grp.c_end; cc += kChunk) {
    const int cw = min(kChunk, grp.c_end - cc);
    ell_logits(cs, vs, rows, j, w, bias, d, r * b, cc, cw, L);
    online_update(L, rows, cc, cw, b, grp.h0,
                  labels + static_cast<size_t>(row0) * r, r, sm, ss, sp);
  }
  flush_stats(sm, ss, sp, rows, row0, grp.h0, grp.nh, r, lse, nll);
}

__global__ void __launch_bounds__(kThreads)
ell_bwd_kernel(const int* __restrict__ ell_cols,
               const float* __restrict__ ell_vals, const float* __restrict__ w,
               const float* __restrict__ bias, const int* __restrict__ labels,
               const float* __restrict__ lse, const float* __restrict__ g,
               int n, int j, int d, int r, int b, int hpg, int rows_per_block,
               float* __restrict__ dw, float* __restrict__ dbias) {
  extern __shared__ float smem[];
  float* L = smem;                                // kMaxRows x kLd
  float* vs = L + kMaxRows * kLd + 3 * kMaxRows * kMaxHeads;
  int* cs = reinterpret_cast<int*>(vs + rows_per_block * j);

  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n - row0);
  const Group grp = group_of(blockIdx.y, hpg, r, b);
  const int cols = r * b;
  const size_t roff = static_cast<size_t>(row0) * r;
  stage_rows(ell_cols, ell_vals, row0, rows, j, cs, vs);
  for (int cc = grp.c_begin; cc < grp.c_end; cc += kChunk) {
    const int cw = min(kChunk, grp.c_end - cc);
    ell_logits(cs, vs, rows, j, w, bias, d, cols, cc, cw, L);
    dlogits_in_place(L, kMaxRows, rows, cc, cw, b, labels + roff, lse + roff,
                     g + row0, r);
    add_dbias(L, rows, cc, cw, dbias);
    // scatter: dW[cols[n][t]][cc + c] += vals[n][t] * dlogits[n][c]
    const int c = threadIdx.x % kChunk, parity = threadIdx.x / kChunk;
    if (c < cw) {
      for (int nn = parity; nn < rows; nn += kThreads / kChunk) {
        const float dl = L[nn * kLd + c];
        for (int t = 0; t < j; ++t) {
          const int col = cs[nn * j + t];
          if (col >= 0 && col < d)
            atomicAdd(dw + static_cast<size_t>(col) * cols + cc + c,
                      vs[nn * j + t] * dl);
        }
      }
    }
    __syncthreads();
  }
}

inline size_t smem_bytes(int rows_per_block, int j) {
  return sizeof(float) * (kMaxRows * kLd + 3 * kMaxRows * kMaxHeads) +
         static_cast<size_t>(rows_per_block) * j * (sizeof(float) + sizeof(int));
}

}  // namespace mach

extern "C" {

// cols (n, j) int32, vals (n, j) f32 — padded ELL; w (d, r*b) f32; bias
// (r*b,) f32 or null; labels (n, r) int32; rows_per_block in [1, 16];
// outputs lse (n, r), nll (n, r) scratch, loss (n,).
int fused_xent_ell_fwd_launch(const void* cols, const void* vals, const void* w,
                              const void* bias, const void* labels, int n,
                              int j, int d, int r, int b, int rows_per_block,
                              void* lse, void* nll, void* loss, void* stream) {
  if (n < 1 || j < 1 || d < 1 || r < 1 || b < 1 || rows_per_block < 1 ||
      rows_per_block > mach::kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = mach::smem_bytes(rows_per_block, j);
  cudaError_t err = mach::allow_smem(mach::ell_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hpg = mach::heads_per_group(b);
  const dim3 grid((n + rows_per_block - 1) / rows_per_block,
                  (r + hpg - 1) / hpg);
  mach::ell_fwd_kernel<<<grid, mach::kThreads, smem, s>>>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(labels), n, j, d, r, b, hpg, rows_per_block,
      static_cast<float*>(lse), static_cast<float*>(nll));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(mach::launch_sum_heads(
      static_cast<const float*>(nll), n, r, static_cast<float*>(loss), s));
}

// lse (n, r) from the forward; g (n,) f32; dw (d, r*b) and dbias (r*b,)
// or null, zero-filled by the caller.
int fused_xent_ell_bwd_launch(const void* cols, const void* vals, const void* w,
                              const void* bias, const void* labels,
                              const void* lse, const void* g, int n, int j,
                              int d, int r, int b, int rows_per_block, void* dw,
                              void* dbias, void* stream) {
  if (n < 1 || j < 1 || d < 1 || r < 1 || b < 1 || rows_per_block < 1 ||
      rows_per_block > mach::kMaxRows || (bias == nullptr) != (dbias == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = mach::smem_bytes(rows_per_block, j);
  cudaError_t err = mach::allow_smem(mach::ell_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hpg = mach::heads_per_group(b);
  const dim3 grid((n + rows_per_block - 1) / rows_per_block,
                  (r + hpg - 1) / hpg);
  mach::ell_bwd_kernel<<<grid, mach::kThreads, smem, s>>>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(g), n, j, d, r, b, hpg, rows_per_block,
      static_cast<float*>(dw), static_cast<float*>(dbias));
  return static_cast<int>(cudaGetLastError());
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
