// Fused projection + R-head cross-entropy on dense inputs, forward and
// backward, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/mach_fused_xent.py::mach_fused_xent_pallas
// (its forward body and the two-phase backward of its custom VJP).
// h (N, d) f32, W (d, R*B) f32, optional bias (R*B,), labels (N, R)
// int32 -> per-example loss (N,) and per-head logsumexp (N, R); the
// backward gives dW (d, R*B), dbias and, when asked, dh (N, d).  The
// (N, R*B) logits never reach device memory in either pass.
//
// What bounds it on this card: the product, 2*N*d*R*B float32 operations
// forward (64.4 GFLOP at ImageNet-21k, N = 512, d = 6,144, R*B = 10,240:
// 0.96 ms at 67 TFLOP/s) and three times that backward (the logits are
// recomputed, then dW and dh).  Bytes are small beside it (W is 252 MB).
// The design is a plain shared-memory tiled product in float32 FMA (no
// tensor cores, so no TF32 rounding): a block owns 64 rows and a head
// group, stages 64x16 tiles of h and 16x128 tiles of W in shared memory,
// and each of its 256 threads accumulates a 4x8 patch of the logits tile
// in registers.  The epilogue reads the tile from shared memory.  The
// backward recomputes the tile once, forms dlogits in place, and sweeps d
// again in 32-wide slices for dW += h^T dlogits and dh += dlogits W^T,
// adding into zero-filled outputs with atomics (dW from N/64 row tiles,
// dh from every column chunk).
#include "mach_xent_common.cuh"

namespace mach {

constexpr int kRows = 64;         // rows a block owns
constexpr int kDepth = 16;        // d-slice of the logits product
constexpr int kLdA = kRows + 4;   // row stride of the transposed h tile
constexpr int kSlice = 32;        // d-slice of the backward products

// L[n][c] = sum_k h[row0+n][k] * W[k][cc+c] (+ bias) for the block's
// rows x chunk; zero outside rows x cw.  Ends synchronised.
__device__ void logits_tile(const float* __restrict__ h,
                            const float* __restrict__ w,
                            const float* __restrict__ bias, int row0, int rows,
                            int d, int cols, int cc, int cw, float* As,
                            float* Bs, float* L) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kDepth) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = tid + kThreads * q, n = idx / kDepth, k = idx % kDepth;
      As[k * kLdA + n] = (n < rows && k0 + k < d)
          ? h[static_cast<size_t>(row0 + n) * d + k0 + k] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int idx = tid + kThreads * q, k = idx / kChunk, c = idx % kChunk;
      Bs[k * kChunk + c] = (k0 + k < d && c < cw)
          ? w[static_cast<size_t>(k0 + k) * cols + cc + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      float a[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k * kLdA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Bs[k * kChunk + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      const bool ok = n < rows && c < cw;
      const float bb = (ok && bias != nullptr) ? bias[cc + c] : 0.f;
      L[n * kLd + c] = ok ? acc[i][j] + bb : 0.f;
    }
  }
  __syncthreads();
}

// grid (ceil(N/64), head groups); dynamic shared memory fwd_smem_bytes().
__global__ void __launch_bounds__(kThreads)
dense_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
                 const float* __restrict__ bias, const int* __restrict__ labels,
                 int n, int d, int r, int b, int hpg, float* __restrict__ lse,
                 float* __restrict__ nll) {
  extern __shared__ float smem[];
  float* As = smem;                       // kDepth x kLdA
  float* Bs = As + kDepth * kLdA;         // kDepth x kChunk
  float* L = Bs + kDepth * kChunk;        // kRows x kLd
  float* sm = L + kRows * kLd;            // 3 x kRows x kMaxHeads
  float* ss = sm + kRows * kMaxHeads;
  float* sp = ss + kRows * kMaxHeads;

  const int row0 = blockIdx.x * kRows, rows = min(kRows, n - row0);
  const Group grp = group_of(blockIdx.y, hpg, r, b);
  const int cols = r * b;
  stats_init(sm, ss, sp, kRows * kMaxHeads);
  for (int cc = grp.c_begin; cc < grp.c_end; cc += kChunk) {
    const int cw = min(kChunk, grp.c_end - cc);
    logits_tile(h, w, bias, row0, rows, d, cols, cc, cw, As, Bs, L);
    online_update(L, rows, cc, cw, b, grp.h0,
                  labels + static_cast<size_t>(row0) * r, r, sm, ss, sp);
  }
  flush_stats(sm, ss, sp, rows, row0, grp.h0, grp.nh, r, lse, nll);
}

// grid (ceil(N/64), head groups); dynamic shared memory bwd_smem_bytes().
__global__ void __launch_bounds__(kThreads)
dense_bwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
                 const float* __restrict__ bias, const int* __restrict__ labels,
                 const float* __restrict__ lse, const float* __restrict__ g,
                 int n, int d, int r, int b, int hpg, float* __restrict__ dh,
                 float* __restrict__ dw, float* __restrict__ dbias) {
  extern __shared__ float smem[];
  float* As = smem;                       // kDepth x kLdA
  float* Bs = As + kDepth * kLdA;         // kDepth x kChunk
  float* L = Bs + kDepth * kChunk;        // kRows x kLd (dlogits)
  float* Hs = L + kRows * kLd;            // kRows x (kSlice + 1)
  float* Ws = Hs + kRows * (kSlice + 1);  // kSlice x kLd

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows, rows = min(kRows, n - row0);
  const Group grp = group_of(blockIdx.y, hpg, r, b);
  const int cols = r * b;
  const size_t roff = static_cast<size_t>(row0) * r;
  for (int cc = grp.c_begin; cc < grp.c_end; cc += kChunk) {
    const int cw = min(kChunk, grp.c_end - cc);
    logits_tile(h, w, bias, row0, rows, d, cols, cc, cw, As, Bs, L);
    dlogits_in_place(L, kRows, rows, cc, cw, b, labels + roff, lse + roff,
                     g + row0, r);
    add_dbias(L, rows, cc, cw, dbias);

    for (int k0 = 0; k0 < d; k0 += kSlice) {
      // stage h[rows, k0:k0+32] and W[k0:k0+32, chunk]
      for (int idx = tid; idx < kRows * kSlice; idx += kThreads) {
        const int nn = idx / kSlice, k = idx % kSlice;
        Hs[nn * (kSlice + 1) + k] = (nn < rows && k0 + k < d)
            ? h[static_cast<size_t>(row0 + nn) * d + k0 + k] : 0.f;
      }
      for (int idx = tid; idx < kSlice * kChunk; idx += kThreads) {
        const int k = idx / kChunk, c = idx % kChunk;
        Ws[k * kLd + c] = (k0 + k < d && c < cw)
            ? w[static_cast<size_t>(k0 + k) * cols + cc + c] : 0.f;
      }
      __syncthreads();
      {  // dW[k0+k][cc+c] += sum_n h[n][k] * dlog[n][c]: k = ty + 8i, c = tx + 32j
        const int tx = tid % 32, ty = tid / 32;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int nn = 0; nn < rows; ++nn) {
          float a[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = Hs[nn * (kSlice + 1) + ty + 8 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = L[nn * kLd + tx + 32 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + ty + 8 * i;
          if (k >= d) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 32 * j;
            if (c < cw)
              atomicAdd(dw + static_cast<size_t>(k) * cols + cc + c, acc[i][j]);
          }
        }
      }
      if (dh != nullptr) {  // dh[n][k0+k] += sum_c dlog[n][c] * W[k][c]: k = tx, n = ty + 8i
        const int tx = tid % 32, ty = tid / 32;
        float acc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = 0.f;
        for (int c = 0; c < cw; ++c) {
          const float wv = Ws[tx * kLd + c];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[i] = fmaf(L[(ty + 8 * i) * kLd + c], wv, acc[i]);
        }
        if (k0 + tx < d) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int nn = ty + 8 * i;
            if (nn < rows)
              atomicAdd(dh + static_cast<size_t>(row0 + nn) * d + k0 + tx,
                        acc[i]);
          }
        }
      }
      __syncthreads();
    }
  }
}

inline size_t fwd_smem_bytes() {
  return sizeof(float) * (kDepth * kLdA + kDepth * kChunk + kRows * kLd +
                          3 * kRows * kMaxHeads);
}

inline size_t bwd_smem_bytes() {
  return sizeof(float) * (kDepth * kLdA + kDepth * kChunk + kRows * kLd +
                          kRows * (kSlice + 1) + kSlice * kLd);
}

inline dim3 grid_of(int n, int r, int hpg) {
  return dim3((n + kRows - 1) / kRows, (r + hpg - 1) / hpg);
}

}  // namespace mach

extern "C" {

// h (n, d) f32; w (d, r*b) f32; bias (r*b,) f32 or null; labels (n, r)
// int32; outputs lse (n, r), nll (n, r) scratch, loss (n,).
// Returns a cudaError_t code.
int fused_xent_dense_fwd_launch(const void* h, const void* w, const void* bias,
                                const void* labels, int n, int d, int r, int b,
                                void* lse, void* nll, void* loss,
                                void* stream) {
  if (n < 1 || d < 1 || r < 1 || b < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = mach::fwd_smem_bytes();
  cudaError_t err = mach::allow_smem(mach::dense_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hpg = mach::heads_per_group(b);
  mach::dense_fwd_kernel<<<mach::grid_of(n, r, hpg), mach::kThreads, smem, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels), n, d,
      r, b, hpg, static_cast<float*>(lse), static_cast<float*>(nll));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(mach::launch_sum_heads(
      static_cast<const float*>(nll), n, r, static_cast<float*>(loss), s));
}

// lse (n, r) from the forward; g (n,) f32 cotangent; dh (n, d) or null,
// dw (d, r*b), dbias (r*b,) or null — zero-filled by the caller.
int fused_xent_dense_bwd_launch(const void* h, const void* w, const void* bias,
                                const void* labels, const void* lse,
                                const void* g, int n, int d, int r, int b,
                                void* dh, void* dw, void* dbias,
                                void* stream) {
  if (n < 1 || d < 1 || r < 1 || b < 1 || (bias == nullptr) != (dbias == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = mach::bwd_smem_bytes();
  cudaError_t err = mach::allow_smem(mach::dense_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hpg = mach::heads_per_group(b);
  mach::dense_bwd_kernel<<<mach::grid_of(n, r, hpg), mach::kThreads, smem, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(g), n, d, r, b,
      hpg, static_cast<float*>(dh), static_cast<float*>(dw),
      static_cast<float*>(dbias));
  return static_cast<int>(cudaGetLastError());
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
