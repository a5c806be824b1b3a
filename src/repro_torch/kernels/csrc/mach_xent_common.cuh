// Shared pieces of the fused projection + R-head cross-entropy kernels
// (mach_fused_xent_{dense,ell,gather}.cu).
//
// Every kernel produces logits one tile at a time and never writes them
// to device memory.  Here, as the gather kernel uses them: a block owns a
// few rows and a head group: heads [h0, h0 + nh) and their columns
// [h0*B, (h0+nh)*B) of the R*B logits, which it walks in chunks of kChunk
// columns.  A head of B <= kChunk buckets lies in one chunk; a wider head
// (ImageNet-21k's B = 512) spans several, and its logsumexp is completed
// across them with an online max / sum-exp, as the TPU kernels'
// _online_update does across column blocks.  Blocks of different head
// groups write disjoint (row, head) entries, and a second small kernel
// sums each row's R heads in order r = 0..R-1, so the forward pass is
// deterministic.  (The dense and ELL kernels split a head across column
// tiles and merge its partials in a second kernel instead.)
//
// The backward pass turns a recomputed logits tile into
//   dlogits[n, c] = g[n] * (softmax[n, c] - 1[c = label column])
// from the saved per-head logsumexp, not recomputed.  The dense kernel
// reduces it into dW, dh and dbias with float atomic adds into zero-filled
// outputs: those sums run across blocks, in an order that changes from run
// to run.  The gather and ELL kernels write the dlogits out and sum dW and
// dbias from them in a fixed order.
#pragma once

#include "mach_common.cuh"

namespace mach {

constexpr int kChunk = 128;          // logits columns a tile holds
constexpr int kLd = kChunk + 1;      // row stride of a logits tile (floats)
constexpr int kMaxHeads = 8;         // heads a block owns when B <= kChunk

// Heads per block: whole heads up to kChunk columns, else one head.
inline int heads_per_group(int b) {
  if (b >= kChunk) return 1;
  const int h = kChunk / b;
  return h < kMaxHeads ? h : kMaxHeads;
}

struct Group {
  int h0, nh;                 // heads [h0, h0 + nh)
  int c_begin, c_end;         // their columns
};

__device__ __forceinline__ Group group_of(int g, int hpg, int r, int b) {
  Group grp;
  grp.h0 = g * hpg;
  grp.nh = min(hpg, r - grp.h0);
  grp.c_begin = grp.h0 * b;
  grp.c_end = (grp.h0 + grp.nh) * b;
  return grp;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Running (max, sum-exp, picked label logit) per (row, head of the
// group): arrays of rows * kMaxHeads floats in shared memory.
__device__ __forceinline__ void stats_init(float* m, float* s, float* p,
                                           int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    m[i] = -CUDART_INF_F;
    s[i] = 0.f;
    p[i] = 0.f;
  }
}

// Fold the logits tile L (rows x cw, row stride kLd; columns [cc, cc+cw))
// into the running statistics.  One warp per (row, head segment).
// labels points at row 0's (R,) bucket ids.  Ends synchronised.
__device__ __forceinline__ void online_update(const float* L, int rows, int cc,
                                              int cw, int b, int h0,
                                              const int* __restrict__ labels,
                                              int r, float* m, float* s,
                                              float* p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int num_warps = blockDim.x >> 5;
  const int ha = cc / b, hb = (cc + cw - 1) / b;
  const int nseg = hb - ha + 1;
  for (int pair = warp; pair < rows * nseg; pair += num_warps) {
    const int n = pair / nseg, h = ha + pair % nseg;
    const int s0 = max(cc, h * b), s1 = min(cc + cw, (h + 1) * b);
    const float* row = L + n * kLd - cc;
    float mx = -CUDART_INF_F;
    for (int c = s0 + lane; c < s1; c += 32) mx = fmaxf(mx, row[c]);
    mx = warp_max(mx);
    const int yc = h * b + labels[static_cast<size_t>(n) * r + h];
    float se = 0.f, pk = 0.f;
    for (int c = s0 + lane; c < s1; c += 32) {
      const float x = row[c];
      se += expf(x - mx);
      if (c == yc) pk += x;
    }
    se = warp_sum(se);
    pk = warp_sum(pk);
    if (lane == 0) {
      const int i = n * kMaxHeads + (h - h0);
      const float mo = m[i];
      const float mn = fmaxf(mo, mx);
      s[i] = s[i] * expf(mo - mn) + se * expf(mx - mn);
      m[i] = mn;
      p[i] += pk;
    }
  }
  __syncthreads();
}

// Per (row, head): lse = m + log(s) and nll = lse - picked, into the
// (N, R) outputs at global row row0.
__device__ __forceinline__ void flush_stats(const float* m, const float* s,
                                            const float* p, int rows, int row0,
                                            int h0, int nh, int r,
                                            float* __restrict__ lse,
                                            float* __restrict__ nll) {
  for (int i = threadIdx.x; i < rows * nh; i += blockDim.x) {
    const int n = i / nh, j = i % nh;
    const int k = n * kMaxHeads + j;
    const float l = m[k] + logf(s[k]);
    const size_t o = static_cast<size_t>(row0 + n) * r + h0 + j;
    lse[o] = l;
    nll[o] = l - p[k];
  }
}

// Turn the logits tile L (tile_rows x kChunk) into dlogits in place:
// g * (exp(L - lse) - onehot) at valid (row, column), 0 elsewhere, so
// later products may read the whole tile.  lse/labels/g point at row 0.
// Ends synchronised.
__device__ __forceinline__ void dlogits_in_place(float* L, int tile_rows,
                                                 int rows, int cc, int cw,
                                                 int b, const int* labels,
                                                 const float* lse,
                                                 const float* g, int r) {
  for (int e = threadIdx.x; e < tile_rows * kChunk; e += blockDim.x) {
    const int n = e / kChunk, c = e % kChunk;
    float v = 0.f;
    if (n < rows && c < cw) {
      const int col = cc + c, h = col / b;
      const size_t o = static_cast<size_t>(n) * r + h;
      const float onehot = (col == h * b + labels[o]) ? 1.f : 0.f;
      v = g[n] * (expf(L[n * kLd + c] - lse[o]) - onehot);
    }
    L[n * kLd + c] = v;
  }
  __syncthreads();
}

// loss[n] = sum over r = 0..R-1 of nll[n, r], one thread per row.
__global__ void sum_heads_kernel(const float* __restrict__ nll, int n, int r,
                                 float* __restrict__ loss) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float acc = 0.f;
  for (int h = 0; h < r; ++h) acc += nll[static_cast<size_t>(row) * r + h];
  loss[row] = acc;
}

inline cudaError_t launch_sum_heads(const float* nll, int n, int r, float* loss,
                                    cudaStream_t stream) {
  sum_heads_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      nll, n, r, loss);
  return cudaGetLastError();
}

}  // namespace mach
