// bf16 tensor-core building blocks shared by kernel 10's forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu) on Hopper.
//
// The products run as mma.sync.m16n8k16 (bf16 in, float32 accumulate)
// with operands read from shared memory by ldmatrix (the warp-level
// helpers live in mma_sync.cuh).  Tiles arrive by cp.async, 16 bytes a
// thread, zero-filled past the tensor's edge and past hd, so a
// zero-padded width leaves every score unchanged.  Rows in shared memory
// are padded by 8 bf16 (16 bytes): the 8 row addresses of one ldmatrix
// then fall on distinct bank groups.
//
// warp_scores is the one function that forms scores S = Qs·Kᵀ, for the
// forward and for both backward passes: an element's value depends only
// on its row of Qs, its row of K and the order of the k-chunks, which is
// the same in every caller, so the backward's exp(S − lse) uses the very
// scores the forward normalized (a row that sees one key gets P = 1).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace flash_mma {

using bf16 = __nv_bfloat16;
using mma_sync::cp_async16;
using mma_sync::cp_async_commit;
using mma_sync::cp_async_wait;
using mma_sync::ldsm_x4;
using mma_sync::ldsm_x4_t;
using mma_sync::mma;
using mma_sync::pack_bf16;
using mma_sync::smem_u32;

constexpr int kBK = 64;    // keys a tile, the plain version's
constexpr float kNegInf = -3.4028234663852886e38f;   // finfo(float32).min

// the padded width a head dim runs at: 64, 128 or 256
__host__ __device__ constexpr int padded_hd(int hd) {
  return hd <= 64 ? 64 : (hd <= 128 ? 128 : 256);
}

// rows [r0, r0 + kRows) of one head of a (B, len, heads, hd) tensor
// (src points at (b, 0, head, 0); stride = heads·hd) into dst (kRows, LD),
// by cp.async; rows past len and columns past hd are zero-filled
template <int kRows, int HDP, int kThreads>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t stride, int r0, int len,
                                          int hd) {
  constexpr int kChunks = HDP / 8, LD = HDP + 8;
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = r0 + r < len && c * 8 < hd;
    const bf16* g = ok ? src + static_cast<size_t>(r0 + r) * stride + c * 8
                       : src;
    cp_async16(dst + r * LD + c * 8, g, ok);
  }
}

// round rows of q to bf16(q · scale) in place: the reference's Qs
template <int HDP>
__device__ __forceinline__ void scale_rows(bf16* rows, int n_rows, int hd,
                                           float scale, int tid, int nthreads) {
  constexpr int LD = HDP + 8;
  const int pairs = hd / 2;
  for (int idx = tid; idx < n_rows * pairs; idx += nthreads) {
    const int r = idx / pairs, c = 2 * (idx % pairs);
    __nv_bfloat162* p =
        reinterpret_cast<__nv_bfloat162*>(rows + r * LD + c);
    const float2 f = __bfloat1622float2(*p);
    *p = __floats2bfloat162_rn(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale));
  }
}

// S (16 rows x NT·8 keys) = a_rows (16, LD) · b_rows (NT·8, LD)ᵀ over the
// first hd columns, k-chunk by k-chunk in ascending order.  Accumulator
// layout of m16n8: s[j][0..1] row lane/4, keys 8j + 2(lane%4) + {0, 1};
// s[j][2..3] the same keys at row lane/4 + 8.
template <int NT, int HDP>
__device__ __forceinline__ void warp_scores(float (&s)[NT][4],
                                            const bf16* a_rows,
                                            const bf16* b_rows, int hd,
                                            int lane) {
  constexpr int LD = HDP + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    if (kk * 16 < hd) {
      uint32_t a[4];
      ldsm_x4(a, a_rows + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t b[4];
        ldsm_x4(b, b_rows + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma(s[2 * j], a, b[0], b[1]);
        mma(s[2 * j + 1], a, b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ bool visible(int row, int col, int t_len,
                                        int s_len, int causal, int window) {
  return row < t_len && col < s_len && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
}

// no (row, key) of rows [r0, r0 + nr) x keys [c0, c0 + nc) is visible
__device__ __forceinline__ bool all_masked(int r0, int nr, int c0, int nc,
                                           int causal, int window) {
  return (causal && c0 > r0 + nr - 1) ||
         (window > 0 && c0 + nc - 1 <= r0 - window);
}

// the key tiles [tile_begin, tile_end) that the mask leaves partly open
// for query rows q0 .. q0 + rows - 1
__device__ __forceinline__ void key_tiles(int q0, int rows, int t_len,
                                          int s_len, int causal, int window,
                                          int* tile_begin, int* tile_end) {
  const int q_hi = min(q0 + rows, t_len) - 1;
  const int k_end = causal ? min(s_len, q_hi + 1) : s_len;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  *tile_begin = k_begin / kBK;
  *tile_end = k_end > k_begin ? (k_end + kBK - 1) / kBK : *tile_begin;
}

}  // namespace flash_mma
