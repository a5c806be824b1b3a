// Backward of causal / windowed GQA flash attention for Hopper (sm_90a).
//
// The gradient of kernel 10 (flash_attention.cu), which replaces
// src/repro/kernels/flash_attention.py::flash_attention_pallas; the JAX
// package has no backward kernel and differentiates its jnp attention.
// This is the FlashAttention-2 recurrence, from the forward's output O and
// row log-sum-exp lse (B, H, T):
//
//   D_i = sum_c dO_ic O_ic
//   over the visible (query, key) tiles: S = Qs K^T (recomputed),
//   P = exp(S - lse), dV += P^T dO, dP = dO V^T, dS = P * (dP - D),
//   dQ += dS K * scale, dK += dS^T Qs
//
// where Qs is q * scale rounded to q's type, as the forward forms it, so
// dK is the gradient of S = Qs K^T and dQ that of q through the scale.
// P and dS are float32; in bfloat16 P is rounded to v's type before
// P^T dO and dS to k's type before dS K and dS^T Qs (the operands of the
// tensor cores; FlashAttention-2's cast points, which the plain version
// repeats).  Masked entries have P = 0 exactly, so a wholly masked tile
// adds nothing and skipping it changes no bit.  Both passes are
// deterministic: every sum is owned by one block, with no atomics.
//
// bfloat16 (the LM path): two kernels on the tensor cores (mma.sync
// m16n8k16, bf16 in, float32 accumulate), 8 warps a block, 64-row query
// tiles and 64-key tiles, at a padded width HDP of 64, 128 or 256 (any hd
// that is a multiple of 16 up to 256; columns past hd are zero-filled and
// never written).  Every S is formed by flash_mma.cuh's warp_scores, the
// forward's own function, so exp(S - lse) uses the scores the forward
// normalized and a query row that sees one key gets P = 1 exactly.
//  1. dq_mma_kernel: one block per (b, head, 64-query tile), over the key
//     tiles the forward visits for its rows.  Its prologue forms D as the
//     diagonal of dO·Oᵀ by warp_scores, in dP's own order, so a row that
//     sees one key (O = its V row, P = 1) gets dP - D = 0 and dQ = 0
//     exactly (written to dsum for pass 2), and Qs (written to the qs
//     scratch, so pass 2 reads it by cp.async with no rounding pass).  K
//     and V tiles stream through a two-stage cp.async ring.  Warp
//     (r, c) forms S and dP for query rows 16r.. and keys 32c.., rounds
//     dS to bf16 into shared memory, and after a barrier adds dS · K for
//     rows 16r.. and output columns c·HDP/2.. into 16 x HDP/2 float32
//     registers (64 at HDP = 256).
//  2. dkdv_mma_kernel: one block per (b, kv head, 64-key tile).  K and V
//     stay in shared memory; Qs and dO tiles of every (query head of the
//     group, query tile that can see the key tile) stream through a
//     two-stage ring.  Warp (r, c) forms S and dP for query rows 16r..
//     and keys 32c.. (the orientation of the forward, so S is bit-equal),
//     writes bf16 P and dS, and after a barrier adds P^T dO and dS^T Qs
//     (A operands by ldmatrix.trans) for keys 16r.. and columns c·HDP/2..
//     into dV and dK accumulators: 2 x 64 float32 registers a thread at
//     HDP = 256, summed over the whole group in a fixed order.
//  Registers at HDP = 256: 128 accumulators + 32 for S and dP in pass 2;
//  64 + 32 in pass 1; within 255, no spills (chip_smoke.py prints
//  ptxas's count).  Shared memory at HDP = 256: pass 2 holds K, V and
//  two stages of Qs and dO, (64, 264) bf16 each, plus P and dS (64, 72):
//  216 KB, one block an SM; pass 1 207 KB.
//  Parallelism at KV = 1: pass 2 has S/64 x B·KV blocks (128 at
//  (2, 4096, KV = 1), against 132 SMs), each owning a key tile for all
//  10 heads of its group; the blocks are issued in key order, the early
//  key tiles (seen by the most query tiles) first.  Splitting the group's
//  heads over blocks would need a reduction of float32 partials; at this
//  shape a block an SM already covers 97% of the SMs, so it is not done.
//
// float32 (the reference model and its rtol-1e-4 checks, which TF32
// cannot meet): three kernels of float32 FMAs from shared memory.
//  1. row_dot: D, one warp a (b, t, h) row.
//  2. dkdv: one block per (b, kv head, 32-key tile).  K and V sit in
//     shared memory; the block loops over the group's H / KV query heads
//     and, for each, the 32-query tiles that can see the key tile (query
//     rows >= its first key when causal, < its last key + window when
//     windowed).  dK and dV accumulate in registers (4 key rows by hd / 32
//     columns a thread) over the whole group.
//  3. dq: one block per (b, head, 32-query tile), over the key tiles the
//     forward visits for those rows; dQ accumulates in registers.
//  S is summed in the forward's order (float4 steps of d, one fmaf each),
//  so exp(S - lse) uses the scores the forward normalized.  Four float32
//  (32, hd + 4) tiles (Q, dO, K, V), P and dS (32, 33) and the rows' lse
//  and D: 142 KB at hd = 256.
//
// What bounds it on this card: operations.  The backward's tensor-core
// work is 2.5x the forward's: 10 hd flops per attended (query, key) pair
// and head (S, dP, dV, dK, dQ), 322 GFLOP at (2, 4096, 10, 256) with
// window 2048, 0.33 ms at 989 TFLOP/s bf16; the two passes recompute S
// and dP (14 hd flops a pair done) to avoid atomics.
#include <cuda_bf16.h>

#include "flash_mma.cuh"
#include "mach_common.cuh"

namespace flash_bwd {

constexpr int kThreads = 256;
constexpr int kBQ = 32;            // query rows a tile (float32)
constexpr int kBK = 32;            // key columns a tile (float32)
constexpr int kMaxHd = 256;
constexpr int kMaxCols = kMaxHd / 32;   // accumulator columns a thread
constexpr int kPS = kBK + 1;       // padded P / dS row (floats)

using flash_mma::visible;

inline size_t smem_bytes(int hd) {
  return sizeof(float) * (4 * static_cast<size_t>(kBQ) * (hd + 4) +
                          2 * kBQ * kPS + 2 * kBQ);
}

// rows [r0, r0 + kBQ) of head hh of a (B, len, nheads, hd) tensor into
// dst (kBQ, hd + 4), zero beyond len; q is scaled as the forward does
template <bool kScaleQ>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int b, int r0, int len, int nheads,
                                          int hh, int hd, float scale) {
  const int stride = hd + 4;
  for (int idx = threadIdx.x; idx < kBQ * hd; idx += kThreads) {
    const int r = idx / hd, d = idx % hd;
    const int row = r0 + r;
    float val = 0.f;
    if (row < len) {
      val = src[((static_cast<size_t>(b) * len + row) * nheads + hh) * hd + d];
      if (kScaleQ) val = __fmul_rn(val, scale);
    }
    dst[r * stride + d] = val;
  }
}

// out[c] = row i of a . row (j + 8c) of b over hd, c < 4, summed in the
// forward's order
__device__ __forceinline__ void dot4(float (&out)[4], const float* a,
                                     const float* b, int i, int j, int hd) {
  const int stride = hd + 4;
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c] = 0.f;
  for (int d = 0; d < hd; d += 4) {
    const float4 av = *reinterpret_cast<const float4*>(&a[i * stride + d]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 bv =
          *reinterpret_cast<const float4*>(&b[(j + 8 * c) * stride + d]);
      out[c] = fmaf(av.x, bv.x, out[c]);
      out[c] = fmaf(av.y, bv.y, out[c]);
      out[c] = fmaf(av.z, bv.z, out[c]);
      out[c] = fmaf(av.w, bv.w, out[c]);
    }
  }
}

// P and dS of one (query tile, key tile) into ps / dss, from the Q, dO,
// K, V tiles and the rows' lse and D in shared memory
__device__ __forceinline__ void p_and_ds(const float* qs, const float* dos,
                                         const float* ks, const float* vs,
                                         const float* lse_s, const float* d_s,
                                         float* ps, float* dss, int q0, int k0,
                                         int t_len, int s_len, int hd,
                                         int causal, int window) {
  const int si = threadIdx.x / 8, sj = threadIdx.x % 8;
  float sc[4], dp[4];
  dot4(sc, qs, ks, si, sj, hd);
  dot4(dp, dos, vs, si, sj, hd);
  const int row = q0 + si;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = sj + 8 * c;
    const float p = visible(row, k0 + j, t_len, s_len, causal, window)
                        ? expf(sc[c] - lse_s[si])
                        : 0.f;
    ps[si * kPS + j] = p;
    dss[si * kPS + j] = p * (dp[c] - d_s[si]);
  }
}

__global__ void __launch_bounds__(kThreads)
row_dot_kernel(const float* __restrict__ dout, const float* __restrict__ out,
               float* __restrict__ dsum, int rows, int t_len, int heads,
               int hd) {
  const int r = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const size_t base = static_cast<size_t>(r) * hd;
  float s = 0.f;
  for (int c = lane; c < hd; c += 32)
    s = fmaf(dout[base + c], out[base + c], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {   // r walks (b, t, h); D is (b, h, t)
    const int b = r / (t_len * heads), rem = r % (t_len * heads);
    dsum[(static_cast<size_t>(b) * heads + rem % heads) * t_len +
         rem / heads] = s;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            float* __restrict__ dk, float* __restrict__ dv, int t_len,
            int s_len, int heads, int kv_heads, int hd, float scale,
            int causal, int window) {
  extern __shared__ __align__(16) float smem[];
  const int stride = hd + 4;
  float* ks = smem;                       // (kBK, hd + 4)
  float* vs = ks + kBK * stride;          // (kBK, hd + 4)
  float* qs = vs + kBK * stride;          // (kBQ, hd + 4)
  float* dos = qs + kBQ * stride;         // (kBQ, hd + 4)
  float* ps = dos + kBQ * stride;         // (kBQ, kPS)
  float* dss = ps + kBQ * kPS;            // (kBQ, kPS)
  float* lse_s = dss + kBQ * kPS;         // (kBQ,)
  float* d_s = lse_s + kBQ;               // (kBQ,)

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kBK;
  const int b = blockIdx.y / kv_heads, kvh = blockIdx.y % kv_heads;
  const int group = heads / kv_heads;
  const int ar = tid / 32, lane = tid % 32;   // key rows ar*4.., cols lane+32m

  load_tile<false>(ks, k, b, k0, s_len, kv_heads, kvh, hd, 0.f);
  load_tile<false>(vs, v, b, k0, s_len, kv_heads, kvh, hd, 0.f);

  float dk_acc[4][kMaxCols], dv_acc[4][kMaxCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < kMaxCols; ++m) dk_acc[r][m] = dv_acc[r][m] = 0.f;

  // query tiles with a row that sees a key of this tile
  const int k_last = min(k0 + kBK, s_len) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(t_len, k_last + window) : t_len;
  const int tile_lo = q_lo / kBQ;
  const int tile_hi = q_hi > q_lo ? (q_hi + kBQ - 1) / kBQ : tile_lo;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    for (int qt = tile_lo; qt < tile_hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();   // the previous tile is done with qs, dos, ps, dss
      load_tile<true>(qs, q, b, q0, t_len, heads, h, hd, scale);
      load_tile<false>(dos, dout, b, q0, t_len, heads, h, hd, 0.f);
      if (tid < kBQ) {
        const int row = q0 + tid;
        const size_t o = (static_cast<size_t>(b) * heads + h) * t_len + row;
        lse_s[tid] = row < t_len ? lse[o] : CUDART_INF_F;
        d_s[tid] = row < t_len ? dsum[o] : 0.f;
      }
      __syncthreads();
      p_and_ds(qs, dos, ks, vs, lse_s, d_s, ps, dss, q0, k0, t_len, s_len,
               hd, causal, window);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Qs
      for (int i = 0; i < kBQ; ++i) {
        float pv[4], dsv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pv[r] = ps[i * kPS + ar * 4 + r];
          dsv[r] = dss[i * kPS + ar * 4 + r];
        }
#pragma unroll
        for (int m = 0; m < kMaxCols; ++m) {
          const int c = lane + 32 * m;
          if (c < hd) {
            const float dov = dos[i * stride + c];
            const float qv = qs[i * stride + c];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              dv_acc[r][m] = fmaf(pv[r], dov, dv_acc[r][m]);
              dk_acc[r][m] = fmaf(dsv[r], qv, dk_acc[r][m]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ar * 4 + r;
    if (key >= s_len) continue;
    const size_t off =
        ((static_cast<size_t>(b) * s_len + key) * kv_heads + kvh) * hd;
#pragma unroll
    for (int m = 0; m < kMaxCols; ++m) {
      const int c = lane + 32 * m;
      if (c < hd) {
        dk[off + c] = dk_acc[r][m];
        dv[off + c] = dv_acc[r][m];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dsum,
          float* __restrict__ dq, int t_len, int s_len, int heads, int kv_heads,
          int hd, float scale, int causal, int window) {
  extern __shared__ __align__(16) float smem[];
  const int stride = hd + 4;
  float* qs = smem;                       // (kBQ, hd + 4)
  float* dos = qs + kBQ * stride;         // (kBQ, hd + 4)
  float* ks = dos + kBQ * stride;         // (kBK, hd + 4)
  float* vs = ks + kBK * stride;          // (kBK, hd + 4)
  float* ps = vs + kBK * stride;          // (kBQ, kPS)
  float* dss = ps + kBQ * kPS;            // (kBQ, kPS)
  float* lse_s = dss + kBQ * kPS;         // (kBQ,)
  float* d_s = lse_s + kBQ;               // (kBQ,)

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int kvh = h / (heads / kv_heads);
  const int ar = tid / 32, lane = tid % 32;   // rows ar*4.., cols lane+32m

  load_tile<true>(qs, q, b, q0, t_len, heads, h, hd, scale);
  load_tile<false>(dos, dout, b, q0, t_len, heads, h, hd, 0.f);
  if (tid < kBQ) {
    const int row = q0 + tid;
    const size_t o = (static_cast<size_t>(b) * heads + h) * t_len + row;
    lse_s[tid] = row < t_len ? lse[o] : CUDART_INF_F;
    d_s[tid] = row < t_len ? dsum[o] : 0.f;
  }

  float acc[4][kMaxCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < kMaxCols; ++m) acc[r][m] = 0.f;

  // the key tiles the forward visits for rows q0 .. q_last
  const int q_last = min(q0 + kBQ, t_len) - 1;
  const int k_end = causal ? min(s_len, q_last + 1) : s_len;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int tile_lo = k_begin / kBK;
  const int tile_hi = k_end > k_begin ? (k_end + kBK - 1) / kBK : tile_lo;

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();   // the previous tile is done with ks, vs, dss
    load_tile<false>(ks, k, b, k0, s_len, kv_heads, kvh, hd, 0.f);
    load_tile<false>(vs, v, b, k0, s_len, kv_heads, kvh, hd, 0.f);
    __syncthreads();
    p_and_ds(qs, dos, ks, vs, lse_s, d_s, ps, dss, q0, k0, t_len, s_len, hd,
             causal, window);
    __syncthreads();
    // dQ += dS K
    for (int j = 0; j < kBK; ++j) {
      float dsv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsv[r] = dss[(ar * 4 + r) * kPS + j];
#pragma unroll
      for (int m = 0; m < kMaxCols; ++m) {
        const int c = lane + 32 * m;
        if (c < hd) {
          const float kv = ks[j * stride + c];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][m] = fmaf(dsv[r], kv, acc[r][m]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ar * 4 + r;
    if (row >= t_len) continue;
    const size_t off =
        ((static_cast<size_t>(b) * t_len + row) * heads + h) * hd;
#pragma unroll
    for (int m = 0; m < kMaxCols; ++m) {
      const int c = lane + 32 * m;
      if (c < hd) dq[off + c] = acc[r][m] * scale;
    }
  }
}

namespace fm = flash_mma;

constexpr int kMmaRows = 64;             // query rows / keys a tile (bf16)
constexpr int kPLD = fm::kBK + 8;        // padded P / dS row (bf16)

template <int HDP>
constexpr size_t dq_smem_bytes() {       // Qs, dO; 2 stages of K, V; dS
  return sizeof(fm::bf16) * (6 * kMmaRows * (HDP + 8) + kMmaRows * kPLD);
}

template <int HDP>
constexpr size_t dkdv_smem_bytes() {     // K, V; 2 stages of Qs, dO; P, dS
  return sizeof(fm::bf16) * (6 * kMmaRows * (HDP + 8) + 2 * kMmaRows * kPLD);
}

// P = exp(S - lse) on the visible entries and dS = P (dP - D) of a warp's
// 16 query rows x 32 keys (rows row_a, row_a + 8 of the accumulator
// layout; keys c0 + 8j + 2(lane%4) + {0, 1}), rounded to bf16 into
// shared memory rows (ld kPLD) at the same positions; null ps skips P
template <int HDP>
__device__ __forceinline__ void p_and_ds_mma(
    const fm::bf16* qs, const fm::bf16* dos, const fm::bf16* kt,
    const fm::bf16* vt, fm::bf16* ps, fm::bf16* dss, int row_a, int c0,
    const float (&lse_r)[2], const float (&d_r)[2], int t_len, int s_len,
    int hd, int causal, int window, int lane) {
  float s[4][4], dp[4][4];
  fm::warp_scores<4, HDP>(s, qs, kt, hd, lane);
  fm::warp_scores<4, HDP>(dp, dos, vt, hd, lane);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + j * 8 + 2 * (lane % 4) + e;
        p[e] = fm::visible(row_a + 8 * i, col, t_len, s_len, causal, window)
                   ? expf(s[j][2 * i + e] - lse_r[i])
                   : 0.f;
        ds[e] = p[e] * (dp[j][2 * i + e] - d_r[i]);
      }
      const int off = (lane / 4 + 8 * i) * kPLD + j * 8 + 2 * (lane % 4);
      if (ps != nullptr)
        *reinterpret_cast<__nv_bfloat162*>(ps + off) =
            __floats2bfloat162_rn(p[0], p[1]);
      *reinterpret_cast<__nv_bfloat162*>(dss + off) =
          __floats2bfloat162_rn(ds[0], ds[1]);
    }
}

// zeros into a warp's 16 x 32 block of P / dS (a wholly masked block)
__device__ __forceinline__ void zero_block(fm::bf16* ps, fm::bf16* dss,
                                           int lane) {
  for (int idx = lane; idx < 16 * 16; idx += 32) {
    const int off = (idx / 16) * kPLD + 2 * (idx % 16);
    const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
    if (ps != nullptr) *reinterpret_cast<__nv_bfloat162*>(ps + off) = z;
    *reinterpret_cast<__nv_bfloat162*>(dss + off) = z;
  }
}

// pass 1: dQ, with D and Qs for pass 2
template <int HDP>
__global__ void __launch_bounds__(256, 1)
dq_mma_kernel(const fm::bf16* __restrict__ q, const fm::bf16* __restrict__ k,
              const fm::bf16* __restrict__ v, const fm::bf16* __restrict__ out,
              const fm::bf16* __restrict__ dout,
              const float* __restrict__ lse, float* __restrict__ dsum,
              fm::bf16* __restrict__ qs_out, fm::bf16* __restrict__ dq,
              int t_len, int s_len, int heads, int kv_heads, int hd,
              float scale, int causal, int window) {
  constexpr int LD = HDP + 8, kHalf = HDP / 2, kDT = kHalf / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fm::bf16* qs = reinterpret_cast<fm::bf16*>(smem_raw);   // (64, LD)
  fm::bf16* dos = qs + kMmaRows * LD;                     // (64, LD)
  fm::bf16* ks = dos + kMmaRows * LD;                     // 2 x (64, LD)
  fm::bf16* vs = ks + 2 * kMmaRows * LD;                  // 2 x (64, LD)
  fm::bf16* dss = vs + 2 * kMmaRows * LD;                 // (64, kPLD)
  __shared__ float lse_s[kMmaRows], d_s[kMmaRows];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp & 3, ch = warp >> 2;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;   // longest first
  const int kvh = h / (heads / kv_heads);
  const size_t q_stride = static_cast<size_t>(heads) * hd;
  const size_t kv_stride = static_cast<size_t>(kv_heads) * hd;
  const size_t q_base = static_cast<size_t>(b) * t_len * q_stride + h * hd;
  const size_t kv_base = static_cast<size_t>(b) * s_len * kv_stride + kvh * hd;
  const size_t row_base = (static_cast<size_t>(b) * heads + h) * t_len;

  int tile_begin, tile_end;
  fm::key_tiles(q0, kMmaRows, t_len, s_len, causal, window, &tile_begin,
                &tile_end);
  fm::load_rows<kMmaRows, HDP, 256>(qs, q + q_base, q_stride, q0, t_len, hd);
  fm::load_rows<kMmaRows, HDP, 256>(dos, dout + q_base, q_stride, q0, t_len,
                                    hd);
  // O into stage 1 of the K ring, free until the loop's first prefetch
  fm::load_rows<kMmaRows, HDP, 256>(ks + kMmaRows * LD, out + q_base,
                                    q_stride, q0, t_len, hd);
  fm::cp_async_commit();
  if (tid < kMmaRows)
    lse_s[tid] = q0 + tid < t_len ? lse[row_base + q0 + tid] : CUDART_INF_F;
  fm::cp_async_wait<0>();
  __syncthreads();
  // D = rowsum(dO * O): the diagonal of warp_scores(dO, O), formed as dP
  // is, so that a row that sees one key (O = that key's V, P = 1) gets
  // dP - D = 0 exactly and an exact dQ of zero
  if (ch == 0) {
    float dd[2][4];
    fm::warp_scores<2, HDP>(dd, dos + rg * 16 * LD,
                            ks + (kMmaRows + rg * 16) * LD, hd, lane);
    const int r = lane / 4, c = 2 * (lane % 4);
    if (r == c || r == c + 1) {
      d_s[rg * 16 + r] = dd[0][r - c];
      d_s[rg * 16 + 8 + r] = dd[1][2 + r - c];
    }
  }
  // Qs = bf16(q * scale), also for pass 2
  fm::scale_rows<HDP>(qs, kMmaRows, hd, scale, tid, 256);
  __syncthreads();
  for (int idx = tid; idx < kMmaRows * (hd / 8); idx += 256) {
    const int r = idx / (hd / 8), c = 8 * (idx % (hd / 8));
    if (q0 + r < t_len)
      *reinterpret_cast<uint4*>(qs_out + q_base + (q0 + r) * q_stride + c) =
          *reinterpret_cast<const uint4*>(qs + r * LD + c);
  }
  if (tid < kMmaRows && q0 + tid < t_len) dsum[row_base + q0 + tid] = d_s[tid];
  if (tile_begin < tile_end) {
    fm::load_rows<kMmaRows, HDP, 256>(ks, k + kv_base, kv_stride,
                                      tile_begin * fm::kBK, s_len, hd);
    fm::load_rows<kMmaRows, HDP, 256>(vs, v + kv_base, kv_stride,
                                      tile_begin * fm::kBK, s_len, hd);
  }
  fm::cp_async_commit();

  const int row_a = q0 + rg * 16 + lane / 4;
  const float lse_r[2] = {lse_s[rg * 16 + lane / 4],
                          lse_s[rg * 16 + lane / 4 + 8]};
  const float d_r[2] = {d_s[rg * 16 + lane / 4], d_s[rg * 16 + lane / 4 + 8]};
  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int st = (tile - tile_begin) & 1;
    if (tile + 1 < tile_end) {
      const int nst = st ^ 1;
      fm::load_rows<kMmaRows, HDP, 256>(ks + nst * kMmaRows * LD, k + kv_base,
                                        kv_stride, (tile + 1) * fm::kBK,
                                        s_len, hd);
      fm::load_rows<kMmaRows, HDP, 256>(vs + nst * kMmaRows * LD, v + kv_base,
                                        kv_stride, (tile + 1) * fm::kBK,
                                        s_len, hd);
    }
    fm::cp_async_commit();
    fm::cp_async_wait<1>();
    __syncthreads();

    const int k0 = tile * fm::kBK;
    const fm::bf16* kt = ks + st * kMmaRows * LD;
    const fm::bf16* vt = vs + st * kMmaRows * LD;
    fm::bf16* dsw = dss + rg * 16 * kPLD + ch * 32;
    if (fm::all_masked(q0 + rg * 16, 16, k0 + ch * 32, 32, causal, window)) {
      zero_block(nullptr, dsw, lane);
    } else {
      p_and_ds_mma<HDP>(qs + rg * 16 * LD, dos + rg * 16 * LD,
                        kt + ch * 32 * LD, vt + ch * 32 * LD, nullptr, dsw,
                        row_a, k0 + ch * 32, lse_r, d_r, t_len, s_len, hd,
                        causal, window, lane);
    }
    __syncthreads();

    // dQ (rows 16rg.., columns ch·HDP/2..) += dS · K
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      fm::ldsm_x4(a, dss + (rg * 16 + (lane & 15)) * kPLD + kk * 16 +
                         (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kDT / 2; ++j) {
        const int col0 = ch * kHalf + j * 16;
        if (col0 < hd) {
          uint32_t bk[4];
          fm::ldsm_x4_t(bk, kt + (kk * 16 + (lane & 7) +
                                  (((lane >> 3) & 1) << 3)) * LD +
                                col0 + (lane >> 4) * 8);
          fm::mma(acc[2 * j], a, bk[0], bk[1]);
          fm::mma(acc[2 * j + 1], a, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage and with dS
  }
  fm::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= t_len) continue;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      const int col = ch * kHalf + j * 8 + 2 * (lane % 4);
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(dq + q_base + row * q_stride +
                                           col) =
            __floats2bfloat162_rn(acc[j][2 * i] * scale,
                                  acc[j][2 * i + 1] * scale);
    }
  }
}

// pass 2: dK and dV, summed over the group's heads
template <int HDP>
__global__ void __launch_bounds__(256, 1)
dkdv_mma_kernel(const fm::bf16* __restrict__ qs_in,
                const fm::bf16* __restrict__ k, const fm::bf16* __restrict__ v,
                const fm::bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                fm::bf16* __restrict__ dk, fm::bf16* __restrict__ dv,
                int t_len, int s_len, int heads, int kv_heads, int hd,
                int causal, int window) {
  constexpr int LD = HDP + 8, kHalf = HDP / 2, kDT = kHalf / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fm::bf16* ks = reinterpret_cast<fm::bf16*>(smem_raw);   // (64, LD)
  fm::bf16* vs = ks + kMmaRows * LD;                      // (64, LD)
  fm::bf16* qs = vs + kMmaRows * LD;                      // 2 x (64, LD)
  fm::bf16* dos = qs + 2 * kMmaRows * LD;                 // 2 x (64, LD)
  fm::bf16* ps = dos + 2 * kMmaRows * LD;                 // (64, kPLD)
  fm::bf16* dss = ps + kMmaRows * kPLD;                   // (64, kPLD)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp & 3, ch = warp >> 2;
  const int b = blockIdx.x / kv_heads, kvh = blockIdx.x % kv_heads;
  const int k0 = blockIdx.y * fm::kBK;
  const int group = heads / kv_heads;
  const size_t q_stride = static_cast<size_t>(heads) * hd;
  const size_t kv_stride = static_cast<size_t>(kv_heads) * hd;
  const size_t kv_base = static_cast<size_t>(b) * s_len * kv_stride + kvh * hd;

  // query tiles with a row that sees a key of this tile
  const int k_last = min(k0 + fm::kBK, s_len) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(t_len, k_last + window) : t_len;
  const int tile_lo = q_lo / kMmaRows;
  const int n_q = q_hi > q_lo ? (q_hi + kMmaRows - 1) / kMmaRows - tile_lo : 0;
  const int steps = group * n_q;    // (head of the group, query tile)

  auto issue = [&](int i) {
    const int h = kvh * group + i / n_q;
    const int q0 = (tile_lo + i % n_q) * kMmaRows;
    const size_t q_base = static_cast<size_t>(b) * t_len * q_stride + h * hd;
    const int st = i & 1;
    fm::load_rows<kMmaRows, HDP, 256>(qs + st * kMmaRows * LD, qs_in + q_base,
                                      q_stride, q0, t_len, hd);
    fm::load_rows<kMmaRows, HDP, 256>(dos + st * kMmaRows * LD, dout + q_base,
                                      q_stride, q0, t_len, hd);
  };

  fm::load_rows<kMmaRows, HDP, 256>(ks, k + kv_base, kv_stride, k0, s_len, hd);
  fm::load_rows<kMmaRows, HDP, 256>(vs, v + kv_base, kv_stride, k0, s_len, hd);
  if (steps > 0) issue(0);
  fm::cp_async_commit();

  float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) issue(i + 1);
    fm::cp_async_commit();
    const int h = kvh * group + i / n_q;
    const int q0 = (tile_lo + i % n_q) * kMmaRows;
    const int row_a = q0 + rg * 16 + lane / 4;
    const size_t row_base = (static_cast<size_t>(b) * heads + h) * t_len;
    float lse_r[2], d_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      lse_r[r] = row < t_len ? lse[row_base + row] : CUDART_INF_F;
      d_r[r] = row < t_len ? dsum[row_base + row] : 0.f;
    }
    fm::cp_async_wait<1>();
    __syncthreads();

    const int st = i & 1;
    const fm::bf16* qt = qs + st * kMmaRows * LD;
    const fm::bf16* dot = dos + st * kMmaRows * LD;
    fm::bf16* psw = ps + rg * 16 * kPLD + ch * 32;
    fm::bf16* dsw = dss + rg * 16 * kPLD + ch * 32;
    if (fm::all_masked(q0 + rg * 16, 16, k0 + ch * 32, 32, causal, window)) {
      zero_block(psw, dsw, lane);
    } else {
      p_and_ds_mma<HDP>(qt + rg * 16 * LD, dot + rg * 16 * LD,
                        ks + ch * 32 * LD, vs + ch * 32 * LD, psw, dsw,
                        row_a, k0 + ch * 32, lse_r, d_r, t_len, s_len, hd,
                        causal, window, lane);
    }
    __syncthreads();

    // keys 16rg.., columns ch·HDP/2..: dV += Pᵀ dO, dK += dSᵀ Qs
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int a_off = (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * kPLD +
                        rg * 16 + ((lane >> 3) & 1) * 8;
      uint32_t ap[4], ads[4];
      fm::ldsm_x4_t(ap, ps + a_off);
      fm::ldsm_x4_t(ads, dss + a_off);
#pragma unroll
      for (int j = 0; j < kDT / 2; ++j) {
        const int col0 = ch * kHalf + j * 16;
        if (col0 < hd) {
          const int b_off =
              (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD + col0 +
              (lane >> 4) * 8;
          uint32_t bo[4], bq[4];
          fm::ldsm_x4_t(bo, dot + b_off);
          fm::mma(dv_acc[2 * j], ap, bo[0], bo[1]);
          fm::mma(dv_acc[2 * j + 1], ap, bo[2], bo[3]);
          fm::ldsm_x4_t(bq, qt + b_off);
          fm::mma(dk_acc[2 * j], ads, bq[0], bq[1]);
          fm::mma(dk_acc[2 * j + 1], ads, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage, P and dS
  }
  fm::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + rg * 16 + lane / 4 + 8 * i;
    if (key >= s_len) continue;
    const size_t off = kv_base + key * kv_stride;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      const int col = ch * kHalf + j * 8 + 2 * (lane % 4);
      if (col < hd) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
            __floats2bfloat162_rn(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
            __floats2bfloat162_rn(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
      }
    }
  }
}

template <int HDP>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const void* lse,
                       void* dsum, void* qs, void* dq, void* dk, void* dv,
                       int batch, int t_len, int s_len, int heads,
                       int kv_heads, int hd, float scale, int causal,
                       int window, cudaStream_t stream) {
  const size_t smem_q = dq_smem_bytes<HDP>(), smem_kv = dkdv_smem_bytes<HDP>();
  cudaError_t err = mach::allow_smem(dq_mma_kernel<HDP>, smem_q);
  if (err != cudaSuccess) return err;
  err = mach::allow_smem(dkdv_mma_kernel<HDP>, smem_kv);
  if (err != cudaSuccess) return err;
  using fm::bf16;
  dim3 grid_q(batch * heads, (t_len + kMmaRows - 1) / kMmaRows);
  dq_mma_kernel<HDP><<<grid_q, 256, smem_q, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dsum), static_cast<bf16*>(qs),
      static_cast<bf16*>(dq), t_len, s_len, heads, kv_heads, hd, scale,
      causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_kv(batch * kv_heads, (s_len + kMmaRows - 1) / kMmaRows);
  dkdv_mma_kernel<HDP><<<grid_kv, 256, smem_kv, stream>>>(
      static_cast<const bf16*>(qs), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), t_len, s_len, heads,
      kv_heads, hd, causal, window);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const void* lse,
                       void* dsum, void* dq, void* dk, void* dv, int batch,
                       int t_len, int s_len, int heads, int kv_heads, int hd,
                       float scale, int causal, int window,
                       cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = mach::allow_smem(dkdv_kernel, smem);
  if (err != cudaSuccess) return err;
  err = mach::allow_smem(dq_kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows = batch * t_len * heads;
  row_dot_kernel<<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                   stream>>>(static_cast<const float*>(dout),
                             static_cast<const float*>(out),
                             static_cast<float*>(dsum), rows, t_len, heads,
                             hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_kv((s_len + kBK - 1) / kBK, batch * kv_heads);
  dkdv_kernel<<<grid_kv, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<float*>(dk), static_cast<float*>(dv), t_len, s_len, heads,
      kv_heads, hd, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_q((t_len + kBQ - 1) / kBQ, batch * heads);
  dq_kernel<<<grid_q, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<float*>(dq), t_len, s_len, heads, kv_heads, hd, scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace flash_bwd

extern "C" {

// q, out, dout, dq (batch, t_len, heads, hd); k, v, dk, dv (batch, s_len,
// kv_heads, hd), all contiguous float32 (bf16 == 0: the FMA kernels) or
// bfloat16 (bf16 == 1: the tensor-core kernels); lse (batch, heads, t_len)
// float32 from the forward; dsum a float32 scratch of lse's size; qs a
// scratch of q's shape and type for bf16 (Qs, from pass 1 to pass 2),
// unused for float32.  Limits as the forward's.  Returns a cudaError_t
// code.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* out, const void* dout,
                               const void* lse, void* dsum, void* qs,
                               void* dq, void* dk, void* dv, int batch,
                               int t_len, int s_len, int heads, int kv_heads,
                               int hd, float scale, int causal, int window,
                               int bf16, void* stream) {
  if (batch < 1 || t_len < 1 || s_len < 1 || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || hd < 16 || hd > flash_bwd::kMaxHd ||
      hd % 16 != 0 || batch * heads > 65535 ||
      (t_len + flash_bwd::kBQ - 1) / flash_bwd::kBQ > 65535 ||
      (s_len + flash_bwd::kBK - 1) / flash_bwd::kBK > 65535 ||
      (bf16 && qs == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    return static_cast<int>(flash_bwd::launch_f32(
        q, k, v, out, dout, lse, dsum, dq, dk, dv, batch, t_len, s_len, heads,
        kv_heads, hd, scale, causal, window, s));
  }
  auto run = flash_mma::padded_hd(hd) == 64    ? flash_bwd::launch_mma<64>
             : flash_mma::padded_hd(hd) == 128 ? flash_bwd::launch_mma<128>
                                               : flash_bwd::launch_mma<256>;
  return static_cast<int>(run(q, k, v, out, dout, lse, dsum, qs, dq, dk, dv,
                              batch, t_len, s_len, heads, kv_heads, hd, scale,
                              causal, window, s));
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
