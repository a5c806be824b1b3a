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
// S is summed in the forward's order (float4 steps of d, one fmaf each),
// so exp(S - lse) uses the scores the forward normalized.  P is float32:
// this is the exact gradient of softmax attention, not of the forward's
// rounding of e to v's type before P V.
//
// Three kernels on one stream, one launch function:
//  1. row_dot: D, one warp a (b, t, h) row.
//  2. dkdv: one block per (b, kv head, 32-key tile).  K and V sit in
//     shared memory; the block loops over the group's H / KV query heads
//     and, for each, the 32-query tiles that can see the key tile (query
//     rows >= its first key when causal, < its last key + window when
//     windowed).  dK and dV accumulate in registers (4 key rows by hd / 32
//     columns a thread) over the whole group, so there are no atomics and
//     the result does not depend on scheduling.
//  3. dq: one block per (b, head, 32-query tile), over the key tiles the
//     forward visits for those rows; dQ accumulates in registers.
// Masked entries have P = 0 exactly, so a wholly masked tile adds nothing
// and skipping it changes no bit.
//
// Shared memory: four float32 (32, hd + 4) tiles (Q, dO, K, V), P and dS
// (32, 33) and the rows' lse and D: 142 KB at hd = 256, one block an SM.
// 32-row tiles (not the forward's 64) keep the register accumulators at
// 64 floats a thread at hd = 256.
//
// What bounds it on this card: operations.  The backward's tensor-core
// work is 2.5x the forward's: 10 hd flops per attended (query, key) pair
// and head (S, dP, dV, dK, dQ), 322 GFLOP at (2, 4096, 10, 256) with
// window 2048, 0.33 ms at 989 TFLOP/s bf16; this first kernel runs on
// float32 FMAs outside the tensor cores and recomputes S and dP in both
// passes (14 hd flops a pair).
#include <cuda_bf16.h>

#include "mach_common.cuh"

namespace flash_bwd {

constexpr int kThreads = 256;
constexpr int kBQ = 32;            // query rows a tile
constexpr int kBK = 32;            // key columns a tile
constexpr int kMaxHd = 256;
constexpr int kMaxCols = kMaxHd / 32;   // accumulator columns a thread
constexpr int kPS = kBK + 1;       // padded P / dS row (floats)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

inline size_t smem_bytes(int hd) {
  return sizeof(float) * (4 * static_cast<size_t>(kBQ) * (hd + 4) +
                          2 * kBQ * kPS + 2 * kBQ);
}

// rows [r0, r0 + kBQ) of head hh of a (B, len, nheads, hd) tensor into
// dst (kBQ, hd + 4) as float32, zero beyond len; q is scaled and rounded
// to its type, as the forward does
template <typename T, bool kScaleQ>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int b, int r0, int len, int nheads,
                                          int hh, int hd, float scale) {
  const int stride = hd + 4;
  for (int idx = threadIdx.x; idx < kBQ * hd; idx += kThreads) {
    const int r = idx / hd, d = idx % hd;
    const int row = r0 + r;
    float val = 0.f;
    if (row < len) {
      val = to_f32(src[((static_cast<size_t>(b) * len + row) * nheads + hh) *
                           hd + d]);
      if (kScaleQ) val = round_to<T>(__fmul_rn(val, scale));
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

__device__ __forceinline__ bool visible(int row, int col, int t_len,
                                        int s_len, int causal, int window) {
  return row < t_len && col < s_len && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_dot_kernel(const T* __restrict__ dout, const T* __restrict__ out,
               float* __restrict__ dsum, int rows, int t_len, int heads,
               int hd) {
  const int r = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const size_t base = static_cast<size_t>(r) * hd;
  float s = 0.f;
  for (int c = lane; c < hd; c += 32)
    s = fmaf(to_f32(dout[base + c]), to_f32(out[base + c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {   // r walks (b, t, h); D is (b, h, t)
    const int b = r / (t_len * heads), rem = r % (t_len * heads);
    dsum[(static_cast<size_t>(b) * heads + rem % heads) * t_len +
         rem / heads] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            T* __restrict__ dk, T* __restrict__ dv, int t_len, int s_len,
            int heads, int kv_heads, int hd, float scale, int causal,
            int window) {
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

  load_tile<T, false>(ks, k, b, k0, s_len, kv_heads, kvh, hd, 0.f);
  load_tile<T, false>(vs, v, b, k0, s_len, kv_heads, kvh, hd, 0.f);

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
      load_tile<T, true>(qs, q, b, q0, t_len, heads, h, hd, scale);
      load_tile<T, false>(dos, dout, b, q0, t_len, heads, h, hd, 0.f);
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
        dk[off + c] = from_f32<T>(dk_acc[r][m]);
        dv[off + c] = from_f32<T>(dv_acc[r][m]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dsum,
          T* __restrict__ dq, int t_len, int s_len, int heads, int kv_heads,
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

  load_tile<T, true>(qs, q, b, q0, t_len, heads, h, hd, scale);
  load_tile<T, false>(dos, dout, b, q0, t_len, heads, h, hd, 0.f);
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
    load_tile<T, false>(ks, k, b, k0, s_len, kv_heads, kvh, hd, 0.f);
    load_tile<T, false>(vs, v, b, k0, s_len, kv_heads, kvh, hd, 0.f);
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
      if (c < hd) dq[off + c] = from_f32<T>(acc[r][m] * scale);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const void* lse,
                   void* dsum, void* dq, void* dk, void* dv, int batch,
                   int t_len, int s_len, int heads, int kv_heads, int hd,
                   float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = mach::allow_smem(dkdv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  err = mach::allow_smem(dq_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int rows = batch * t_len * heads;
  row_dot_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads,
                      0, stream>>>(static_cast<const T*>(dout),
                                   static_cast<const T*>(out),
                                   static_cast<float*>(dsum), rows, t_len,
                                   heads, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_kv((s_len + kBK - 1) / kBK, batch * kv_heads);
  dkdv_kernel<T><<<grid_kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dk), static_cast<T*>(dv), t_len, s_len, heads, kv_heads,
      hd, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_q((t_len + kBQ - 1) / kBQ, batch * heads);
  dq_kernel<T><<<grid_q, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dq), t_len, s_len, heads, kv_heads, hd, scale, causal,
      window);
  return cudaGetLastError();
}

}  // namespace flash_bwd

extern "C" {

// q, out, dout, dq (batch, t_len, heads, hd); k, v, dk, dv (batch, s_len,
// kv_heads, hd), all contiguous float32 (bf16 == 0) or bfloat16 (bf16 ==
// 1); lse (batch, heads, t_len) float32 from the forward; dsum a float32
// scratch of lse's size.  Limits as the forward's.  Returns a cudaError_t
// code.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* out, const void* dout,
                               const void* lse, void* dsum, void* dq,
                               void* dk, void* dv, int batch, int t_len,
                               int s_len, int heads, int kv_heads, int hd,
                               float scale, int causal, int window, int bf16,
                               void* stream) {
  if (batch < 1 || t_len < 1 || s_len < 1 || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || hd < 16 || hd > flash_bwd::kMaxHd ||
      hd % 16 != 0 || batch * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return static_cast<int>(flash_bwd::launch<__nv_bfloat16>(
        q, k, v, out, dout, lse, dsum, dq, dk, dv, batch, t_len, s_len, heads,
        kv_heads, hd, scale, causal, window, s));
  }
  return static_cast<int>(flash_bwd::launch<float>(
      q, k, v, out, dout, lse, dsum, dq, dk, dv, batch, t_len, s_len, heads,
      kv_heads, hd, scale, causal, window, s));
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
