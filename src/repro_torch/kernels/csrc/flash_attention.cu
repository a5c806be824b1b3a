// Causal / windowed GQA flash attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// and computes what its _flash_body computes, for contiguous positions
// (query row i, key column j): q is scaled in float32 and rounded to k's
// type, scores are float32 sums, a column is kept iff j <= i (causal) and
// j > i - window (windowed), masked scores are the most negative float32
// (-3.4028235e38, not -inf), the running (m, l, acc) state guards the
// correction of rows that have no valid column yet, e is rounded to v's
// type before P·V, and the output is acc / max(l, 1e-37) with rows of
// l = 0 set to zero.
//
// Layout: q, out (B, T, H, hd); k, v (B, S, KV, hd), all contiguous and
// of one type (float32 or bfloat16); query head h reads kv head
// h / (H / KV).  One block owns one (batch, head) and a 64-query tile:
// the scaled q tile sits in shared memory, and 64-key tiles of K and V
// stream through it.  The block walks only the key tiles that the causal
// mask and the window leave partly open (a window of 2048 at T = 4096
// reads about half of them); a wholly masked tile would leave (m, l, acc)
// unchanged, so skipping it changes no bit.  The plain version
// (kernels/flash_attention.py) walks the same 64-key tiles, so both take
// the same running maxima and round e at the same points; only the order
// of the float32 sums differs.
//
// Threads: 256, as 16 row groups of 4 query rows by 16 column lanes.  For
// the scores a thread holds a 4 x 4 tile (key columns lane + 16c); the 16
// lanes of a row group reduce row maxima and sums with warp shuffles.
// For P·V it holds 4 rows x hd/16 output columns (lane + 16j) in float32
// registers.  Shared rows are padded (hd + 4 floats) so the float4 reads
// of K rows are free of bank conflicts.
//
// Training asks for the row log-sum-exp as well: with a non-null lse
// (B, H, T) float32 the kernel also writes m + log(l) for each query row
// (+inf for a row with no visible column, so that the backward's
// exp(S - lse) is zero there).  Serving passes none, and the output is
// the same either way, bit for bit.
//
// What bounds it on this card: operations.  4·hd flops per attended
// (query, key) pair and head — 64.4 GFLOP at (1, 4096, 10, 256) with
// window 2048 — is 0.065 ms at the 989 TFLOP/s bf16 tensor-core peak,
// and 0.96 ms at 67 TFLOP/s outside the tensor cores, where this first
// kernel runs: plain float32 FMAs from shared memory, no mma, no TMA.
// HBM traffic is q, k, v and out once each (K/V re-reads by the heads of
// a group and the query tiles of a window hit L2).
#include <cuda_bf16.h>

#include "mach_common.cuh"

namespace flash {

constexpr int kThreads = 256;
constexpr int kBQ = 64;            // query rows a block
constexpr int kBK = 64;            // key columns a tile
constexpr int kMaxHd = 256;
constexpr int kMaxCols = kMaxHd / 16;   // output columns a thread
constexpr int kPS = kBK + 4;       // padded P row (floats)
constexpr float kNegInf = -3.4028234663852886e38f;   // finfo(float32).min

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
// round a float32 to T's precision and back (the casts of the reference)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

inline size_t smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (hd + 4) +
                          static_cast<size_t>(kBK) * (hd + 4) +
                          static_cast<size_t>(kBK) * hd + kBQ * kPS);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int t_len,
             int s_len, int heads, int kv_heads, int hd, float scale,
             int causal, int window) {
  extern __shared__ __align__(16) float smem[];
  const int qs_stride = hd + 4;
  float* qs = smem;                               // (kBQ, hd + 4)
  float* ks = qs + kBQ * qs_stride;               // (kBK, hd + 4)
  float* vs = ks + kBK * qs_stride;               // (kBK, hd)
  float* ps = vs + kBK * hd;                      // (kBQ, kPS)

  const int tid = threadIdx.x;
  const int rg = tid / 16;          // row group: rows rg*4 .. rg*4+3
  const int lane = tid % 16;        // column lane
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int kvh = h / (heads / kv_heads);
  const int ncols = hd / 16;

  // the scaled q tile: round_to<T>(q * scale), zero beyond T
  for (int idx = tid; idx < kBQ * hd; idx += kThreads) {
    const int r = idx / hd, d = idx % hd;
    const int row = q0 + r;
    float val = 0.f;
    if (row < t_len) {
      val = to_f32(q[((static_cast<size_t>(b) * t_len + row) * heads + h) *
                         hd + d]);
      val = round_to<T>(__fmul_rn(val, scale));
    }
    qs[r * qs_stride + d] = val;
  }

  float m[4], l[4], acc[4][kMaxCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) acc[i][j] = 0.f;
  }

  // key tiles that the mask leaves partly open for rows q0 .. q_hi
  const int q_hi = min(q0 + kBQ, t_len) - 1;
  const int k_end = causal ? min(s_len, q_hi + 1) : s_len;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int tile_begin = k_begin / kBK;
  const int tile_end = k_end > k_begin ? (k_end + kBK - 1) / kBK : tile_begin;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();   // the previous tile's P·V is done with ks, vs, ps
    for (int idx = tid; idx < kBK * hd; idx += kThreads) {
      const int r = idx / hd, d = idx % hd;
      const int col = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (col < s_len) {
        const size_t off =
            ((static_cast<size_t>(b) * s_len + col) * kv_heads + kvh) * hd + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[r * qs_stride + d] = kv;
      vs[r * hd + d] = vv;
    }
    __syncthreads();

    // scores: rows rg*4+i, columns lane+16c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            &qs[(rg * 4 + i) * qs_stride + d]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(
            &ks[(lane + 16 * c) * qs_stride + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qv[i].x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(qv[i].y, kv[c].y, s[i][c]);
          s[i][c] = fmaf(qv[i].z, kv[c].z, s[i][c]);
          s[i][c] = fmaf(qv[i].w, kv[c].w, s[i][c]);
        }
    }

    // mask, online softmax update, e rounded to v's type into ps
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      bool ok[4];
      float tmax = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + lane + 16 * c;
        ok[c] = row < t_len && col < s_len && (!causal || col <= row) &&
                (window <= 0 || col > row - window);
        if (!ok[c]) s[i][c] = kNegInf;
        tmax = fmaxf(tmax, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      corr[i] = m[i] > kNegInf / 2 ? expf(m[i] - m_new) : 0.f;
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        rsum += e;
        ps[(rg * 4 + i) * kPS + lane + 16 * c] = round_to<T>(e);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = __fadd_rn(__fmul_rn(l[i], corr[i]), rsum);
      m[i] = m_new;
    }
    __syncthreads();

    // acc = acc * corr + P · V
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) acc[i][j] *= corr[i];
    for (int jj = 0; jj < kBK; ++jj) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(rg * 4 + i) * kPS + jj];
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        if (j < ncols) {
          const float vv = vs[jj * hd + lane + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= t_len) continue;
    const float denom = fmaxf(l[i], 1e-37f);
    T* dst = out + ((static_cast<size_t>(b) * t_len + row) * heads + h) * hd;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      if (j < ncols) {
        const float o = l[i] > 0.f ? __fdiv_rn(acc[i][j], denom) : 0.f;
        dst[lane + 16 * j] = from_f32<T>(o);
      }
    }
    if (lse != nullptr && lane == 0) {
      lse[(static_cast<size_t>(b) * heads + h) * t_len + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : CUDART_INF_F;
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int batch, int t_len, int s_len, int heads,
                   int kv_heads, int hd, float scale, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = mach::allow_smem(flash_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t_len + kBQ - 1) / kBQ, batch * heads);
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), t_len, s_len, heads, kv_heads, hd, scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace flash

extern "C" {

// q, out (batch, t_len, heads, hd); k, v (batch, s_len, kv_heads, hd);
// all contiguous float32 (bf16 == 0) or bfloat16 (bf16 == 1).  heads a
// multiple of kv_heads; hd a multiple of 16, at most 256; window <= 0
// means no window.  lse: null, or (batch, heads, t_len) float32 for the
// row log-sum-exp.  Returns a cudaError_t code.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, void* lse, int batch, int t_len,
                           int s_len, int heads, int kv_heads, int hd,
                           float scale, int causal, int window, int bf16,
                           void* stream) {
  if (batch < 1 || t_len < 1 || s_len < 1 || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || hd < 16 || hd > flash::kMaxHd || hd % 16 != 0 ||
      batch * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return static_cast<int>(flash::launch<__nv_bfloat16>(
        q, k, v, out, lse, batch, t_len, s_len, heads, kv_heads, hd, scale,
        causal, window, s));
  }
  return static_cast<int>(flash::launch<float>(
      q, k, v, out, lse, batch, t_len, s_len, heads, kv_heads, hd, scale,
      causal, window, s));
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
