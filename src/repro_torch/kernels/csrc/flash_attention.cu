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
// of one type; query head h reads kv head h / (H / KV).  Both kernels
// walk 64-key tiles, only those that the causal mask and the window leave
// partly open for the block's rows (a window of 2048 at T = 4096 reads
// about half of them); a wholly masked tile would leave (m, l, acc)
// unchanged, so skipping it changes no bit.  The plain version
// (kernels/flash_attention.py) walks the same 64-key tiles, so both take
// the same running maxima and round e at the same points; only the order
// of the float32 sums differs.
//
// Training asks for the row log-sum-exp as well: with a non-null lse
// (B, H, T) float32 the kernels also write m + log(l) for each query row
// (+inf for a row with no visible column, so that the backward's
// exp(S - lse) is zero there).  Serving passes none, and the output is
// the same either way, bit for bit.
//
// bfloat16 (the LM path): flash_mma_kernel, on the tensor cores.
//   One block owns a (b, head) and a query tile of 16 rows a warp: 4 warps
//   (64 rows) at a padded width HDP of 64 or 128, 8 warps (128 rows) at
//   256.  Any hd that is a multiple of 16 up to 256 runs at the next HDP,
//   its columns past hd zero-filled: they add nothing to S, and the output
//   columns past hd are not written.  Qs = bf16(q · scale) sits in shared
//   memory; K and V tiles stream through a two-stage cp.async ring (the
//   next tile loads while this one computes).  Each warp forms its 16 x 64
//   scores with flash_mma.cuh's warp_scores (mma.sync m16n8k16, bf16 in,
//   float32 accumulate), masks them in the accumulator layout, updates
//   (m, l) per row with quad shuffles, rounds e to bf16 straight into the
//   A fragments of P·V (the accumulator of two n8 tiles is the A fragment
//   of one k16 step), and adds P·V into its 16 x HDP float32 output in
//   registers.  The cast points are exactly the plain version's; the
//   tensor cores only sum in another order.
//   Registers at HDP = 256: the output is 16 x 256 float32 a warp, 128 a
//   thread, plus 32 for the scores; Q stays in shared memory (re-read by
//   ldmatrix each tile) rather than in 64 more registers, so the kernel
//   fits 255 without spills (chip_smoke.py prints ptxas's count).
//   Shared memory at HDP = 256: Q (128, 264) + two stages of K and V
//   (64, 264) bf16 = 198 KB, one block (8 warps) an SM; at 128, 85 KB,
//   two blocks an SM.  Rows are padded by 16 bytes so ldmatrix is free of
//   bank conflicts.  Query tiles are issued longest-first (the causal
//   tiles at the end of the sequence see the most keys), and a warp skips
//   a key tile that is wholly masked for its own 16 rows.
//
// float32 (the reference model and its rtol-1e-4 checks, which TF32
// cannot meet): flash_kernel, plain float32 FMAs from shared memory.  256
// threads, as 16 row groups of 4 query rows by 16 column lanes; for the
// scores a thread holds a 4 x 4 tile (key columns lane + 16c), for P·V 4
// rows x hd/16 output columns (lane + 16j) in registers.  Shared rows are
// padded (hd + 4 floats) so the float4 reads of K rows are free of bank
// conflicts.
//
// What bounds it on this card: operations.  4·hd flops per attended
// (query, key) pair and head — 64.4 GFLOP at (1, 4096, 10, 256) with
// window 2048 — is 0.065 ms at the 989 TFLOP/s bf16 tensor-core peak.
// mma.sync reaches only part of that peak (wgmma with TMA-fed tiles is
// the way to the rest), and the S and P·V operands are re-read from
// shared memory by every warp.  HBM traffic is q, k, v and out once each
// (K/V re-reads by the heads of a group and the query tiles of a window
// hit L2: the heads of one query tile are issued together).
#include <cuda_bf16.h>

#include "flash_mma.cuh"
#include "mach_common.cuh"

namespace flash {

using flash_mma::kBK;              // key columns a tile
using flash_mma::kNegInf;

constexpr int kThreads = 256;
constexpr int kBQ = 64;            // query rows a block (float32)
constexpr int kMaxHd = 256;
constexpr int kMaxCols = kMaxHd / 16;   // output columns a thread
constexpr int kPS = kBK + 4;       // padded P row (floats)

inline size_t smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (hd + 4) +
                          static_cast<size_t>(kBK) * (hd + 4) +
                          static_cast<size_t>(kBK) * hd + kBQ * kPS);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out,
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

  // the scaled q tile, zero beyond T
  for (int idx = tid; idx < kBQ * hd; idx += kThreads) {
    const int r = idx / hd, d = idx % hd;
    const int row = q0 + r;
    float val = 0.f;
    if (row < t_len) {
      val = __fmul_rn(q[((static_cast<size_t>(b) * t_len + row) * heads + h) *
                          hd + d], scale);
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

  int tile_begin, tile_end;
  flash_mma::key_tiles(q0, kBQ, t_len, s_len, causal, window, &tile_begin,
                       &tile_end);

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
        kv = k[off];
        vv = v[off];
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

    // mask, online softmax update, e into ps
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
        ps[(rg * 4 + i) * kPS + lane + 16 * c] = e;
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
    float* dst =
        out + ((static_cast<size_t>(b) * t_len + row) * heads + h) * hd;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      if (j < ncols) {
        const float o = l[i] > 0.f ? __fdiv_rn(acc[i][j], denom) : 0.f;
        dst[lane + 16 * j] = o;
      }
    }
    if (lse != nullptr && lane == 0) {
      lse[(static_cast<size_t>(b) * heads + h) * t_len + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : CUDART_INF_F;
    }
  }
}


namespace fm = flash_mma;

template <int HDP, int WARPS>
constexpr size_t mma_smem_bytes() {
  return sizeof(fm::bf16) * (16 * WARPS + 4 * fm::kBK) * (HDP + 8);
}

template <int HDP, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
flash_mma_kernel(const fm::bf16* __restrict__ q, const fm::bf16* __restrict__ k,
                 const fm::bf16* __restrict__ v, fm::bf16* __restrict__ out,
                 float* __restrict__ lse, int t_len, int s_len, int heads,
                 int kv_heads, int hd, float scale, int causal, int window) {
  constexpr int kNT = WARPS * 32, kRows = 16 * WARPS, LD = HDP + 8;
  constexpr int kDT = HDP / 8;                  // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fm::bf16* qs = reinterpret_cast<fm::bf16*>(smem_raw);   // (kRows, LD)
  fm::bf16* ks = qs + kRows * LD;                         // 2 x (kBK, LD)
  fm::bf16* vs = ks + 2 * fm::kBK * LD;                   // 2 x (kBK, LD)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // longest first
  const int kvh = h / (heads / kv_heads);
  const size_t q_stride = static_cast<size_t>(heads) * hd;
  const size_t kv_stride = static_cast<size_t>(kv_heads) * hd;
  const fm::bf16* qb = q + static_cast<size_t>(b) * t_len * q_stride + h * hd;
  const size_t kv_base = static_cast<size_t>(b) * s_len * kv_stride + kvh * hd;
  const fm::bf16* kb = k + kv_base;
  const fm::bf16* vb = v + kv_base;

  int tile_begin, tile_end;
  fm::key_tiles(q0, kRows, t_len, s_len, causal, window, &tile_begin,
                &tile_end);

  fm::load_rows<kRows, HDP, kNT>(qs, qb, q_stride, q0, t_len, hd);
  fm::cp_async_commit();
  if (tile_begin < tile_end) {
    fm::load_rows<fm::kBK, HDP, kNT>(ks, kb, kv_stride, tile_begin * fm::kBK,
                                     s_len, hd);
    fm::load_rows<fm::kBK, HDP, kNT>(vs, vb, kv_stride, tile_begin * fm::kBK,
                                     s_len, hd);
  }
  fm::cp_async_commit();
  fm::cp_async_wait<1>();
  __syncthreads();
  // each warp reads only its own 16 rows of Qs
  fm::scale_rows<HDP>(qs + warp * 16 * LD, 16, hd, scale, lane, 32);
  __syncwarp();

  const int row_a = q0 + warp * 16 + lane / 4, row_b = row_a + 8;
  float m[2] = {fm::kNegInf, fm::kNegInf}, l[2] = {0.f, 0.f};
  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int st = (tile - tile_begin) & 1;
    if (tile + 1 < tile_end) {   // the next tile into the other stage
      const int nst = st ^ 1;
      fm::load_rows<fm::kBK, HDP, kNT>(ks + nst * fm::kBK * LD, kb, kv_stride,
                                       (tile + 1) * fm::kBK, s_len, hd);
      fm::load_rows<fm::kBK, HDP, kNT>(vs + nst * fm::kBK * LD, vb, kv_stride,
                                       (tile + 1) * fm::kBK, s_len, hd);
    }
    fm::cp_async_commit();
    fm::cp_async_wait<1>();
    __syncthreads();

    const int k0 = tile * fm::kBK;
    const fm::bf16* kt = ks + st * fm::kBK * LD;
    const fm::bf16* vt = vs + st * fm::kBK * LD;
    if (!fm::all_masked(q0 + warp * 16, 16, k0, fm::kBK, causal, window)) {
      float s[8][4];
      fm::warp_scores<8, HDP>(s, qs + warp * 16 * LD, kt, hd, lane);

      // mask; row maxima over the quad that holds a row
      uint32_t ok = 0;
      float mx[2] = {fm::kNegInf, fm::kNegInf};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * (lane % 4) + (e & 1);
          const bool vis = fm::visible(e < 2 ? row_a : row_b, col, t_len,
                                       s_len, causal, window);
          if (vis) ok |= 1u << (j * 4 + e);
          else s[j][e] = fm::kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = m[i] > fm::kNegInf / 2 ? expf(m[i] - m_new) : 0.f;
        m[i] = m_new;
      }
      // e = exp(s - m), summed in float32, rounded to bf16 for P·V
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float e4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          e4[e] = (ok >> (j * 4 + e)) & 1u ? expf(s[j][e] - m[e >> 1]) : 0.f;
          rsum[e >> 1] += e4[e];
        }
        pa[j / 2][(j & 1) * 2] = fm::pack_bf16(e4[0], e4[1]);
        pa[j / 2][(j & 1) * 2 + 1] = fm::pack_bf16(e4[2], e4[3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
        rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
        l[i] = __fadd_rn(__fmul_rn(l[i], corr[i]), rsum[i]);
      }
      // acc = acc * corr + P · V
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int j = 0; j < kDT / 2; ++j) {
          if (j * 16 < hd) {
            uint32_t bv[4];
            fm::ldsm_x4_t(bv, vt + (kk * 16 + (lane & 7) +
                                    (((lane >> 3) & 1) << 3)) * LD +
                                  j * 16 + (lane >> 4) * 8);
            fm::mma(o[2 * j], pa[kk], bv[0], bv[1]);
            fm::mma(o[2 * j + 1], pa[kk], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

  // out = acc / max(l, 1e-37), zero where l = 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row_a : row_b;
    if (row >= t_len) continue;
    const float denom = fmaxf(l[i], 1e-37f);
    fm::bf16* dst = out + static_cast<size_t>(b) * t_len * q_stride +
                    static_cast<size_t>(row) * q_stride + h * hd;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      const int col = j * 8 + 2 * (lane % 4);
      if (col < hd) {
        const float o0 = l[i] > 0.f ? __fdiv_rn(o[j][2 * i], denom) : 0.f;
        const float o1 = l[i] > 0.f ? __fdiv_rn(o[j][2 * i + 1], denom) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(o0, o1);
      }
    }
    if (lse != nullptr && lane % 4 == 0) {
      lse[(static_cast<size_t>(b) * heads + h) * t_len + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : CUDART_INF_F;
    }
  }
}

template <int HDP, int WARPS>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       void* lse, int batch, int t_len, int s_len, int heads,
                       int kv_heads, int hd, float scale, int causal,
                       int window, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<HDP, WARPS>();
  cudaError_t err = mach::allow_smem(flash_mma_kernel<HDP, WARPS>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(batch * heads, (t_len + 16 * WARPS - 1) / (16 * WARPS));
  flash_mma_kernel<HDP, WARPS><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const fm::bf16*>(q), static_cast<const fm::bf16*>(k),
      static_cast<const fm::bf16*>(v), static_cast<fm::bf16*>(out),
      static_cast<float*>(lse), t_len, s_len, heads, kv_heads, hd, scale,
      causal, window);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       void* lse, int batch, int t_len, int s_len, int heads,
                       int kv_heads, int hd, float scale, int causal,
                       int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = mach::allow_smem(flash_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t_len + kBQ - 1) / kBQ, batch * heads);
  flash_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), t_len, s_len, heads, kv_heads, hd, scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace flash

extern "C" {

// q, out (batch, t_len, heads, hd); k, v (batch, s_len, kv_heads, hd);
// all contiguous float32 (bf16 == 0: the FMA kernel) or bfloat16 (bf16 ==
// 1: the tensor-core kernel).  heads a multiple of kv_heads; hd a
// multiple of 16, at most 256; window <= 0 means no window.  lse: null,
// or (batch, heads, t_len) float32 for the row log-sum-exp.  Returns a
// cudaError_t code.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, void* lse, int batch, int t_len,
                           int s_len, int heads, int kv_heads, int hd,
                           float scale, int causal, int window, int bf16,
                           void* stream) {
  if (batch < 1 || t_len < 1 || s_len < 1 || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || hd < 16 || hd > flash::kMaxHd || hd % 16 != 0 ||
      batch * heads > 65535 || (t_len + flash::kBQ - 1) / flash::kBQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    return static_cast<int>(flash::launch_f32(
        q, k, v, out, lse, batch, t_len, s_len, heads, kv_heads, hd, scale,
        causal, window, s));
  }
  auto run = flash_mma::padded_hd(hd) == 64 ? flash::launch_mma<64, 4>
             : flash_mma::padded_hd(hd) == 128 ? flash::launch_mma<128, 4>
                                               : flash::launch_mma<256, 8>;
  return static_cast<int>(run(q, k, v, out, lse, batch, t_len, s_len, heads,
                              kv_heads, hd, scale, causal, window, s));
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
