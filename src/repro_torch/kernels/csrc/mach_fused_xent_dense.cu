// Fused projection + R-head cross-entropy on dense inputs, forward and
// backward, for Hopper (sm_90a), on the tensor cores.
//
// Replaces src/repro/kernels/mach_fused_xent.py::mach_fused_xent_pallas
// (its forward body and the two-phase backward of its custom VJP).
// h (N, d), W (d, R*B) and an optional bias (R*B,), all float32 or all
// bfloat16, labels (N, R) int32 -> per-example loss (N,) and per-head
// logsumexp (N, R), float32; the backward gives dW, dbias and, when asked,
// dh, in the inputs' dtype, summed in float32.  The (N, R*B) logits and
// dlogits never reach device memory in either pass.
//
// What bounds it on this card: the products, 2*N*d*R*B operations forward
// and 4*N*d*R*B backward (the logits again, then dW; 6 with dh).  bf16
// runs them as mma.sync.m16n8k16 (a bf16 x bf16 product is exact in
// float32, so this is the JAX kernel's function); float32 as 3xTF32 on
// mma.sync.m16n8k8 (three TF32 products an operation, float32-level
// error), so its floor is 3x the operations at the TF32 rate.
//
// Design (mma.sync with ldmatrix / plain shared loads; wgmma and TMA are
// later work):
// - A block owns a (row tile, column tile) of the logits.  float32: 64 x
//   128 forward (640 blocks at ImageNet-21k), 128 x 128 backward, eight
//   warps with 32 x 32 or 32 x 64 patches in registers; bf16: 128 x 256
//   both ways, warps of 64 x 64.  The patches are summed over d in
//   32-deep (float32) or 64-deep (bf16) stages fed by a
//   3-stage cp.async ring (plain element loads where a row stride or base
//   is not 16-byte aligned, as at d = 333 or R*B = 259).  Rows past N,
//   depth past d and columns past R*B are zero-filled.  The tensor cores
//   truncate as they accumulate, so each 8-deep (float32) or 32-deep
//   (bf16) chunk is summed into zeroed fragments and added to the running
//   sum by float32 adds.  Every logit is formed by the same instruction
//   sequence in both passes, so the backward's exp(logit - lse) uses the
//   forward's logits.
// - Forward: each (row, head) segment of the tile yields a partial (max,
//   sum-exp, label logit) in a small (N, R, span) scratch; a second kernel
//   merges each head's partials in column order, and a third sums the R
//   heads in order.  Deterministic.
// - Backward: dlogits = g * (softmax - onehot) is formed in registers from
//   the saved lse, written to shared memory (bf16 inputs: rounded to bf16
//   there, FlashAttention-2's cast point), and dbias takes its float32
//   column sums.  Then the block sweeps d in 64-wide slices: dW[slice,
//   cols] += h^T dlogits over its 128 rows and, when asked, dh[rows,
//   slice] += dlogits W^T over its columns, each added into a float32
//   accumulator by red.global.add.v4.f32 (one add per element per row tile
//   for dW, per column tile for dh).  Those sums run across blocks, in an
//   order that changes from run to run.  bf16 results are cast from the
//   accumulators once at the end.
#include <cuda_bf16.h>

#include <type_traits>

#include "mach_xent_common.cuh"
#include "mma_sync.cuh"

namespace dense {

namespace ms = mma_sync;
using bf16 = __nv_bfloat16;
using mach::kThreads;

constexpr int kStages = 3;      // cp.async ring depth
constexpr int kBwdRows = 128;   // rows a backward block owns
constexpr int kSlice = 64;      // d-slice of the backward's dW / dh products

// Tiles by dtype, and shared-memory row strides (elements).  float32
// fragments are read by plain 4-byte loads: a stride = 4 mod 32 makes the
// (row lane/4, column lane%4) pattern conflict-free, 8 mod 32 the
// transposed one.  bf16 rows are padded by 16 bytes so the 8 row
// addresses of an ldmatrix fall on distinct bank groups.  bf16 takes the
// wider tiles (warp patches of 64 x 64): its operands are half the bytes.
template <typename T> struct Lay;
template <> struct Lay<float> {
  static constexpr int kN = 128;          // logits columns a tile
  static constexpr int kFwdRows = 64;     // rows a forward block owns
  static constexpr int kFwdWarpRows = 2;  // forward warps 2 x 4: 32 x 32 each
  static constexpr int kFwdBlocks = 2;    // forward blocks an SM
  static constexpr int kBwdWarpRows = 4;  // backward warps 4 x 2: 32 x 64
  static constexpr int kK = 32;           // d-depth of a ring stage
  static constexpr int kA = kK + 4;       // h stage (rows x k)
  static constexpr int kB = kN + 8;       // W stage (k x columns)
  static constexpr int kD = kN + 8;       // dlogits (rows x columns)
  static constexpr int kH = kSlice + 8;   // h slice (rows x k)
  static constexpr int kW = kN + 4;       // W slice (k x columns)
  static constexpr int kL = kN + 4;       // forward's float32 logits tile
};
template <> struct Lay<bf16> {
  static constexpr int kN = 256;
  static constexpr int kFwdRows = 128;
  static constexpr int kFwdWarpRows = 2;  // warps 2 x 4: 64 x 64 each
  static constexpr int kFwdBlocks = 1;
  static constexpr int kBwdWarpRows = 2;  // warps 2 x 4: 64 x 64 each
  static constexpr int kK = 64;
  static constexpr int kA = kK + 8;
  static constexpr int kB = kN + 8;
  static constexpr int kD = kN + 8;
  static constexpr int kH = kSlice + 8;
  static constexpr int kW = kN + 8;
  static constexpr int kL = kN + 4;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// dst (ROWS x COLS, row stride LD) = rows [r0, r0 + ROWS) x columns
// [c0, c0 + COLS) of a row-major matrix of `stride` elements a row; zero
// at rows >= row_end or columns >= col_end.  kVec: 16-byte cp.async
// (needs 16-byte aligned rows and col_end, c0 multiples of 16 bytes);
// else plain loads.
template <typename T, bool kVec, int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          size_t stride, int r0, int row_end,
                                          int c0, int col_end) {
  if constexpr (kVec) {
    constexpr int V = 16 / sizeof(T), CH = COLS / V;
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += kThreads) {
      const int r = idx / CH, c = (idx % CH) * V;
      const bool ok = r0 + r < row_end && c0 + c < col_end;
      const T* g = ok ? src + static_cast<size_t>(r0 + r) * stride + c0 + c
                      : src;
      ms::cp_async16(dst + r * LD + c, g, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * COLS; idx += kThreads) {
      const int r = idx / COLS, c = idx % COLS;
      const bool ok = r0 + r < row_end && c0 + c < col_end;
      dst[r * LD + c] =
          ok ? src[static_cast<size_t>(r0 + r) * stride + c0 + c] : T(0.f);
    }
  }
}

// acc[MT][NT] += A (16·MT rows from m0, K deep) · B (K deep, 8·NT columns
// from n0), one warp.  kAKM: A is stored k-major ([k][m], ldmatrix.trans /
// transposed loads), else [m][k].  kBKN: B is stored [k][n], else [n][k].
// Accumulator layout of m16n8: acc[i][j][0..1] row m0 + 16i + lane/4,
// columns n0 + 8j + 2(lane%4) + {0, 1}; [2..3] the same 8 rows lower.
// The tensor cores add into their accumulator with truncation, so each
// k-chunk (8 deep in float32, 32 in bf16) is summed into zeroed fragments
// and then added to acc by float32 adds (rounded to nearest), and the
// error does not grow with the depth of the sum.
template <bool kAKM, bool kBKN, int MT, int NT, int K, int LDA, int LDB>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const float* A, const float* B,
                                         int m0, int n0, int lane) {
  const int qr = lane >> 2, qc = lane & 3;
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ab[MT][4], as[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = m0 + 16 * i + qr, k = k0 + qc;
      float v[4];
      if constexpr (kAKM) {
        const float* p = A + k * LDA + m;
        v[0] = p[0]; v[1] = p[8]; v[2] = p[4 * LDA]; v[3] = p[4 * LDA + 8];
      } else {
        const float* p = A + m * LDA + k;
        v[0] = p[0]; v[1] = p[8 * LDA]; v[2] = p[4]; v[3] = p[8 * LDA + 4];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) ms::split_tf32(v[e], ab[i][e], as[i][e]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + qr, k = k0 + qc;
      float v0, v1;
      if constexpr (kBKN) {
        const float* p = B + k * LDB + n;
        v0 = p[0]; v1 = p[4 * LDB];
      } else {
        const float* p = B + n * LDB + k;
        v0 = p[0]; v1 = p[4];
      }
      uint32_t bb0, bs0, bb1, bs1;
      ms::split_tf32(v0, bb0, bs0);
      ms::split_tf32(v1, bb1, bs1);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float t[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
        ms::mma_3xtf32(t, u, ab[i], as[i], bb0, bb1, bs0, bs1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e] + u[e];
      }
    }
  }
}

template <bool kAKM, bool kBKN, int MT, int NT, int K, int LDA, int LDB>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const bf16* A, const bf16* B,
                                         int m0, int n0, int lane) {
  static_assert(NT % 2 == 0, "bf16 B fragments come in pairs of n-tiles");
  static_assert(K % 32 == 0, "bf16 k-chunks are 32 deep");
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 32) {
    uint32_t a[2][MT][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int kk = k0 + 16 * ks;
        if constexpr (kAKM) {
          ms::ldsm_x4_t(a[ks][i], A + (kk + (lane & 7) + ((lane >> 4) << 3)) *
                                          LDA + m0 + 16 * i +
                                      ((lane >> 3) & 1) * 8);
        } else {
          ms::ldsm_x4(a[ks][i], A + (m0 + 16 * i + (lane & 15)) * LDA + kk +
                                    (lane >> 4) * 8);
        }
      }
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t b[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int kk = k0 + 16 * ks;
        if constexpr (kBKN) {
          ms::ldsm_x4_t(b[ks], B + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                       LDB + n0 + 16 * j + (lane >> 4) * 8);
        } else {
          ms::ldsm_x4(b[ks], B + (n0 + 16 * j + (lane & 7) +
                                  ((lane >> 4) << 3)) * LDB + kk +
                                 ((lane >> 3) & 1) * 8);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          ms::mma(t0, a[ks][i], b[ks][0], b[ks][1]);
          ms::mma(t1, a[ks][i], b[ks][2], b[ks][3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][2 * j][e] += t0[e];
          acc[i][2 * j + 1][e] += t1[e];
        }
      }
    }
  }
}

// The logits patch of one warp: acc = h[row0.., :] · W[:, c0..] over all
// of d, through the block's cp.async ring (kStages x (BM x kA + kK x kB)
// elements at `ring`).  The one product path of both passes.  Ends
// synchronised with no copy in flight.
template <typename T, bool kVec, int BM, int MT, int NT>
__device__ __forceinline__ void logits_product(
    float (&acc)[MT][NT][4], T* ring, const T* __restrict__ h,
    const T* __restrict__ w, int row0, int n, int d, int cols, int c0,
    int wr0, int wc0, int lane) {
  using L = Lay<T>;
  constexpr int kAStage = BM * L::kA, kStage = kAStage + L::kK * L::kB;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int nk = (d + L::kK - 1) / L::kK;
  auto load = [&](int kt) {
    T* s = ring + (kt % kStages) * kStage;
    load_tile<T, kVec, BM, L::kK, L::kA>(s, h, d, row0, n, kt * L::kK, d);
    load_tile<T, kVec, L::kK, L::kN, L::kB>(s + kAStage, w, cols, kt * L::kK,
                                           d, c0, cols);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    ms::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    ms::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    ms::cp_async_commit();
    const T* s = ring + (kt % kStages) * kStage;
    warp_mma<false, true, MT, NT, L::kK, L::kA, L::kB>(acc, s, s + kAStage, wr0,
                                                     wc0, lane);
  }
  ms::cp_async_wait<0>();
  __syncthreads();
}

// the column tiles [t0, t1] (of bn columns) that head hh's buckets span
__device__ __forceinline__ int first_tile(int hh, int b, int bn) {
  return hh * b / bn;
}
__device__ __forceinline__ int last_tile(int hh, int b, int bn) {
  return (hh * b + b - 1) / bn;
}

// grid (ceil(N/kFwdRows), ceil(R*B/kN)); dynamic shared memory
// fwd_smem<T>().  part: 3 planes of (N, R, span) partial (max, sum-exp,
// label logit).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, Lay<T>::kFwdBlocks)
fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
           const T* __restrict__ bias, const int* __restrict__ labels, int n,
           int d, int r, int b, int span, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* lg = reinterpret_cast<float*>(smem);   // after the product
  using L = Lay<T>;
  constexpr int BM = L::kFwdRows, BN = L::kN, WM = L::kFwdWarpRows;
  constexpr int WN = 8 / WM, MT = BM / WM / 16, NT = BN / WN / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr0 = (warp / WN) * (BM / WM), wc0 = (warp % WN) * (BN / WN);
  const int row0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int cols = r * b;

  float acc[MT][NT][4];
  logits_product<T, kVec, BM, MT, NT>(acc, ring, h, w, row0, n, d, cols, c0,
                                      wr0, wc0, lane);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = wc0 + 8 * j + 2 * (lane & 3);
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      if (c0 + col < cols) b0 = to_f32(bias[c0 + col]);
      if (c0 + col + 1 < cols) b1 = to_f32(bias[c0 + col + 1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = wr0 + 16 * i + (lane >> 2) + 8 * hf;
        *reinterpret_cast<float2*>(lg + row * L::kL + col) =
            make_float2(acc[i][j][2 * hf] + b0, acc[i][j][2 * hf + 1] + b1);
      }
  }
  __syncthreads();

  // one warp per (row, head segment of the tile)
  const int rows = min(BM, n - row0), cw = min(BN, cols - c0);
  const int ha = c0 / b, hb = (c0 + cw - 1) / b, nseg = hb - ha + 1;
  const size_t plane = static_cast<size_t>(n) * r * span;
  for (int pair = warp; pair < rows * nseg; pair += kThreads / 32) {
    const int nn = pair / nseg, hh = ha + pair % nseg;
    const int s0 = max(c0, hh * b) - c0, s1 = min(c0 + cw, (hh + 1) * b) - c0;
    const float* row = lg + nn * L::kL;
    float mx = -CUDART_INF_F;
    for (int c = s0 + lane; c < s1; c += 32) mx = fmaxf(mx, row[c]);
    mx = mach::warp_max(mx);
    float se = 0.f;
    for (int c = s0 + lane; c < s1; c += 32) se += expf(row[c] - mx);
    se = mach::warp_sum(se);
    if (lane == 0) {
      const size_t hr = static_cast<size_t>(row0 + nn) * r + hh;
      const int yc = hh * b + labels[hr] - c0;
      const size_t o = hr * span + (blockIdx.y - first_tile(hh, b, BN));
      part[o] = mx;
      part[plane + o] = se;
      part[2 * plane + o] = (yc >= s0 && yc < s1) ? row[yc] : 0.f;
    }
  }
}

// one thread per (row, head): merge the head's partials in column order
__global__ void merge_kernel(const float* __restrict__ part, int n, int r,
                             int b, int bn, int span, float* __restrict__ lse,
                             float* __restrict__ nll) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * r) return;
  const int hh = i % r, nt = last_tile(hh, b, bn) - first_tile(hh, b, bn) + 1;
  const size_t plane = static_cast<size_t>(n) * r * span;
  const float* pm = part + static_cast<size_t>(i) * span;
  float m = -CUDART_INF_F;
  for (int t = 0; t < nt; ++t) m = fmaxf(m, pm[t]);
  float s = 0.f, p = 0.f;
  for (int t = 0; t < nt; ++t) {
    s += pm[plane + t] * expf(pm[t] - m);
    p += pm[2 * plane + t];
  }
  const float l = m + logf(s);
  lse[i] = l;
  nll[i] = l - p;
}

// Add one m16n8 fragment v (rows row + lane/4 and + 8, columns col +
// 2(lane%4) + {0, 1}) into a row-major float32 matrix of `stride`
// elements a row, clipped to row_end x col_end.  Neighbouring lanes swap
// halves first, so each lane holds 4 consecutive columns of one row and
// adds them as one red.global.add.v4.f32 (vec4: stride a multiple of 4).
__device__ __forceinline__ void red_fragment(float* __restrict__ dst,
                                             size_t stride, const float (&v)[4],
                                             int row, int row_end, int col,
                                             int col_end, bool vec4, int lane) {
  const int qr = lane >> 2, odd = lane & 1;
  const float s0 = odd ? v[0] : v[2], s1 = odd ? v[1] : v[3];
  const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  const float4 x = odd ? make_float4(r0, r1, v[2], v[3])
                       : make_float4(v[0], v[1], r0, r1);
  const int rr = row + qr + 8 * odd, cc = col + 2 * ((lane & 3) & ~1);
  if (rr >= row_end) return;
  float* p = dst + static_cast<size_t>(rr) * stride + cc;
  if (vec4 && cc + 3 < col_end) {
    atomicAdd(reinterpret_cast<float4*>(p), x);
    return;
  }
  if (cc < col_end) atomicAdd(p, x.x);
  if (cc + 1 < col_end) atomicAdd(p + 1, x.y);
  if (cc + 2 < col_end) atomicAdd(p + 2, x.z);
  if (cc + 3 < col_end) atomicAdd(p + 3, x.w);
}

// grid (ceil(N/128), ceil(R*B/kN)); dynamic shared memory bwd_smem<T>().
// dh (N, d) or null, dw (d, R*B), db (R*B,) or null: float32, zero-filled.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
bwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
           const T* __restrict__ bias, const int* __restrict__ labels,
           const float* __restrict__ lse, const float* __restrict__ g, int n,
           int d, int r, int b, float* __restrict__ dh,
           float* __restrict__ dw, float* __restrict__ db) {
  using L = Lay<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BM = kBwdRows, BN = L::kN, WM = L::kBwdWarpRows;
  T* D = reinterpret_cast<T*>(smem);           // BM x kD dlogits
  T* work = D + BM * L::kD;                    // the ring, then the slices
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qr = lane >> 2, qc = lane & 3;
  const int row0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int cols = r * b;

  {  // dlogits of the tile, and dbias
    constexpr int WN = 8 / WM, MT = BM / WM / 16, NT = BN / WN / 8;
    const int wr0 = (warp / WN) * (BM / WM), wc0 = (warp % WN) * (BN / WN);
    float acc[MT][NT][4];
    logits_product<T, kVec, BM, MT, NT>(acc, work, h, w, row0, n, d, cols, c0,
                                        wr0, wc0, lane);
    float colsum[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      colsum[j][0] = colsum[j][1] = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = c0 + wc0 + 8 * j + 2 * qc + q;
        const float bb = (bias != nullptr && c < cols) ? to_f32(bias[c]) : 0.f;
        const int hh = c / b;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int nn = row0 + wr0 + 16 * i + qr + 8 * hf;
            float v = 0.f;
            if (nn < n && c < cols) {
              const size_t o = static_cast<size_t>(nn) * r + hh;
              const float onehot = (c == hh * b + labels[o]) ? 1.f : 0.f;
              v = g[nn] * (expf(acc[i][j][2 * hf + q] + bb - lse[o]) - onehot);
            }
            acc[i][j][2 * hf + q] = v;
            colsum[j][q] += v;
          }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          T* p = D + (wr0 + 16 * i + qr + 8 * hf) * L::kD + wc0 + 8 * j + 2 * qc;
          const float v0 = acc[i][j][2 * hf], v1 = acc[i][j][2 * hf + 1];
          if constexpr (std::is_same<T, float>::value) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            *reinterpret_cast<uint32_t*>(p) = ms::pack_bf16(v0, v1);
          }
        }
    }
    if (db != nullptr) {  // column sums over the warp's rows, float32
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float s = colsum[j][q];
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 16);
          const int c = c0 + wc0 + 8 * j + 2 * qc + q;
          if (qr == 0 && c < cols) atomicAdd(db + c, s);
        }
    }
  }
  __syncthreads();

  // d in slices: dW[k0.., c0..] += h[rows, k0..]^T D; dh[rows, k0..] += D W[k0.., c0..]^T
  constexpr int kHs = BM * L::kH, kBuf = kHs + kSlice * L::kW;
  const bool want_dh = dh != nullptr;
  const bool vec_w = (cols % 4) == 0, vec_h = (d % 4) == 0;
  const int ns = (d + kSlice - 1) / kSlice;
  auto load = [&](int s) {
    T* buf = work + (s & 1) * kBuf;
    load_tile<T, kVec, BM, kSlice, L::kH>(buf, h, d, row0, n, s * kSlice, d);
    if (want_dh)
      load_tile<T, kVec, kSlice, BN, L::kW>(buf + kHs, w, cols, s * kSlice, d,
                                            c0, cols);
  };
  load(0);
  ms::cp_async_commit();
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      load(s + 1);
      ms::cp_async_commit();
      ms::cp_async_wait<1>();
    } else {
      ms::cp_async_wait<0>();
    }
    __syncthreads();
    const T* hs = work + (s & 1) * kBuf;
    const int k0 = s * kSlice;
    {  // dW: 64 x BN over the BM rows; warps 2 (k) x 4 (columns)
      constexpr int NT = BN / 32;
      const int m0 = (warp >> 2) * 32, n0 = (warp & 3) * (BN / 4);
      float acc[2][NT][4] = {};
      warp_mma<true, true, 2, NT, BM, L::kH, L::kD>(acc, hs, D, m0, n0, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          red_fragment(dw, cols, acc[i][j], k0 + m0 + 16 * i, d,
                       c0 + n0 + 8 * j, cols, vec_w, lane);
    }
    if (want_dh) {  // dh: BM x 64 over the BN columns; warps 4 (rows) x 2 (k)
      const int m0 = (warp >> 1) * 32, n0 = (warp & 1) * 32;
      float acc[2][4][4] = {};
      warp_mma<false, false, 2, 4, BN, L::kD, L::kW>(acc, D, hs + kHs, m0, n0,
                                                     lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          red_fragment(dh, d, acc[i][j], row0 + m0 + 16 * i, n,
                       k0 + n0 + 8 * j, d, vec_h, lane);
    }
    __syncthreads();
  }
}

__global__ void to_bf16_kernel(const float* __restrict__ src,
                               bf16* __restrict__ dst, size_t count) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < count; i += static_cast<size_t>(gridDim.x) * blockDim.x)
    dst[i] = __float2bfloat16_rn(src[i]);
}

template <typename T>
constexpr size_t ring_bytes(int rows) {
  return sizeof(T) * kStages * (rows * Lay<T>::kA + Lay<T>::kK * Lay<T>::kB);
}

template <typename T>
constexpr size_t fwd_smem() {
  const size_t tile = sizeof(float) * Lay<T>::kFwdRows * Lay<T>::kL;
  const size_t ring = ring_bytes<T>(Lay<T>::kFwdRows);
  return ring > tile ? ring : tile;
}

template <typename T>
constexpr size_t bwd_smem() {
  const size_t slices =
      sizeof(T) * 2 * (kBwdRows * Lay<T>::kH + kSlice * Lay<T>::kW);
  const size_t work = ring_bytes<T>(kBwdRows) > slices
                          ? ring_bytes<T>(kBwdRows) : slices;
  return sizeof(T) * kBwdRows * Lay<T>::kD + work;
}

// 16-byte cp.async needs every row of h and W, and both bases, 16-byte aligned
template <typename T>
bool vec_ok(const void* h, const void* w, int d, int cols) {
  constexpr int V = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0 && d % V == 0 &&
         cols % V == 0;
}

template <typename T>
cudaError_t launch_fwd(const void* h, const void* w, const void* bias,
                       const int* labels, int n, int d, int r, int b,
                       int span, float* part, cudaStream_t s) {
  auto kern = vec_ok<T>(h, w, d, r * b) ? fwd_kernel<T, true>
                                        : fwd_kernel<T, false>;
  const size_t smem = fwd_smem<T>();
  cudaError_t err = mach::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  constexpr int BM = Lay<T>::kFwdRows, BN = Lay<T>::kN;
  const dim3 grid((n + BM - 1) / BM, (r * b + BN - 1) / BN);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const T*>(bias), labels, n, d, r, b, span, part);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* h, const void* w, const void* bias,
                       const int* labels, const float* lse, const float* g,
                       int n, int d, int r, int b, float* dh, float* dw,
                       float* db, cudaStream_t s) {
  auto kern = vec_ok<T>(h, w, d, r * b) ? bwd_kernel<T, true>
                                        : bwd_kernel<T, false>;
  const size_t smem = bwd_smem<T>();
  cudaError_t err = mach::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  constexpr int BN = Lay<T>::kN;
  const dim3 grid((n + kBwdRows - 1) / kBwdRows, (r * b + BN - 1) / BN);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const T*>(bias), labels, lse, g, n, d, r, b, dh, dw, db);
  return cudaGetLastError();
}

cudaError_t cast_bf16(const float* src, void* dst, size_t count,
                      cudaStream_t s) {
  if (dst == nullptr || count == 0) return cudaSuccess;
  const size_t blocks = (count + kThreads - 1) / kThreads;
  to_bf16_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                   kThreads, 0, s>>>(src, static_cast<bf16*>(dst), count);
  return cudaGetLastError();
}

}  // namespace dense

extern "C" {

// h (n, d), w (d, r*b), bias (r*b,) or null: float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); labels (n, r) int32; part (3, n, r, span) float32
// scratch with span >= (b + kN - 2) / kN + 1 (kN = 128 float32, 256 bf16);
// outputs lse (n, r), nll (n, r) scratch, loss (n,), float32.  Returns a
// cudaError_t code.
int fused_xent_dense_fwd_launch(const void* h, const void* w, const void* bias,
                                const void* labels, int n, int d, int r, int b,
                                int is_bf16, int span, void* part, void* lse,
                                void* nll, void* loss, void* stream) {
  const int bn = is_bf16 ? dense::Lay<dense::bf16>::kN : dense::Lay<float>::kN;
  if (n < 1 || d < 1 || r < 1 || b < 1 || span < (b + bn - 2) / bn + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int* y = static_cast<const int*>(labels);
  float* p = static_cast<float*>(part);
  cudaError_t err =
      is_bf16 ? dense::launch_fwd<dense::bf16>(h, w, bias, y, n, d, r, b, span, p, s)
           : dense::launch_fwd<float>(h, w, bias, y, n, d, r, b, span, p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  dense::merge_kernel<<<(n * r + mach::kThreads - 1) / mach::kThreads,
                        mach::kThreads, 0, s>>>(p, n, r, b, bn, span,
                                                static_cast<float*>(lse),
                                                static_cast<float*>(nll));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(mach::launch_sum_heads(
      static_cast<const float*>(nll), n, r, static_cast<float*>(loss), s));
}

// lse (n, r) from the forward; g (n,) f32 cotangent; dh_acc (n, d) or
// null, dw_acc (d, r*b), db_acc (r*b,) or null: float32 accumulators,
// zero-filled by the caller.  is_bf16 = 1: dh_out / dw_out / db_out
// (bfloat16, null where the accumulator is) receive the cast sums.
int fused_xent_dense_bwd_launch(const void* h, const void* w, const void* bias,
                                const void* labels, const void* lse,
                                const void* g, int n, int d, int r, int b,
                                int is_bf16, void* dh_acc, void* dw_acc,
                                void* db_acc, void* dh_out, void* dw_out,
                                void* db_out, void* stream) {
  if (n < 1 || d < 1 || r < 1 || b < 1 ||
      (bias == nullptr) != (db_acc == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int* y = static_cast<const int*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  float* dh = static_cast<float*>(dh_acc);
  float* dw = static_cast<float*>(dw_acc);
  float* db = static_cast<float*>(db_acc);
  cudaError_t err =
      is_bf16 ? dense::launch_bwd<dense::bf16>(h, w, bias, y, l, gg, n, d, r, b,
                                            dh, dw, db, s)
           : dense::launch_bwd<float>(h, w, bias, y, l, gg, n, d, r, b, dh, dw,
                                      db, s);
  if (err != cudaSuccess || !is_bf16) return static_cast<int>(err);
  const size_t cols = static_cast<size_t>(r) * b;
  if (dh != nullptr) {
    err = dense::cast_bf16(dh, dh_out, static_cast<size_t>(n) * d, s);
  }
  if (err == cudaSuccess) {
    err = dense::cast_bf16(dw, dw_out, static_cast<size_t>(d) * cols, s);
  }
  if (err == cudaSuccess && db != nullptr) {
    err = dense::cast_bf16(db, db_out, cols, s);
  }
  return static_cast<int>(err);
}

// dynamic shared memory (bytes) of the forward (bwd = 0) or backward block
int fused_xent_dense_smem(int is_bf16, int bwd) {
  if (bwd) {
    return static_cast<int>(is_bf16 ? dense::bwd_smem<dense::bf16>()
                                    : dense::bwd_smem<float>());
  }
  return static_cast<int>(is_bf16 ? dense::fwd_smem<dense::bf16>()
                                  : dense::fwd_smem<float>());
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
