// Fused projection + R-head cross-entropy on a padded-ELL sparse batch
// (nnz below 512: ODP, the 500k-label workload), forward and backward,
// for Hopper (sm_90a).
//
// Replaces src/repro/kernels/mach_fused_xent.py::
// mach_fused_xent_sparse_pallas.  cols/vals (N, J) — row n's feature ids
// and weights, padded slots carrying col id d and val 0 — W (d, R*B),
// optional bias (R*B,), labels (N, R) -> loss (N,), lse (N, R); backward
// dW (d, R*B) and dbias.  vals get no gradient.  Slots whose col id is
// outside [0, d) are skipped, so W[d] is never read; duplicate ids sum.
//
// The TPU kernel densified each (rows x d-block) activation slice in VMEM
// through a one-hot contraction, because its matrix unit needs dense
// tiles.  Here the products are FMAs over the valid slots alone.
//
// What bounds it on this card: bytes.  Forward, the W rows the batch
// touches, each read once (ODP, N = 512, nnz = 120, R*B = 800: about half
// of its ~61k slots are distinct features; the 500k-label workload, d =
// 1,024, R*B = 32,768, or 4,096 over the selected columns: all of W, 134
// or 16.8 MB).  Backward, the dense dW output written once (1.35 GB at
// ODP).  Measured, the staged sums run well above that: they are held
// back by the shared-memory pipe, which serves both a slot's W load and
// the shuffles that broadcast its col id and val (PERF.md §6).
//
// Design:
// - A block owns a row tile and a tile of kTileCols = 32 logits columns.
//   A quarter warp sums one row, a lane 4 of its columns: the row's slots
//   are broadcast to the quarter in slot order and, where valid, v *
//   W[col, 4 columns] (a float4) is added in registers, 8 slots' loads in
//   flight; each 32-slot chunk's sum is then added to the row's.  The next
//   chunk, or the next row's first, is fetched while one is summed.  Where
//   the W column slice W[0:d, tile] fits in shared memory (d up to ~1,800:
//   the 500k workload's 128 KB), a block of 16 warps first stages it by
//   cp.async, every W row once in feature order, and its slots then read
//   shared memory: a W element crosses from L2 once per row tile, where
//   the kernel this replaces read it once per slot (~16 times at d =
//   1,024).  Row tiles are as tall as putting one block on every SM
//   allows (all 512 rows at R*B = 32,768; 256 at 4,096).  At ODP's d no
//   slice fits and a feature rarely repeats: 4-warp blocks of 16 rows read
//   each slot's 128 bytes of W from L2 (800 blocks).  Both ways sum the
//   same products in the same order, so the two passes' logits are the
//   same bits.
// - Forward: each (row, head segment) of a tile yields a partial (max,
//   sum-exp, label logit) by warp reductions; ell_merge_kernel merges a
//   head's partials (a warp a (row, head): each lane's share in column
//   order, then a fixed shuffle tree), and sum_heads_kernel adds the R
//   heads in order.
// - Backward, three launches and torch.sort (kernels/mach_fused_xent.py
//   ell_bwd_cuda):
//   1. ell_tile_kernel recomputes each logits tile as the forward does and
//      writes dlogits = g * (softmax - onehot) (N, R*B) float32 from the
//      saved lse (67 MB at R*B = 32,768; 1.6 MB at ODP), and the blocks of
//      column tile 0 each slot's sort key (its col id, d for padding).
//   2. Kernel 6's column order (mach_fused_xent_gather.cu order_kernel
//      after a stable torch.sort of the keys): for each feature f its
//      (row, val) pairs in ascending (row, slot) order.
//   3. dW and dbias, each element written once, summed in that order: a
//      feature the batch does not touch gets a zero row from the same
//      launch, so dW needs no zero fill.  Where the pairs outnumber the features (the
//      500k workload: ~32 a feature) ell_dw_kernel gives a block a
//      (feature range, 32-column tile) and stages the (N x 32) dlogits
//      slice in shared memory (N up to ~1,750).  The ranges and, inside a
//      block, its quarter warps' chunks are cut by pairs, not features,
//      and a feature cut by a chunk's end is summed in pieces merged in
//      chunk order: the trained batch's Zipf head (3,342 of 32,768 pairs
//      on one feature) would else leave one quarter summing it alone.  A
//      lane sums 4 columns, 8 pairs at a time, the 8s and the pieces
//      added by a compensated sum (a popular feature's thousands of pairs
//      stay within float32 of the exact sum); the blocks of range 0 sum
//      dbias.  Else (ODP: 0.15 pairs a feature, 1.35 GB of dW mostly
//      zeros) kernel 6's dw_rows_kernel (mach_xent_dw.cuh) writes dW a
//      whole row a warp, so the stores run along rows, and dbias_kernel
//      sums dbias.  The switch counts the ELL's N*J slots, which the host
//      knows; the valid pairs (colptr[d]) lie on the card, and reading
//      them would stall the stream each step and break graph capture.
//      Padding moves the choice only where N*J is near d.
// Nothing sums across blocks by float atomics: the forward and the
// backward return the same bits from run to run.
#include "mach_xent_common.cuh"
#include "mach_xent_dw.cuh"

namespace mach {

constexpr int kTileCols = 32;    // logits columns a block owns
constexpr int kQuad = 4;         // columns a lane owns (a float4)
constexpr int kLanesRow = kTileCols / kQuad;   // lanes a row: a quarter warp
constexpr int kRowsWarp = 32 / kLanesRow;      // rows a warp sums at once
constexpr int kStagedWarps = 16; // warps of a block that stages W
constexpr int kDirectWarps = 4;  // warps of a block that reads W from L2
constexpr int kDirectRows = kDirectWarps * kRowsWarp;   // its rows
constexpr int kDwWarps = 16;     // warps of a block of the tiled dW

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// Rows [0, count) x columns [c0, c0 + kTileCols) of a row-major (count, ld)
// float32 matrix into dst (count x kTileCols), zeros past column c0 +
// width.  vec: 16-byte copies (ld % 4 == 0 and src 16-byte aligned).  Every
// thread of the block takes part; ends synchronised.
__device__ void stage_slice(float* dst, const float* __restrict__ src,
                            int count, int ld, int c0, int width, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < count * (kTileCols / 4); i += blockDim.x) {
      const int row = i / (kTileCols / 4), q = 4 * (i % (kTileCols / 4));
      const bool ok = q < width;
      cp_async16(dst + row * kTileCols + q,
                 src + static_cast<size_t>(row) * ld + c0 + (ok ? q : 0), ok);
    }
  } else {
    for (int i = threadIdx.x; i < count * kTileCols; i += blockDim.x) {
      const int row = i / kTileCols, q = i % kTileCols;
      const bool ok = q < width;
      cp_async4(dst + i, src + static_cast<size_t>(row) * ld + c0 + (ok ? q : 0),
                ok);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

__device__ __forceinline__ void fma4(float4& acc, float v, const float4& x) {
  acc.x = fmaf(v, x.x, acc.x);
  acc.y = fmaf(v, x.y, acc.y);
  acc.z = fmaf(v, x.z, acc.z);
  acc.w = fmaf(v, x.w, acc.w);
}

__device__ __forceinline__ float& at(float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}
__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// Reductions over the 8 lanes of a quarter warp (xor 4, 2, 1 stays in it).
__device__ __forceinline__ float quarter_max(float v) {
  for (int off = kLanesRow / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float quarter_sum(float v) {
  for (int off = kLanesRow / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// This lane's kQuad columns of W row col: src points at the lane's first
// column of row 0, ld its row stride; live of them inside the R*B
// columns (kVec: 0 or kQuad, 16-byte aligned).  Staged rows are shared
// memory, zero-filled past R*B.
template <bool kStaged, bool kVec>
__device__ __forceinline__ float4 load_w(const float* __restrict__ src,
                                         int col, size_t ld, int live) {
  const float* p = src + static_cast<size_t>(col) * ld;
  if (kStaged) return *reinterpret_cast<const float4*>(p);
  if (kVec) {
    return live == kQuad ? __ldg(reinterpret_cast<const float4*>(p))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kQuad; ++k)
    if (k < live) at(x, k) = __ldg(p + k);
  return x;
}

// Slots t0 + sub + 8k (k < 4) of one row: col ids (-1 past J) and vals.
__device__ __forceinline__ void load_chunk(const int* __restrict__ cs,
                                           const float* __restrict__ vs,
                                           int j, int t0, int sub,
                                           int (&pc)[4], float (&pv)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = t0 + sub + kLanesRow * k;
    pc[k] = t < j ? cs[t] : -1;
    pv[k] = t < j ? vs[t] : 0.f;
  }
}

// the column tiles [first, last] that head hh's buckets span
__device__ __forceinline__ int first_tile(int hh, int b) {
  return hh * b / kTileCols;
}
__device__ __forceinline__ int last_tile(int hh, int b) {
  return (hh * b + b - 1) / kTileCols;
}

// grid (row tiles, column tiles); kStaged: kStagedWarps warps and dynamic
// shared memory d * kTileCols floats; else kDirectWarps and none.  A
// quarter warp sums one row's 32 columns, a lane 4 of them, over each
// 32-slot chunk of the row (lane t holds slots t, t + 8, t + 16, t + 24):
// every slot is broadcast to the quarter in slot order and, where valid,
// v * W[col, 4 columns] is added (a float4 of W, a group of 8 slots' loads
// in flight); groups where no quarter has a valid slot are skipped, and
// each chunk's sum is added to the row's.  The next chunk, or the next
// row's first, and a row's labels (and lse, g) are fetched a step ahead.
// Forward (!kDlogits): out is the 3 planes of (N, R, span) partials (max,
// sum-exp, label logit).  Backward (kDlogits): out is dlogits (N, R*B)
// from lse and the (N,) cotangent g, and keys (N*J) the slots' sort keys.
template <bool kStaged, bool kVec, bool kDlogits>
__global__ void __launch_bounds__((kStaged ? kStagedWarps : kDirectWarps) * 32)
ell_tile_kernel(const int* __restrict__ ell_cols,
                const float* __restrict__ ell_vals,
                const float* __restrict__ w, const float* __restrict__ bias,
                const int* __restrict__ labels, const float* __restrict__ lse,
                const float* __restrict__ g, int n, int j, int d, int r, int b,
                int rows_per_block, int span, int vec, float* __restrict__ out,
                int* __restrict__ keys) {
  constexpr int kWarps = kStaged ? kStagedWarps : kDirectWarps;
  constexpr int kStride = kWarps * kRowsWarp;      // rows a block sums at once
  extern __shared__ __align__(16) float ws[];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane / kLanesRow, sub = lane % kLanesRow;
  const int cols = r * b, c0 = blockIdx.y * kTileCols;
  const int cw = min(kTileCols, cols - c0), ci = c0 + sub * kQuad;
  const int live = max(0, min(kQuad, c0 + cw - ci));
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n - row0);
  if (kStaged) stage_slice(ws, w, d, cols, c0, cw, vec != 0);
  const float* src = kStaged ? ws + sub * kQuad : w + ci;
  const size_t ld = kStaged ? kTileCols : cols;
  float4 bc = make_float4(0.f, 0.f, 0.f, 0.f);
  int hk[kQuad];                     // each column's head (-1 past R*B)
#pragma unroll
  for (int k = 0; k < kQuad; ++k) {
    hk[k] = k < live ? (ci + k) / b : -1;
    if (bias != nullptr && k < live) at(bc, k) = bias[ci + k];
  }
  const int ha = c0 / b, hb = (c0 + cw - 1) / b;
  const size_t plane = static_cast<size_t>(n) * r * span;
  const int chunks = (j + 31) / 32;
  // this warp's row iterations, each a row a quarter, and the steps of
  // its (iteration, chunk) stream
  const int iters = warp * kRowsWarp < rows
                        ? (rows - warp * kRowsWarp + kStride - 1) / kStride
                        : 0;
  const int steps = iters * chunks;

  int pc[4];
  float pv[4];
  auto row_of = [&](int it) {        // -1 where the quarter has no row
    const int nn = it * kStride + warp * kRowsWarp + q;
    return nn < rows ? row0 + nn : -1;
  };
  auto fetch = [&](int step) {
    const int rw = row_of(step / chunks);
    const size_t o = static_cast<size_t>(rw < 0 ? row0 : rw) * j;
    load_chunk(ell_cols + o, ell_vals + o, rw < 0 ? 0 : j,
               32 * (step % chunks), sub, pc, pv);
  };
  if (steps > 0) fetch(0);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int lab[kQuad];
  float lsek[kQuad], gr = 0.f;
  for (int step = 0; step < steps; ++step) {
    const int ch = step % chunks, row = row_of(step / chunks);
    const bool on = row >= 0;
    int cc[4];                       // col ids, -1 where not valid
    float cv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cc[k] = on && pc[k] >= 0 && pc[k] < d ? pc[k] : -1;
      cv[k] = pv[k];
    }
    if (step + 1 < steps) fetch(step + 1);
    if (ch == 0) {                   // the row's labels (lse, g) ahead
      acc = make_float4(0.f, 0.f, 0.f, 0.f);
      const size_t hr0 = static_cast<size_t>(on ? row : row0) * r;
#pragma unroll
      for (int k = 0; k < kQuad; ++k) {
        const size_t o = hr0 + (hk[k] < 0 ? 0 : hk[k]);
        lab[k] = labels[o];
        if (kDlogits) lsek[k] = lse[o];
      }
      if (kDlogits) gr = g[on ? row : row0];
    }
    if (kDlogits && blockIdx.y == 0 && on) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 32 * ch + sub + kLanesRow * k;
        if (t < j) {
          keys[static_cast<size_t>(row) * j + t] = cc[k] >= 0 ? cc[k] : d;
        }
      }
    }
    float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {    // slots 8k + u, in order
      if (!__any_sync(full, cc[k] >= 0)) continue;
      float4 x[kLanesRow];
      float v[kLanesRow];
      bool ok[kLanesRow];
#pragma unroll
      for (int u = 0; u < kLanesRow; ++u) {
        const int col = __shfl_sync(full, cc[k], u, kLanesRow);
        v[u] = __shfl_sync(full, cv[k], u, kLanesRow);
        ok[u] = col >= 0;
        if (ok[u]) x[u] = load_w<kStaged, kVec>(src, col, ld, live);
      }
#pragma unroll
      for (int u = 0; u < kLanesRow; ++u)
        if (ok[u]) fma4(part, v[u], x[u]);
    }
    acc.x += part.x;
    acc.y += part.y;
    acc.z += part.z;
    acc.w += part.w;
    if (ch + 1 < chunks) continue;

    // the row's 32 logits are summed: its partials or its dlogits
    const float4 x = make_float4(acc.x + bc.x, acc.y + bc.y, acc.z + bc.z,
                                 acc.w + bc.w);
    bool is_label[kQuad];
#pragma unroll
    for (int k = 0; k < kQuad; ++k)
      is_label[k] = hk[k] >= 0 && ci + k == hk[k] * b + lab[k];
    if (kDlogits) {
      if (on && live > 0) {
        float4 dl = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < kQuad; ++k) {
          if (k < live)
            at(dl, k) = gr * (expf(at(x, k) - lsek[k]) - (is_label[k] ? 1.f : 0.f));
        }
        float* dst = out + static_cast<size_t>(row) * cols + ci;
        if (kVec) {
          *reinterpret_cast<float4*>(dst) = dl;
        } else {
#pragma unroll
          for (int k = 0; k < kQuad; ++k)
            if (k < live) dst[k] = at(dl, k);
        }
      }
    } else {
      const size_t hr0 = static_cast<size_t>(on ? row : row0) * r;
      for (int hh = ha; hh <= hb; ++hh) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int k = 0; k < kQuad; ++k)
          if (hk[k] == hh) mx = fmaxf(mx, at(x, k));
        mx = quarter_max(mx);
        float se = 0.f, pk = 0.f;
#pragma unroll
        for (int k = 0; k < kQuad; ++k) {
          if (hk[k] == hh) {
            se += expf(at(x, k) - mx);
            if (is_label[k]) pk += at(x, k);
          }
        }
        se = quarter_sum(se);
        pk = quarter_sum(pk);
        if (on && sub == 0) {
          const size_t o = (hr0 + hh) * span + (blockIdx.y - first_tile(hh, b));
          out[o] = mx;
          out[plane + o] = se;
          out[2 * plane + o] = pk;
        }
      }
    }
  }
}

// (m, s) <- (m, s) merged with (m2, s2): the larger max, each sum-exp
// rescaled to it; two empty sides (max -inf) stay empty.
__device__ __forceinline__ void merge_stats(float& m, float& s, float m2,
                                            float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -CUDART_INF_F) return;
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// A warp per (row, head): lane t merges the head's partials t, t + 32, ...
// in column order, then a shuffle tree of fixed shape merges the lanes
// (both sides of each step compute the same sums).
__global__ void __launch_bounds__(kThreads)
ell_merge_kernel(const float* __restrict__ part, int n, int r, int b, int span,
                 float* __restrict__ lse, float* __restrict__ nll) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  if (i >= static_cast<size_t>(n) * r) return;     // the whole warp
  const int hh = static_cast<int>(i % r);
  const int nt = last_tile(hh, b) - first_tile(hh, b) + 1;
  const size_t plane = static_cast<size_t>(n) * r * span;
  const float* pm = part + i * span;
  float m = -CUDART_INF_F, s = 0.f, p = 0.f;
  for (int t = lane; t < nt; t += 32) {
    merge_stats(m, s, pm[t], pm[plane + t]);
    p += pm[2 * plane + t];
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(full, m, off);
    const float s2 = __shfl_xor_sync(full, s, off);
    p += __shfl_xor_sync(full, p, off);
    merge_stats(m, s, m2, s2);
  }
  if (lane == 0) {
    const float l = m + logf(s);
    lse[i] = l;
    nll[i] = l - p;
  }
}

// total += v by Kahan's compensated sum (c carries the lost low bits).
__device__ __forceinline__ void kahan_add(float& total, float& c, float v) {
  const float y = v - c;
  const float t = total + y;
  c = (t - total) - y;
  total = t;
}
__device__ __forceinline__ void kahan_add4(float4& total, float4& c,
                                           const float4& v) {
  kahan_add(total.x, c.x, v.x);
  kahan_add(total.y, c.y, v.y);
  kahan_add(total.z, c.z, v.z);
  kahan_add(total.w, c.w, v.w);
}

// The first feature f in [0, d) with colptr[f] >= p (d if none).
__device__ __forceinline__ int feature_from(const int* __restrict__ colptr,
                                            int d, int p) {
  int lo = 0, hi = d;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (colptr[mid] >= p) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// grid (feature ranges, column tiles), kDwWarps warps; dynamic shared
// memory n * kTileCols floats (the block's dlogits slice).  Range x holds
// the features whose first pair falls in its x-th equal share of the
// batch's colptr[d] pairs, so the ranges sum alike however the pairs
// crowd on a few features.  A range's pairs are cut into kQuarters equal
// contiguous chunks, one a quarter warp (a lane 4 of the 32 columns),
// which sums each feature's pairs inside its chunk: a feature
// wholly inside is written at once; the piece of one that began in an
// earlier chunk goes to shared memory, and after a barrier the quarter
// where that feature began adds the pieces in chunk order and writes it.
// A Zipf head of thousands of pairs is so spread over many quarters and
// sets no tail.  Features without pairs get zero rows.  dw (d, cols)
// written once; dbias (cols,) or null, from the range-0 blocks.
__global__ void __launch_bounds__(kDwWarps * 32)
ell_dw_kernel(const int* __restrict__ colptr, const int* __restrict__ term_row,
              const float* __restrict__ term_val,
              const float* __restrict__ dlogits, int n, int d, int cols,
              int vec, float* __restrict__ dw, float* __restrict__ dbias) {
  constexpr int kQuarters = kDwWarps * kRowsWarp;
  extern __shared__ __align__(16) float sl[];
  __shared__ float4 part[kQuarters][kLanesRow];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane / kLanesRow, sub = lane % kLanesRow;
  const int qi = warp * kRowsWarp + q;
  const int c0 = blockIdx.y * kTileCols, cw = min(kTileCols, cols - c0);
  const int ci = c0 + sub * kQuad, live = max(0, min(kQuad, c0 + cw - ci));
  stage_slice(sl, dlogits, n, cols, c0, cw, vec != 0);
  const float* src = sl + sub * kQuad;

  // this range's features [fa, fb), their pairs [p0, p1), the quarter's
  // chunk [cs, ce) and the feature f holding pair cs
  const long long pairs = colptr[d], ranges = gridDim.x;
  const int fa = blockIdx.x == 0 ? 0 : feature_from(colptr, d, static_cast<int>(
                                           pairs * blockIdx.x / ranges));
  const int fb = blockIdx.x + 1 == gridDim.x
                     ? d
                     : feature_from(colptr, d, static_cast<int>(
                           pairs * (blockIdx.x + 1) / ranges));
  const int p0 = colptr[fa], p1 = colptr[fb];
  const int per = (p1 - p0 + kQuarters - 1) / kQuarters;
  const int cs = min(p1, p0 + qi * per), ce = min(p1, cs + per);
  int f = fa;
  if (cs < ce) {
    int hi = fb - 1;
    while (f < hi) {
      const int mid = (f + hi + 1) >> 1;
      if (colptr[mid] <= cs) f = mid; else hi = mid - 1;
    }
  }
  auto store = [&](int row, const float4& t) {    // dW[row, this lane's 4]
    float* dst = dw + static_cast<size_t>(row) * cols + ci;
    if (vec && live == kQuad) {
      *reinterpret_cast<float4*>(dst) = t;
    } else {
#pragma unroll
      for (int k = 0; k < kQuad; ++k)
        if (k < live) dst[k] = at(t, k);
    }
  };

  if (dbias != nullptr && blockIdx.x == 0) {   // quarters sum runs of rows
    const int run = (n + kQuarters - 1) / kQuarters;
    const int n0 = min(n, qi * run), n1 = min(n, n0 + run);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = n0; i < n1; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(src + i * kTileCols);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    part[qi][sub] = acc;
    __syncthreads();
    if (warp == 0 && q == 0) {
      float4 s = part[0][sub];
      for (int k = 1; k < kQuarters; ++k) {
        s.x += part[k][sub].x;
        s.y += part[k][sub].y;
        s.z += part[k][sub].z;
        s.w += part[k][sub].w;
      }
#pragma unroll
      for (int k = 0; k < kQuad; ++k)
        if (k < live) dbias[ci + k] = at(s, k);
    }
    __syncthreads();                           // part is reused below
  }

  for (int z = fa + static_cast<int>(threadIdx.x); z < fb; z += blockDim.x) {
    if (colptr[z] == colptr[z + 1]) {          // no pairs: a zero row
      float* dst = dw + static_cast<size_t>(z) * cols + c0;
      for (int k = 0; k < cw; ++k) dst[k] = 0.f;
    }
  }
  // the quarter's walk over its chunk [cs, ce): segment [s, e) of feature
  // f (its pairs [fs, fe); fen the next feature's end), 8 pairs at a time,
  // one a lane, broadcast to the quarter in order; each 8's sum is added
  // by a compensated sum.  The next 8 pairs in column order, wherever the
  // segment ends, and the next feature's end are fetched a step ahead.
  // The warp's quarters step together (one 8 each a step, while any has
  // pairs left), so their broadcasts are whole-warp shuffles.
  const unsigned full = 0xffffffffu;
  int s = cs, e = cs, fs = 0, fe = 0, fen = 0;
  if (cs < ce) {
    fs = colptr[f];
    fe = colptr[f + 1];
    fen = f + 2 <= d ? colptr[f + 2] : fe;
    e = min(fe, ce);
  }
  int prow = s + sub < ce ? term_row[s + sub] : 0;
  float pval = s + sub < ce ? term_val[s + sub] : 0.f;
  int fp = -1;                      // the feature that goes on past ce
  float4 pend = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 total = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 comp = make_float4(0.f, 0.f, 0.f, 0.f);
  while (__any_sync(full, s < ce)) {
    const bool on = s < ce;
    const int crow = prow;
    const float cval = pval;
    const int next = s + kLanesRow < e ? s + kLanesRow : e;
    if (on && next + sub < ce) {
      prow = term_row[next + sub];
      pval = term_val[next + sub];
    }
    float4 x[kLanesRow];
    float v[kLanesRow];
#pragma unroll
    for (int u = 0; u < kLanesRow; ++u) {
      const int rr = __shfl_sync(full, crow, u, kLanesRow);
      v[u] = __shfl_sync(full, cval, u, kLanesRow);
      x[u] = *reinterpret_cast<const float4*>(src + rr * kTileCols);
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < kLanesRow; ++u)
      if (on && s + u < e) fma4(acc, v[u], x[u]);
    kahan_add4(total, comp, acc);
    if (!on) continue;
    s = next;
    if (s < e) continue;
    if (fs < cs) {                  // the segment is summed
      part[qi][sub] = total;        // began in an earlier chunk
    } else if (fe > ce) {
      fp = f;
      pend = total;
    } else {
      store(f, total);
    }
    total = make_float4(0.f, 0.f, 0.f, 0.f);
    comp = total;
    if (s < ce) {                   // the next feature with pairs
      do {
        ++f;
        fs = fe;
        fe = fen;
        fen = f + 2 <= d ? colptr[f + 2] : fe;
      } while (fe == fs);
      e = min(fe, ce);
    }
  }
  __syncthreads();
  if (fp >= 0) {                    // add the pieces of later chunks
    const int end = colptr[fp + 1];
    comp = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = qi + 1; k < kQuarters && p0 + k * per < end; ++k)
      kahan_add4(pend, comp, part[k][sub]);
    store(fp, pend);
  }
}

inline cudaError_t device_limits(int* sms, int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  return err;
}

inline bool vec_ok(const void* p, int cols) {
  return cols % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kStaged, bool kVec, bool kDlogits>
cudaError_t launch_tile(dim3 grid, size_t smem, const int* cols,
                        const float* vals, const float* w, const float* bias,
                        const int* labels, const float* lse, const float* g,
                        int n, int j, int d, int r, int b, int rows, int span,
                        int vec, float* out, int* keys, cudaStream_t s) {
  auto kernel = ell_tile_kernel<kStaged, kVec, kDlogits>;
  if (kStaged) {
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, (kStaged ? kStagedWarps : kDirectWarps) * 32, smem, s>>>(
      cols, vals, w, bias, labels, lse, g, n, j, d, r, b, rows, span, vec, out,
      keys);
  return cudaGetLastError();
}

// The forward's and the dlogits pass's tiles (both take the same, so their
// logits are the same bits): staged where W's column slice fits beside the
// block's static memory, with the fewest row tiles that put a block on
// every SM; else kDirectRows-row tiles.  vec: W and the dlogits rows
// 16-byte aligned (R*B % 4 == 0).
template <bool kDlogits>
cudaError_t launch_tiles(const int* cols, const float* vals, const float* w,
                         const float* bias, const int* labels,
                         const float* lse, const float* g, int n, int j, int d,
                         int r, int b, int span, float* out, int* keys,
                         cudaStream_t s) {
  int sms = 0, optin = 0;
  cudaError_t err = device_limits(&sms, &optin);
  if (err != cudaSuccess) return err;
  const int c = r * b;
  const long long col_tiles = (c + kTileCols - 1) / kTileCols;
  if (col_tiles > 65535) return cudaErrorInvalidValue;
  const size_t slice = static_cast<size_t>(d) * kTileCols * sizeof(float);
  const bool staged = slice + 1024 <= static_cast<size_t>(optin);
  long long row_tiles = (n + kDirectRows - 1) / kDirectRows;
  if (staged) {
    const long long most =
        (n + kStagedWarps * kRowsWarp - 1) / (kStagedWarps * kRowsWarp);
    row_tiles = (sms + col_tiles - 1) / col_tiles;
    row_tiles = row_tiles > most ? most : row_tiles;
  }
  const int rows = static_cast<int>((n + row_tiles - 1) / row_tiles);
  const dim3 grid((n + rows - 1) / rows, static_cast<unsigned>(col_tiles));
  const bool vec = vec_ok(w, c) && (!kDlogits || vec_ok(out, c));
  const size_t smem = staged ? slice : 0;
#define MACH_ELL_TILE(S, V)                                                   \
  launch_tile<S, V, kDlogits>(grid, smem, cols, vals, w, bias, labels, lse,   \
                              g, n, j, d, r, b, rows, span, vec ? 1 : 0, out, \
                              keys, s)
  if (staged) return vec ? MACH_ELL_TILE(true, true) : MACH_ELL_TILE(true, false);
  return vec ? MACH_ELL_TILE(false, true) : MACH_ELL_TILE(false, false);
#undef MACH_ELL_TILE
}

}  // namespace mach

extern "C" {

// cols (n, j) int32, vals (n, j) f32 — padded ELL; w (d, r*b) f32; bias
// (r*b,) f32 or null; labels (n, r) int32; part (3, n, r, span) f32
// scratch with span >= (b + 30) / 32 + 1; outputs lse (n, r), nll (n, r)
// scratch, loss (n,).
int fused_xent_ell_fwd_launch(const void* cols, const void* vals, const void* w,
                              const void* bias, const void* labels, int n,
                              int j, int d, int r, int b, int span, void* part,
                              void* lse, void* nll, void* loss, void* stream) {
  if (n < 1 || j < 1 || d < 1 || r < 1 || b < 1 ||
      span < (b + mach::kTileCols - 2) / mach::kTileCols + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<float*>(part);
  cudaError_t err = mach::launch_tiles<false>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(labels), nullptr, nullptr, n, j, d, r, b, span,
      p, nullptr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long warps = static_cast<long long>(n) * r;
  const int per = mach::kThreads / 32;
  mach::ell_merge_kernel<<<static_cast<unsigned>((warps + per - 1) / per),
                           mach::kThreads, 0, s>>>(
      p, n, r, b, span, static_cast<float*>(lse), static_cast<float*>(nll));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(mach::launch_sum_heads(
      static_cast<const float*>(nll), n, r, static_cast<float*>(loss), s));
}

// Backward launch 1.  lse (n, r) from the forward; g (n,) f32 -> dlogits
// (n, r*b) f32 scratch, keys (n, j) int32 scratch (col id, d for padding).
int fused_xent_ell_dlogits_launch(const void* cols, const void* vals,
                                  const void* w, const void* bias,
                                  const void* labels, const void* lse,
                                  const void* g, int n, int j, int d, int r,
                                  int b, void* dlogits, void* keys,
                                  void* stream) {
  if (n < 1 || j < 1 || d < 1 || r < 1 || b < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(mach::launch_tiles<true>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(g), n, j, d, r, b, 0,
      static_cast<float*>(dlogits), static_cast<int*>(keys),
      static_cast<cudaStream_t>(stream)));
}

// Backward launch 3 (launch 2 is the gather library's order launch).
// colptr (d + 1,), term_row / term_val (m = n*j entries, the first
// colptr[d] valid), the dlogits (n, cols) -> dw (d, cols), every element
// written once, and dbias (cols,) or null; heavy (at least 2 + min(d,
// m / 65)) int32 scratch.  Where the batch's pairs outnumber the features
// (each dW row then sums many dlogits rows) and the (n x 32) dlogits
// slice fits in shared memory, ell_dw_kernel; else a warp a dW row
// (mach_xent_dw.cuh, kernel 6's), whose stores run along whole rows.
int fused_xent_ell_dw_launch(const void* colptr, const void* term_row,
                             const void* term_val, const void* dlogits, int n,
                             int m, int d, int cols, void* dw, void* dbias,
                             void* heavy, void* stream) {
  if (n < 1 || m < 1 || d < 1 || cols < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0, optin = 0;
  cudaError_t err = mach::device_limits(&sms, &optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  auto cp = static_cast<const int*>(colptr);
  auto tr = static_cast<const int*>(term_row);
  auto tv = static_cast<const float*>(term_val);
  auto dl = static_cast<const float*>(dlogits);
  auto out = static_cast<float*>(dw);
  auto db = static_cast<float*>(dbias);
  const long long col_tiles = (cols + mach::kTileCols - 1) / mach::kTileCols;
  const size_t slice = static_cast<size_t>(n) * mach::kTileCols * sizeof(float);
  const size_t fixed =
      sizeof(float4) * mach::kDwWarps * mach::kRowsWarp * mach::kLanesRow;
  const bool tiles = m >= d && col_tiles <= 65535 &&
                     slice + fixed + 1024 <= static_cast<size_t>(optin);
  if (!tiles) {
    auto hv = static_cast<int*>(heavy);
    const bool v4 = mach::vec_ok(dl, cols) && mach::vec_ok(out, cols);
    err = v4 ? mach::launch_dw<4>(cp, tr, tv, dl, d, cols, out, hv + 1, hv, s)
             : mach::launch_dw<1>(cp, tr, tv, dl, d, cols, out, hv + 1, hv, s);
    if (err != cudaSuccess || db == nullptr) return static_cast<int>(err);
    mach::dbias_kernel<<<(cols + mach::kBiasCols - 1) / mach::kBiasCols,
                         mach::kThreads, 0, s>>>(dl, n, cols, db);
    return static_cast<int>(cudaGetLastError());
  }
  // feature ranges enough to put two blocks on every SM, at most one a
  // pass of a block's quarter warps over the features
  constexpr int kPass = mach::kDwWarps * mach::kRowsWarp;
  const long long passes = (d + kPass - 1) / kPass;
  long long ranges = (2LL * sms + col_tiles - 1) / col_tiles;
  ranges = ranges > passes ? passes : ranges;
  const dim3 grid(static_cast<unsigned>(ranges),
                  static_cast<unsigned>(col_tiles));
  err = mach::allow_smem(mach::ell_dw_kernel, slice);
  if (err != cudaSuccess) return static_cast<int>(err);
  mach::ell_dw_kernel<<<grid, mach::kDwWarps * 32, slice, s>>>(
      cp, tr, tv, dl, n, d, cols,
      mach::vec_ok(dl, cols) && mach::vec_ok(out, cols) ? 1 : 0, out, db);
  return static_cast<int>(cudaGetLastError());
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
