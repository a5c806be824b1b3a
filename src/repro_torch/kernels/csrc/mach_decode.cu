// Fused MACH top-1 decode (Algorithm 2's argmax) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/mach_decode.py::mach_decode_pallas, which
// recast the gather G[n,k] = sum_r P[n,r,h_r(k)] as a matmul against a
// multi-hot matrix built in VMEM because random gathers are slow on the
// TPU.  Here the gather is direct, from the probabilities staged in shared
// memory, and it returns the first maximum (sum descending, then lowest
// class id) and the raw sum, not Eq. 2.
//
// What bounds it on this card: the N*K*R shared-memory gathers (672 M at
// ODP, N = 256, R = 25, K = 105,033), not HBM — the probabilities are
// 0.8 MB and the (R, K) table 10.5 MB (L2-resident).  Shared memory serves
// 128 bytes a clock an SM, so 32 gathered floats a clock an SM at best.
// Two mappings, chosen by the wrapper from (N, R*B):
// - query per lane (top1_lane_kernel, N >= 32 and 32 queries' R*B values
//   fit): a block stages Q = 32 or 64 queries transposed, as (R*B, Q) plus
//   a pad column, so that P[q, r, h] sits at (r*B + h)*(Q + Q/32) + q.  A
//   warp walks a strip of classes; a class's R bucket ids are the same in
//   every lane (computed inline, or one broadcast table load), and lane l
//   gathers queries l*Q/32.. with one 4- or 8-byte load per (class, r):
//   consecutive words, no bank conflict, a hash shared by Q queries.  The
//   R repetitions go in chunks of 4 with no branch inside a chunk, so a
//   chunk's gathers are in flight together.  The tile is staged by 4-byte
//   cp.async, every copy in flight at once, a warp's stores spread over
//   the 32 banks, and K is split for one wave (a block fills an SM's
//   shared memory), so each SM stages once.
// - class per thread (top1_partial_kernel, small N or large R*B: the LM
//   head's N = 1 and 4 at R*B = 16,384, ImageNet-21k's 10,240): a block
//   holds up to kMaxQueries queries' R*B values and each thread walks
//   classes, gathering R values per query; random bucket ids make these
//   gathers conflict in the banks, and the R ids are reused by few queries.
//
// The TPU grid walked K in order with a running argmax in scratch; blocks
// here run in no order, so K is split across blocks (blockIdx.x) and
// top1_merge_kernel merges the per-split winners.  Every comparison is on
// the key (sum descending, class id ascending), so the first maximum wins
// whatever the schedule; each sum runs over r in order 0..R-1, the plain
// version's order, so values agree bit for bit.
#include "mach_common.cuh"

namespace mach {

constexpr int kMaxQueries = 8;   // queries per block (registers)

// Class per thread: up to kMaxQueries queries' R*B values a block, rows
// one after another; a thread gathers R values per query for its class.
template <bool kInline>
__global__ void __launch_bounds__(kThreads)
top1_partial_kernel(const float* __restrict__ meta, int n, int r_count, int b,
                    int num_classes, const int* __restrict__ table,
                    const long long* __restrict__ coeffs, int shift,
                    int queries_per_block, int split_len,
                    float* __restrict__ part_val, int* __restrict__ part_idx) {
  extern __shared__ float probs[];  // (queries_per_block, R*B)
  __shared__ float warp_val[kMaxQueries][kThreads / 32];
  __shared__ int warp_idx[kMaxQueries][kThreads / 32];

  const int rb = r_count * b;
  const int split = blockIdx.x, num_splits = gridDim.x;
  const int q0 = blockIdx.y * queries_per_block;
  const int nq = min(queries_per_block, n - q0);
  for (int t = threadIdx.x; t < nq * rb; t += blockDim.x) {
    probs[t] = meta[static_cast<size_t>(q0) * rb + t];
  }
  uint32_t a[kMaxR];
  load_coeffs<kInline>(a, r_count, coeffs);
  __syncthreads();

  float best_val[kMaxQueries];
  int best_idx[kMaxQueries];
#pragma unroll
  for (int q = 0; q < kMaxQueries; ++q) {
    best_val[q] = -CUDART_INF_F;
    best_idx[q] = kWorstIdx;
  }

  const int k_begin = split * split_len;
  const int k_end = min(num_classes, k_begin + split_len);
  for (int k = k_begin + threadIdx.x; k < k_end; k += blockDim.x) {
    int h[kMaxR];
    bucket_ids<kInline>(h, k, r_count, num_classes, table, a, shift);
#pragma unroll
    for (int q = 0; q < kMaxQueries; ++q) {
      if (q < nq) {
        const float s = gather_sum(probs + q * rb, h, r_count, b);
        if (better(s, k, best_val[q], best_idx[q])) {
          best_val[q] = s;
          best_idx[q] = k;
        }
      }
    }
  }

  // block reduction per query: warp shuffles, then one warp over warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int num_warps = blockDim.x >> 5;
#pragma unroll
  for (int q = 0; q < kMaxQueries; ++q) {
    float v = best_val[q];
    int i = best_idx[q];
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { warp_val[q][warp] = v; warp_idx[q][warp] = i; }
  }
  __syncthreads();
  if (warp == 0) {
    for (int q = 0; q < nq; ++q) {
      float v = lane < num_warps ? warp_val[q][lane] : -CUDART_INF_F;
      int i = lane < num_warps ? warp_idx[q][lane] : kWorstIdx;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, v, off);
        const int oi = __shfl_down_sync(0xffffffffu, i, off);
        if (better(ov, oi, v, i)) { v = ov; i = oi; }
      }
      if (lane == 0) {
        const size_t o = static_cast<size_t>(q0 + q) * num_splits + split;
        part_val[o] = v;
        part_idx[o] = i;
      }
    }
  }
}

constexpr int kLaneThreads = 512;   // query per lane: 16 warps a block
constexpr int kLaneWarps = kLaneThreads / 32;
enum Mapping : int { kClassPerThread = 0, kQueryPerLane = 1 };

// Shared memory of the query-per-lane block: the transposed tile and its
// zero row, reused for the warps' winners once the walk is done.
inline size_t lane_smem(int rb, int vec) {
  const size_t q = 32 * vec;
  const size_t tile = static_cast<size_t>(rb + 1) * (q + vec) * sizeof(float);
  const size_t winners = kLaneWarps * q * (sizeof(float) + sizeof(int));
  return tile > winners ? tile : winners;
}

// Query per lane: Q = 32 * kVec queries a block, lane l owning queries
// l*kVec .. l*kVec + kVec - 1.  Row R*B of the tile is zeros: repetitions
// past R gather it, and adding +0.0 leaves a sum unchanged (a sum that
// starts at +0.0 is never -0.0), so no add needs a mask.
template <bool kInline, int kVec>
__global__ void __launch_bounds__(kLaneThreads, 1)
top1_lane_kernel(const float* __restrict__ meta, int n, int r_count, int b,
                 int num_classes, const int* __restrict__ table,
                 const long long* __restrict__ coeffs, int shift,
                 int split_len, float* __restrict__ part_val,
                 int* __restrict__ part_idx) {
  constexpr int kQ = 32 * kVec, kStride = kQ + kVec, kChunk = 4;
  extern __shared__ __align__(16) float probs[];   // (R*B + 1, kStride)
  const int rb = r_count * b;
  const int split = blockIdx.x, num_splits = gridDim.x;
  const int q0 = blockIdx.y * kQ;
  const int nq = min(kQ, n - q0);
  const float* src = meta + static_cast<size_t>(q0) * rb;

  // stage the tile transposed by 4-byte cp.async, all in flight at once:
  // query q of column j to probs[j * kStride + q]; queries past n, and
  // the zero row, read as zeros.  A warp takes kSpan neighbouring columns
  // of kVec neighbouring queries: its reads are kVec runs of kSpan * 4
  // bytes, and its stores land at (j * kVec + q) mod 32, 32 distinct banks.
  constexpr int kSpan = 32 / kVec;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = lane / kSpan; q < kQ; q += kVec) {
    const float* row = src + static_cast<size_t>(min(q, nq - 1)) * rb;
    for (int j = warp * kSpan + lane % kSpan; j <= rb;
         j += kLaneWarps * kSpan) {
      cp_async4(probs + j * kStride + q, row + min(j, rb - 1),
                q < nq && j < rb);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  uint32_t a[kMaxR];
  load_coeffs<kInline>(a, r_count, coeffs);
  __syncthreads();

  const float* col = probs + lane * kVec;
  float best_val[kVec];
  int best_idx[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    best_val[e] = -CUDART_INF_F;
    best_idx[e] = kWorstIdx;
  }
  const int k_begin = split * split_len;
  const int k_end = min(num_classes, k_begin + split_len);
  // two classes a step (the second clamped to the first past k_end), so
  // that two independent chains of adds are in flight
  for (int k = k_begin + warp; k < k_end; k += 2 * kLaneWarps) {
    const int kk[2] = {k, k + kLaneWarps < k_end ? k + kLaneWarps : k};
    float s[2][kVec];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) s[c][e] = 0.f;
    }
    // repetitions in chunks of kChunk: the chunk's bucket ids and loads
    // (one branch a chunk, none inside, so they are in flight together),
    // then its adds in r order
#pragma unroll
    for (int j0 = 0; j0 < kMaxR; j0 += kChunk) {
      if (j0 < r_count) {
        float x[2][kChunk][kVec];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            const int j = j0 + u;
            const bool on = j < r_count;
            const uint32_t kc = static_cast<uint32_t>(kk[c]);
            const int h =
                kInline ? static_cast<int>((a[j] * kc) >> shift)
                        : __ldg(table + static_cast<size_t>(on ? j : 0) *
                                            num_classes + kc);
            const float* p = col + (on ? j * b + h : rb) * kStride;
            if constexpr (kVec == 2) {
              const float2 v = *reinterpret_cast<const float2*>(p);
              x[c][u][0] = v.x;
              x[c][u][1] = v.y;
            } else {
              x[c][u][0] = *p;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              s[c][e] = __fadd_rn(s[c][e], x[c][u][e]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        if (better(s[c][e], kk[c], best_val[e], best_idx[e])) {
          best_val[e] = s[c][e];
          best_idx[e] = kk[c];
        }
      }
    }
  }

  // the block's winner per query: each warp's candidates, then one thread
  // a query over the warps
  __syncthreads();
  float* win_val = probs;                                     // (warps, kQ)
  int* win_idx = reinterpret_cast<int*>(probs + kLaneWarps * kQ);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    win_val[warp * kQ + lane * kVec + e] = best_val[e];
    win_idx[warp * kQ + lane * kVec + e] = best_idx[e];
  }
  __syncthreads();
  if (threadIdx.x < nq) {
    float v = -CUDART_INF_F;
    int i = kWorstIdx;
    for (int w = 0; w < kLaneWarps; ++w) {
      const float wv = win_val[w * kQ + threadIdx.x];
      const int wi = win_idx[w * kQ + threadIdx.x];
      if (better(wv, wi, v, i)) { v = wv; i = wi; }
    }
    const size_t o = static_cast<size_t>(q0 + threadIdx.x) * num_splits + split;
    part_val[o] = v;
    part_idx[o] = i;
  }
}

// One thread per query: the best key over its num_splits partial winners.
__global__ void top1_merge_kernel(const float* __restrict__ part_val,
                                  const int* __restrict__ part_idx, int n,
                                  int num_splits, float* __restrict__ out_val,
                                  int* __restrict__ out_idx) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  float v = -CUDART_INF_F;
  int i = kWorstIdx;
  for (int s = 0; s < num_splits; ++s) {
    const size_t o = static_cast<size_t>(q) * num_splits + s;
    if (better(part_val[o], part_idx[o], v, i)) { v = part_val[o]; i = part_idx[o]; }
  }
  out_val[q] = v;
  out_idx[q] = i;
}

// Launch the partial kernel of `mapping` (queries_per_block 32 or 64 for
// the query-per-lane mapping), then the merge over splits.
template <bool kInline>
cudaError_t launch_top1(int mapping, const float* meta, int n, int r_count,
                        int b, int num_classes, const int* table,
                        const long long* coeffs, int shift,
                        int queries_per_block, int num_splits, float* part_val,
                        int* part_idx, float* out_val, int* out_idx,
                        cudaStream_t stream) {
  const int split_len = (num_classes + num_splits - 1) / num_splits;
  const dim3 grid(num_splits, (n + queries_per_block - 1) / queries_per_block);
  const int rb = r_count * b;
  cudaError_t err;
  if (mapping == kQueryPerLane) {
    const int vec = queries_per_block / 32;
    const size_t smem = lane_smem(rb, vec);
    auto kernel = vec == 2 ? top1_lane_kernel<kInline, 2>
                           : top1_lane_kernel<kInline, 1>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kLaneThreads, smem, stream>>>(
        meta, n, r_count, b, num_classes, table, coeffs, shift, split_len,
        part_val, part_idx);
  } else {
    const size_t smem =
        static_cast<size_t>(queries_per_block) * rb * sizeof(float);
    err = allow_smem(top1_partial_kernel<kInline>, smem);
    if (err != cudaSuccess) return err;
    top1_partial_kernel<kInline><<<grid, kThreads, smem, stream>>>(
        meta, n, r_count, b, num_classes, table, coeffs, shift,
        queries_per_block, split_len, part_val, part_idx);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  top1_merge_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part_val, part_idx, n, num_splits, out_val, out_idx);
  return cudaGetLastError();
}

}  // namespace mach

extern "C" {

// meta (n, R, B) f32; table (R, K) int32 or, when table is null, coeffs
// (R,) int64 holding uint32 multipliers with `shift`; mapping 0 = class per
// thread (queries_per_block <= kMaxQueries), 1 = query per lane
// (queries_per_block 32 or 64); part_* (n, num_splits) scratch; out_* (n,).
// Returns a cudaError_t code.
int mach_top1_launch(const void* meta, int n, int r_count, int b,
                     int num_classes, const void* table, const void* coeffs,
                     int shift, int mapping, int queries_per_block,
                     int num_splits, void* part_val, void* part_idx,
                     void* out_val, void* out_idx, void* stream) {
  using namespace mach;
  const bool layout_ok =
      mapping == kQueryPerLane
          ? (queries_per_block == 32 || queries_per_block == 64)
          : (mapping == kClassPerThread && queries_per_block >= 1 &&
             queries_per_block <= kMaxQueries);
  if (n < 1 || r_count < 1 || r_count > kMaxR || b < 1 || num_classes < 1 ||
      !layout_ok || num_splits < 1 || (table == nullptr && coeffs == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const float*>(meta);
  auto pv = static_cast<float*>(part_val);
  auto pi = static_cast<int*>(part_idx);
  auto ov = static_cast<float*>(out_val);
  auto oi = static_cast<int*>(out_idx);
  if (table != nullptr) {
    return static_cast<int>(launch_top1<false>(
        mapping, m, n, r_count, b, num_classes, static_cast<const int*>(table),
        nullptr, 0, queries_per_block, num_splits, pv, pi, ov, oi, s));
  }
  return static_cast<int>(launch_top1<true>(
      mapping, m, n, r_count, b, num_classes, nullptr,
      static_cast<const long long*>(coeffs), shift, queries_per_block,
      num_splits, pv, pi, ov, oi, s));
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
