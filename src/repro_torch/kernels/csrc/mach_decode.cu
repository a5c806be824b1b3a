// Fused MACH top-1 decode (Algorithm 2's argmax) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/mach_decode.py::mach_decode_pallas, which
// recast the gather G[n,k] = sum_r P[n,r,h_r(k)] as a matmul against a
// multi-hot matrix built in VMEM because random gathers are slow on the
// TPU.  Here the gather is direct: a block copies the R*B probabilities
// of up to kMaxQueries queries into shared memory (3.2 KB a query at ODP,
// R=25, B=32), and each thread walks classes k, computes the R bucket ids
// once and gathers R values per query from shared memory.
//
// What bounds it on this card: the R shared-memory gathers per (query,
// class) — N*K*R loads, 672 M at ODP with N = 256 — issued at most 32 a
// cycle per SM, with bank conflicts from random bucket ids.  HBM traffic
// is only the probabilities, the (R, K) table (10.5 MB at ODP, held in
// the 50 MB L2 after the first query tile reads it) and N outputs.  The
// design keeps the gathers in shared memory, reuses each class's bucket
// ids across the block's queries, and needs no table at all in inline
// mode.
//
// The TPU grid walked K in order with a running argmax in scratch; blocks
// here run in no order, so K is split across blocks (blockIdx.x) and a
// second kernel merges the per-split winners.  Both compare on the key
// (sum descending, class id ascending): the first maximum wins, as in
// the TPU kernel.  Returns the raw sum, not Eq. 2.
#include "mach_common.cuh"

namespace mach {

constexpr int kMaxQueries = 8;   // queries per block (registers)

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

template <bool kInline>
cudaError_t launch_top1(const float* meta, int n, int r_count, int b,
                        int num_classes, const int* table,
                        const long long* coeffs, int shift,
                        int queries_per_block, int num_splits, float* part_val,
                        int* part_idx, float* out_val, int* out_idx,
                        cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(queries_per_block) * r_count * b * sizeof(float);
  cudaError_t err = allow_smem(top1_partial_kernel<kInline>, smem);
  if (err != cudaSuccess) return err;
  const int split_len = (num_classes + num_splits - 1) / num_splits;
  const dim3 grid(num_splits, (n + queries_per_block - 1) / queries_per_block);
  top1_partial_kernel<kInline><<<grid, kThreads, smem, stream>>>(
      meta, n, r_count, b, num_classes, table, coeffs, shift,
      queries_per_block, split_len, part_val, part_idx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  top1_merge_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part_val, part_idx, n, num_splits, out_val, out_idx);
  return cudaGetLastError();
}

}  // namespace mach

extern "C" {

// meta (n, R, B) f32; table (R, K) int32 or, when table is null, coeffs
// (R,) int64 holding uint32 multipliers with `shift`; part_* (n,
// num_splits) scratch; out_* (n,).  Returns a cudaError_t code.
int mach_top1_launch(const void* meta, int n, int r_count, int b,
                     int num_classes, const void* table, const void* coeffs,
                     int shift, int queries_per_block, int num_splits,
                     void* part_val, void* part_idx, void* out_val,
                     void* out_idx, void* stream) {
  if (n < 1 || r_count < 1 || r_count > mach::kMaxR || b < 1 ||
      num_classes < 1 || queries_per_block < 1 ||
      queries_per_block > mach::kMaxQueries || num_splits < 1 ||
      (table == nullptr && coeffs == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const float*>(meta);
  auto pv = static_cast<float*>(part_val);
  auto pi = static_cast<int*>(part_idx);
  auto ov = static_cast<float*>(out_val);
  auto oi = static_cast<int*>(out_idx);
  if (table != nullptr) {
    return static_cast<int>(mach::launch_top1<false>(
        m, n, r_count, b, num_classes, static_cast<const int*>(table), nullptr,
        0, queries_per_block, num_splits, pv, pi, ov, oi, s));
  }
  return static_cast<int>(mach::launch_top1<true>(
      m, n, r_count, b, num_classes, nullptr,
      static_cast<const long long*>(coeffs), shift, queries_per_block,
      num_splits, pv, pi, ov, oi, s));
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
