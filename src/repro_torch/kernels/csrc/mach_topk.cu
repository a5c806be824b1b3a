// Fused streaming MACH top-k decode for Hopper (sm_90a), under the
// unbiased (Eq. 2), min (Eq. 7) or median (Eq. 8) estimator.
//
// Replaces src/repro/kernels/mach_topk.py::mach_topk_pallas, which built
// each K block's scores with multi-hot matmuls on the MXU (a TPU
// workaround for slow gathers) and merged them into a running top-k held
// in scratch across a sequential grid.  Here a block copies the R*B
// probabilities of up to kMaxQueriesTopk queries into shared memory; each
// thread walks classes k, computes the R bucket ids once and gathers R
// values per query from shared memory.
//
// What bounds it on this card: the N*K*R shared-memory gathers (672 M at
// ODP with N = 256), issued at most 32 a cycle per SM, plus the per-class
// reduction: an add (unbiased), a min, or for the median a count against
// the running threshold and, for the classes that pass it, a bitonic
// sorting network over 32 registers.  HBM traffic is the probabilities,
// the (R, K) table (L2-resident at ODP's 10.5 MB; none in inline mode)
// and the outputs.
// The (N, K) score matrix never exists: a class enters a per-query
// candidate pool in shared memory only if it beats the query's current
// k-th best key, so after the first few hundred classes almost none do.
//
// Blocks run in no order, so K is split across blocks (blockIdx.x): each
// keeps its own top-k per query, and a second kernel merges the splits'
// lists.  Every comparison is on the key (value descending, class id
// ascending), so tie order is lowest id first whatever the schedule.
// Unbiased selection runs on the sum; the caller applies Eq. 2's
// monotone affine map after selection, as the TPU kernel did.
//
// Per-query pool layout: slots [0, kcap) hold the running top-k sorted
// best first, slots [kcap, pool) collect candidates.  When a pool could
// overflow in the next chunk of kThreads classes, it is bitonic-sorted
// and the threshold becomes its kcap-th key.
#include "mach_common.cuh"

namespace mach {

constexpr int kMaxQueriesTopk = 4;   // queries per block
constexpr int kMaxK = 128;           // largest k (and kcap) the kernel takes

enum Estimator : int { kUnbiased = 0, kMin = 1, kMedian = 2 };

// Score of one class for one query.  Returns false when the class
// cannot beat threshold value `thr` (median's cheap pre-test), so the
// caller may skip it; `out` is then unset.
template <int kEst>
__device__ __forceinline__ bool class_score(const float* __restrict__ p,
                                            const int (&h)[kMaxR], int r_count,
                                            int b, float thr, float& out) {
  if (kEst == kUnbiased) {
    out = gather_sum(p, h, r_count, b);
    return true;
  }
  if (kEst == kMin) {
    float m = CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kMaxR; ++j) {
      if (j < r_count) m = fminf(m, p[j * b + h[j]]);
    }
    out = m;
    return true;
  }
  // median: the midpoint of order statistics lo = (R-1)/2 and hi = R/2
  float g[kMaxR];
  int at_least_thr = 0;
#pragma unroll
  for (int j = 0; j < kMaxR; ++j) {
    g[j] = j < r_count ? p[j * b + h[j]] : CUDART_INF_F;  // pad sorts last
    if (j < r_count) at_least_thr += g[j] >= thr;
  }
  // median >= thr needs the hi-th order statistic >= thr, i.e. at least
  // R - hi values >= thr; otherwise the class ranks below the threshold
  if (at_least_thr < r_count - r_count / 2) return false;
  out = sorted_median(g, r_count);
  return true;
}

// Sort query q's pool, keep its best kcap keys, clear the candidate
// slots and move the threshold.  Called by the whole block.
__device__ __forceinline__ void merge_pool(float* v, int* idx, int pool,
                                           int kcap, int* count, float* thr_val,
                                           int* thr_idx) {
  bitonic_sort_best_first(v, idx, pool);
  for (int t = kcap + threadIdx.x; t < pool; t += blockDim.x) {
    v[t] = -CUDART_INF_F;
    idx[t] = kWorstIdx;
  }
  if (threadIdx.x == 0) {
    *count = 0;
    *thr_val = v[kcap - 1];
    *thr_idx = idx[kcap - 1];
  }
  __syncthreads();
}

template <int kEst, bool kInline>
__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const float* __restrict__ meta, int n, int r_count, int b,
                    int num_classes, const int* __restrict__ table,
                    const long long* __restrict__ coeffs, int shift,
                    int queries_per_block, int kcap, int pool, int split_len,
                    float* __restrict__ part_val, int* __restrict__ part_idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int count[kMaxQueriesTopk];
  __shared__ float thr_val[kMaxQueriesTopk];
  __shared__ int thr_idx[kMaxQueriesTopk];

  const int rb = r_count * b;
  float* probs = reinterpret_cast<float*>(smem);               // (qpb, R*B)
  float* pool_val = probs + queries_per_block * rb;            // (qpb, pool)
  int* pool_idx = reinterpret_cast<int*>(pool_val + queries_per_block * pool);

  const int split = blockIdx.x, num_splits = gridDim.x;
  const int q0 = blockIdx.y * queries_per_block;
  const int nq = min(queries_per_block, n - q0);
  for (int t = threadIdx.x; t < nq * rb; t += blockDim.x) {
    probs[t] = meta[static_cast<size_t>(q0) * rb + t];
  }
  for (int t = threadIdx.x; t < queries_per_block * pool; t += blockDim.x) {
    pool_val[t] = -CUDART_INF_F;
    pool_idx[t] = kWorstIdx;
  }
  if (threadIdx.x < kMaxQueriesTopk) {
    count[threadIdx.x] = 0;
    thr_val[threadIdx.x] = -CUDART_INF_F;
    thr_idx[threadIdx.x] = kWorstIdx;
  }
  uint32_t a[kMaxR];
  load_coeffs<kInline>(a, r_count, coeffs);
  __syncthreads();

  const int k_begin = split * split_len;
  const int k_end = min(num_classes, k_begin + split_len);
  const int merge_at = pool - kcap - static_cast<int>(blockDim.x);
  for (int base = k_begin; base < k_end; base += blockDim.x) {
    const int k = base + threadIdx.x;
    if (k < k_end) {
      int h[kMaxR];
      bucket_ids<kInline>(h, k, r_count, num_classes, table, a, shift);
#pragma unroll
      for (int q = 0; q < kMaxQueriesTopk; ++q) {
        if (q < nq) {
          float s;
          if (class_score<kEst>(probs + q * rb, h, r_count, b, thr_val[q], s) &&
              better(s, k, thr_val[q], thr_idx[q])) {
            const int slot = kcap + atomicAdd(&count[q], 1);
            pool_val[q * pool + slot] = s;
            pool_idx[q * pool + slot] = k;
          }
        }
      }
    }
    __syncthreads();
    // every thread reads the counts before any merge resets one
    unsigned full = 0;
    for (int q = 0; q < nq; ++q) full |= (count[q] > merge_at ? 1u : 0u) << q;
    __syncthreads();
    for (int q = 0; q < nq; ++q) {
      if ((full >> q) & 1u) {
        merge_pool(pool_val + q * pool, pool_idx + q * pool, pool, kcap,
                   &count[q], &thr_val[q], &thr_idx[q]);
      }
    }
  }
  for (int q = 0; q < nq; ++q) {
    merge_pool(pool_val + q * pool, pool_idx + q * pool, pool, kcap, &count[q],
               &thr_val[q], &thr_idx[q]);
  }
  for (int t = threadIdx.x; t < nq * kcap; t += blockDim.x) {
    const int q = t / kcap, j = t - q * kcap;
    const size_t o =
        (static_cast<size_t>(q0 + q) * num_splits + split) * kcap + j;
    part_val[o] = pool_val[q * pool + j];
    part_idx[o] = pool_idx[q * pool + j];
  }
}

// One block per query: sort the num_splits * kcap partial keys (padded
// to `width`, a power of two) and write the best k.
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ part_val,
                  const int* __restrict__ part_idx, int num_parts, int width,
                  int k, float* __restrict__ out_val, int* __restrict__ out_idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* v = reinterpret_cast<float*>(smem);
  int* idx = reinterpret_cast<int*>(v + width);
  const size_t row = blockIdx.x;
  for (int t = threadIdx.x; t < width; t += blockDim.x) {
    const bool real = t < num_parts;
    v[t] = real ? part_val[row * num_parts + t] : -CUDART_INF_F;
    idx[t] = real ? part_idx[row * num_parts + t] : kWorstIdx;
  }
  __syncthreads();
  bitonic_sort_best_first(v, idx, width);
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    out_val[row * k + t] = v[t];
    out_idx[row * k + t] = idx[t];
  }
}

template <int kEst, bool kInline>
cudaError_t launch_topk(const float* meta, int n, int r_count, int b,
                        int num_classes, const int* table,
                        const long long* coeffs, int shift,
                        int queries_per_block, int k, int kcap, int pool,
                        int num_splits, int merge_width, float* part_val,
                        int* part_idx, float* out_val, int* out_idx,
                        cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(queries_per_block) *
                      (static_cast<size_t>(r_count) * b * sizeof(float) +
                       static_cast<size_t>(pool) * (sizeof(float) + sizeof(int)));
  cudaError_t err = allow_smem(topk_partial_kernel<kEst, kInline>, smem);
  if (err != cudaSuccess) return err;
  const int split_len = (num_classes + num_splits - 1) / num_splits;
  const dim3 grid(num_splits, (n + queries_per_block - 1) / queries_per_block);
  topk_partial_kernel<kEst, kInline><<<grid, kThreads, smem, stream>>>(
      meta, n, r_count, b, num_classes, table, coeffs, shift,
      queries_per_block, kcap, pool, split_len, part_val, part_idx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t merge_smem =
      static_cast<size_t>(merge_width) * (sizeof(float) + sizeof(int));
  err = allow_smem(topk_merge_kernel, merge_smem);
  if (err != cudaSuccess) return err;
  topk_merge_kernel<<<n, kThreads, merge_smem, stream>>>(
      part_val, part_idx, num_splits * kcap, merge_width, k, out_val, out_idx);
  return cudaGetLastError();
}

template <int kEst>
cudaError_t launch_topk_mode(const float* meta, int n, int r_count, int b,
                             int num_classes, const int* table,
                             const long long* coeffs, int shift,
                             int queries_per_block, int k, int kcap, int pool,
                             int num_splits, int merge_width, float* part_val,
                             int* part_idx, float* out_val, int* out_idx,
                             cudaStream_t stream) {
  if (table != nullptr) {
    return launch_topk<kEst, false>(meta, n, r_count, b, num_classes, table,
                                    nullptr, 0, queries_per_block, k, kcap,
                                    pool, num_splits, merge_width, part_val,
                                    part_idx, out_val, out_idx, stream);
  }
  return launch_topk<kEst, true>(meta, n, r_count, b, num_classes, nullptr,
                                 coeffs, shift, queries_per_block, k, kcap,
                                 pool, num_splits, merge_width, part_val,
                                 part_idx, out_val, out_idx, stream);
}

bool is_pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace mach

extern "C" {

// meta (n, R, B) f32; table (R, K) int32 or, when table is null, coeffs
// (R,) int64 holding uint32 multipliers with `shift`; estimator 0/1/2 =
// unbiased (raw sum) / min / median; part_* (n, num_splits, kcap)
// scratch; out_* (n, k).  kcap, pool and merge_width are powers of two
// with k <= kcap <= kMaxK, pool - kcap >= 256 and merge_width >=
// num_splits * kcap.  Returns a cudaError_t code.
int mach_topk_launch(const void* meta, int n, int r_count, int b,
                     int num_classes, const void* table, const void* coeffs,
                     int shift, int estimator, int queries_per_block, int k,
                     int kcap, int pool, int num_splits, int merge_width,
                     void* part_val, void* part_idx, void* out_val,
                     void* out_idx, void* stream) {
  using namespace mach;
  if (n < 1 || r_count < 1 || r_count > kMaxR || b < 1 || num_classes < 1 ||
      queries_per_block < 1 || queries_per_block > kMaxQueriesTopk || k < 1 ||
      k > kcap || kcap > kMaxK || !is_pow2(kcap) || !is_pow2(pool) ||
      pool - kcap < kThreads || num_splits < 1 || !is_pow2(merge_width) ||
      merge_width < num_splits * kcap ||
      (table == nullptr && coeffs == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const float*>(meta);
  auto t = static_cast<const int*>(table);
  auto c = static_cast<const long long*>(coeffs);
  auto pv = static_cast<float*>(part_val);
  auto pi = static_cast<int*>(part_idx);
  auto ov = static_cast<float*>(out_val);
  auto oi = static_cast<int*>(out_idx);
  cudaError_t err;
  switch (estimator) {
    case kUnbiased:
      err = launch_topk_mode<kUnbiased>(m, n, r_count, b, num_classes, t, c,
                                        shift, queries_per_block, k, kcap, pool,
                                        num_splits, merge_width, pv, pi, ov, oi,
                                        s);
      break;
    case kMin:
      err = launch_topk_mode<kMin>(m, n, r_count, b, num_classes, t, c, shift,
                                   queries_per_block, k, kcap, pool, num_splits,
                                   merge_width, pv, pi, ov, oi, s);
      break;
    case kMedian:
      err = launch_topk_mode<kMedian>(m, n, r_count, b, num_classes, t, c,
                                      shift, queries_per_block, k, kcap, pool,
                                      num_splits, merge_width, pv, pi, ov, oi,
                                      s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
