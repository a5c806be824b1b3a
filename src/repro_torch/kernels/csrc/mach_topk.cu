// Fused streaming MACH top-k decode for Hopper (sm_90a), under the
// unbiased (Eq. 2), min (Eq. 7) or median (Eq. 8) estimator.
//
// Replaces src/repro/kernels/mach_topk.py::mach_topk_pallas, which built
// each K block's scores with multi-hot matmuls on the MXU (a TPU
// workaround for slow gathers) and merged them into a running top-k held
// in scratch across a sequential grid.  Here the gathers are direct, from
// the probabilities staged in shared memory.
//
// What bounds it on this card: the N*K*R shared-memory gathers (672 M at
// ODP with N = 256), at most 32 gathered floats a clock an SM, plus the
// per-class reduction: an add (unbiased), a min, or for the median a count
// against the running threshold and, for the classes that pass it, a
// sorting network over 32 registers.  HBM traffic is the probabilities,
// the (R, K) table (L2-resident at ODP's 10.5 MB; none in inline mode)
// and the outputs.  The (N, K) score matrix never exists.  Two mappings,
// chosen by the wrapper (mach_topk.topk_layout):
// - query per lane (topk_lane_kernel; N >= 32, k <= 32 and the transposed
//   tile fits, but for the median with the table hash: ODP): kernel 1's mapping (mach_decode.cu), 32 or 64 queries
//   a block staged transposed, a warp walking classes two at a time with
//   the R bucket ids computed once a warp and the 32 lanes gathering one
//   bucket of their queries from consecutive words (no bank conflict).
//   Each lane keeps its queries' best 1, 16 or 32 keys in registers, a
//   packed (value, class id) key tested against the list's tail with one
//   compare: no shared pool, atomic or barrier in the walk.  At the end
//   the warps' lists meet in shared memory and a warp a query sorts them.
// - class per thread (topk_partial_kernel; the LM head's N = 1 and 4,
//   ImageNet-21k's R*B = 10,240, k > 32, the median with the table hash,
//   where the lane kernel's sorting network runs on nearly every step and
//   was the slower one): a block holds up to
//   kMaxQueriesTopk queries' R*B values and each thread walks classes,
//   computing its R bucket ids once for them.  A class enters a per-query
//   candidate pool in shared memory only if it beats the query's current
//   k-th best; slots [0, kcap) hold the running top-k sorted best first,
//   slots [kcap, pool) collect candidates, and when a pool could overflow
//   in the next chunk of kThreads classes it is bitonic-sorted and the
//   threshold becomes its kcap-th key.
//
// Blocks run in no order, so K is split across blocks (blockIdx.x): each
// keeps its own top-k per query, and a second kernel merges the splits'
// lists.  Every comparison is on the key (value descending, class id
// ascending), so tie order is lowest id first whatever the schedule.
// Unbiased selection runs on the sum over r in order from +0.0; the caller
// applies Eq. 2's monotone affine map after selection, as the TPU kernel
// did.
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

constexpr int kTopkLaneThreads = 512;   // query per lane: 16 warps a block
constexpr int kTopkLaneWarps = kTopkLaneThreads / 32;
enum Mapping : int { kClassPerThread = 0, kQueryPerLane = 1 };

// Partial (value, class id) of a list key; the empty slot 0 ranks last.
__device__ __forceinline__ void write_part(Key key, size_t o,
                                           float* __restrict__ part_val,
                                           int* __restrict__ part_idx) {
  part_val[o] = key == 0ull ? -CUDART_INF_F : key_value(key);
  part_idx[o] = key == 0ull ? kWorstIdx : key_id(key);
}

// Query per lane: Q = 32 * kVec queries a block, lane l owning queries
// l*kVec .. l*kVec + kVec - 1, each with a list of its kLen best keys
// (value, class id) in registers.  The tile is staged as kernel 1's
// (mach_decode.cu: top1_lane_kernel), (R*B, Q) transposed plus a pad column,
// so the 32 lanes gather one bucket of 32 queries from consecutive words;
// row R*B is the pad that repetitions past R gather: +0.0 for the sum
// (which starts at +0.0, so adding it changes nothing), +inf for the min
// and the median (which sorts it last).  A class is tested against its
// list's tail, one compare, and inserted only when it beats it: no shared
// pool, no atomic and no barrier in the walk.  The median gathers a
// class's R values, counts those at or above the tail's value (the median
// can beat the tail only if at least R - R/2 are), and the warp runs the
// sorting network when any lane's class passes; `network_runs`, when not
// null, counts those runs.
template <int kEst, bool kInline, int kVec, int kLen>
__global__ void __launch_bounds__(kTopkLaneThreads, 1)
topk_lane_kernel(const float* __restrict__ meta, int n, int r_count, int b,
                 int num_classes, const int* __restrict__ table,
                 const long long* __restrict__ coeffs, int shift, int kcap,
                 int split_len, float* __restrict__ part_val,
                 int* __restrict__ part_idx,
                 unsigned long long* __restrict__ network_runs) {
  constexpr int kQ = 32 * kVec, kStride = kQ + kVec, kChunk = 4;
  extern __shared__ __align__(16) float probs[];   // (R*B + 1, kStride)
  const int rb = r_count * b;
  const int split = blockIdx.x, num_splits = gridDim.x;
  const int q0 = blockIdx.y * kQ;
  const int nq = min(kQ, n - q0);
  const float* src = meta + static_cast<size_t>(q0) * rb;

  // stage the tile transposed, as kernel 1 does: query q of column j to
  // probs[j * kStride + q] by 4-byte cp.async, all in flight at once
  constexpr int kSpan = 32 / kVec;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = lane / kSpan; q < kQ; q += kVec) {
    const float* row = src + static_cast<size_t>(min(q, nq - 1)) * rb;
    for (int j = warp * kSpan + lane % kSpan; j <= rb;
         j += kTopkLaneWarps * kSpan) {
      cp_async4(probs + j * kStride + q, row + min(j, rb - 1),
                q < nq && j < rb);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  uint32_t a[kMaxR];
  load_coeffs<kInline>(a, r_count, coeffs);
  __syncthreads();
  if (kEst != kUnbiased) {
    for (int q = threadIdx.x; q < kStride; q += blockDim.x) {
      probs[rb * kStride + q] = CUDART_INF_F;
    }
    __syncthreads();
  }

  const float* col = probs + lane * kVec;
  Key list[kVec][kLen];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
#pragma unroll
    for (int i = 0; i < kLen; ++i) list[e][i] = 0ull;
  }
  const int k_begin = split * split_len;
  const int k_end = min(num_classes, k_begin + split_len);
  unsigned long long runs = 0;
  if constexpr (kEst == kMedian) {
    // one class a step; its R values per query, then the pre-test
    for (int k = k_begin + warp; k < k_end; k += kTopkLaneWarps) {
      const uint32_t kc = static_cast<uint32_t>(k);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const Key tail = list[e][kLen - 1];
        const float thr = tail == 0ull ? -CUDART_INF_F : key_value(tail);
        float g[kMaxR];
        int at_least = 0;
#pragma unroll
        for (int j = 0; j < kMaxR; ++j) {
          g[j] = CUDART_INF_F;
          if (j < r_count) {
            const int h =
                kInline ? static_cast<int>((a[j] * kc) >> shift)
                        : __ldg(table + static_cast<size_t>(j) * num_classes +
                                kc);
            g[j] = col[(j * b + h) * kStride + e];
            at_least += g[j] >= thr;
          }
        }
        const bool pass = at_least >= r_count - r_count / 2;
        if (__any_sync(0xffffffffu, pass)) {
          ++runs;
          const float s = sorted_median(g, r_count);
          if (pass) keep_best(list[e], value_key(s, k));
        }
      }
    }
    if (network_runs != nullptr && lane == 0) atomicAdd(network_runs, runs);
  } else {
    // two classes a step (the second only while it is below k_end), so
    // that two independent chains are in flight; repetitions in chunks of
    // kChunk, a chunk's bucket ids and loads first, then its sums or mins
    for (int k = k_begin + warp; k < k_end; k += 2 * kTopkLaneWarps) {
      const bool two = k + kTopkLaneWarps < k_end;
      const int kk[2] = {k, two ? k + kTopkLaneWarps : k};
      float s[2][kVec];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          s[c][e] = kEst == kUnbiased ? 0.f : CUDART_INF_F;
        }
      }
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
                s[c][e] = kEst == kUnbiased ? __fadd_rn(s[c][e], x[c][u][e])
                                            : fminf(s[c][e], x[c][u][e]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (c == 0 || two) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            keep_best(list[e], value_key(s[c][e], kk[c]));
          }
        }
      }
    }
  }

  // the block's top kcap per query: the warps' lists meet in shared memory
  // (the tile is done with), and a warp a query sorts its 16 * kLen keys
  __syncthreads();
  constexpr int kAll = kTopkLaneWarps * kLen;
  constexpr int kV = kAll >= 32 ? kAll / 32 : 1;
  Key* keys = reinterpret_cast<Key*>(probs);       // (kQ, warps, kLen)
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
#pragma unroll
    for (int i = 0; i < kLen; ++i) {
      keys[((lane * kVec + e) * kTopkLaneWarps + warp) * kLen + i] =
          list[e][i];
    }
  }
  __syncthreads();
  for (int q = warp; q < nq; q += kTopkLaneWarps) {
    Key key[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int p = lane * kV + j;
      key[j] = p < kAll ? keys[q * kAll + p] : 0ull;
    }
    warp_sort_desc<kV>(key, lane);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int p = lane * kV + j;
      if (p < kcap) {
        write_part(key[j],
                   (static_cast<size_t>(q0 + q) * num_splits + split) * kcap +
                       p,
                   part_val, part_idx);
      }
    }
  }
}

// Shared memory of the query-per-lane block: the transposed tile with its
// pad row, or the warps' lists once the walk is done, whichever is larger.
inline size_t lane_smem(int rb, int vec, int len) {
  const size_t q = 32 * vec;
  const size_t tile = static_cast<size_t>(rb + 1) * (q + vec) * sizeof(float);
  const size_t lists = q * kTopkLaneWarps * len * sizeof(Key);
  return tile > lists ? tile : lists;
}

template <int kEst, bool kInline, int kVec, int kLen>
cudaError_t launch_lane(const float* meta, int n, int r_count, int b,
                        int num_classes, const int* table,
                        const long long* coeffs, int shift, int kcap,
                        int num_splits, float* part_val, int* part_idx,
                        unsigned long long* network_runs,
                        cudaStream_t stream) {
  auto kernel = topk_lane_kernel<kEst, kInline, kVec, kLen>;
  const size_t smem = lane_smem(r_count * b, kVec, kLen);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int split_len = (num_classes + num_splits - 1) / num_splits;
  const dim3 grid(num_splits, (n + 32 * kVec - 1) / (32 * kVec));
  kernel<<<grid, kTopkLaneThreads, smem, stream>>>(
      meta, n, r_count, b, num_classes, table, coeffs, shift, kcap, split_len,
      part_val, part_idx, network_runs);
  return cudaGetLastError();
}

// The query-per-lane instantiations: (queries a block, list length) in
// (32 | 64, 1), (32 | 64, 16), (32, 32).
template <int kEst, bool kInline>
cudaError_t launch_lane_len(int queries_per_block, int list_len,
                            const float* meta, int n, int r_count, int b,
                            int num_classes, const int* table,
                            const long long* coeffs, int shift, int kcap,
                            int num_splits, float* part_val, int* part_idx,
                            unsigned long long* network_runs,
                            cudaStream_t s) {
#define MACH_LANE(V, L)                                                      \
  launch_lane<kEst, kInline, V, L>(meta, n, r_count, b, num_classes, table,  \
                                   coeffs, shift, kcap, num_splits, part_val, \
                                   part_idx, network_runs, s)
  const bool two = queries_per_block == 64;
  if (list_len == 1) return two ? MACH_LANE(2, 1) : MACH_LANE(1, 1);
  if (list_len == 16) return two ? MACH_LANE(2, 16) : MACH_LANE(1, 16);
  if (list_len == 32 && !two) return MACH_LANE(1, 32);
#undef MACH_LANE
  return cudaErrorInvalidValue;
}

// Operands of one launch, as mach_topk_launch takes them.
struct TopkArgs {
  const float* meta;
  int n, r_count, b, num_classes;
  const int* table;
  const long long* coeffs;
  int shift, mapping, queries_per_block, list_len, k, kcap, pool, num_splits,
      merge_width;
  float* part_val;
  int* part_idx;
  float* out_val;
  int* out_idx;
  unsigned long long* network_runs;
};

template <int kEst, bool kInline>
cudaError_t launch_partial(const TopkArgs& t, cudaStream_t stream) {
  const int* table = kInline ? nullptr : t.table;
  const long long* coeffs = kInline ? t.coeffs : nullptr;
  const int shift = kInline ? t.shift : 0;
  if (t.mapping == kQueryPerLane) {
    // the median with the table hash runs class per thread (the wrapper's
    // topk_layout), so its lane kernels are not built
    if constexpr (kEst == kMedian && !kInline) {
      return cudaErrorInvalidValue;
    } else {
      return launch_lane_len<kEst, kInline>(
          t.queries_per_block, t.list_len, t.meta, t.n, t.r_count, t.b,
          t.num_classes, table, coeffs, shift, t.kcap, t.num_splits,
          t.part_val, t.part_idx, t.network_runs, stream);
    }
  }
  const int qpb = t.queries_per_block;
  const size_t smem = static_cast<size_t>(qpb) *
                      (static_cast<size_t>(t.r_count) * t.b * sizeof(float) +
                       static_cast<size_t>(t.pool) * (sizeof(float) + sizeof(int)));
  cudaError_t err = allow_smem(topk_partial_kernel<kEst, kInline>, smem);
  if (err != cudaSuccess) return err;
  const int split_len = (t.num_classes + t.num_splits - 1) / t.num_splits;
  const dim3 grid(t.num_splits, (t.n + qpb - 1) / qpb);
  topk_partial_kernel<kEst, kInline><<<grid, kThreads, smem, stream>>>(
      t.meta, t.n, t.r_count, t.b, t.num_classes, table, coeffs, shift, qpb,
      t.kcap, t.pool, split_len, t.part_val, t.part_idx);
  return cudaGetLastError();
}

template <int kEst>
cudaError_t launch_topk(const TopkArgs& t, cudaStream_t stream) {
  cudaError_t err = t.table != nullptr ? launch_partial<kEst, false>(t, stream)
                                       : launch_partial<kEst, true>(t, stream);
  if (err != cudaSuccess) return err;
  const size_t merge_smem =
      static_cast<size_t>(t.merge_width) * (sizeof(float) + sizeof(int));
  err = allow_smem(topk_merge_kernel, merge_smem);
  if (err != cudaSuccess) return err;
  topk_merge_kernel<<<t.n, kThreads, merge_smem, stream>>>(
      t.part_val, t.part_idx, t.num_splits * t.kcap, t.merge_width, t.k,
      t.out_val, t.out_idx);
  return cudaGetLastError();
}

bool is_pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace mach

extern "C" {

// meta (n, R, B) f32; table (R, K) int32 or, when table is null, coeffs
// (R,) int64 holding uint32 multipliers with `shift`; estimator 0/1/2 =
// unbiased (raw sum) / min / median; mapping 0 = class per thread
// (queries_per_block <= kMaxQueriesTopk, a shared pool of `pool` slots a
// query: a power of two with pool - kcap >= 256), 1 = query per lane
// (queries_per_block 32 or 64, list_len 1, 16 or 32 keys a lane keeps per
// query, 64 queries only with list_len <= 16, kcap <= list_len; not for
// the median with the table hash);
// part_* (n, num_splits, kcap) scratch; out_* (n, k); network_runs null or
// one counter the query-per-lane median adds its sorting-network runs to.
// kcap and merge_width are powers of two with k <= kcap <= kMaxK and
// merge_width >= num_splits * kcap.  Returns a cudaError_t code.
int mach_topk_launch(const void* meta, int n, int r_count, int b,
                     int num_classes, const void* table, const void* coeffs,
                     int shift, int estimator, int mapping,
                     int queries_per_block, int list_len, int k, int kcap,
                     int pool, int num_splits, int merge_width,
                     void* part_val, void* part_idx, void* out_val,
                     void* out_idx, void* network_runs, void* stream) {
  using namespace mach;
  const bool layout_ok =
      mapping == kQueryPerLane
          ? ((queries_per_block == 32 || queries_per_block == 64) &&
             kcap <= list_len)
          : (mapping == kClassPerThread && queries_per_block >= 1 &&
             queries_per_block <= kMaxQueriesTopk && is_pow2(pool) &&
             pool - kcap >= kThreads);
  if (n < 1 || r_count < 1 || r_count > kMaxR || b < 1 || num_classes < 1 ||
      !layout_ok || k < 1 || k > kcap || kcap > kMaxK || !is_pow2(kcap) ||
      num_splits < 1 || !is_pow2(merge_width) ||
      merge_width < num_splits * kcap ||
      (table == nullptr && coeffs == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TopkArgs t;
  t.meta = static_cast<const float*>(meta);
  t.n = n;
  t.r_count = r_count;
  t.b = b;
  t.num_classes = num_classes;
  t.table = static_cast<const int*>(table);
  t.coeffs = static_cast<const long long*>(coeffs);
  t.shift = shift;
  t.mapping = mapping;
  t.queries_per_block = queries_per_block;
  t.list_len = list_len;
  t.k = k;
  t.kcap = kcap;
  t.pool = pool;
  t.num_splits = num_splits;
  t.merge_width = merge_width;
  t.part_val = static_cast<float*>(part_val);
  t.part_idx = static_cast<int*>(part_idx);
  t.out_val = static_cast<float*>(out_val);
  t.out_idx = static_cast<int*>(out_idx);
  t.network_runs = static_cast<unsigned long long*>(network_runs);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (estimator) {
    case kUnbiased: err = launch_topk<kUnbiased>(t, s); break;
    case kMin: err = launch_topk<kMin>(t, s); break;
    case kMedian: err = launch_topk<kMedian>(t, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
