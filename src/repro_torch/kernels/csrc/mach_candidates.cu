// Count-min candidate-filtered MACH top-k decode for Hopper (sm_90a).
//
// Kernel 7, bucket_topm_kernel, replaces
// src/repro/kernels/mach_candidates.py::bucket_topm_pallas (m rounds of
// max / argmax / mask over a VMEM-resident row): one block per (query,
// repetition) bitonic-sorts the B bucket values in shared memory on the key
// (value descending, bucket id ascending) — lax.top_k's tie order — and
// writes the first m ids and tau, the m-th value.  Bound by the bytes of the
// probabilities (read once); B <= 27k fits a block's shared memory.
//
// Kernel 8, cand_partial_kernel + cand_merge_kernel, replaces
// ::mach_candidate_topk_pallas, which walked a sequential grid of chunks
// per query, DMA-selected each chunk's inverted-table row by a
// scalar-prefetched id, recomputed buckets with one-hot matmuls on the MXU
// and merged into a running top-k held in VMEM across the grid.  Here blocks
// run in no order: a block owns one query and every num_splits-th tile of
// 256 pool entries (pool entry e = chunk e / L, slot e % L; chunk c is the
// inverted row r0*B + ids[r0, c % m], r0 = c / m), so the work of a query
// spreads evenly over its blocks whatever the chunk count (800 chunks at
// ODP exact mode, 10,240 at ImageNet-21k).  A thread owns an entry: it reads
// the class id from the inverted row (neighbouring threads, neighbouring
// slots), then visits repetitions in order, hashing the class (inline
// multiply-shift or a table read) and gathering g[r] from the query's R*B
// probabilities — in shared memory when they fit, else from global memory,
// where one query's row stays in L2 (512 KB at R=16, B=8192).  member[r] =
// g[r] >= tau[r]; the entry is claimed iff the first member repetition is
// r0, so an entry of chunk r0 stops at the first member repetition below r0
// or at r0 itself if it is no member there (in exact mode every entry of a
// chunk r0 >= 1 stops after one gather).  A claimed entry goes on to all R
// values: their sum in r order (unbiased), min, or the median through the
// register network of mach_common.cuh, and count >= t decides its band.
//
// Keys are 64-bit: band (2 valid, 1 backfill, 0 dead) in bits 62-63, the
// selection value made order-preserving in bits 30-61, and 2^30-1-class id
// below, so one unsigned compare ranks (band, value descending, class id
// ascending) and the result does not depend on the schedule.  Each block
// keeps a threshold-filtered pool of keys in shared memory (slots [0, kcap)
// the running top-kcap, bitonic-sorted when the rest could overflow), writes
// its top-kcap to (N, num_splits, kcap) partials, and a merge kernel sorts
// each query's num_splits * kcap keys (<= 4096) and decodes the best k into
// (value, band, class id).  No (N, K) or (N, P) tensor exists.
//
// What bounds it on this card: the gathered values the early stop above
// leaves (R per claimed entry, fewer for the rest of the P = R*m*L pool
// entries; mach_candidates.py::pool_gathers counts them) at one float
// operation each, against the bytes of the probabilities, the inverted rows
// the batch touches and the outputs.
#include "mach_common.cuh"

namespace mach {

constexpr int kMaxKCand = 128;        // largest k (and kcap) the kernel takes
constexpr int kIdBits = 30;           // class ids < 2^30
constexpr unsigned kIdMask = (1u << kIdBits) - 1;

enum Estimator : int { kUnbiased = 0, kMin = 1, kMedian = 2 };
enum Band : int { kDead = 0, kBackfill = 1, kValid = 2 };

using Key = unsigned long long;

// ---------------------------------------------------------------------------
// Kernel 7: bucket top-m.
// ---------------------------------------------------------------------------

// One block per (query, repetition) row of B values; `width` is B rounded
// up to a power of two, the pads sorting last.
__global__ void __launch_bounds__(kThreads)
bucket_topm_kernel(const float* __restrict__ meta, int b, int m, int width,
                   float* __restrict__ tau, int* __restrict__ ids) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* v = reinterpret_cast<float*>(smem);
  int* idx = reinterpret_cast<int*>(v + width);
  const size_t row = blockIdx.x;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    const bool real = i < b;
    v[i] = real ? meta[row * b + i] : -CUDART_INF_F;
    idx[i] = real ? i : kWorstIdx;
  }
  __syncthreads();
  bitonic_sort_best_first(v, idx, width);
  for (int i = threadIdx.x; i < m; i += blockDim.x) ids[row * m + i] = idx[i];
  if (threadIdx.x == 0) tau[row] = v[m - 1];
}

// ---------------------------------------------------------------------------
// Kernel 8: filtered gather + score + top-k.
// ---------------------------------------------------------------------------

__device__ __forceinline__ Key make_key(int band, float v, int cls) {
  uint32_t u = __float_as_uint(__fadd_rn(v, 0.0f));   // -0 ranks as +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);     // order-preserving
  return (static_cast<Key>(band) << 62) | (static_cast<Key>(u) << kIdBits) |
         static_cast<Key>(kIdMask - static_cast<unsigned>(cls));
}

__device__ __forceinline__ void split_key(Key key, float& v, int& band,
                                          int& cls) {
  band = static_cast<int>(key >> 62);
  if (band == kDead) {
    v = -CUDART_INF_F;
    cls = -1;
    return;
  }
  uint32_t u = static_cast<uint32_t>(key >> kIdBits);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  v = __uint_as_float(u);
  cls = static_cast<int>(kIdMask - static_cast<unsigned>(key & kIdMask));
}

// Bitonic sort of n (a power of two) keys in shared memory, largest first.
// All threads of the block take part; ends synchronised.
__device__ __forceinline__ void sort_keys_desc(Key* key, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const Key a = key[lo], c = key[hi];
        if (((lo & size) == 0) ? c > a : a > c) {
          key[lo] = c;
          key[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

struct CandArgs {
  const float* meta;       // (n, R*B)
  const float* tau;        // (n, R)
  const int* ids;          // (n, R, m)
  const int* inverted;     // (R*B, L)
  const int* table;        // (R, K) or null
  const long long* coeffs; // (R,) or null
  int n, r_count, b, m, ell, num_classes, shift, t, k, kcap, pool, num_splits;
  Key* part;               // (n, num_splits, kcap)
  float* out_sel;          // (n, k)
  int* out_band;           // (n, k)
  int* out_idx;            // (n, k)
};

// Key of pool entry `cls`, found in a chunk of repetition r0, or 0 (dead)
// when another repetition claims it or none does.
template <int kEst, bool kInline>
__device__ __forceinline__ Key entry_key(const CandArgs& a,
                                         const float* __restrict__ p,
                                         const float* __restrict__ tau,
                                         const uint32_t (&coef)[kMaxR], int r0,
                                         int cls) {
  float g[kMaxR];
  float sum = 0.f, lo = CUDART_INF_F;
  int count = 0;
#pragma unroll
  for (int j = 0; j < kMaxR; ++j) {
    g[j] = CUDART_INF_F;                 // pads sort last in the median
    if (j < a.r_count) {
      const int h =
          kInline ? static_cast<int>((coef[j] * static_cast<uint32_t>(cls)) >>
                                     a.shift)
                  : __ldg(a.table + static_cast<size_t>(j) * a.num_classes + cls);
      const float v = p[j * a.b + h];
      const bool member = v >= tau[j];
      if (j < r0 ? member : (j == r0 && !member)) return 0ull;
      count += member;
      g[j] = v;
      sum = __fadd_rn(sum, v);
      lo = fminf(lo, v);
    }
  }
  float s;
  if (kEst == kUnbiased) {
    s = sum;
  } else if (kEst == kMin) {
    s = lo;
  } else {
    s = sorted_median(g, a.r_count);
  }
  return make_key((a.t <= 1 || count >= a.t) ? kValid : kBackfill, s, cls);
}

// Sort the pool, keep its best kcap keys, clear the rest and move the
// threshold.  Called by the whole block.
__device__ __forceinline__ void merge_keys(Key* keys, int pool, int kcap,
                                           int* count, Key* thr) {
  sort_keys_desc(keys, pool);
  for (int i = kcap + threadIdx.x; i < pool; i += blockDim.x) keys[i] = 0ull;
  if (threadIdx.x == 0) {
    *count = 0;
    *thr = keys[kcap - 1];
  }
  __syncthreads();
}

template <int kEst, bool kInline, bool kSmemProbs>
__global__ void __launch_bounds__(kThreads)
cand_partial_kernel(const CandArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float tau_s[kMaxR];
  __shared__ int count;
  __shared__ Key thr;
  Key* keys = reinterpret_cast<Key*>(smem);                 // (pool,)
  float* probs = reinterpret_cast<float*>(keys + a.pool);   // (R*B,)

  const int q = blockIdx.y, split = blockIdx.x;
  const int rb = a.r_count * a.b;
  const float* row = a.meta + static_cast<size_t>(q) * rb;
  if (kSmemProbs) {
    for (int i = threadIdx.x; i < rb; i += blockDim.x) probs[i] = row[i];
  }
  for (int i = threadIdx.x; i < a.pool; i += blockDim.x) keys[i] = 0ull;
  if (threadIdx.x < kMaxR) {
    tau_s[threadIdx.x] =
        threadIdx.x < a.r_count ? a.tau[q * a.r_count + threadIdx.x] : 0.f;
  }
  if (threadIdx.x == 0) {
    count = 0;
    thr = 0ull;
  }
  uint32_t coef[kMaxR];
  load_coeffs<kInline>(coef, a.r_count, a.coeffs);
  __syncthreads();

  const float* p = kSmemProbs ? probs : row;
  const int* ids_q = a.ids + static_cast<size_t>(q) * a.r_count * a.m;
  const int total = a.r_count * a.m * a.ell;
  const int step = a.num_splits * static_cast<int>(blockDim.x);
  const int merge_at = a.pool - a.kcap - static_cast<int>(blockDim.x);
  for (int base = split * blockDim.x; base < total; base += step) {
    const int e = base + threadIdx.x;
    if (e < total) {
      const int c = e / a.ell;
      const int r0 = c / a.m;
      const int cls = __ldg(a.inverted +
                            (static_cast<size_t>(r0) * a.b + ids_q[c]) * a.ell +
                            (e - c * a.ell));
      if (cls >= 0 && cls < a.num_classes) {
        const Key key = entry_key<kEst, kInline>(a, p, tau_s, coef, r0, cls);
        if (key > thr) keys[a.kcap + atomicAdd(&count, 1)] = key;
      }
    }
    __syncthreads();
    // every thread reads the count before a merge resets it
    const bool full = count > merge_at;
    __syncthreads();
    if (full) merge_keys(keys, a.pool, a.kcap, &count, &thr);
  }
  merge_keys(keys, a.pool, a.kcap, &count, &thr);
  Key* out = a.part + (static_cast<size_t>(q) * a.num_splits + split) * a.kcap;
  for (int i = threadIdx.x; i < a.kcap; i += blockDim.x) out[i] = keys[i];
}

// One block per query: sort its num_splits * kcap partial keys (padded to
// `width`, a power of two) and decode the best k.
__global__ void __launch_bounds__(kThreads)
cand_merge_kernel(const CandArgs a, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key* keys = reinterpret_cast<Key*>(smem);
  const size_t row = blockIdx.x;
  const int parts = a.num_splits * a.kcap;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    keys[i] = i < parts ? a.part[row * parts + i] : 0ull;
  }
  __syncthreads();
  sort_keys_desc(keys, width);
  for (int i = threadIdx.x; i < a.k; i += blockDim.x) {
    float v;
    int band, cls;
    split_key(keys[i], v, band, cls);
    a.out_sel[row * a.k + i] = v;
    a.out_band[row * a.k + i] = band;
    a.out_idx[row * a.k + i] = cls;
  }
}

template <int kEst, bool kInline, bool kSmemProbs>
cudaError_t launch_cand(const CandArgs& a, int width, cudaStream_t stream) {
  auto kernel = cand_partial_kernel<kEst, kInline, kSmemProbs>;
  const size_t smem =
      static_cast<size_t>(a.pool) * sizeof(Key) +
      (kSmemProbs ? static_cast<size_t>(a.r_count) * a.b * sizeof(float) : 0);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.num_splits, a.n), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t merge_smem = static_cast<size_t>(width) * sizeof(Key);
  err = allow_smem(cand_merge_kernel, merge_smem);
  if (err != cudaSuccess) return err;
  cand_merge_kernel<<<a.n, kThreads, merge_smem, stream>>>(a, width);
  return cudaGetLastError();
}

template <int kEst>
cudaError_t launch_est(const CandArgs& a, int width, bool smem_probs,
                       cudaStream_t s) {
  if (a.table != nullptr) {
    return smem_probs ? launch_cand<kEst, false, true>(a, width, s)
                      : launch_cand<kEst, false, false>(a, width, s);
  }
  return smem_probs ? launch_cand<kEst, true, true>(a, width, s)
                    : launch_cand<kEst, true, false>(a, width, s);
}

bool is_pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace mach

extern "C" {

// meta (n, R, B) f32 -> tau (n, R) f32, ids (n, R, m) int32; width is a
// power of two >= B.  Returns a cudaError_t code.
int bucket_topm_launch(const void* meta, int n, int r_count, int b, int m,
                       int width, void* tau, void* ids, void* stream) {
  using namespace mach;
  if (n < 1 || r_count < 1 || b < 1 || m < 1 || m > b || !is_pow2(width) ||
      width < b) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(width) * (sizeof(float) + sizeof(int));
  cudaError_t err = allow_smem(bucket_topm_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bucket_topm_kernel<<<n * r_count, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(meta), b, m, width, static_cast<float*>(tau),
      static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}

// meta (n, R, B) f32, tau (n, R) f32, ids (n, R, m) int32, inverted
// (R*B, L) int32; table (R, K) int32 or, when table is null, coeffs (R,)
// int64 holding uint32 multipliers with `shift`; estimator 0/1/2 =
// unbiased (raw sum) / min / median; part (n, num_splits, kcap) 64-bit
// scratch; out_sel (n, k) f32, out_band and out_idx (n, k) int32.  kcap,
// pool and merge_width are powers of two with k <= kcap <= 128, pool -
// kcap >= 256 and merge_width >= num_splits * kcap; smem_probs nonzero
// copies each query's R*B probabilities to shared memory.  Returns a
// cudaError_t code.
int mach_candidate_topk_launch(
    const void* meta, const void* tau, const void* ids, const void* inverted,
    int n, int r_count, int b, int m, int ell, int num_classes,
    const void* table, const void* coeffs, int shift, int estimator, int t,
    int k, int kcap, int pool, int num_splits, int merge_width, int smem_probs,
    void* part, void* out_sel, void* out_band, void* out_idx, void* stream) {
  using namespace mach;
  if (n < 1 || r_count < 1 || r_count > kMaxR || b < 1 || m < 1 || m > b ||
      ell < 1 || num_classes < 1 || num_classes > static_cast<int>(kIdMask) ||
      t < 1 || t > r_count || k < 1 || k > kcap || kcap > kMaxKCand ||
      !is_pow2(kcap) || !is_pow2(pool) || pool - kcap < kThreads ||
      num_splits < 1 || !is_pow2(merge_width) ||
      merge_width < num_splits * kcap ||
      static_cast<long long>(r_count) * m * ell >= (1ll << 31) ||
      (table == nullptr && coeffs == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CandArgs a;
  a.meta = static_cast<const float*>(meta);
  a.tau = static_cast<const float*>(tau);
  a.ids = static_cast<const int*>(ids);
  a.inverted = static_cast<const int*>(inverted);
  a.table = static_cast<const int*>(table);
  a.coeffs = table == nullptr ? static_cast<const long long*>(coeffs) : nullptr;
  a.n = n;
  a.r_count = r_count;
  a.b = b;
  a.m = m;
  a.ell = ell;
  a.num_classes = num_classes;
  a.shift = shift;
  a.t = t;
  a.k = k;
  a.kcap = kcap;
  a.pool = pool;
  a.num_splits = num_splits;
  a.part = static_cast<Key*>(part);
  a.out_sel = static_cast<float*>(out_sel);
  a.out_band = static_cast<int*>(out_band);
  a.out_idx = static_cast<int*>(out_idx);
  auto s = static_cast<cudaStream_t>(stream);
  const bool sp = smem_probs != 0;
  cudaError_t err;
  switch (estimator) {
    case kUnbiased: err = launch_est<kUnbiased>(a, merge_width, sp, s); break;
    case kMin: err = launch_est<kMin>(a, merge_width, sp, s); break;
    case kMedian: err = launch_est<kMedian>(a, merge_width, sp, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
