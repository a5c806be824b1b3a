// Count-min candidate-filtered MACH top-k decode for Hopper (sm_90a).
//
// Kernel 7 (topm_select_kernel, topm_warp_kernel, topm_block_kernel)
// replaces src/repro/kernels/mach_candidates.py::bucket_topm_pallas (m
// rounds of max / argmax / mask over a VMEM-resident row): per (query,
// repetition) row of B values, the first m bucket ids on the key (value
// descending, bucket id ascending) — lax.top_k's tie order — and tau, the
// m-th value.  What bounds it on this card is not the bytes (0.8 MB at ODP,
// 5 MB at ImageNet-21k, read once) but the latency of short sorts: a block
// per row with a __syncthreads a sorting stage ran 15 stages over 32
// values at ODP with 16 of 256 threads busy.  So a value and its id travel
// as one 64-bit key (one unsigned compare ranks a pair), a row is held by
// one warp wherever it fits, and the kernel that runs is chosen from (B, m)
// by the wrapper (mach_candidates.topm_layout):
// - select: each lane keeps a sorted list of its best next_pow2(m) keys in
//   registers while it streams its part of the row, then m rounds of a warp
//   arg-max across the 32 lists; no sort.  For m <= 32 above B = 1,024
//   (the LM engine's B = 2,048, the gate's 8,192: few rows, so a block's 8
//   warps share a row and their lists merge the same way), and at B <=
//   1,024 where the list is no longer than the keys a lane would sort
//   (approximate modes at ImageNet-21k; measured on an H100, the arg-max
//   rounds cost more than a short sort at ODP's B = 32);
// - warp, B <= 1024 otherwise (exact mode at ODP and ImageNet-21k, every m
//   at B <= 32): a bitonic sort held in the warp's registers, V = B/32 keys
//   a lane rounded up to a power of two; strides below V inside a lane,
//   larger ones by shuffles;
// - block, B > 1024 with m > 32: the keys in shared memory, sorted by the
//   block.
// Rows are read with 16-byte loads wherever B % 4 == 0.
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

constexpr int kTopmWarps = 8;            // rows a block, one a warp
constexpr int kTopmBlockThreads = 1024;  // the block sort's threads
constexpr int kTopmWarpRow = 1024;       // longest row one warp selects from
enum TopmPath : int { kTopmSelect = 0, kTopmWarp = 1, kTopmBlock = 2 };

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

// (value, bucket id) as one key, larger ranking first: the value's
// order-preserving bits above (-0.0 folded into +0.0, which torch.sort
// counts equal and orders by id), 2^32 - 1 - id below.  Every real key is
// nonzero; pads are 0 and sort last.
__device__ __forceinline__ Key topm_key(float v, int id) {
  uint32_t u = __float_as_uint(__fadd_rn(v, 0.0f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<Key>(u) << 32) |
         static_cast<Key>(0xffffffffu - static_cast<uint32_t>(id));
}

__device__ __forceinline__ int topm_id(Key key) {
  return static_cast<int>(0xffffffffu - static_cast<uint32_t>(key));
}

// Rows can be read as float4 when B % 4 == 0 and the base is aligned.
__device__ __forceinline__ bool rows_vectorizable(const float* meta, int b) {
  return (b & 3) == 0 && (reinterpret_cast<uintptr_t>(meta) & 15) == 0;
}

// Insert x into a lane's list, best first, keeping its kLen best keys.
template <int kLen>
__device__ __forceinline__ void keep_best(Key (&list)[kLen], Key x) {
  if (x > list[kLen - 1]) {
#pragma unroll
    for (int i = kLen - 1; i > 0; --i) {
      list[i] = x > list[i - 1] ? list[i - 1] : (x > list[i] ? x : list[i]);
    }
    list[0] = x > list[0] ? x : list[0];
  }
}

// m rounds of a warp arg-max over the lanes' list heads; the winner's
// lane pops its head.  Returns, in lane t < m, the t-th best key.
template <int kLen>
__device__ __forceinline__ Key pop_best(Key (&list)[kLen], int m, int lane) {
  Key mine = 0ull;
  for (int t = 0; t < m; ++t) {
    Key best = list[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const Key other = __shfl_xor_sync(0xffffffffu, best, off);
      best = other > best ? other : best;
    }
    if (list[0] == best) {   // keys are unique: one lane pops
#pragma unroll
      for (int i = 0; i + 1 < kLen; ++i) list[i] = list[i + 1];
      list[kLen - 1] = 0ull;
    }
    if (lane == t) mine = best;
  }
  return mine;
}

// m <= kLen <= 32: each lane keeps its best kLen keys of the values it
// streams (float4s, four loads in flight), then pop_best.  kRowWarps > 1
// warps share a long row, a slice each; their top-m lists meet in shared
// memory and the first warp pops the row's top m from them.  Lane t
// writes the t-th id, so the ids go out coalesced.
template <int kLen, int kRowWarps>
__global__ void __launch_bounds__(kTopmWarps * 32)
topm_select_kernel(const float* __restrict__ meta, int rows, int b, int m,
                   float* __restrict__ tau, int* __restrict__ ids) {
  __shared__ Key heads[kRowWarps > 1 ? kRowWarps : 1][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = kRowWarps > 1 ? blockIdx.x
                                : blockIdx.x * kTopmWarps + warp;
  if (row >= rows) return;   // a whole warp, or the whole block
  const float* src = meta + static_cast<size_t>(row) * b;
  const int slice = kRowWarps > 1 ? ((b + 4 * kRowWarps - 1) /
                                     (4 * kRowWarps)) * 4 : b;
  const int lo = kRowWarps > 1 ? warp * slice : 0;
  const int hi = min(b, lo + slice);
  Key list[kLen];
#pragma unroll
  for (int i = 0; i < kLen; ++i) list[i] = 0ull;
  if (rows_vectorizable(meta, b)) {
    for (int i0 = lo + 4 * lane; i0 < hi; i0 += 4 * 128) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 128 * u;
        if (i < hi) v[u] = *reinterpret_cast<const float4*>(src + i);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 128 * u;
        if (i < hi) {
          keep_best(list, topm_key(v[u].x, i));
          keep_best(list, topm_key(v[u].y, i + 1));
          keep_best(list, topm_key(v[u].z, i + 2));
          keep_best(list, topm_key(v[u].w, i + 3));
        }
      }
    }
  } else {
    for (int i = lo + lane; i < hi; i += 32) {
      keep_best(list, topm_key(src[i], i));
    }
  }
  Key mine = pop_best(list, m, lane);
  if constexpr (kRowWarps > 1) {
    heads[warp][lane] = lane < m ? mine : 0ull;
    __syncthreads();
    if (warp != 0) return;
#pragma unroll
    for (int i = 0; i < kLen; ++i) list[i] = 0ull;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) keep_best(list, heads[w][lane]);
    mine = pop_best(list, m, lane);
  }
  if (lane < m) ids[static_cast<size_t>(row) * m + lane] = topm_id(mine);
  if (lane == m - 1) tau[row] = src[topm_id(mine)];
}

// Bitonic sort, best first, of the 32 * kV keys a warp holds, key[j] of
// lane l at position p = l * kV + j: a stride below kV pairs two registers
// of one lane, a larger one the same register of lanes l and l ^ (stride /
// kV).  Every index is a compile-time constant once unrolled, so the keys
// stay in registers.
template <int kV>
__device__ __forceinline__ void warp_sort_desc(Key (&key)[kV], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * kV; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= kV) {
        const int lanes = stride / kV;
        const bool lower = (lane & lanes) == 0;
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const Key other = __shfl_xor_sync(0xffffffffu, key[j], lanes);
          const bool best_first = ((lane * kV + j) & size) == 0;
          const bool keep_larger = lower == best_first;
          key[j] = (other > key[j]) == keep_larger ? other : key[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const int jj = j ^ stride;
          if (jj > j) {
            const bool best_first = ((lane * kV + j) & size) == 0;
            const Key x = key[j], y = key[jj];
            const bool swap = best_first ? y > x : x > y;
            key[j] = swap ? y : x;
            key[jj] = swap ? x : y;
          }
        }
      }
    }
  }
}

// B <= 32 * kV <= 1024: one warp sorts a row in registers and writes its
// first m ids (16-byte stores where m % 4 == 0).
template <int kV>
__global__ void __launch_bounds__(kTopmWarps * 32)
topm_warp_kernel(const float* __restrict__ meta, int rows, int b, int m,
                 float* __restrict__ tau, int* __restrict__ ids) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kTopmWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* src = meta + static_cast<size_t>(row) * b;
  const int p0 = lane * kV;
  Key key[kV];
  bool loaded = false;
  if constexpr (kV >= 4) {
    if (rows_vectorizable(meta, b)) {
#pragma unroll
      for (int j = 0; j < kV; j += 4) {
        const int p = p0 + j;        // p < b implies p + 3 < b
        const float4 v = p < b ? *reinterpret_cast<const float4*>(src + p)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        key[j] = p < b ? topm_key(v.x, p) : 0ull;
        key[j + 1] = p < b ? topm_key(v.y, p + 1) : 0ull;
        key[j + 2] = p < b ? topm_key(v.z, p + 2) : 0ull;
        key[j + 3] = p < b ? topm_key(v.w, p + 3) : 0ull;
      }
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      key[j] = p0 + j < b ? topm_key(src[p0 + j], p0 + j) : 0ull;
    }
  }
  warp_sort_desc<kV>(key, lane);
  int* out = ids + static_cast<size_t>(row) * m;
  bool stored = false;
  if constexpr (kV >= 4) {
    if ((m & 3) == 0) {
#pragma unroll
      for (int j = 0; j < kV; j += 4) {
        if (p0 + j < m) {
          *reinterpret_cast<int4*>(out + p0 + j) =
              make_int4(topm_id(key[j]), topm_id(key[j + 1]),
                        topm_id(key[j + 2]), topm_id(key[j + 3]));
        }
      }
      stored = true;
    }
  }
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int p = p0 + j;
    if (!stored && p < m) out[p] = topm_id(key[j]);
    if (p == m - 1) tau[row] = src[topm_id(key[j])];
  }
}

// B > 1024 with m > 32: one block per row sorts its keys, padded to
// `width`, in shared memory.
__global__ void __launch_bounds__(kTopmBlockThreads)
topm_block_kernel(const float* __restrict__ meta, int b, int m, int width,
                  float* __restrict__ tau, int* __restrict__ ids) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key* key = reinterpret_cast<Key*>(smem);
  const size_t row = blockIdx.x;
  const float* src = meta + row * b;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    key[i] = i < b ? topm_key(src[i], i) : 0ull;
  }
  __syncthreads();
  sort_keys_desc(key, width);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    ids[row * m + i] = topm_id(key[i]);
  }
  if (threadIdx.x == 0) tau[row] = src[topm_id(key[m - 1])];
}

// A row longer than kTopmWarpRow is shared by a block's warps.
template <int kLen>
cudaError_t launch_topm_select(const float* meta, int rows, int b, int m,
                               float* tau, int* ids, cudaStream_t stream) {
  if (b > kTopmWarpRow) {
    topm_select_kernel<kLen, kTopmWarps>
        <<<rows, kTopmWarps * 32, 0, stream>>>(meta, rows, b, m, tau, ids);
  } else {
    topm_select_kernel<kLen, 1>
        <<<(rows + kTopmWarps - 1) / kTopmWarps, kTopmWarps * 32, 0, stream>>>(
            meta, rows, b, m, tau, ids);
  }
  return cudaGetLastError();
}

template <int kV>
cudaError_t launch_topm_warp(const float* meta, int rows, int b, int m,
                             float* tau, int* ids, cudaStream_t stream) {
  topm_warp_kernel<kV>
      <<<(rows + kTopmWarps - 1) / kTopmWarps, kTopmWarps * 32, 0, stream>>>(
          meta, rows, b, m, tau, ids);
  return cudaGetLastError();
}

using TopmLaunch = cudaError_t (*)(const float*, int, int, int, float*, int*,
                                   cudaStream_t);
// indexed by log2 of the list length / the keys a lane
constexpr TopmLaunch kTopmSelectLaunch[] = {
    launch_topm_select<1>, launch_topm_select<2>, launch_topm_select<4>,
    launch_topm_select<8>, launch_topm_select<16>, launch_topm_select<32>};
constexpr TopmLaunch kTopmWarpLaunch[] = {
    launch_topm_warp<1>, launch_topm_warp<2>, launch_topm_warp<4>,
    launch_topm_warp<8>, launch_topm_warp<16>, launch_topm_warp<32>};

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

// meta (n, R, B) f32 -> tau (n, R) f32, ids (n, R, m) int32, by `path`
// (TopmPath) with `keys`: the list length a lane keeps (select, a power of
// two in [m, 32]), the keys a lane sorts (warp, a power of two with 32 *
// keys >= B) or the keys the block sorts (block, a power of two >= B).
// Returns a cudaError_t code.
int bucket_topm_launch(const void* meta, int n, int r_count, int b, int m,
                       int path, int keys, void* tau, void* ids,
                       void* stream) {
  using namespace mach;
  if (n < 1 || r_count < 1 || b < 1 || m < 1 || m > b || !is_pow2(keys) ||
      static_cast<long long>(n) * r_count >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = n * r_count;
  auto s = static_cast<cudaStream_t>(stream);
  auto src = static_cast<const float*>(meta);
  auto t = static_cast<float*>(tau);
  auto o = static_cast<int*>(ids);
  const int lg = __builtin_ctz(static_cast<unsigned>(keys));
  if (path == kTopmSelect && m <= keys && keys <= 32) {
    return static_cast<int>(kTopmSelectLaunch[lg](src, rows, b, m, t, o, s));
  }
  if (path == kTopmWarp && b <= 32 * keys && keys <= 32) {
    return static_cast<int>(kTopmWarpLaunch[lg](src, rows, b, m, t, o, s));
  }
  if (path == kTopmBlock && keys >= b) {
    const size_t smem = static_cast<size_t>(keys) * sizeof(Key);
    cudaError_t err = allow_smem(topm_block_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    topm_block_kernel<<<rows, kTopmBlockThreads, smem, s>>>(src, b, m, keys,
                                                             t, o);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
