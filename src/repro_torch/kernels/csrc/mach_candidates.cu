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
// Kernel 8, cand_warp_kernel + cand_merge_kernel, replaces
// ::mach_candidate_topk_pallas, which walked a sequential grid of chunks
// per query, DMA-selected each chunk's inverted-table row by a
// scalar-prefetched id, recomputed buckets with one-hot matmuls on the MXU
// and merged into a running top-k held in VMEM across the grid.  The pool
// of a query is its R*m chunks (chunk c is the inverted row r0*B + ids[r0,
// c % m], r0 = c / m) of L entries each.  member[r] = g[r] >= tau[r] with
// g[r] the query's probability in class cls's bucket h_r(cls); an entry of
// chunk r0 is claimed iff its first member repetition is r0, so a class is
// claimed at most once.  A claimed entry's value: the sum of its R values
// in r order from +0.0 (unbiased), their min (fminf), or their median
// through the register network of mach_common.cuh (sorted_median); count
// >= t decides its band.
//
// What bounds it on this card: the gathered values, one float operation
// each (mach_candidates.py::pool_gathers counts what these inputs need: R
// for a claimed entry, one per repetition up to the first member one for
// the rest), the probabilities and inverted rows read, and the latency of
// the chains of dependent gathers that the early stop makes.  The first
// CUDA design gave a thread one entry per step, with two integer divisions
// per entry, up to R dependent gathers, a shared-memory atomic and two
// block barriers every 256 entries: about one gather a clock an SM.  So:
// - a warp walks whole chunks of one query (chunks strided over the
//   query's warps), so r0, the bucket id and the row pointer are
//   warp-uniform and found once a chunk (no division per entry); a chunk's
//   own repetition puts every entry in one bucket, so its test at r0 is
//   one value for the whole chunk;
// - a lane reads four entries of the row with one 16-byte load, two steps
//   of rows in flight ahead of the one it scores, and runs the four
//   entries' chains side by side: below r0 a gather is a test that may end
//   the chain, above r0 (claimed entries only) the gathers are independent;
// - where m = B, tau is each row's minimum, so every bucket of repetition 0
//   is a member and only the chunks of repetition 0 can claim: the kernel
//   checks each repetition for that (tau[j] at or below the row's minimum)
//   and skips later repetitions' chunks whole, which leaves exact mode the
//   streaming kernel's N*K*R gathers instead of (R-1)*B*L more tests;
// - each warp keeps its running top kcap keys in registers (kcap/32 a lane,
//   1 or 4), best first across the warp, and a warp-uniform threshold, the
//   kcap-th key; a ballot after each step finds lanes with a key above it,
//   and only then are those keys inserted, one at a time.  No block barrier
//   and no atomic in the walk; at its end warp 0 folds the other warps'
//   lists into its own by bitonic merges in registers;
// - probabilities sit in shared memory when R*B fits (a block's walk is at
//   least R*B entries, to pay for the copy), else in global memory, where
//   one query's row stays in L2 (512 KB at R=16, B=8192);
// - in table mode each gather also needs h_r(cls) from the table at a
//   random class: the wrapper hands the kernel the table transposed, (K,
//   R), so a class's bucket ids lie side by side (100 bytes at R = 25) and
//   its chain's reads after the first hit L1, where the (R, K) rows cost
//   an L2 sector a gather.
// Keys are 64-bit: band (2 valid, 1 backfill, 0 dead) in bits 62-63, the
// selection value made order-preserving in bits 30-61, and 2^30-1-class id
// below, so one unsigned compare ranks (band, value descending, class id
// ascending) and the result does not depend on the schedule.  Each block
// writes its top kcap to (N, num_splits, kcap) partials, and a merge kernel
// sorts each query's num_splits * kcap keys (<= 4096) and decodes the best
// k into (value, band, class id).  No (N, K) or (N, P) tensor exists.  The
// grid and the probabilities' home come from mach_candidates.cand_layout.
#include "mach_common.cuh"

namespace mach {

constexpr int kMaxKCand = 128;        // largest k (and kcap) the kernel takes
constexpr int kIdBits = 30;           // class ids < 2^30
constexpr unsigned kIdMask = (1u << kIdBits) - 1;

enum Estimator : int { kUnbiased = 0, kMin = 1, kMedian = 2 };
enum Band : int { kDead = 0, kBackfill = 1, kValid = 2 };

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

// Rows can be read as float4 when B % 4 == 0 and the base is aligned.
__device__ __forceinline__ bool rows_vectorizable(const float* meta, int b) {
  return (b & 3) == 0 && (reinterpret_cast<uintptr_t>(meta) & 15) == 0;
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
          keep_best(list, value_key(v[u].x, i));
          keep_best(list, value_key(v[u].y, i + 1));
          keep_best(list, value_key(v[u].z, i + 2));
          keep_best(list, value_key(v[u].w, i + 3));
        }
      }
    }
  } else {
    for (int i = lo + lane; i < hi; i += 32) {
      keep_best(list, value_key(src[i], i));
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
  if (lane < m) ids[static_cast<size_t>(row) * m + lane] = key_id(mine);
  if (lane == m - 1) tau[row] = src[key_id(mine)];
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
        key[j] = p < b ? value_key(v.x, p) : 0ull;
        key[j + 1] = p < b ? value_key(v.y, p + 1) : 0ull;
        key[j + 2] = p < b ? value_key(v.z, p + 2) : 0ull;
        key[j + 3] = p < b ? value_key(v.w, p + 3) : 0ull;
      }
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      key[j] = p0 + j < b ? value_key(src[p0 + j], p0 + j) : 0ull;
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
              make_int4(key_id(key[j]), key_id(key[j + 1]),
                        key_id(key[j + 2]), key_id(key[j + 3]));
        }
      }
      stored = true;
    }
  }
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int p = p0 + j;
    if (!stored && p < m) out[p] = key_id(key[j]);
    if (p == m - 1) tau[row] = src[key_id(key[j])];
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
    key[i] = i < b ? value_key(src[i], i) : 0ull;
  }
  __syncthreads();
  sort_keys_desc(key, width);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    ids[row * m + i] = key_id(key[i]);
  }
  if (threadIdx.x == 0) tau[row] = src[key_id(key[m - 1])];
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

constexpr int kCandWarps = 8;                      // warps a block
constexpr int kCandThreads = kCandWarps * 32;
constexpr int kCandStep = 128;                     // pool entries a warp step

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
  const int* table;        // (K, R): the hash table transposed, or null
  const long long* coeffs; // (R,) or null
  int n, r_count, b, m, ell, num_classes, shift, t, k, kcap, num_splits;
  Key* part;               // (n, num_splits, kcap)
  float* out_sel;          // (n, k)
  int* out_band;           // (n, k)
  int* out_idx;            // (n, k)
};

// Where a warp's walk stands: chunk c (inverted row r0 * B + bucket) and
// its step s, kCandStep entries a step.
struct Pos {
  int c, s, r0, bucket;
};

// Chunk c's first step; r0 and the bucket id are found once a chunk.
__device__ __forceinline__ Pos chunk_at(int c, int m,
                                        const int* __restrict__ ids_q,
                                        int live) {
  Pos p{c, 0, 0, 0};
  if (c < live) {
    p.r0 = c / m;
    p.bucket = __ldg(ids_q + c);
  }
  return p;
}

__device__ __forceinline__ Pos advance(const Pos& p, int steps, int stride,
                                       int m, const int* __restrict__ ids_q,
                                       int live) {
  if (p.s + 1 < steps) return Pos{p.c, p.s + 1, p.r0, p.bucket};
  return chunk_at(p.c + stride, m, ids_q, live);
}

// A lane's four entries of step p: one 16-byte load when the rows allow
// it; -1 past the row's end or the walk's.
__device__ __forceinline__ int4 fetch(const CandArgs& a, const Pos& p,
                                      int live, int lane, bool vec) {
  int4 v = make_int4(-1, -1, -1, -1);
  if (p.c >= live) return v;
  const int* row =
      a.inverted + (static_cast<size_t>(p.r0) * a.b + p.bucket) * a.ell;
  const int slot = p.s * kCandStep + 4 * lane;
  if (vec) {
    if (slot < a.ell) v = __ldg(reinterpret_cast<const int4*>(row + slot));
    return v;
  }
  if (slot < a.ell) v.x = __ldg(row + slot);
  if (slot + 1 < a.ell) v.y = __ldg(row + slot + 1);
  if (slot + 2 < a.ell) v.z = __ldg(row + slot + 2);
  if (slot + 3 < a.ell) v.w = __ldg(row + slot + 3);
  return v;
}

// g[j] of class cls: the bucket from the inline hash or the transposed
// table (a class's R bucket ids side by side), the value from the query's
// probabilities.
template <bool kInline>
__device__ __forceinline__ float gather(const CandArgs& a,
                                        const float* __restrict__ p,
                                        const uint32_t* coef, int j, int cls) {
  const int h =
      kInline ? static_cast<int>((coef[j] * static_cast<uint32_t>(cls)) >>
                                 a.shift)
              : __ldg(a.table + static_cast<size_t>(cls) * a.r_count + j);
  return p[j * a.b + h];
}

// The key of a claimed entry under the median: all R values (the chunk's
// own repetition gives its bucket's value gr), their median through the
// register network — unless the pre-test shows that it cannot beat `thr`
// (its band below thr's, or fewer than R - R/2 values at or above thr's
// value): then 0.
template <bool kInline>
__device__ __forceinline__ Key median_key(const CandArgs& a,
                                          const float* __restrict__ p,
                                          const float* tau,
                                          const uint32_t* coef, int r0,
                                          float gr, int cls, Key thr) {
  float thr_v;
  int thr_band, thr_cls;
  split_key(thr, thr_v, thr_band, thr_cls);
  float g[kMaxR];
  int count = 1, at_least = 0;
#pragma unroll
  for (int j = 0; j < kMaxR; ++j) {
    float x = CUDART_INF_F;               // pads sort last
    if (j < a.r_count) {
      x = j == r0 ? gr : gather<kInline>(a, p, coef, j, cls);
      count += j > r0 && x >= tau[j];
      at_least += x >= thr_v;
    }
    g[j] = x;
  }
  const int band = (a.t <= 1 || count >= a.t) ? kValid : kBackfill;
  if (band < thr_band ||
      (band == thr_band && at_least < a.r_count - a.r_count / 2)) {
    return 0ull;
  }
  return make_key(band, sorted_median(g, a.r_count), cls);
}

// The keys of a lane's four entries of chunk (r0, bucket), 0 where dead.
// The chunk's own repetition puts every entry in the same bucket, so its
// test is one value for the whole chunk (gr >= tau[r0]).  Below r0 each
// gather is a test — an entry dies at its first member repetition — and
// the four entries' chains run side by side; a claimed entry then goes on
// to every repetition above r0, counting members.  The sum runs over r in
// order from +0.0, as the plain version's.
template <int kEst, bool kInline>
__device__ __forceinline__ void entry_keys(const CandArgs& a,
                                           const float* __restrict__ p,
                                           const float* tau,
                                           const uint32_t* coef, int4 v,
                                           const Pos& pos, Key thr,
                                           Key (&cand)[4]) {
  const int cls[4] = {v.x, v.y, v.z, v.w};
  const int r0 = pos.r0;
  const float gr = p[r0 * a.b + pos.bucket];
  const bool chunk_member = gr >= tau[r0];
  bool alive[4];
  float sum[4], lo[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    alive[u] = chunk_member && cls[u] >= 0 && cls[u] < a.num_classes;
    sum[u] = 0.f;
    lo[u] = CUDART_INF_F;
    cand[u] = 0ull;
  }
  for (int j = 0; j < r0; ++j) {
    if (!(alive[0] || alive[1] || alive[2] || alive[3])) break;
    const float tj = tau[j];
    float g[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      g[u] = alive[u] ? gather<kInline>(a, p, coef, j, cls[u]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (g[u] >= tj) alive[u] = false;
      sum[u] = __fadd_rn(sum[u], g[u]);
      lo[u] = fminf(lo[u], g[u]);
    }
  }
  if (kEst == kMedian) {
    // each round scores every lane's next claimed entry, so the warp runs
    // as many rounds as its busiest lane has claimed entries (every lane
    // of the warp reaches this loop)
    unsigned left = (alive[0] ? 1u : 0u) | (alive[1] ? 2u : 0u) |
                    (alive[2] ? 4u : 0u) | (alive[3] ? 8u : 0u);
    while (__any_sync(0xffffffffu, left != 0u)) {
      if (left != 0u) {
        const int u = __ffs(left) - 1;
        const int c = u == 0 ? cls[0] : (u == 1 ? cls[1] : (u == 2 ? cls[2]
                                                                   : cls[3]));
        const Key key = median_key<kInline>(a, p, tau, coef, r0, gr, c, thr);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          if (w == u) cand[w] = key;
        }
        left &= left - 1u;
      }
    }
    return;
  }
  if (!(alive[0] || alive[1] || alive[2] || alive[3])) return;
  int count[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    sum[u] = __fadd_rn(sum[u], gr);
    lo[u] = fminf(lo[u], gr);
    count[u] = 1;
  }
#pragma unroll 2
  for (int j = r0 + 1; j < a.r_count; ++j) {
    const float tj = tau[j];
    float g[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      g[u] = alive[u] ? gather<kInline>(a, p, coef, j, cls[u]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      sum[u] = __fadd_rn(sum[u], g[u]);
      lo[u] = fminf(lo[u], g[u]);
      count[u] += g[u] >= tj;
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (alive[u]) {
      const int band = (a.t <= 1 || count[u] >= a.t) ? kValid : kBackfill;
      cand[u] = make_key(band, kEst == kUnbiased ? sum[u] : lo[u], cls[u]);
    }
  }
}

// The warp's running top keys: 32 * kKpl of them in registers, best first
// at position p = lane * kKpl + j.  Insert x (larger than the last):
// positions past x's place take their predecessor's key.
template <int kKpl>
__device__ __forceinline__ void list_insert(Key (&list)[kKpl], Key x,
                                            int lane) {
  Key before = __shfl_up_sync(0xffffffffu, list[kKpl - 1], 1);
  if (lane == 0) before = ~0ull;
#pragma unroll
  for (int j = kKpl - 1; j >= 0; --j) {
    const Key prev = j > 0 ? list[j - 1] : before;
    list[j] = list[j] > x ? list[j] : (prev > x ? x : prev);
  }
}

// The key at warp-uniform position pos of the list.
template <int kKpl>
__device__ __forceinline__ Key list_at(const Key (&list)[kKpl], int pos) {
  Key mine = list[0];
#pragma unroll
  for (int j = 1; j < kKpl; ++j) {
    if (pos % kKpl == j) mine = list[j];
  }
  return __shfl_sync(0xffffffffu, mine, pos / kKpl);
}

// Offer the lanes' candidate keys to the list: while some lane holds one
// above the threshold (the kcap-th key), the lowest such lane's best goes
// in.  Keys are unique (a class is claimed at most once a query), so the
// list's order is the key's whatever the order of the offers.
template <int kKpl>
__device__ __forceinline__ void offer(Key (&list)[kKpl], Key& thr,
                                      Key (&cand)[4], int kcap, int lane) {
  while (true) {
    Key mine = 0ull;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (cand[u] > thr && cand[u] > mine) mine = cand[u];
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, mine != 0ull);
    if (ballot == 0u) return;
    const int src = __ffs(ballot) - 1;
    const Key x = __shfl_sync(0xffffffffu, mine, src);
    list_insert(list, x, lane);
    thr = list_at(list, kcap - 1);
    if (lane == src) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (cand[u] == x) cand[u] = 0ull;
      }
    }
  }
}

template <int kEst, bool kInline, bool kSmemProbs, int kKpl>
__global__ void __launch_bounds__(kCandThreads)
cand_warp_kernel(const CandArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float tau_s[kMaxR];
  __shared__ uint32_t coef_s[kMaxR];
  __shared__ int live_reps;
  constexpr int kList = 32 * kKpl;
  Key* lists = reinterpret_cast<Key*>(smem);                  // (warps, kList)
  float* probs = reinterpret_cast<float*>(lists + kCandWarps * kList);

  const int q = blockIdx.x, split = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rb = a.r_count * a.b;
  const float* row = a.meta + static_cast<size_t>(q) * rb;
  if (kSmemProbs) {
    if ((rb & 3) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
      for (int i = threadIdx.x; i < rb / 4; i += blockDim.x) {
        reinterpret_cast<float4*>(probs)[i] =
            __ldg(reinterpret_cast<const float4*>(row) + i);
      }
    } else {
      for (int i = threadIdx.x; i < rb; i += blockDim.x) probs[i] = row[i];
    }
  }
  if (threadIdx.x < kMaxR) {
    const bool on = threadIdx.x < a.r_count;
    tau_s[threadIdx.x] = on ? a.tau[q * a.r_count + threadIdx.x] : 0.f;
    coef_s[threadIdx.x] =
        (kInline && on) ? static_cast<uint32_t>(a.coeffs[threadIdx.x]) : 0u;
  }
  if (threadIdx.x == 0) live_reps = a.r_count;
  __syncthreads();
  const float* p = kSmemProbs ? probs : row;

  // A repetition j where every bucket is a member (tau[j] at or below the
  // row's minimum, as when m = B) is at or above every class's first member
  // repetition, so no entry of a later repetition's chunks is claimed:
  // those chunks are skipped whole.  Checked where m = B.
  if (a.m == a.b) {
    for (int j = warp; j < a.r_count; j += kCandWarps) {
      bool all = true;
      for (int i = lane; i < a.b; i += 32) all &= p[j * a.b + i] >= tau_s[j];
      if (__all_sync(0xffffffffu, all) && lane == 0) {
        atomicMin(&live_reps, j + 1);
      }
    }
    __syncthreads();
  }

  const int live = live_reps * a.m;                 // chunks that can claim
  const int steps = (a.ell + kCandStep - 1) / kCandStep;
  const int stride = gridDim.y * kCandWarps;
  const bool vec = (a.ell & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(a.inverted) & 15) == 0;
  const int* ids_q = a.ids + static_cast<size_t>(q) * a.r_count * a.m;

  Key list[kKpl];
#pragma unroll
  for (int j = 0; j < kKpl; ++j) list[j] = 0ull;
  Key thr = 0ull;
  // two steps' rows in flight ahead of the one scored
  Pos p0 = chunk_at(split * kCandWarps + warp, a.m, ids_q, live);
  Pos p1 = advance(p0, steps, stride, a.m, ids_q, live);
  int4 v0 = fetch(a, p0, live, lane, vec);
  int4 v1 = fetch(a, p1, live, lane, vec);
  while (p0.c < live) {
    const Pos p2 = advance(p1, steps, stride, a.m, ids_q, live);
    const int4 v2 = fetch(a, p2, live, lane, vec);
    Key cand[4];
    entry_keys<kEst, kInline>(a, p, tau_s, coef_s, v0, p0, thr, cand);
    offer(list, thr, cand, a.kcap, lane);
    p0 = p1;
    v0 = v1;
    p1 = p2;
    v1 = v2;
  }

  // the block's top kcap: warp 0 merges each other warp's list into its
  // own, a bitonic merge of its list with the other one reversed
#pragma unroll
  for (int j = 0; j < kKpl; ++j) lists[warp * kList + lane * kKpl + j] = list[j];
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < kCandWarps; ++w) {
#pragma unroll
    for (int j = 0; j < kKpl; ++j) {
      const Key other =
          lists[w * kList + (31 - lane) * kKpl + (kKpl - 1 - j)];
      list[j] = other > list[j] ? other : list[j];
    }
    warp_bitonic_stage<kKpl>(list, lane, kList);
  }
  Key* out = a.part + (static_cast<size_t>(q) * a.num_splits + split) * a.kcap;
#pragma unroll
  for (int j = 0; j < kKpl; ++j) {
    const int pos = lane * kKpl + j;
    if (pos < a.kcap) out[pos] = list[j];
  }
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

template <int kEst, bool kInline, bool kSmemProbs, int kKpl>
cudaError_t launch_cand(const CandArgs& a, int width, cudaStream_t stream) {
  auto kernel = cand_warp_kernel<kEst, kInline, kSmemProbs, kKpl>;
  const size_t smem =
      static_cast<size_t>(kCandWarps) * 32 * kKpl * sizeof(Key) +
      (kSmemProbs ? static_cast<size_t>(a.r_count) * a.b * sizeof(float) : 0);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.n, a.num_splits), kCandThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t merge_smem = static_cast<size_t>(width) * sizeof(Key);
  err = allow_smem(cand_merge_kernel, merge_smem);
  if (err != cudaSuccess) return err;
  cand_merge_kernel<<<a.n, kThreads, merge_smem, stream>>>(a, width);
  return cudaGetLastError();
}

template <int kEst, int kKpl>
cudaError_t launch_est(const CandArgs& a, int width, bool smem_probs,
                       cudaStream_t s) {
  if (a.table != nullptr) {
    return smem_probs ? launch_cand<kEst, false, true, kKpl>(a, width, s)
                      : launch_cand<kEst, false, false, kKpl>(a, width, s);
  }
  return smem_probs ? launch_cand<kEst, true, true, kKpl>(a, width, s)
                    : launch_cand<kEst, true, false, kKpl>(a, width, s);
}

template <int kKpl>
cudaError_t launch_kpl(const CandArgs& a, int estimator, int width,
                       bool smem_probs, cudaStream_t s) {
  switch (estimator) {
    case kUnbiased: return launch_est<kUnbiased, kKpl>(a, width, smem_probs, s);
    case kMin: return launch_est<kMin, kKpl>(a, width, smem_probs, s);
    case kMedian: return launch_est<kMedian, kKpl>(a, width, smem_probs, s);
    default: return cudaErrorInvalidValue;
  }
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
// (R*B, L) int32; table (K, R) int32 (the hash table transposed) or, when
// table is null, coeffs (R,)
// int64 holding uint32 multipliers with `shift`; estimator 0/1/2 =
// unbiased (raw sum) / min / median; part (n, num_splits, kcap) 64-bit
// scratch; out_sel (n, k) f32, out_band and out_idx (n, k) int32.  kcap
// and merge_width are powers of two with k <= kcap <= 32 * lane_keys,
// lane_keys 1 or 4 (the keys a lane holds of its warp's list), kcap <= 128
// and merge_width >= num_splits * kcap; smem_probs nonzero copies each
// query's R*B probabilities to shared memory.  Returns a cudaError_t code.
int mach_candidate_topk_launch(
    const void* meta, const void* tau, const void* ids, const void* inverted,
    int n, int r_count, int b, int m, int ell, int num_classes,
    const void* table, const void* coeffs, int shift, int estimator, int t,
    int k, int kcap, int lane_keys, int num_splits, int merge_width,
    int smem_probs, void* part, void* out_sel, void* out_band, void* out_idx,
    void* stream) {
  using namespace mach;
  if (n < 1 || r_count < 1 || r_count > kMaxR || b < 1 || m < 1 || m > b ||
      ell < 1 || num_classes < 1 || num_classes > static_cast<int>(kIdMask) ||
      t < 1 || t > r_count || k < 1 || k > kcap || kcap > kMaxKCand ||
      !is_pow2(kcap) || (lane_keys != 1 && lane_keys != 4) ||
      kcap > 32 * lane_keys || num_splits < 1 || num_splits > 65535 ||
      !is_pow2(merge_width) || merge_width < num_splits * kcap ||
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
  a.num_splits = num_splits;
  a.part = static_cast<Key*>(part);
  a.out_sel = static_cast<float*>(out_sel);
  a.out_band = static_cast<int*>(out_band);
  a.out_idx = static_cast<int*>(out_idx);
  auto s = static_cast<cudaStream_t>(stream);
  const bool sp = smem_probs != 0;
  const cudaError_t err =
      lane_keys == 1 ? launch_kpl<1>(a, estimator, merge_width, sp, s)
                     : launch_kpl<4>(a, estimator, merge_width, sp, s);
  return static_cast<int>(err);
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
