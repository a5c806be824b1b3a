// The walker groups and the cp.async ring shared by the RG-LRU scan
// kernels (lru_scan.cu, forward; lru_scan_bwd.cu, backward).
//
// A block owns one walker group: kChannels neighbouring channels of one
// batch row, kChannels * 4 = 64 bytes of a float32 row (32 bytes in
// bfloat16).  The time axis is cut into stages of steps_of<T, SF>() steps,
// and a ring of ns stage slots in shared memory carries them through
// three roles, one warp group each, that meet only at the slots'
// mbarriers:
//   - the fill warps copy a stage's operand rows into a free slot
//     (cp.async, so up to ns stages are in flight) and arrive on the
//     slot's `full` barrier when the copies land;
//   - the walker warp waits on `full`, and lane c < kChannels carries
//     channel c0 + c through the stage's steps in a register, writing its
//     results over an operand it has read; it arrives on `walked`;
//   - the drain warp waits on `walked`, reads the results into registers,
//     arrives on `empty` (the slot may be refilled) and stores them as
//     whole rows.
// So the walker's own work is the dependent chain of the recurrence and
// its shared-memory reads and writes; copies, stores and walk overlap.
// Copies and stores use the widest unit a row's alignment allows (Unit
// below; the wrapper's scan_layout picks it, and the ring's depth ns from
// the shared memory the SM's groups can share).
//
// Ragged edges run through the same code: a stage past the last step
// holds fewer rows, and the channels of the last tile past D are neither
// copied, walked into the output nor stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mach_common.cuh"

namespace lru_ring {

constexpr int kChannels = 16;    // channels a walker group owns
// steps a stage holds in float32 (twice as many in bfloat16): long stages
// while an SM holds at most two groups, short ones beyond (the wrapper's
// scan_layout chooses; the kernels take either as SF)
constexpr int kStepsLong = 32;
constexpr int kStepsShort = 16;
constexpr int kMaxStages = 24;   // stage slots in the ring, at most
constexpr int kAhead = 16;       // steps a walker reads into registers at once
constexpr int kFillers = 64;     // threads that copy (warps 1 and 2)
constexpr int kDrainer = 96;     // the first thread of the drain warp (3)
constexpr int kThreads = 128;    // the walker warp (0), fill, drain

// Bytes a copy or store moves: 16 (cp.async.cg; every row and pointer
// 16-byte aligned), 4 (cp.async.ca; 4-byte aligned) or 2 (a plain load
// and store: bfloat16 rows at odd element offsets).
enum Unit : int { kUnit16 = 16, kUnit4 = 4, kUnit2 = 2 };

template <typename T, int SF>
__host__ __device__ constexpr int steps_of() {
  return SF * 4 / static_cast<int>(sizeof(T));
}

// Elements a unit holds.
template <typename T, int UNIT>
__host__ __device__ constexpr int units_elems() {
  static_assert(UNIT >= static_cast<int>(sizeof(T)) &&
                    (kChannels * sizeof(T)) % UNIT == 0,
                "a unit holds whole elements and a row whole units");
  return UNIT / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int UNIT>
__device__ __forceinline__ void copy_unit(void* dst, const void* src) {
  const uint32_t s = smem_addr(dst);
  if constexpr (UNIT == kUnit16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else if constexpr (UNIT == kUnit4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  } else {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

// The register type of a unit.
template <int UNIT> struct UnitOf;
template <> struct UnitOf<kUnit16> { using type = uint4; };
template <> struct UnitOf<kUnit4> { using type = uint32_t; };
template <> struct UnitOf<kUnit2> { using type = uint16_t; };

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count));
}

// Arrive (release: this thread's shared-memory reads and writes before it
// are seen by whoever waits on the phase).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

// Arrive once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait (acquire) until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One walker group's place in (B, T, D): batch row b, channels
// [c0, c0 + kChannels) cut at D.
struct Group {
  size_t base;   // element offset of (b, 0, c0)
  int b, c0;
};

__device__ __forceinline__ Group group_of(int t_len, int d) {
  const int tiles = (d + kChannels - 1) / kChannels;
  Group g;
  g.b = blockIdx.x / tiles;
  g.c0 = (blockIdx.x % tiles) * kChannels;
  g.base = static_cast<size_t>(g.b) * t_len * d + g.c0;
  return g;
}

// Copy rows [0, rows) of NOPS operands into a stage slot ([NOPS][S][kChannels]
// elements): operand k's row u is step t0 + u + shift[k] of src[k] (rows
// before step 0 are skipped).  Filler li of kFillers takes a share.
template <typename T, int UNIT, int SF, int NOPS>
__device__ __forceinline__ void load_stage(T* slot, const T* const (&src)[NOPS],
                                           const int (&shift)[NOPS], int t0,
                                           int rows, int d, int c0, int li) {
  constexpr int S = steps_of<T, SF>();
  constexpr int kEpu = units_elems<T, UNIT>();
  constexpr int kUpr = kChannels / kEpu;   // units a row
#pragma unroll
  for (int k = 0; k < NOPS; ++k) {
    for (int i = li; i < rows * kUpr; i += kFillers) {
      const int u = i / kUpr, j = i % kUpr;
      const int t = t0 + u + shift[k];
      if (t >= 0 && c0 + j * kEpu < d) {
        copy_unit<UNIT>(slot + (k * S + u) * kChannels + j * kEpu,
                        src[k] + static_cast<size_t>(t) * d + j * kEpu);
      }
    }
  }
}

// The drain warp's share of a walked stage: NOUT results, result k from
// the slot's operand out_op[k] to dst[k]; rows [0, rows) from step t0.
// Lane l reads its units into registers, arrives on `empty`, then stores.
template <typename T, int UNIT, int SF, int NOUT>
__device__ __forceinline__ void drain_stage(const T* slot, uint64_t* empty,
                                            T* const (&dst)[NOUT],
                                            const int (&out_op)[NOUT], int t0,
                                            int rows, int d, int c0,
                                            int lane) {
  using U = typename UnitOf<UNIT>::type;
  constexpr int S = steps_of<T, SF>();
  constexpr int kEpu = units_elems<T, UNIT>();
  constexpr int kUpr = kChannels / kEpu;                 // units a row
  constexpr int kPer = NOUT * S * kUpr / 32;             // units a lane
  static_assert(NOUT * S * kUpr % 32 == 0, "units split over 32 lanes");
  // unit i = lane + 32 q is result k = 32 q / (S kUpr) (a constant),
  // row u and unit j of the row
  U v[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int k = 32 * q / (S * kUpr);
    const int i = 32 * q % (S * kUpr) + lane;
    const int u = i / kUpr, j = i % kUpr;
    if (u < rows) {
      v[q] = *reinterpret_cast<const U*>(
          slot + (out_op[k] * S + u) * kChannels + j * kEpu);
    }
  }
  mbar_arrive(empty);
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int k = 32 * q / (S * kUpr);
    const int i = 32 * q % (S * kUpr) + lane;
    const int u = i / kUpr, j = i % kUpr;
    if (u < rows && c0 + j * kEpu < d) {
      *reinterpret_cast<U*>(dst[k] + static_cast<size_t>(t0 + u) * d +
                            j * kEpu) = v[q];
    }
  }
}

// Bytes of a ring's barriers, ahead of its slots (16-byte aligned).
__host__ __device__ constexpr int barrier_bytes(int ns) {
  return (3 * 8 * ns + 15) / 16 * 16;
}

// The ring's schedule for one group: nst stages, stage q covering steps
// [t0, t0 + rows) = span(q), NOPS operands copied in (operand k's row u
// from step t0 + u + shift[k] of src[k]) and NOUT results stored out
// (result k from the slot's operand out_op[k], to dst[k]).  The walker
// warp calls walk(slot, t0, rows) for each stage in order; its results
// must be in the slot when it returns.  smem: barrier_bytes(ns), then ns
// slots.
template <typename T, int UNIT, int SF, int NOPS, int NOUT, typename Span,
          typename Walk>
__device__ __forceinline__ void run_ring(unsigned char* smem, int ns, int nst,
                                         Span span,
                                         const T* const (&src)[NOPS],
                                         const int (&shift)[NOPS],
                                         T* const (&dst)[NOUT],
                                         const int (&out_op)[NOUT], int d,
                                         int c0, Walk walk) {
  constexpr int kSlot = NOPS * steps_of<T, SF>() * kChannels;   // elements
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* walked = full + ns;
  uint64_t* empty = walked + ns;
  T* ring = reinterpret_cast<T*>(smem + barrier_bytes(ns));
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int j = 0; j < ns; ++j) {
      mbar_init(full + j, kFillers);
      mbar_init(walked + j, 32);
      mbar_init(empty + j, 32);
    }
  }
  __syncthreads();
  if (tid < 32) {                                  // the walker warp
    for (int s = 0; s < nst; ++s) {
      const int j = s % ns;
      mbar_wait(full + j, (s / ns) & 1);
      const int2 tr = span(s);
      walk(ring + j * kSlot, tr.x, tr.y);
      mbar_arrive(walked + j);
    }
  } else if (tid < kDrainer) {                     // the fill warps
    const int li = tid - 32;
    for (int s = 0; s < nst; ++s) {
      const int j = s % ns;
      if (s >= ns) mbar_wait(empty + j, (s / ns - 1) & 1);
      const int2 tr = span(s);
      load_stage<T, UNIT, SF, NOPS>(ring + j * kSlot, src, shift, tr.x, tr.y, d,
                                c0, li);
      if constexpr (UNIT == kUnit2) {
        mbar_arrive(full + j);                     // plain copies: done
      } else {
        mbar_arrive_copies(full + j);
      }
    }
  } else {                                         // the drain warp
    for (int s = 0; s < nst; ++s) {
      const int j = s % ns;
      mbar_wait(walked + j, (s / ns) & 1);
      const int2 tr = span(s);
      drain_stage<T, UNIT, SF, NOUT>(ring + j * kSlot, empty + j, dst, out_op,
                                 tr.x, tr.y, d, c0, tid - kDrainer);
    }
  }
}

// Launch a walker-group kernel over every (b, channel tile), with ns ring
// slots of `slot_bytes` each.
template <typename Kernel, typename... Args>
inline cudaError_t launch_groups(Kernel kernel, int b, int d, int ns,
                                 size_t slot_bytes, cudaStream_t stream,
                                 Args... args) {
  const size_t smem =
      static_cast<size_t>(ns) * slot_bytes + barrier_bytes(ns);
  cudaError_t err = mach::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long groups =
      static_cast<long long>(b) * ((d + kChannels - 1) / kChannels);
  if (groups > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(groups), kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace lru_ring
