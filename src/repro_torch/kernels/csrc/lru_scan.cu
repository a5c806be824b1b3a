// RG-LRU linear recurrence h_t = a_t * h_{t-1} + x_t for Hopper (sm_90a).
//
// Replaces src/repro/kernels/lru_scan.py::lru_scan_pallas, which carried
// the state of a (batch, channel) tile in VMEM scratch across a
// sequential T grid axis.  Blocks here run in no order, so the T axis
// becomes a loop inside the thread: lane c of a walker group owns
// channel c0 + c of batch row b and walks t = 0..T-1 with h in a
// register, starting from h0[b, c0 + c] (lru_ring.cuh: a group is 16
// channels, 64 bytes of a float32 row, walked by one warp, fed by two
// and drained by one).
//
// Arithmetic: h = __fadd_rn(__fmul_rn(a, h), x) in float32 — two
// roundings, never contracted to an FMA — so the kernel equals the plain
// version's sequential loop (kernels/lru_scan.py) bit for bit.  The
// output takes x's type (float32 or bfloat16), as on the TPU.
//
// What bounds it on this card: bytes.  Each a and x element is read once
// and each h written once, 3*B*T*D*4 bytes in float32: 126 MB at the
// prefill shape (1, 4096, 2560), 0.038 ms at 3.35 TB/s.  The walk itself
// is T dependent multiply-then-add steps (about 16.5 us at T = 4,096),
// so the design's work is to feed it: narrow groups give B*D/16 walkers
// (160 at the prefill, 320 at training's B = 2), each with a ring of up
// to 24 stages of 32 or 16 steps (4 or 2 KB in float32) that its fill
// warps keep in flight by cp.async while it walks.  h is written over x
// in the stage slot and the drain warp stores it as whole 64-byte rows.
// A decode step (T = 1) is one launch of one stage per group and is
// launch-bound.
#include "lru_ring.cuh"

namespace lru {

using namespace lru_ring;

template <typename T, int UNIT, int SF>
__global__ void __launch_bounds__(kThreads)
lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                const float* __restrict__ h0, T* __restrict__ out, int t_len,
                int d, int ns) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int S = steps_of<T, SF>();
  const Group grp = group_of(t_len, d);
  const int lane = threadIdx.x;
  const int c = grp.c0 + lane;
  const bool walker = lane < kChannels && c < d;
  float h = walker ? h0[static_cast<size_t>(grp.b) * d + c] : 0.f;
  const T* const src[2] = {a + grp.base, x + grp.base};
  const int shift[2] = {0, 0};
  T* const dst[1] = {out + grp.base};
  const int out_op[1] = {1};                  // h is written over x
  auto span = [&](int q) { return make_int2(q * S, min(S, t_len - q * S)); };
  auto walk = [&](T* slot, int, int rows) {
    if (!walker) return;
    const T* sa = slot;
    T* sx = slot + S * kChannels;
    if (rows == S) {
#pragma unroll
      for (int u0 = 0; u0 < S; u0 += kAhead) {
        float av[kAhead], xv[kAhead];               // reads first, then
#pragma unroll                                      // the dependent chain
        for (int k = 0; k < kAhead; ++k) {
          av[k] = to_f32(sa[(u0 + k) * kChannels + lane]);
          xv[k] = to_f32(sx[(u0 + k) * kChannels + lane]);
        }
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          h = __fadd_rn(__fmul_rn(av[k], h), xv[k]);
          sx[(u0 + k) * kChannels + lane] = from_f32<T>(h);
        }
      }
    } else {
      for (int u = 0; u < rows; ++u) {
        const int e = u * kChannels + lane;
        h = __fadd_rn(__fmul_rn(to_f32(sa[e]), h), to_f32(sx[e]));
        sx[e] = from_f32<T>(h);
      }
    }
  };
  run_ring<T, UNIT, SF, 2, 1>(smem, ns, (t_len + S - 1) / S,
                          span, src, shift, dst, out_op, d, grp.c0, walk);
}

template <typename T, int UNIT, int SF>
cudaError_t launch(const void* a, const void* x, const void* h0, void* out,
                   int b, int t_len, int d, int ns, cudaStream_t stream) {
  if (ns < 2 && t_len > steps_of<T, SF>()) return cudaErrorInvalidValue;
  return launch_groups(lru_scan_kernel<T, UNIT, SF>, b, d, ns,
                       2 * steps_of<T, SF>() * kChannels * sizeof(T),
                       stream,
                       static_cast<const T*>(a), static_cast<const T*>(x),
                       static_cast<const float*>(h0), static_cast<T*>(out),
                       t_len, d, ns);
}

}  // namespace lru

extern "C" {

// a, x, out (b, t_len, d) contiguous, all float32 (bf16 == 0) or all
// bfloat16 (bf16 == 1); h0 (b, d) float32.  unit (16, 4 or 2 bytes),
// steps (a stage's steps in float32 units: kStepsLong or kStepsShort)
// and stages (ring slots, 1..kMaxStages, at least 2 when T spans two
// stages) come from the wrapper's scan_layout; unit 16 needs every
// pointer and d * element size 16-byte aligned, unit 4 4-byte aligned,
// unit 2 bfloat16.  Returns a cudaError_t code.
int lru_scan_launch(const void* a, const void* x, const void* h0, void* out,
                    int b, int t_len, int d, int bf16, int unit, int steps,
                    int stages, void* stream) {
  if (b < 1 || t_len < 1 || d < 1 || stages < 1 ||
      stages > lru_ring::kMaxStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define LRU_FWD(T, U)                                                      \
  if (steps == lru_ring::kStepsLong) {                                     \
    err = lru::launch<T, U, lru_ring::kStepsLong>(a, x, h0, out, b, t_len, \
                                                  d, stages, s);           \
  } else if (steps == lru_ring::kStepsShort) {                             \
    err = lru::launch<T, U, lru_ring::kStepsShort>(a, x, h0, out, b,       \
                                                   t_len, d, stages, s);   \
  }
  if (bf16) {
    if (unit == 16) LRU_FWD(__nv_bfloat16, 16)
    if (unit == 4) LRU_FWD(__nv_bfloat16, 4)
    if (unit == 2) LRU_FWD(__nv_bfloat16, 2)
  } else {
    if (unit == 16) LRU_FWD(float, 16)
    if (unit == 4) LRU_FWD(float, 4)
  }
#undef LRU_FWD
  return static_cast<int>(err);
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
