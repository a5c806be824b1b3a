// Backward of the RG-LRU linear recurrence h_t = a_t * h_{t-1} + x_t for
// Hopper (sm_90a).
//
// The gradient of kernel 9 (lru_scan.cu), which replaces
// src/repro/kernels/lru_scan.py::lru_scan_pallas; the JAX package has no
// backward kernel and differentiates through the scan.  Given the
// forward's output h and the cotangent dh, the reverse recurrence
//
//   g_t  = dh_t + a_{t+1} * g_{t+1}      (t = T-1 .. 0, g_T = a_T = 0)
//   dx_t = g_t,   da_t = g_t * h_{t-1}   (h_{-1} = h0),   dh0 = a_0 * g_0
//
// runs in float32: lane c of a walker warp owns channel c0 + c and walks
// t from T-1 down to 0 with g and a_{t+1} in registers, the forward's
// design mirrored (lru_ring.cuh): stages are taken from the end of T, and
// a stage slot holds a, dh and h shifted by one step (row u of it is
// h_{t-1} for the slot's step t; step 0 reads h0 instead).  dx is
// written over dh and da over the shifted h in the slot, and both are
// stored as whole rows.
//
// Arithmetic: g = __fadd_rn(dh, __fmul_rn(a_next, g)) and
// da = __fmul_rn(g, h_prev) — never contracted to an FMA — in the order
// of the plain reverse loop (kernels/lru_scan.py::lru_scan_bwd_plain),
// which it equals bit for bit.  a, h, dh, da and dx share one type
// (float32 or bfloat16); h0 and dh0 are float32.
//
// What bounds it on this card: bytes.  a, h and dh are read once and da
// and dx written once, 5*B*T*D*4 bytes in float32 (plus h0 and dh0):
// 419 MB at the training shape (2, 4096, 2560), 0.125 ms at 3.35 TB/s.
// A group's fill warps keep up to 24 stages of 32 or 16 steps (6 or 3 KB
// in float32) in flight.
#include "lru_ring.cuh"

namespace lru_bwd {

using namespace lru_ring;

template <typename T, int UNIT, int SF>
__global__ void __launch_bounds__(kThreads)
lru_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                    const float* __restrict__ h0, const T* __restrict__ dh,
                    T* __restrict__ da, T* __restrict__ dx,
                    float* __restrict__ dh0, int t_len, int d, int ns) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int S = steps_of<T, SF>();
  constexpr int kRows = S * kChannels;
  const Group grp = group_of(t_len, d);
  const int lane = threadIdx.x;
  const int c = grp.c0 + lane;
  const bool walker = lane < kChannels && c < d;
  const float h_init = walker ? h0[static_cast<size_t>(grp.b) * d + c] : 0.f;
  // slot operands: a, dh (then dx), h shifted by one step (then da)
  const T* const src[3] = {a + grp.base, dh + grp.base, h + grp.base};
  const int shift[3] = {0, 0, -1};
  T* const dst[2] = {dx + grp.base, da + grp.base};
  const int out_op[2] = {1, 2};
  // stage q covers steps [t0, t0 + rows), taken from the end of T
  auto span = [&](int q) {
    const int t0 = max(0, t_len - (q + 1) * S);
    return make_int2(t0, t_len - q * S - t0);
  };
  float g = 0.f, a_next = 0.f;
  auto walk = [&](T* slot, int t0, int rows) {
    if (!walker) return;
    const T* sa = slot;
    T* sd = slot + kRows;
    T* sh = slot + 2 * kRows;
    auto step = [&](int u, float av, float dv, float hv) {
      const int e = u * kChannels + lane;
      g = __fadd_rn(dv, __fmul_rn(a_next, g));
      const float h_prev = t0 + u > 0 ? hv : h_init;
      sd[e] = from_f32<T>(g);
      sh[e] = from_f32<T>(__fmul_rn(g, h_prev));
      a_next = av;
    };
    if (rows == S) {
#pragma unroll
      for (int u0 = S - kAhead; u0 >= 0; u0 -= kAhead) {
        float av[kAhead], dv[kAhead], hv[kAhead];   // reads first, then
#pragma unroll                                      // the dependent chain
        for (int k = 0; k < kAhead; ++k) {
          const int e = (u0 + k) * kChannels + lane;
          av[k] = to_f32(sa[e]);
          dv[k] = to_f32(sd[e]);
          hv[k] = to_f32(sh[e]);
        }
#pragma unroll
        for (int k = kAhead - 1; k >= 0; --k) {
          step(u0 + k, av[k], dv[k], hv[k]);
        }
      }
    } else {
      for (int u = rows - 1; u >= 0; --u) {
        const int e = u * kChannels + lane;
        step(u, to_f32(sa[e]), to_f32(sd[e]), to_f32(sh[e]));
      }
    }
  };
  run_ring<T, UNIT, SF, 3, 2>(smem, ns, (t_len + S - 1) / S,
                          span, src, shift, dst, out_op, d, grp.c0, walk);
  if (walker) {
    dh0[static_cast<size_t>(grp.b) * d + c] = __fmul_rn(a_next, g);
  }
}

template <typename T, int UNIT, int SF>
cudaError_t launch(const void* a, const void* h, const void* h0,
                   const void* dh, void* da, void* dx, void* dh0, int b,
                   int t_len, int d, int ns, cudaStream_t stream) {
  if (ns < 2 && t_len > steps_of<T, SF>()) return cudaErrorInvalidValue;
  return launch_groups(lru_scan_bwd_kernel<T, UNIT, SF>, b, d, ns,
                       3 * steps_of<T, SF>() * kChannels * sizeof(T),
                       stream,
                       static_cast<const T*>(a), static_cast<const T*>(h),
                       static_cast<const float*>(h0), static_cast<const T*>(dh),
                       static_cast<T*>(da), static_cast<T*>(dx),
                       static_cast<float*>(dh0), t_len, d, ns);
}

}  // namespace lru_bwd

extern "C" {

// a, h, dh, da, dx (b, t_len, d) contiguous, all float32 (bf16 == 0) or
// all bfloat16 (bf16 == 1); h0, dh0 (b, d) float32.  h is the forward's
// output.  unit, steps and stages as for lru_scan_launch (the wrapper's
// scan_layout).  Returns a cudaError_t code.
int lru_scan_bwd_launch(const void* a, const void* h, const void* h0,
                        const void* dh, void* da, void* dx, void* dh0, int b,
                        int t_len, int d, int bf16, int unit, int steps,
                        int stages, void* stream) {
  if (b < 1 || t_len < 1 || d < 1 || stages < 1 ||
      stages > lru_ring::kMaxStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define LRU_BWD(T, U)                                                   \
  if (steps == lru_ring::kStepsLong) {                                  \
    err = lru_bwd::launch<T, U, lru_ring::kStepsLong>(                  \
        a, h, h0, dh, da, dx, dh0, b, t_len, d, stages, s);             \
  } else if (steps == lru_ring::kStepsShort) {                          \
    err = lru_bwd::launch<T, U, lru_ring::kStepsShort>(                 \
        a, h, h0, dh, da, dx, dh0, b, t_len, d, stages, s);             \
  }
  if (bf16) {
    if (unit == 16) LRU_BWD(__nv_bfloat16, 16)
    if (unit == 4) LRU_BWD(__nv_bfloat16, 4)
    if (unit == 2) LRU_BWD(__nv_bfloat16, 2)
  } else {
    if (unit == 16) LRU_BWD(float, 16)
    if (unit == 4) LRU_BWD(float, 4)
  }
#undef LRU_BWD
  return static_cast<int>(err);
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
