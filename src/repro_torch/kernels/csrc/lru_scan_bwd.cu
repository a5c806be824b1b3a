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
// runs in float32: one thread owns one (b, d) channel and walks t from
// T-1 down to 0 with g and a_{t+1} in registers, the forward's design
// mirrored.  Neighbouring threads take neighbouring d, so every step's
// loads and stores are coalesced; kUnroll steps of a, dh and h are loaded
// ahead of the dependent updates.
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
// Only B*D threads (5,120 there) walk T, so it is latency-bound, as the
// forward is.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lru_bwd {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
lru_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                    const float* __restrict__ h0, const T* __restrict__ dh,
                    T* __restrict__ da, T* __restrict__ dx,
                    float* __restrict__ dh0, int t_len, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= d) return;
  const size_t row = static_cast<size_t>(d);
  const size_t base = static_cast<size_t>(b) * t_len * row + c;
  const float h_init = h0[static_cast<size_t>(b) * row + c];
  float g = 0.f, a_next = 0.f;
  int t = t_len - 1;
  // steps t .. t - kUnroll + 1, loads first
  for (; t - kUnroll + 1 >= 0; t -= kUnroll) {
    float av[kUnroll], dv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = t - u;
      av[u] = to_f32(a[base + s * row]);
      dv[u] = to_f32(dh[base + s * row]);
      hv[u] = s > 0 ? to_f32(h[base + (s - 1) * row]) : h_init;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = t - u;
      g = __fadd_rn(dv[u], __fmul_rn(a_next, g));
      dx[base + s * row] = from_f32<T>(g);
      da[base + s * row] = from_f32<T>(__fmul_rn(g, hv[u]));
      a_next = av[u];
    }
  }
  for (; t >= 0; --t) {
    g = __fadd_rn(to_f32(dh[base + t * row]), __fmul_rn(a_next, g));
    const float h_prev = t > 0 ? to_f32(h[base + (t - 1) * row]) : h_init;
    dx[base + t * row] = from_f32<T>(g);
    da[base + t * row] = from_f32<T>(__fmul_rn(g, h_prev));
    a_next = to_f32(a[base + t * row]);
  }
  dh0[static_cast<size_t>(b) * row + c] = __fmul_rn(a_next, g);
}

template <typename T>
cudaError_t launch(const void* a, const void* h, const void* h0,
                   const void* dh, void* da, void* dx, void* dh0, int b,
                   int t_len, int d, cudaStream_t stream) {
  dim3 grid((d + kThreads - 1) / kThreads, b);
  lru_scan_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const float*>(h0), static_cast<const T*>(dh),
      static_cast<T*>(da), static_cast<T*>(dx), static_cast<float*>(dh0),
      t_len, d);
  return cudaGetLastError();
}

}  // namespace lru_bwd

extern "C" {

// a, h, dh, da, dx (b, t_len, d) contiguous, all float32 (bf16 == 0) or
// all bfloat16 (bf16 == 1); h0, dh0 (b, d) float32.  h is the forward's
// output.  Returns a cudaError_t code.
int lru_scan_bwd_launch(const void* a, const void* h, const void* h0,
                        const void* dh, void* da, void* dx, void* dh0, int b,
                        int t_len, int d, int bf16, void* stream) {
  if (b < 1 || t_len < 1 || d < 1 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return static_cast<int>(lru_bwd::launch<__nv_bfloat16>(
        a, h, h0, dh, da, dx, dh0, b, t_len, d, s));
  }
  return static_cast<int>(
      lru_bwd::launch<float>(a, h, h0, dh, da, dx, dh0, b, t_len, d, s));
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
