// RG-LRU linear recurrence h_t = a_t * h_{t-1} + x_t for Hopper (sm_90a).
//
// Replaces src/repro/kernels/lru_scan.py::lru_scan_pallas, which carried
// the state of a (batch, channel) tile in VMEM scratch across a
// sequential T grid axis.  Blocks here run in no order, so the T axis
// becomes a loop inside the thread: one thread owns one (b, d) channel
// and walks t = 0..T-1 with h in a register, starting from h0[b, d].
// Neighbouring threads take neighbouring d, so every step's loads of a
// and x and its store of h are coalesced.
//
// Arithmetic: h = __fadd_rn(__fmul_rn(a, h), x) in float32 — two
// roundings, never contracted to an FMA — so the kernel equals the plain
// version's sequential loop (kernels/lru_scan.py) bit for bit.  The
// output takes x's type (float32 or bfloat16), as on the TPU.
//
// What bounds it on this card: bytes.  Each a and x element is read once
// and each h written once, 3*B*T*D*4 bytes in float32: 126 MB at the
// prefill shape (1, 4096, 2560), 0.038 ms at 3.35 TB/s.  The sequential
// walk leaves only B*D threads (2,560 at prefill), so the design keeps
// many loads in flight per thread instead: kUnroll steps of a and x are
// loaded ahead of the dependent updates.  A decode step (T = 1) is one
// launch of B*D threads and is launch-bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lru {

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
lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                const float* __restrict__ h0, T* __restrict__ out, int t_len,
                int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= d) return;
  const size_t row = static_cast<size_t>(d);
  const size_t base = static_cast<size_t>(b) * t_len * row + c;
  float h = h0[static_cast<size_t>(b) * row + c];
  int t = 0;
  for (; t + kUnroll <= t_len; t += kUnroll) {
    float av[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = to_f32(a[base + (t + u) * row]);
      xv[u] = to_f32(x[base + (t + u) * row]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), xv[u]);
      out[base + (t + u) * row] = from_f32<T>(h);
    }
  }
  for (; t < t_len; ++t) {
    h = __fadd_rn(__fmul_rn(to_f32(a[base + t * row]), h),
                  to_f32(x[base + t * row]));
    out[base + t * row] = from_f32<T>(h);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* x, const void* h0, void* out,
                   int b, int t_len, int d, cudaStream_t stream) {
  dim3 grid((d + kThreads - 1) / kThreads, b);
  lru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<const float*>(h0), static_cast<T*>(out), t_len, d);
  return cudaGetLastError();
}

}  // namespace lru

extern "C" {

// a, x, out (b, t_len, d) contiguous, all float32 (bf16 == 0) or all
// bfloat16 (bf16 == 1); h0 (b, d) float32.  Returns a cudaError_t code.
int lru_scan_launch(const void* a, const void* x, const void* h0, void* out,
                    int b, int t_len, int d, int bf16, void* stream) {
  if (b < 1 || t_len < 1 || d < 1 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return static_cast<int>(
        lru::launch<__nv_bfloat16>(a, x, h0, out, b, t_len, d, s));
  }
  return static_cast<int>(lru::launch<float>(a, x, h0, out, b, t_len, d, s));
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
