// MACH R-head cross-entropy on given logits, forward and backward, for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/mach_xent.py::mach_xent_pallas (its forward
// body _xent_fwd_body and backward body _xent_bwd_body).  For logits
// (N, R, B) and labels (N, R):
//
//   forward   loss_n = sum_r [ log sum_j exp(x_nrj - m_nr) + m_nr - x_nr,y ]
//   backward  grad_nrj = g_n * (exp(x_nrj - m_nr) / s_nr - [j == y_nr])
//
// with m the head's max and s its exp-sum, all in float32; logits are
// float32 or bfloat16 (read with __bfloat162float), the loss is float32
// and the gradient takes the logits' type (__float2bfloat16_rn), as the
// TPU kernel's out_shape gives it.  The TPU kernel picks the label by a
// one-hot contraction; the value is the same as a direct read, and a
// label outside [0, B) picks nothing there and here.
//
// Layout: one block per row n, 8 warps; warp w takes heads w, w + 8, ...
// and walks the head's B logits with its 32 lanes (neighbouring lanes on
// neighbouring logits: coalesced), reducing max and exp-sum with warp
// shuffles.  The forward writes each head's loss to shared memory and
// thread 0 sums them in r order.  Blocks map to rows one to one, so a
// ragged N needs no padding and no mask (the TPU kernel pads N to its
// block).  The second and third walks over a head re-read its 4 KB (bf16,
// B = 2048) from L1.
//
// What bounds it on this card: bytes.  The forward reads the N*R*B
// logits once (and writes N floats); the backward reads them and writes
// the gradient of the same size: at N = 8192, R = 8, B = 2048 in bf16,
// 268 MB and 537 MB, 0.080 and 0.160 ms at 3.35 TB/s.  This first kernel
// loads 2 or 4 bytes a lane, not 16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace xent {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// max and exp-sum of one head's b logits, the same in every lane
template <typename T>
__device__ __forceinline__ void head_stats(const T* __restrict__ row, int b,
                                           int lane, float& mx, float& s) {
  mx = -CUDART_INF_F;
  for (int j = lane; j < b; j += 32) mx = fmaxf(mx, to_f32(row[j]));
  mx = warp_max(mx);
  s = 0.f;
  for (int j = lane; j < b; j += 32) s += expf(to_f32(row[j]) - mx);
  s = warp_sum(s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                float* __restrict__ loss, int r_count, int b) {
  extern __shared__ float head_loss[];   // (r_count,)
  const int n = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < r_count; r += kWarps) {
    const size_t head = static_cast<size_t>(n) * r_count + r;
    const T* row = logits + head * b;
    float mx, s;
    head_stats(row, b, lane, mx, s);
    if (lane == 0) {
      const int y = labels[head];
      const float picked = (y >= 0 && y < b) ? to_f32(row[y]) : 0.f;
      head_loss[r] = (logf(s) + mx) - picked;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int r = 0; r < r_count; ++r) total += head_loss[r];
    loss[n] = total;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                const float* __restrict__ g, T* __restrict__ grad, int r_count,
                int b) {
  const int n = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float gn = g[n];
  for (int r = warp; r < r_count; r += kWarps) {
    const size_t head = static_cast<size_t>(n) * r_count + r;
    const T* row = logits + head * b;
    T* out = grad + head * b;
    float mx, s;
    head_stats(row, b, lane, mx, s);
    const int y = labels[head];
    for (int j = lane; j < b; j += 32) {
      const float p = expf(to_f32(row[j]) - mx) / s;
      out[j] = from_f32<T>(gn * (p - (j == y ? 1.f : 0.f)));
    }
  }
}

}  // namespace xent

extern "C" {

// logits (n, r, b) contiguous float32 (bf16 == 0) or bfloat16 (bf16 ==
// 1); labels (n, r) int32; loss (n,) float32.  Returns a cudaError_t code.
int mach_xent_fwd_launch(const void* logits, const void* labels, void* loss,
                         int n, int r, int b, int bf16, void* stream) {
  if (n < 1 || r < 1 || b < 1 || r > 8192) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * r;
  if (bf16) {
    xent::xent_fwd_kernel<__nv_bfloat16><<<n, xent::kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(logits),
        static_cast<const int*>(labels), static_cast<float*>(loss), r, b);
  } else {
    xent::xent_fwd_kernel<float><<<n, xent::kThreads, smem, s>>>(
        static_cast<const float*>(logits), static_cast<const int*>(labels),
        static_cast<float*>(loss), r, b);
  }
  return static_cast<int>(cudaGetLastError());
}

// logits, grad (n, r, b) of one type; labels (n, r) int32; g (n,)
// float32, the loss's cotangent.  Returns a cudaError_t code.
int mach_xent_bwd_launch(const void* logits, const void* labels,
                         const void* g, void* grad, int n, int r, int b,
                         int bf16, void* stream) {
  if (n < 1 || r < 1 || b < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    xent::xent_bwd_kernel<__nv_bfloat16><<<n, xent::kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits),
        static_cast<const int*>(labels), static_cast<const float*>(g),
        static_cast<__nv_bfloat16*>(grad), r, b);
  } else {
    xent::xent_bwd_kernel<float><<<n, xent::kThreads, 0, s>>>(
        static_cast<const float*>(logits), static_cast<const int*>(labels),
        static_cast<const float*>(g), static_cast<float*>(grad), r, b);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mach_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
