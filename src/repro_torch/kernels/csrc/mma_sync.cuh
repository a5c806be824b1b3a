// Warp-level tensor-core building blocks for Hopper (sm_90a), shared by
// kernel 10 (flash_mma.cuh, flash_attention*.cu) and kernel 4
// (mach_fused_xent_dense.cu).
//
// bf16: mma.sync.m16n8k16 (bf16 in, float32 accumulate) with operands
// read from shared memory by ldmatrix.  float32: 3xTF32 on
// mma.sync.m16n8k8.tf32 — each operand x is split into big = tf32(x) and
// small = tf32(x − big), and a product is accumulated as small·big +
// big·small, then big·big (small·small, ~2^-24 of it, is dropped).  The
// tensor core ignores the low 13 bits of a .tf32 register, so an unsplit
// float32 operand would give plain TF32.
// Tiles arrive by cp.async (16 bytes a thread, zero-filled past a
// tensor's edge).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_sync {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a · b for one 16 x 8 x 16 bf16 tile
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a · b for one 16 x 8 x 8 tf32 tile
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small (+ the ~2^-22 relative rest), both exact tf32 values
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// 3xTF32 on split operands: small·big + big·small into c_small, then
// big·big into c_big (the caller adds the two, small first into a fresh
// fragment, so no small term is truncated against a large sum)
__device__ __forceinline__ void mma_3xtf32(float (&c_big)[4],
                                           float (&c_small)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           uint32_t b_big0, uint32_t b_big1,
                                           uint32_t b_small0,
                                           uint32_t b_small1) {
  mma_tf32(c_small, a_small, b_big0, b_big1);
  mma_tf32(c_small, a_big, b_small0, b_small1);
  mma_tf32(c_big, a_big, b_big0, b_big1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace mma_sync
