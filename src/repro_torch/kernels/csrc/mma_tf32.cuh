// Tensor-core building blocks for fp32 work on Hopper: TF32 rounding and the
// 3xTF32 split, the m16n8k8 TF32 MMA, and cp.async copies into shared memory.
//
// 3xTF32: an fp32 value v is split into big = tf32(v) and small = v - big,
// two TF32 operands that together carry 22 of fp32's 24 significand bits.
// a * b ~= a_small * b_big + a_big * b_small + a_big * b_big (the
// a_small * b_small term is below fp32's rounding), so three TF32 MMAs give a
// product as accurate as fp32 FMAs, at 495 / 3 = 165 TFLOP/s of
// fp32-accurate work on the H100 against the CUDA cores' 67.
//
// Fragment layouts of mma.m16n8k8 with .tf32 operands (PTX ISA), for lane
// = 4 * g + t of a warp:
//   A (16x8, row-major): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8x8, col-major):  b0 = B[t][g], b1 = B[t+4][g]
//   C (16x8):            c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t], c3 = C[g+8][2t+1]

#pragma once

#include <stdint.h>

namespace rt {

// fp32 -> TF32, rounded to nearest (ties away from zero), as an MMA operand.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v ~= big + small as MMA operands.  The tensor core ignores the low 13 bits
// of a TF32 operand, so adding half a TF32 ulp to v's bits makes big the
// round-half-away TF32 value (as cvt.rna, one integer add), small = v - big
// is exact in fp32, and the core's truncation of small costs at most 2^-21
// of v, with either sign.  Three ALU operations per element.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(v) + 0x1000u;
  small = __float_as_uint(v - __uint_as_float(big & 0xffffe000u));
}

// d += a * b on the tensor cores: m16n8k8, TF32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies; a copy with valid == false reads
// nothing and zero-fills its destination (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight;
// the finished copies are then visible to this thread.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace rt
