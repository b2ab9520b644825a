// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel reads fp32 or bf16 activations, computes in fp32 and writes
// its output in the input type.  The dtype codes below are the ones the
// Python wrappers pass (repro_torch/kernels/build.py::DTYPE_CODES).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr float kNegInf = -1e30f;  // finite mask value, as in the TPU kernels

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float silu_f(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace rt
