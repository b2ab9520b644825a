// GroupNorm (+ optional SiLU) over channels-last (B, N, C) activations.
//
// Replaces: src/repro/kernels/groupnorm_silu/groupnorm_silu.py::groupnorm_silu_pallas
// (_gn_kernel), the SpatialTransformer input norm of the UNet.
//
// What bounds it on the H100: bytes.  It does ~8 flops per element against 8
// bytes (fp32 read + write), far below the ~20 flop/byte fp32 ridge.
//
// Design: one block per (group, batch) walks the group's N x C/G slab twice:
// the first pass accumulates sum and sum of squares in registers and reduces
// them across the block (warp shuffles, then one shared-memory round); the
// second pass normalises with the one-pass variance E[x^2] - mean^2 (as the
// TPU kernel does), applies scale/bias and SiLU, and writes.  The second read
// of a slab (<= 160 KB on the main path) is served from the 50 MB L2.  With
// B=2 and 32 groups that is 64 blocks on 132 SMs: the card is half idle, a
// known cost left to a later change (split each group over several blocks).

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_kernel(const T* __restrict__ x, const float* __restrict__ scale,
          const float* __restrict__ bias, T* __restrict__ y, int N, int C, int G,
          float eps, int silu) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int cpg = C / G;
  const int count = N * cpg;
  const size_t base = static_cast<size_t>(b) * N * C + static_cast<size_t>(g) * cpg;

  float s = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int n = i / cpg, j = i - n * cpg;
    const float v = rt::to_f(x[base + static_cast<size_t>(n) * C + j]);
    s += v;
    s2 += v * v;
  }
  __shared__ float red[2][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = rt::warp_sum(s);
  s2 = rt::warp_sum(s2);
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? red[0][lane] : 0.f;
    s2 = lane < kThreads / 32 ? red[1][lane] : 0.f;
    s = rt::warp_sum(s);
    s2 = rt::warp_sum(s2);
    if (lane == 0) {
      red[0][0] = s;
      red[1][0] = s2;
    }
  }
  __syncthreads();
  const float mean = red[0][0] / count;
  const float var = red[1][0] / count - mean * mean;
  const float rstd = 1.0f / sqrtf(var + eps);

  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int n = i / cpg, j = i - n * cpg;
    const size_t off = base + static_cast<size_t>(n) * C + j;
    const int c = g * cpg + j;
    float v = (rt::to_f(x[off]) - mean) * rstd;
    v = v * scale[c] + bias[c];
    if (silu) v = rt::silu_f(v);
    y[off] = rt::from_f<T>(v);
  }
}

template <typename T>
void launch(const void* x, const float* scale, const float* bias, void* y, int B,
            int N, int C, int G, float eps, int silu, cudaStream_t stream) {
  gn_kernel<T><<<dim3(G, B), kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), N, C, G, eps, silu);
}

}  // namespace

extern "C" int rt_groupnorm_silu(const void* x, const void* scale, const void* bias,
                                 void* y, int B, int N, int C, int G, float eps,
                                 int silu, int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  if (dtype == rt::kF32)
    launch<float>(x, sc, bi, y, B, N, C, G, eps, silu, st);
  else
    launch<__nv_bfloat16>(x, sc, bi, y, B, N, C, G, eps, silu, st);
  return static_cast<int>(cudaGetLastError());
}
