// Temporal Conv1D: a K-tap conv over the frame axis of (B, F, N, C) video
// tensors, zero-padded (pad = K/2), plus bias:
//   y[b, f, n, :] = bias + sum_k x[b, f + k - pad, n, :] @ w[k]
//
// Replaces: src/repro/kernels/conv2d/conv2d.py::temporal_conv1d_pallas
// (_tconv_kernel): the temporal convolutions of Make-A-Video's VideoUNet.
// As on the TPU, the (B, F, N, C) tensor is tiled in place, never permuted
// to (B*N, C, F) in memory.
//
// What bounds it on the H100: operations.  It is a GEMM of B*F*N rows by
// C_out columns over a reduction of K*C: at C = 640-1280 it does hundreds of
// flops per byte it must move.  This first version runs them as fp32 FMAs
// on the CUDA cores (67 TFLOP/s peak), not on the tensor cores (a later
// change).
//
// Design: the TPU kernel holds an (F, block_n, C) block of x and reuses it
// for every tap.  Here one block of 256 threads owns 16 frames x 4 spatial
// positions (64 output rows) x 128 output channels of one batch element and
// walks the C reduction in chunks of 16 channels.  For each chunk it loads
// the x window of its positions once -- the 16 frames plus the K - 1 halo
// frames, zero outside [0, F), which is the conv's zero padding -- and then,
// for each tap k, copies w[k]'s chunk (16 x 128) and accumulates: the A
// operand of tap k is the same window shifted by k frames, so x is read
// from memory once per chunk, not once per tap.  Each thread accumulates a
// 4 x 8 register tile (4 positions of one frame x 8 channels) from float4
// reads of shared memory, as conv2d.cu does; the epilogue adds the bias and
// writes the output once.  F past 16 takes more frame tiles; ragged
// positions, frames and channels are masked.

#include "common.cuh"

namespace {

constexpr int kFrames = 16, kPos = 4, BN = 128, BR = 16, kThreads = 256;
constexpr int kMaxTaps = 9;
constexpr int kWin = kFrames + kMaxTaps - 1;  // x window frames, halo included

template <typename T>
__global__ void __launch_bounds__(kThreads)
tconv_kernel(const T* __restrict__ x, const T* __restrict__ w,
             const float* __restrict__ bias, T* __restrict__ out, int F, int N, int C,
             int Cout, int K, int n_ftiles) {
  __shared__ __align__(16) float Xs[kWin][BR][kPos];
  __shared__ __align__(16) float Bs[BR][BN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kPos, c_out0 = blockIdx.y * BN;
  const int b = blockIdx.z / n_ftiles, f0 = (blockIdx.z - b * n_ftiles) * kFrames;
  const int pad = K / 2, win = kFrames + K - 1;
  const T* xb = x + static_cast<size_t>(b) * F * N * C;

  // B copy: this thread loads column b_n of reduction rows b_r0 + 2 i.
  const int b_n = tid & 127, b_r0 = tid >> 7;
  const bool col_ok = c_out0 + b_n < Cout;
  // Compute tile: frame ty (4 positions) x columns tx*4 + j and 64 + tx*4 + j.
  const int tx = tid & 15, ty = tid >> 4;

  float acc[kPos][8];
#pragma unroll
  for (int i = 0; i < kPos; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += BR) {
    // x window: (frame, position, channel), channel fastest
    for (int idx = tid; idx < win * kPos * BR; idx += kThreads) {
      const int r = idx % BR, p = (idx / BR) % kPos, fr = idx / (BR * kPos);
      const int f = f0 - pad + fr, n = n0 + p, c = c0 + r;
      float val = 0.f;
      if (f >= 0 && f < F && n < N && c < C)
        val = rt::to_f(xb[(static_cast<size_t>(f) * N + n) * C + c]);
      Xs[fr][r][p] = val;
    }
    for (int k = 0; k < K; ++k) {
      const T* wk = w + static_cast<size_t>(k) * C * Cout;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int rr = b_r0 + 2 * i, c = c0 + rr;
        Bs[rr][b_n] =
            (c < C && col_ok) ? rt::to_f(wk[static_cast<size_t>(c) * Cout + c_out0 + b_n]) : 0.f;
      }
      __syncthreads();  // also publishes this chunk's x window
#pragma unroll
      for (int rr = 0; rr < BR; ++rr) {
        // output frame f0 + ty reads input frame f0 + ty + k - pad = window row ty + k
        const float4 a4 = *reinterpret_cast<const float4*>(&Xs[ty + k][rr][0]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[rr][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[rr][64 + tx * 4]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kPos; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const int f = f0 + ty;
  if (f >= F) return;
#pragma unroll
  for (int i = 0; i < kPos; ++i) {
    const int n = n0 + i;
    if (n >= N) continue;
    const size_t orow = ((static_cast<size_t>(b) * F + f) * N + n) * Cout;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c_out0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c < Cout) out[orow + c] = rt::from_f<T>(acc[i][j] + bias[c]);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const float* bias, void* out, int B, int F, int N,
            int C, int Cout, int K, cudaStream_t st) {
  const int n_ftiles = (F + kFrames - 1) / kFrames;
  const dim3 grid((N + kPos - 1) / kPos, (Cout + BN - 1) / BN, B * n_ftiles);
  tconv_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x),
                                             static_cast<const T*>(w), bias,
                                             static_cast<T*>(out), F, N, C, Cout, K, n_ftiles);
}

}  // namespace

extern "C" int rt_temporal_conv1d(const void* x, const void* w, const void* bias, void* out,
                                  int B, int F, int N, int C, int Cout, int K, int dtype,
                                  void* stream) {
  if (K < 1 || K > kMaxTaps || K % 2 == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* bf = static_cast<const float*>(bias);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    launch<float>(x, w, bf, out, B, F, N, C, Cout, K, st);
  else
    launch<__nv_bfloat16>(x, w, bf, out, B, F, N, C, Cout, K, st);
  return static_cast<int>(cudaGetLastError());
}
