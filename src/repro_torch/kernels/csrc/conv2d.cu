// Fused implicit-GEMM NHWC Conv2D (K in {1, 3}, stride 1 or 2, pad K/2).
//
// Replaces: src/repro/kernels/conv2d/conv2d.py::conv2d_pallas (_conv2d_kernel):
// every UNet and VAE convolution, with the fused GroupNorm(+SiLU) producer,
// the bias -> temb -> SiLU -> residual epilogue and the next GroupNorm's
// channel statistics.
//
// What bounds it on the H100: operations.  A 3x3 conv at 320-1280 channels
// does hundreds of flops per byte it must move; this first version runs them
// as fp32 FMAs on the CUDA cores (67 TFLOP/s peak), not on the tensor cores
// (wgmma/TMA are later changes).
//
// Design: the conv is a GEMM of M = OH*OW output pixels (per image) by
// N = C_out by R = K*K*C_in, with the (pixel, tap, channel) patch matrix never
// built in HBM.  One block of 256 threads owns a 64-pixel x 128-channel
// output tile of one image and walks R in chunks of 16: it gathers the A
// chunk straight from x (computing each element's tap and input pixel),
// applies the producer x*a+b (+SiLU) to in-bounds pixels only and writes 0
// for the zero padding -- the semantics are conv(zero_pad(silu(x*a+b))), the
// TPU kernel's row re-zeroing and column skips -- and copies the matching
// rows of the HWIO weight, which is already the (R, C_out) row-major B
// matrix.  Each thread accumulates a 4x8 register tile from float4 reads of
// shared memory, so the inner loop is FMA-bound rather than load-bound.
// The epilogue applies bias, temb, SiLU and the residual to the fp32
// accumulator and writes the output once.
// Statistics: the TPU carried sum / sum-of-squares across its sequential
// grid; blocks here run in no order, so each block reduces its tile's
// columns (shuffle, then shared memory, in a fixed order) into a per-tile
// partial, and a second small kernel sums the partials over the tiles in
// order.  The result is deterministic from run to run.

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 128, BR = 16, kThreads = 256;
constexpr int AS = BM + 4;  // padded row of the A chunk (keeps float4 alignment)

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ gn_a, const float* __restrict__ gn_b,
              const float* __restrict__ bias, const float* __restrict__ temb,
              const T* __restrict__ res, T* __restrict__ out, float* __restrict__ partial,
              int H, int W, int Cin, int OH, int OW, int Cout, int K, int stride,
              int gn_silu, int act_silu) {
  __shared__ __align__(16) float As[BR][AS];
  __shared__ __align__(16) float Bs[BR][BN];

  const int tid = threadIdx.x;
  const int mt = blockIdx.x, nt = blockIdx.y, b = blockIdx.z;
  const int P = OH * OW;
  const int m0 = mt * BM, n0 = nt * BN;
  const int R = K * K * Cin;
  const int pad = K / 2;
  const T* xb = x + static_cast<size_t>(b) * H * W * Cin;

  // A gather: this thread loads reduction index a_r of rows a_row + 16 i.
  const int a_r = tid & 15, a_row = tid >> 4;
  int ih0[4], iw0[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + a_row + 16 * i;
    row_ok[i] = m < P;
    const int oh = m / OW, ow = m - oh * OW;
    ih0[i] = oh * stride - pad;
    iw0[i] = ow * stride - pad;
  }
  // B copy: this thread loads column b_n of reduction rows b_r0 + 2 i.
  const int b_n = tid & 127, b_r0 = tid >> 7;
  const bool col_ok = n0 + b_n < Cout;
  // Compute tile: rows ty*4 + i, columns tx*4 + j and 64 + tx*4 + j.
  const int tx = tid & 15, ty = tid >> 4;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int r0 = 0; r0 < R; r0 += BR) {
    {
      const int r = r0 + a_r;
      const bool r_ok = r < R;
      const int tap = r / Cin, ci = r - tap * Cin;
      const int kh = tap / K, kw = tap - kh * K;
      float ga = 1.f, gb = 0.f;
      if (gn_a != nullptr && r_ok) {
        ga = gn_a[b * Cin + ci];
        gb = gn_b[b * Cin + ci];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ih = ih0[i] + kh, iw = iw0[i] + kw;
        float val = 0.f;
        if (r_ok && row_ok[i] && ih >= 0 && ih < H && iw >= 0 && iw < W) {
          val = rt::to_f(xb[(static_cast<size_t>(ih) * W + iw) * Cin + ci]);
          if (gn_a != nullptr) {
            val = val * ga + gb;
            if (gn_silu) val = rt::silu_f(val);
          }
        }
        As[a_r][a_row + 16 * i] = val;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rr = b_r0 + 2 * i, r = r0 + rr;
      Bs[rr][b_n] = (r < R && col_ok) ? rt::to_f(w[static_cast<size_t>(r) * Cout + n0 + b_n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < BR; ++rr) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[rr][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[rr][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[rr][64 + tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float csum[8], csq[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) csum[j] = csq[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= P) continue;
    const size_t orow = (static_cast<size_t>(b) * P + m) * Cout;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n >= Cout) continue;
      float y = acc[i][j];
      if (bias != nullptr) y += bias[n];
      if (temb != nullptr) y += temb[b * Cout + n];
      if (act_silu) y = rt::silu_f(y);
      if (res != nullptr) y += rt::to_f(res[orow + n]);
      out[orow + n] = rt::from_f<T>(y);
      csum[j] += y;
      csq[j] += y * y;
    }
  }

  if (partial != nullptr) {
    // Rows of column tx*4+j live in the 16 threads with this tx: lanes tx and
    // tx+16 of each of the 8 warps.  Fold the lane pair, then the warps.
    __shared__ float red[kThreads / 32][2][BN];
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      csum[j] += __shfl_xor_sync(0xffffffffu, csum[j], 16);
      csq[j] += __shfl_xor_sync(0xffffffffu, csq[j], 16);
    }
    if (lane < 16) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nl = j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4;
        red[warp][0][nl] = csum[j];
        red[warp][1][nl] = csq[j];
      }
    }
    __syncthreads();
    const int s = tid >> 7, nl = tid & 127;
    float t = 0.f;
#pragma unroll
    for (int wi = 0; wi < kThreads / 32; ++wi) t += red[wi][s][nl];
    if (n0 + nl < Cout)
      partial[((static_cast<size_t>(b) * gridDim.x + mt) * 2 + s) * Cout + n0 + nl] = t;
  }
}

// stats[b, s, n] = sum over pixel tiles of partial[b, tile, s, n], in order.
__global__ void stats_reduce_kernel(const float* __restrict__ partial, float* __restrict__ stats,
                                    int B, int n_tiles, int Cout) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * 2 * Cout) return;
  const int n = idx % Cout, s = (idx / Cout) % 2, b = idx / (2 * Cout);
  float t = 0.f;
  for (int mt = 0; mt < n_tiles; ++mt)
    t += partial[((static_cast<size_t>(b) * n_tiles + mt) * 2 + s) * Cout + n];
  stats[idx] = t;
}

template <typename T>
void launch(const void* x, const void* w, const float* gn_a, const float* gn_b,
            const float* bias, const float* temb, const void* res, void* out,
            float* partial, float* stats, int B, int H, int W, int Cin, int OH, int OW,
            int Cout, int K, int stride, int gn_silu, int act_silu, cudaStream_t st) {
  const int n_tiles = (OH * OW + BM - 1) / BM;
  const dim3 grid(n_tiles, (Cout + BN - 1) / BN, B);
  conv2d_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), gn_a, gn_b, bias, temb,
      static_cast<const T*>(res), static_cast<T*>(out), partial, H, W, Cin, OH, OW, Cout,
      K, stride, gn_silu, act_silu);
  if (stats != nullptr) {
    const int n = B * 2 * Cout;
    stats_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(partial, stats, B, n_tiles, Cout);
  }
}

}  // namespace

extern "C" int rt_conv2d(const void* x, const void* w, const void* gn_a, const void* gn_b,
                         const void* bias, const void* temb, const void* res, void* out,
                         void* partial, void* stats, int B, int H, int W, int Cin, int OH,
                         int OW, int Cout, int K, int stride, int gn_silu, int act_silu,
                         int dtype, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto st = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partial);
  auto* sts = static_cast<float*>(stats);
  if (dtype == rt::kF32)
    launch<float>(x, w, f(gn_a), f(gn_b), f(bias), f(temb), res, out, part, sts, B, H, W,
                  Cin, OH, OW, Cout, K, stride, gn_silu, act_silu, st);
  else
    launch<__nv_bfloat16>(x, w, f(gn_a), f(gn_b), f(bias), f(temb), res, out, part, sts, B,
                          H, W, Cin, OH, OW, Cout, K, stride, gn_silu, act_silu, st);
  return static_cast<int>(cudaGetLastError());
}
