// Fused implicit-GEMM NHWC Conv2D (K in {1, 3}, stride 1 or 2, pad K/2) on the
// H100's tensor cores.
//
// Replaces: src/repro/kernels/conv2d/conv2d.py::conv2d_pallas (_conv2d_kernel):
// every UNet and VAE convolution, with the fused GroupNorm(+SiLU) producer,
// the bias -> temb -> SiLU -> residual epilogue and the next GroupNorm's
// channel statistics.  Semantics: out = epilogue(conv(zero_pad(silu?(x*a+b)))),
// the affine applied to in-bounds pixels only (the padding stays zero).
//
// The conv is a GEMM of M = OH*OW output pixels (per image) by N = C_out by
// R = K*K*C_in, with the (pixel, tap, channel) patch matrix never built in
// HBM: each block gathers its A chunk straight from x and copies the matching
// rows of the HWIO weight, which is already the (R, C_out) row-major B.
//
// What bounds it on the H100.  Operations, almost everywhere: the model runs
// in fp32, and the fp32-accurate rate of the tensor cores is 495 / 3 = 165
// TFLOP/s (3xTF32, below).  At SD's 8x8 level bytes come close: a 1280->1280
// 3x3 conv at B = 2 does 3.8 GFLOP (23 us at 165 TFLOP/s) but reads a 59 MB
// weight (18 us at 3.35 TB/s), and the 2560->1280 one 7.5 GFLOP against
// 118 MB.  What each part of the design does about it:
//
// 1. Tensor cores, 3xTF32.  Products run as mma.sync m16n8k8 TF32 MMAs
//    (mma_tf32.cuh).  A single TF32 product keeps 11 significand bits, which
//    misses the repo's fp32 tolerance, so for fp32 inputs each operand is
//    split into big + small TF32 parts, in registers as its fragment is read
//    from shared memory, and three MMAs give fp32 accuracy.  The
//    tensor core truncates when it adds into its accumulator, so each 32-deep
//    chunk sums from zero into its own registers and is then added to the
//    fp32 total with an ordinary (rounded) add: the truncation stays at the
//    scale of one chunk, not of the whole reduction.  bf16 inputs take two
//    MMAs per product: a bf16 weight is exact in TF32, but the producer's
//    x*a+b (+SiLU) is not, and its emitted statistics are held to 2e-4, so A
//    is still split (A_small * B + A_big * B).
// 2. cp.async stages.  A ring of kStages chunks (32 deep) of A and B lives
//    in dynamic shared memory; the copies of chunk i + 3 are in flight while
//    the MMAs run on chunk i, with one barrier per chunk.  Where C_in % 4 == 0
//    (every conv of the two paths; C_in % 32 == 0 for all but conv_in, whose
//    C_in is 4) a 16-byte copy is 4 channels of one tap, and a pixel outside
//    the image is zero-filled (src-size 0).  Odd C_in or C_out (3, 6, ...)
//    take 4-byte copies; bf16 is loaded through registers and widened to
//    fp32 in shared memory (not on the fp32 path).
// 3. The producer x*a+b (+SiLU) once per element.  In the implicit GEMM
//    each input element enters K*K taps of every N tile's blocks, so applying
//    the producer while gathering A, as the TPU kernel does in VMEM, would
//    evaluate it 9 * C_out / BN times per element (45 at 320 channels): on
//    the tensor cores that cost more than the MMAs (0.06-0.16 of the bound
//    against 0.22-0.27 without a producer, chip_smoke.py on the H100).  For
//    fp32 inputs producer_kernel writes silu?(x*a+b) once into an fp32
//    scratch copy of x that the wrapper allocates, and the GEMM gathers from
//    that copy: its zero fill is the padding, so the affine (affine(0) =
//    b != 0) never reaches a padded pixel.  The cost is one more read and
//    write of x.  bf16 inputs apply it in their register gather, masked by
//    the same (row, tap) test that chose the load.
// 4. Split-K.  A grid of (B * M tiles, N tiles) blocks starves the card at
//    SD's 8x8 and 16x16 levels (20-80 blocks for 132 SMs, each walking
//    R = 11520-23040 alone).  The wrapper's plan (conv2d.py::plan) then cuts
//    R into slices of whole chunks, one per blockIdx.z; each slice writes its
//    fp32 tile to a workspace and splitk_epilogue_kernel sums the slices in
//    order before the epilogue, so the result stays deterministic.  Where the
//    grid already fills the card the epilogue stays fused in the main kernel.
//    Blocks of one weight slice and different images are adjacent in launch
//    order, so the weight is read from HBM about once.
// 5. Tiles that fit the channels: 128 x 128, 128 x 64, 64 x 128 (images of
//    64 pixels) and a narrow 128 x 16 for C_out <= 16, template instances of
//    one kernel, so C_out = 320 runs as 5 x 64 and C_out = 3/4 computes 16
//    columns, not 128.  (A 64 x 64 tile filled the card at SD's 16x16 level
//    unsplit, but ran it at 0.109 of the bound against 0.166 for 128 x 128
//    at the same block count: split-K of the larger tile serves better.)
//
// Statistics: the TPU carried sum / sum-of-squares across its sequential
// grid; blocks here run in no order, so each epilogue block reduces its
// tile's columns (shuffles, then shared memory, in a fixed order) into a
// per-tile partial, and stats_reduce_kernel sums the partials over the tiles
// in order.  Deterministic from run to run.

#include <algorithm>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBK = 32;        // reduction depth of one chunk (one pipeline stage)
constexpr int kStages = 4;
constexpr int kSA = kBK + 4;   // padded A row: the 32 lanes of a fragment read hit 32 banks
constexpr int kSplitRows = 16; // output rows per block of the split-K epilogue

// Warps along M and N of a BM x BN block tile; (BN + 8) % 32 is 8 or 24 for
// every BN here, so B fragment reads are conflict-free with rows BN + 8 long.
template <int BM, int BN> struct Warps;
template <> struct Warps<128, 128> { static constexpr int M = 2, N = 4; };
template <> struct Warps<128, 64> { static constexpr int M = 4, N = 2; };
template <> struct Warps<64, 128> { static constexpr int M = 2, N = 4; };
template <> struct Warps<128, 16> { static constexpr int M = 8, N = 1; };

template <typename T>
struct Conv {
  const T* x;
  const T* w;
  const float* gn_a;
  const float* gn_b;
  const float* bias;
  const float* temb;
  const T* res;
  T* out;
  float* partial;  // (B, stat tiles, 2, C_out) or null
  float* ws;       // (splits, B, P, C_out) fp32 slices, null without split-K
  int B, H, W, Cin, OH, OW, Cout, K, stride, gn_silu, act_silu;
  int R, P, m_tiles, chunks_per_split;
  int a_vec, b_vec;  // 16-byte copies of A / B (fp32, 4-aligned channels)
};

template <typename T>
__device__ __forceinline__ float finish(const Conv<T>& p, float y, int b, int n, size_t o) {
  if (p.bias != nullptr) y += p.bias[n];
  if (p.temb != nullptr) y += p.temb[b * p.Cout + n];
  if (p.act_silu) y = rt::silu_f(y);
  if (p.res != nullptr) y += rt::to_f(p.res[o]);
  return y;
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads) conv2d_kernel(const __grid_constant__ Conv<T> p) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int WM = Warps<BM, BN>::M, WN = Warps<BM, BN>::N;
  static_assert(WM * WN == kThreads / 32, "8 warps");
  constexpr int TM = BM / WM, TN = BN / WN;  // warp tile
  constexpr int MT = TM / 16, NT = TN / 8;   // MMA tiles per warp
  constexpr int SB = BN + 8;
  constexpr int kStageFloats = BM * kSA + kBK * SB;
  constexpr int kRowSegs = kBK / 4;          // 16-byte segments in one A row of a chunk
  constexpr int AJ = BM * kRowSegs / kThreads;  // of them per thread per chunk
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp % WM) * TM, wn0 = (warp / WM) * TN;
  const int b = blockIdx.x / p.m_tiles, mt_idx = blockIdx.x - b * p.m_tiles;
  const int m0 = mt_idx * BM, n0 = blockIdx.y * BN;
  const int n_chunks = (p.R + kBK - 1) / kBK;
  const int kc0 = blockIdx.z * p.chunks_per_split;
  const int nk = max(0, min(n_chunks, kc0 + p.chunks_per_split) - kc0);
  const int pad = p.K / 2, Cin = p.Cin;
  const T* xb = p.x + static_cast<size_t>(b) * p.H * p.W * Cin;
  const float* ga = p.gn_a == nullptr ? nullptr : p.gn_a + b * Cin;
  const float* gb = p.gn_b == nullptr ? nullptr : p.gn_b + b * Cin;

  const auto produce = [&](float v, int ci) {
    v = v * ga[ci] + gb[ci];
    return p.gn_silu ? rt::silu_f(v) : v;
  };
  // reduction index r -> (channel, tap row, tap column)
  const auto decode = [&](int r, int& ci, int& kh, int& kw) {
    const int tap = r / Cin;
    ci = r - tap * Cin;
    kh = tap / p.K;
    kw = tap - kh * p.K;
  };
  const auto in_image = [&](int ih, int iw) {
    return ih >= 0 && ih < p.H && iw >= 0 && iw < p.W;
  };

  // 16-byte A copies: segment a_seg (4 channels) of rows a_row + (kThreads / kRowSegs) j.
  constexpr int kRowStep = kThreads / kRowSegs;
  const int a_seg = tid % kRowSegs, a_row = tid / kRowSegs;
  int ih0[AJ], iw0[AJ];
  bool row_ok[AJ];
#pragma unroll
  for (int j = 0; j < AJ; ++j) {
    const int m = m0 + a_row + kRowStep * j;
    row_ok[j] = m < p.P;
    const int oh = m / p.OW, ow = m - oh * p.OW;
    ih0[j] = oh * p.stride - pad;
    iw0[j] = ow * p.stride - pad;
  }
  // Element-wise A (odd C_in, bf16): column e_col of rows e_row + (kThreads / kBK) j.
  constexpr int kElemStep = kThreads / kBK;
  const int e_col = tid % kBK, e_row = tid / kBK;
  const auto e_src = [&](int row, int kh, int kw, int ci, bool r_ok) -> const T* {
    const int m = m0 + row;
    const int oh = m / p.OW, ow = m - oh * p.OW;
    const int ih = oh * p.stride - pad + kh, iw = ow * p.stride - pad + kw;
    if (!(r_ok && m < p.P && in_image(ih, iw))) return nullptr;
    return xb + (static_cast<size_t>(ih) * p.W + iw) * Cin + ci;
  };

  const auto load_chunk = [&](int kc, int stage) {
    float* As = smem + stage * kStageFloats;
    float* Bs = As + BM * kSA;
    const int r0 = kc * kBK;
    if (kF32 && p.a_vec) {
      const int r = r0 + a_seg * 4;
      int ci, kh, kw;
      decode(r, ci, kh, kw);
#pragma unroll
      for (int j = 0; j < AJ; ++j) {
        const int ih = ih0[j] + kh, iw = iw0[j] + kw;
        const bool ok = r < p.R && row_ok[j] && in_image(ih, iw);
        const T* src = ok ? xb + (static_cast<size_t>(ih) * p.W + iw) * Cin + ci : p.x;
        rt::cp_async16(As + (a_row + kRowStep * j) * kSA + a_seg * 4, src, ok);
      }
    } else {
      const int r = r0 + e_col;
      int ci, kh, kw;
      decode(r, ci, kh, kw);
#pragma unroll 4
      for (int j = 0; j < BM / kElemStep; ++j) {
        const int row = e_row + kElemStep * j;
        const T* src = e_src(row, kh, kw, ci, r < p.R);
        float* dst = As + row * kSA + e_col;
        if constexpr (kF32) {
          rt::cp_async4(dst, src != nullptr ? src : p.x, src != nullptr);
        } else {
          float v = 0.f;
          if (src != nullptr) {
            v = rt::to_f(*src);
            if (ga != nullptr) v = produce(v, ci);  // bf16 only: fp32 x is produced ahead
          }
          *dst = v;
        }
      }
    }
    if (kF32 && p.b_vec) {
      constexpr int kSegs = kBK * BN / 4;  // 16-byte segments of the B chunk
#pragma unroll
      for (int q = 0; q < (kSegs + kThreads - 1) / kThreads; ++q) {
        const int s = tid + q * kThreads;
        if (kSegs % kThreads != 0 && s >= kSegs) break;
        const int kk = s / (BN / 4), n = n0 + (s % (BN / 4)) * 4, r = r0 + kk;
        const bool ok = r < p.R && n < p.Cout;
        rt::cp_async16(Bs + kk * SB + (n - n0), ok ? p.w + static_cast<size_t>(r) * p.Cout + n : p.w,
                       ok);
      }
    } else {
#pragma unroll 4
      for (int q = 0; q < kBK * BN / kThreads; ++q) {
        const int e = tid + q * kThreads;
        const int kk = e / BN, n = n0 + e % BN, r = r0 + kk;
        const bool ok = r < p.R && n < p.Cout;
        const T* src = p.w + static_cast<size_t>(r) * p.Cout + n;
        float* dst = Bs + kk * SB + (n - n0);
        if constexpr (kF32)
          rt::cp_async4(dst, ok ? src : p.w, ok);
        else
          *dst = ok ? rt::to_f(*src) : 0.f;
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const auto compute = [&](int stage) {
    const float* As = smem + stage * kStageFloats;
    const float* Bs = As + BM * kSA;
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      uint32_t a_big[MT][4], a_small[MT][4], b_big[NT][2], b_small[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* a = As + (wm0 + i * 16 + g) * kSA + ks * 8 + t;
        const float v[4] = {a[0], a[8 * kSA], a[4], a[8 * kSA + 4]};
#pragma unroll
        for (int q = 0; q < 4; ++q) rt::split_tf32(v[q], a_big[i][q], a_small[i][q]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* bp = Bs + (ks * 8 + t) * SB + wn0 + j * 8 + g;
        const float v[2] = {bp[0], bp[4 * SB]};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if constexpr (kF32)
            rt::split_tf32(v[q], b_big[j][q], b_small[j][q]);
          else
            b_big[j][q] = rt::to_tf32(v[q]);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          rt::mma_tf32(part[i][j], a_small[i], b_big[j]);
          if constexpr (kF32) rt::mma_tf32(part[i][j], a_big[i], b_small[j]);
          rt::mma_tf32(part[i][j], a_big[i], b_big[j]);
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
  };

  // The pipeline: one commit group per chunk (empty past the end), so that
  // wait_group<kStages - 2> always means "chunk i has landed".
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_chunk(kc0 + s, s);
    rt::cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    rt::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk i visible to all; every warp is done with chunk i - 1
    const int nxt = i + kStages - 1;
    if (nxt < nk) load_chunk(kc0 + nxt, nxt % kStages);
    rt::cp_async_commit();
    compute(i % kStages);
  }
  rt::cp_async_wait<0>();
  __syncthreads();  // shared memory is reused below

  if (p.ws != nullptr) {  // split-K: this slice's fp32 tile; the epilogue runs later
    float* wsb = p.ws + (static_cast<size_t>(blockIdx.z) * p.B + b) * p.P * p.Cout;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm0 + i * 16 + g + 8 * h;
        if (m >= p.P) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int n = n0 + wn0 + j * 8 + 2 * t + c;
            if (n < p.Cout) wsb[static_cast<size_t>(m) * p.Cout + n] = acc[i][j][2 * h + c];
          }
      }
    return;
  }

  float csum[NT][2], csq[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) csum[j][0] = csum[j][1] = csq[j][0] = csq[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + i * 16 + g + 8 * h;
      if (m >= p.P) continue;
      const size_t orow = (static_cast<size_t>(b) * p.P + m) * p.Cout;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + wn0 + j * 8 + 2 * t + c;
          if (n >= p.Cout) continue;
          const float y = finish(p, acc[i][j][2 * h + c], b, n, orow + n);
          p.out[orow + n] = rt::from_f<T>(y);
          csum[j][c] += y;
          csq[j][c] += y * y;
        }
    }

  if (p.partial != nullptr) {
    // Column 2t + c of MMA tile j lives in the 8 lanes with this t: fold
    // them, then the WM warps along M, in order.
    float* red = smem;  // [WM][2][BN]
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          csum[j][c] += __shfl_xor_sync(0xffffffffu, csum[j][c], off);
          csq[j][c] += __shfl_xor_sync(0xffffffffu, csq[j][c], off);
        }
    if (g == 0) {
      const int wm = warp % WM;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int nl = wn0 + j * 8 + 2 * t + c;
          red[(wm * 2 + 0) * BN + nl] = csum[j][c];
          red[(wm * 2 + 1) * BN + nl] = csq[j][c];
        }
    }
    __syncthreads();
    if (tid < 2 * BN) {
      const int s = tid / BN, nl = tid - s * BN;
      float v = 0.f;
#pragma unroll
      for (int wi = 0; wi < WM; ++wi) v += red[(wi * 2 + s) * BN + nl];
      if (n0 + nl < p.Cout)
        p.partial[((static_cast<size_t>(b) * p.m_tiles + mt_idx) * 2 + s) * p.Cout + n0 + nl] = v;
    }
  }
}

// Split-K epilogue: one thread per output channel n over kSplitRows rows of
// one image; sums the slices in order, applies the epilogue, writes the
// output and this row block's statistics partial.
template <typename T>
__global__ void splitk_epilogue_kernel(const __grid_constant__ Conv<T> p, int splits) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int mb = blockIdx.y, b = blockIdx.z;
  if (n >= p.Cout) return;
  const size_t slice = static_cast<size_t>(p.B) * p.P * p.Cout;
  const int m_end = min(p.P, (mb + 1) * kSplitRows);
  float csum = 0.f, csq = 0.f;
  for (int m = mb * kSplitRows; m < m_end; ++m) {
    const size_t o = (static_cast<size_t>(b) * p.P + m) * p.Cout + n;
    float y = 0.f;
    for (int s = 0; s < splits; ++s) y += p.ws[s * slice + o];
    y = finish(p, y, b, n, o);
    p.out[o] = rt::from_f<T>(y);
    csum += y;
    csq += y * y;
  }
  if (p.partial != nullptr) {
    const size_t base = (static_cast<size_t>(b) * gridDim.y + mb) * 2 * p.Cout + n;
    p.partial[base] = csum;
    p.partial[base + p.Cout] = csq;
  }
}

// x_hat = silu?(x * a + b) with (a, b) per (batch, channel): the producer,
// once per element, as the plain version computes it (multiply, then add).
__global__ void producer_kernel(const float* __restrict__ x, const float* __restrict__ a,
                                const float* __restrict__ b, float* __restrict__ x_hat, int n,
                                int HWC, int Cin, int silu) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int k = (i / HWC) * Cin + i % Cin;
    const float v = __fadd_rn(__fmul_rn(x[i], a[k]), b[k]);
    x_hat[i] = silu ? rt::silu_f(v) : v;
  }
}

// stats[b, s, n] = sum over row tiles of partial[b, tile, s, n], in order.
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

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T, int BM, int BN>
cudaError_t launch_tiles(Conv<T> p, float* stats, int splits, cudaStream_t st) {
  constexpr int smem = static_cast<int>(sizeof(float)) * kStages * (BM * kSA + kBK * (BN + 8));
  const auto kern = conv2d_kernel<T, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  p.m_tiles = cdiv(p.P, BM);
  p.chunks_per_split = cdiv(cdiv(p.R, kBK), splits);
  kern<<<dim3(p.B * p.m_tiles, cdiv(p.Cout, BN), splits), kThreads, smem, st>>>(p);
  int stat_tiles = p.m_tiles;
  if (splits > 1) {
    stat_tiles = cdiv(p.P, kSplitRows);
    splitk_epilogue_kernel<T><<<dim3(cdiv(p.Cout, 128), stat_tiles, p.B), 128, 0, st>>>(p, splits);
  }
  if (stats != nullptr)
    stats_reduce_kernel<<<cdiv(p.B * 2 * p.Cout, 256), 256, 0, st>>>(p.partial, stats, p.B,
                                                                     stat_tiles, p.Cout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Conv<T>& p, float* stats, int bm, int bn, int splits,
                     cudaStream_t st) {
  if (splits < 1 || (splits > 1) != (p.ws != nullptr)) return cudaErrorInvalidValue;
  if (bm == 128 && bn == 128) return launch_tiles<T, 128, 128>(p, stats, splits, st);
  if (bm == 128 && bn == 64) return launch_tiles<T, 128, 64>(p, stats, splits, st);
  if (bm == 64 && bn == 128) return launch_tiles<T, 64, 128>(p, stats, splits, st);
  if (bm == 128 && bn == 16) return launch_tiles<T, 128, 16>(p, stats, splits, st);
  return cudaErrorInvalidValue;  // not a tile of conv2d.py::TILES
}

template <typename T>
cudaError_t run(const void* x, const void* w, const void* gn_a, const void* gn_b,
                const void* bias, const void* temb, const void* res, void* out, void* partial,
                void* stats, void* ws, void* x_hat, int B, int H, int W, int Cin, int OH, int OW,
                int Cout, int K, int stride, int gn_silu, int act_silu, int bm, int bn,
                int splits, cudaStream_t st) {
  const auto f = [](const void* q) { return static_cast<const float*>(q); };
  const auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  if (sizeof(T) == 4 && gn_a != nullptr) {  // fp32: the producer runs ahead, once per element
    const long long n = static_cast<long long>(B) * H * W * Cin;
    if (x_hat == nullptr || n > INT32_MAX) return cudaErrorInvalidValue;
    const int blocks = static_cast<int>(std::min<long long>((n + 255) / 256, 132 * 16));
    producer_kernel<<<blocks, 256, 0, st>>>(f(x), f(gn_a), f(gn_b), static_cast<float*>(x_hat),
                                            static_cast<int>(n), H * W * Cin, Cin, gn_silu);
    x = x_hat;
    gn_a = gn_b = nullptr;
  }
  Conv<T> p{static_cast<const T*>(x), static_cast<const T*>(w), f(gn_a), f(gn_b), f(bias),
            f(temb), static_cast<const T*>(res), static_cast<T*>(out),
            static_cast<float*>(partial), static_cast<float*>(ws),
            B, H, W, Cin, OH, OW, Cout, K, stride, gn_silu, act_silu,
            K * K * Cin, OH * OW, 0, 0,
            sizeof(T) == 4 && Cin % 4 == 0 && aligned(x),
            sizeof(T) == 4 && Cout % 4 == 0 && aligned(w)};
  return dispatch(p, static_cast<float*>(stats), bm, bn, splits, st);
}

}  // namespace

extern "C" int rt_conv2d(const void* x, const void* w, const void* gn_a, const void* gn_b,
                         const void* bias, const void* temb, const void* res, void* out,
                         void* partial, void* stats, void* workspace, void* x_hat, int B, int H,
                         int W, int Cin, int OH, int OW, int Cout, int K, int stride,
                         int gn_silu, int act_silu, int bm, int bn, int splits, int dtype,
                         void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == rt::kF32
          ? run<float>(x, w, gn_a, gn_b, bias, temb, res, out, partial, stats, workspace, x_hat,
                       B, H, W, Cin, OH, OW, Cout, K, stride, gn_silu, act_silu, bm, bn, splits,
                       st)
          : run<__nv_bfloat16>(x, w, gn_a, gn_b, bias, temb, res, out, partial, stats,
                               workspace, x_hat, B, H, W, Cin, OH, OW, Cout, K, stride, gn_silu,
                               act_silu, bm, bn, splits, st);
  return static_cast<int>(err);
}
