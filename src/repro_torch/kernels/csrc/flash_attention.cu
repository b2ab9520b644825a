// FlashAttention-2 forward over (B, S, H, D) operands read through strides,
// on the H100's tensor cores.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
// (_fa_kernel): UNet self/cross attention and the text encoder's attention.
//
// What bounds it on the H100: operations.  At Sq = Skv = 4096 the kernel
// does 4*Sq*Skv*D flops per head against (3+1)*S*D*4 bytes, thousands of
// flops per byte.  Both products run on the tensor cores as 3xTF32
// (mma_tf32.cuh): fp32-accurate work at 495 / 3 = 165 TFLOP/s, against 67
// for fp32 FMAs on the CUDA cores.  What each part of the design does:
//
// 1. Warps own query rows.  A block of 4 warps takes 64 query rows of one
//    (head, batch); warp w owns rows 16w..16w+15.  Its 16 x BK score tile
//    S = Q.K^T lives in m16n8k8 accumulator fragments (lane 4g+t holds rows
//    g and g+8, keys 2t and 2t+1 of each 8-key tile), so the row max of the
//    online softmax is two xor shuffles across the quad, the row sum is kept
//    per lane and folded once at the end, and the rescale of the 16 x D O
//    accumulator stays in registers.  The only block barrier is the K/V
//    stage ring's, one per key tile.
// 2. 3xTF32 for both products.  One TF32 product keeps 11 significand bits
//    and misses the fp32 tolerance, so fp32 Q, K, P and V are each split
//    into big + small TF32 parts in registers as their fragments are read,
//    and each product takes three MMAs.  The tensor core truncates when it
//    adds into its accumulator, so each 32-deep chunk (of D for S, of keys
//    for P.V) sums from zero and is added to the fp32 total with a rounded
//    add, as conv2d.cu does.  bf16 Q, K and V are exact in TF32: S takes one
//    MMA and P.V two (P split, V whole), 495 / 1.5 = 330 TFLOP/s.
// 3. P goes from the C layout to the A layout without shuffles.  The C
//    fragment of S holds keys 2t and 2t+1 of rows g and g+8; the A fragment
//    of P.V wants k = t and t+4.  A sum over keys does not depend on their
//    order, so key 2t serves as k = t and key 2t+1 as k = t+4 (a0 = c0,
//    a1 = c2, a2 = c1, a3 = c3), and V's B fragment reads the same keys
//    (b0 = V[2t][g], b1 = V[2t+1][g]).  The probabilities never leave
//    registers.  P.V runs keys outer and head-dim tiles inner, each tile
//    with its own accumulator, so up to 10 MMA chains run side by side;
//    heads past 80 take passes of 4 tiles, since beside Q and O (each D/2
//    registers a lane) no more accumulators fit (D = 160 still spills).
// 4. K/V through a cp.async ring of two stages: the copies of tile j+1 are
//    in flight while tile j runs.  16-byte copies where D % 4 == 0 and the
//    row strides and pointers allow (every main-path shape); 4-byte copies
//    otherwise; bf16 goes through registers and is widened to fp32 in
//    shared memory.  Rows are DP + 4 floats long (DP = D rounded up to 8),
//    which makes every fragment read conflict-free.  Tiles are 64 keys for
//    DP <= 96 and 32 above, so D = 160 takes 84 KB: two blocks per SM.
// 5. Q is read once per block, unscaled, straight into registers in the A
//    fragment layout (pre-scaling would make bf16 Q inexact in TF32);
//    scale * log2(e) is one multiply per score and the softmax uses ex2.approx.
// 6. Head dims: an instance for every multiple of 8 up to 256; a ragged D
//    is zero-filled up to the next one in shared memory and registers.
//
// Semantics, as on the TPU:
//   * Keys past Skv score -1e30; query rows past Sq are not written.
//   * Causal and local-window masks use absolute query positions offset by
//     kv_offset; key tiles that the mask empties for the whole block are
//     skipped, and a warp whose 16 rows need no mask in a tile skips the
//     mask arithmetic.  Rows of a block that skipped every tile give 0.
//   * GQA: the kv head is h / (H / KVH), read in place.
//   * Statistics and the O accumulator are fp32.

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kWarps = 4, kThreads = 32 * kWarps, BQ = 16 * kWarps;
constexpr int kStages = 2;
constexpr int kChunk = 4;  // MMA k-steps (32 deep) summed from zero before a rounded add
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Tile {
  static constexpr int ND = DP / 8;                // 8-wide head-dim chunks
  static constexpr int BK = DP <= 96 ? 64 : 32;    // keys per K/V tile
  static constexpr int NT = BK / 8;                // 8-key tiles
  // head-dim tiles per pass of P.V over the keys: their accumulators live
  // beside Q and O, so heads wider than 80 take passes of 4 tiles
  static constexpr int kGroupN = ND <= 10 ? ND : 4;
  static constexpr int RS = DP + 4;                // row stride, = 4 (mod 8)
  static constexpr int kStageFloats = 2 * BK * RS; // K tile then V tile
  static constexpr int kSmem = static_cast<int>(sizeof(float)) * kStages * kStageFloats;
};

struct Params {
  const void *q, *k, *v;
  void* o;
  int Sq, Skv, H, KVH, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  float scale_log2;  // scale * log2(e)
  int causal, window, kv_offset;
  int vec;  // 16-byte K/V copies (fp32, D % 4 == 0, aligned rows)
};

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }

// 2^v in one MUFU.EX2 (flush to zero below 2^-126, where p vanishes anyway)
__device__ __forceinline__ float exp2_ftz(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) fa_kernel(const __grid_constant__ Params p) {
  using Cfg = Tile<DP>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int ND = Cfg::ND, BK = Cfg::BK, NT = Cfg::NT, RS = Cfg::RS;
  constexpr int kGroupN = Cfg::kGroupN;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int Sq = p.Sq, Skv = p.Skv, D = p.D;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // Q fragments of this warp's 16 rows, unscaled: qf[c] = rows (g, g+8) x
  // columns (8c + t, 8c + t + 4), zero past Sq and D.
  float qf[ND][4];
  const int r0 = q0 + 16 * warp + g;
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 8 * (i & 1), d = 8 * c + t + 4 * (i >> 1);
      qf[c][i] = r < Sq && d < D ? rt::to_f(qb[r * p.q_ss + d]) : 0.f;
    }

  // Key tiles: the block-uniform skips leave a contiguous range [t_lo, t_hi).
  const int q_lo = q0 + p.kv_offset, q_hi = q_lo + BQ - 1;
  const auto keep = [&](int tile) {
    const int kv0 = tile * BK, kv_hi = kv0 + BK - 1;
    if (p.causal && q_hi < kv0) return false;
    if (p.window > 0 && q_lo - kv_hi >= p.window) return false;
    return true;
  };
  int t_lo = 0, t_hi = (Skv + BK - 1) / BK;
  while (t_lo < t_hi && !keep(t_lo)) ++t_lo;
  while (t_hi > t_lo && !keep(t_hi - 1)) --t_hi;
  const int n_tiles = t_hi - t_lo;

  const auto load_tile = [&](int tile, int stage) {
    float* Ks = smem + stage * Cfg::kStageFloats;
    float* Vs = Ks + BK * RS;
    const int kv0 = tile * BK;
    if (kF32 && p.vec) {
      constexpr int kSegs = DP / 4;  // 16-byte segments of one row
#pragma unroll
      for (int q = 0; q < (BK * kSegs + kThreads - 1) / kThreads; ++q) {
        const int s = tid + q * kThreads;
        if ((BK * kSegs) % kThreads != 0 && s >= BK * kSegs) break;
        const int r = s / kSegs, c = (s - r * kSegs) * 4;
        const bool ok = kv0 + r < Skv && c < D;
        const long long row = kv0 + r;
        rt::cp_async16(Ks + r * RS + c, ok ? kb + row * p.k_ss + c : kb, ok);
        rt::cp_async16(Vs + r * RS + c, ok ? vb + row * p.v_ss + c : vb, ok);
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < BK * DP; e += kThreads) {
        const int r = e / DP, c = e - r * DP;
        const bool ok = kv0 + r < Skv && c < D;
        const long long row = kv0 + r;
        if constexpr (kF32) {
          rt::cp_async4(Ks + r * RS + c, ok ? kb + row * p.k_ss + c : kb, ok);
          rt::cp_async4(Vs + r * RS + c, ok ? vb + row * p.v_ss + c : vb, ok);
        } else {
          Ks[r * RS + c] = ok ? rt::to_f(kb[row * p.k_ss + c]) : 0.f;
          Vs[r * RS + c] = ok ? rt::to_f(vb[row * p.v_ss + c]) : 0.f;
        }
      }
    }
  };

  // Softmax state of rows g (index 0) and g + 8 (index 1), in log2 units;
  // l is this lane's share of the row sum, folded across the quad at the end.
  float m[2] = {rt::kNegInf, rt::kNegInf}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  const int row_abs = r0 + p.kv_offset;           // absolute position of row g
  const int w_lo = q0 + 16 * warp + p.kv_offset;  // this warp's rows, absolute

  const auto compute = [&](int tile, int stage) {
    const float* Ks = smem + stage * Cfg::kStageFloats;
    const float* Vs = Ks + BK * RS;
    const int kv0 = tile * BK;

    // S = Q.K^T, in chunks of kChunk head-dim steps summed from zero
    float x[NT][4];
#pragma unroll
    for (int c0 = 0; c0 < ND; c0 += kChunk) {
      float part[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
#pragma unroll
      for (int c = c0; c < (c0 + kChunk < ND ? c0 + kChunk : ND); ++c) {
        uint32_t a_big[4];
        [[maybe_unused]] uint32_t a_small[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kF32)
            rt::split_tf32(qf[c][i], a_big[i], a_small[i]);
          else
            a_big[i] = bits(qf[c][i]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* kp = Ks + (8 * j + g) * RS + 8 * c + t;
          const float v2[2] = {kp[0], kp[4]};
          uint32_t b_big[2];
          [[maybe_unused]] uint32_t b_small[2];
          if constexpr (kF32) {
            rt::split_tf32(v2[0], b_big[0], b_small[0]);
            rt::split_tf32(v2[1], b_big[1], b_small[1]);
            rt::mma_tf32(part[j], a_small, b_big);
            rt::mma_tf32(part[j], a_big, b_small);
          } else {
            b_big[0] = bits(v2[0]);
            b_big[1] = bits(v2[1]);
          }
          rt::mma_tf32(part[j], a_big, b_big);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) x[j][i] = c0 == 0 ? part[j][i] : x[j][i] + part[j][i];
    }

    // scores in log2 units, masked where this warp's rows need it
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) x[j][i] *= p.scale_log2;
    const bool need_mask = kv0 + BK > Skv || (p.causal && kv0 + BK - 1 > w_lo) ||
                           (p.window > 0 && w_lo + 15 - kv0 >= p.window);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = kv0 + 8 * j + 2 * t + (i & 1), row = row_abs + 8 * (i >> 1);
          bool ok = col < Skv;
          if (p.causal) ok = ok && col <= row;
          if (p.window > 0) ok = ok && row - col < p.window;
          if (!ok) x[j][i] = rt::kNegInf;
        }
    }

    // online softmax: row max over the quad, rescale, probabilities
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(x[j][2 * r], x[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = exp2_ftz(m[r] - mx);
      m[r] = mx;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x[j][2 * r + e] = exp2_ftz(x[j][2 * r + e] - mx);
          rs += x[j][2 * r + e];
        }
      l[r] = l[r] * alpha[r] + rs;
    }

    // O = alpha * O + P.V.  Keys outer, a group of head-dim tiles inner: each
    // tile of the group has its own accumulator, so the group's MMA chains
    // run side by side; every kChunk key tiles the chunk is added to O.
#pragma unroll
    for (int n0 = 0; n0 < ND; n0 += kGroupN) {
      float part[kGroupN][4];
#pragma unroll
      for (int nn = 0; nn < kGroupN; ++nn)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[nn][i] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // P as an A fragment: key 2t is k = t, key 2t + 1 is k = t + 4
        const float a[4] = {x[j][0], x[j][2], x[j][1], x[j][3]};
        uint32_t p_big[4], p_small[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) rt::split_tf32(a[i], p_big[i], p_small[i]);
#pragma unroll
        for (int nn = 0; nn < kGroupN; ++nn) {
          const int n = n0 + nn;
          if (n >= ND) break;
          const float* vp = Vs + (8 * j + 2 * t) * RS + 8 * n + g;
          const float v2[2] = {vp[0], vp[RS]};
          uint32_t b_big[2];
          [[maybe_unused]] uint32_t b_small[2];
          if constexpr (kF32) {
            rt::split_tf32(v2[0], b_big[0], b_small[0]);
            rt::split_tf32(v2[1], b_big[1], b_small[1]);
            rt::mma_tf32(part[nn], p_big, b_small);
          } else {
            b_big[0] = bits(v2[0]);
            b_big[1] = bits(v2[1]);
          }
          rt::mma_tf32(part[nn], p_small, b_big);
          rt::mma_tf32(part[nn], p_big, b_big);
        }
        if ((j + 1) % kChunk == 0 || j == NT - 1) {
#pragma unroll
          for (int nn = 0; nn < kGroupN; ++nn) {
            const int n = n0 + nn;
            if (n >= ND) break;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              o[n][i] = j < kChunk ? fmaf(o[n][i], alpha[i >> 1], part[nn][i])
                                   : o[n][i] + part[nn][i];
              part[nn][i] = 0.f;
            }
          }
        }
      }
    }
  };

  // The ring: one commit group per tile (empty past the end), so that
  // wait_group<kStages - 2> means "tile i has landed".
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(t_lo + s, s);
    rt::cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    rt::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i visible to all; every warp is done with tile i - 1
    const int nxt = i + kStages - 1;
    if (nxt < n_tiles) load_tile(t_lo + nxt, nxt % kStages);
    rt::cp_async_commit();
    compute(t_lo + i, i % kStages);
  }
  rt::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    const float denom = lr == 0.f ? 1.f : lr;  // a block that skipped every tile gives 0
    T* orow = static_cast<T*>(p.o) + b * p.o_sb + row * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < D) orow[d] = rt::from_f<T>(o[n][2 * r + e] / denom);
      }
  }
}

template <typename T, int DP>
cudaError_t launch(const Params& p, int B, cudaStream_t st) {
  constexpr int smem = Tile<DP>::kSmem;
  const auto kern = fa_kernel<T, DP>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((p.Sq + BQ - 1) / BQ, p.H, B), kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// One instance per head-dim width DP = 8, 16, ..., 256; D runs at the
// smallest DP >= D.
template <typename T, int DP = 8>
cudaError_t dispatch(const Params& p, int B, cudaStream_t st) {
  if constexpr (DP > 256) {
    return cudaErrorInvalidValue;
  } else {
    if (p.D <= DP) return launch<T, DP>(p, B, st);
    return dispatch<T, DP + 8>(p, B, st);
  }
}

}  // namespace

extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  int B, int Sq, int Skv, int H, int KVH, int D,
                                  const void* strides, float scale, int causal,
                                  int window, int kv_offset, int dtype, void* stream) {
  const auto* s = static_cast<const long long*>(strides);
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  bool vec = dtype == rt::kF32 && D % 4 == 0 && aligned(k) && aligned(v);
  for (int i = 3; i < 9; ++i) vec = vec && s[i] % 4 == 0;  // k and v strides
  const Params p{q, k, v, o, Sq, Skv, H, KVH, D,
                 s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
                 scale * kLog2e, causal, window, kv_offset, vec ? 1 : 0};
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == rt::kF32 ? dispatch<float>(p, B, st) : dispatch<__nv_bfloat16>(p, B, st);
  return static_cast<int>(err);
}
