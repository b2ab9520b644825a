// Temporal attention: attention across the frame axis F of (B, F, HW, H, D)
// operands, for each (batch, spatial position, head), read and written in
// that layout through strides.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::temporal_flash_attention
// (_temporal_kernel): the temporal attention layers of Make-A-Video's
// VideoUNet.  As on the TPU, the (B, F, HW, H, D) tensors are never permuted
// in memory (the conventional path permutes to (B*HW, F, H, D) and back).
//
// What bounds it on the H100: bytes.  Per (position, head) the kernel reads
// 3*F*D and writes F*D elements and does 4*F*F*D flops: at F = 16 in fp32
// that is 4 flops per byte moved, far below the 20 flops per byte at which
// fp32 FMAs (67 TFLOP/s) would take over from HBM (3.35 TB/s).
//
// Design: one block of 128 threads per (tile of NP spatial positions, head,
// batch), NP = 128 / FM where FM is F rounded up to a power of two (the
// compile-time frame limit is 32).  The block copies the q, k and v rows of
// its positions (each row D contiguous elements, float4 / 4 x bf16 loads
// where the strides allow) into shared memory once: F*D*4 bytes per operand
// and position (4 KB at F = 16, D = 64), plus 4 floats of padding per row
// and per position, zero-filling the ragged spatial tail and the head dim
// up to a multiple of 4.  Thread (position p, frame i) then owns query row
// i: its F scores stay in registers, keys at or past frames_valid score
// -1e30 (exactly weight 0 after the full softmax, as on the TPU), and P.V
// reads the v rows of its position from shared memory.  The threads of one
// position read the same k/v element at once (a broadcast); the padding
// puts the per-thread q rows, and the two positions of a warp, on different
// banks.  Each thread writes its output row over its own q row, and the
// block stores the tile with the same coalesced pattern it loaded.
// Statistics and accumulation are fp32 as on the TPU.

#include "common.cuh"

namespace {

constexpr int kThreads = 128, kMaxFrames = 32, kPad = 4;

struct Strides {
  long long b, f, n, h;
};

template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T, int FM>
__global__ void __launch_bounds__(kThreads)
temporal_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, int F, int HW, int D,
                          Strides sq, Strides sk, Strides sv, Strides so, float scale,
                          int frames_valid, int vec) {
  constexpr int NP = kThreads / FM;
  extern __shared__ __align__(16) float smem[];
  const int DP = (D + 3) & ~3;       // head dim padded to a float4
  const int RS = DP + kPad;          // floats per frame row
  const int PS = F * RS + kPad;      // floats per position and operand
  float* Qs = smem;
  float* Ks = Qs + NP * PS;
  float* Vs = Ks + NP * PS;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * NP, h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  // -- load: (position, frame, 4-element chunk), chunk fastest -------------
  const int D4 = DP / 4, rows = NP * F;
  for (int idx = tid; idx < rows * D4; idx += kThreads) {
    const int r = idx / D4, d = (idx - r * D4) * 4;
    const int p = r / F, f = r - p * F, n = n0 + p;
    const int off = p * PS + f * RS + d;
    const T* qr = qb + f * sq.f + n * sq.n + d;
    const T* kr = kb + f * sk.f + n * sk.n + d;
    const T* vr = vb + f * sv.f + n * sv.n + d;
    if (vec) {
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), kv = qv, vv = qv;
      if (n < HW) {
        qv = load4(qr);
        kv = load4(kr);
        vv = load4(vr);
      }
      *reinterpret_cast<float4*>(Qs + off) = qv;
      *reinterpret_cast<float4*>(Ks + off) = kv;
      *reinterpret_cast<float4*>(Vs + off) = vv;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = n < HW && d + e < D;
        Qs[off + e] = ok ? rt::to_f(qr[e]) : 0.f;
        Ks[off + e] = ok ? rt::to_f(kr[e]) : 0.f;
        Vs[off + e] = ok ? rt::to_f(vr[e]) : 0.f;
      }
    }
  }
  __syncthreads();

  // -- compute: thread (p, i) owns query row i of position p ----------------
  const int p = tid / FM, i = tid - p * FM;
  if (i < F) {
    float* qrow = Qs + p * PS + i * RS;
    const float* kp = Ks + p * PS;
    const float* vp = Vs + p * PS;
    float s[FM];
#pragma unroll
    for (int j = 0; j < FM; ++j) s[j] = 0.f;
    for (int d = 0; d < DP; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int j = 0; j < FM; ++j) {
        if (j < F) {
          const float4 c = *reinterpret_cast<const float4*>(kp + j * RS + d);
          s[j] = fmaf(a.x, c.x, fmaf(a.y, c.y, fmaf(a.z, c.z, fmaf(a.w, c.w, s[j]))));
        }
      }
    }
    float m = rt::kNegInf;
#pragma unroll
    for (int j = 0; j < FM; ++j) {
      if (j < F) {
        s[j] = j < frames_valid ? s[j] * scale : rt::kNegInf;
        m = fmaxf(m, s[j]);
      }
    }
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < FM; ++j) {
      if (j < F) {
        s[j] = expf(s[j] - m);
        l += s[j];
      }
    }
    const float inv = 1.f / l;
#pragma unroll
    for (int j = 0; j < FM; ++j) s[j] *= inv;
    for (int d = 0; d < DP; d += 4) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < FM; ++j) {
        if (j < F) {
          const float4 c = *reinterpret_cast<const float4*>(vp + j * RS + d);
          acc.x = fmaf(s[j], c.x, acc.x);
          acc.y = fmaf(s[j], c.y, acc.y);
          acc.z = fmaf(s[j], c.z, acc.z);
          acc.w = fmaf(s[j], c.w, acc.w);
        }
      }
      *reinterpret_cast<float4*>(qrow + d) = acc;  // only this thread reads its q row
    }
  }
  __syncthreads();

  // -- store: the same coalesced pattern as the load ------------------------
  T* ob = o + b * so.b + h * so.h;
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int pp = r / F, f = r - pp * F, n = n0 + pp;
    if (n < HW) ob[f * so.f + n * so.n + d] = rt::from_f<T>(Qs[pp * PS + f * RS + d]);
  }
}

size_t smem_bytes(int F, int D) {
  const int fm = F <= 4 ? 4 : F <= 8 ? 8 : F <= 16 ? 16 : 32;
  const int np = kThreads / fm;
  return sizeof(float) * 3 * size_t(np) * (size_t(F) * (((D + 3) & ~3) + kPad) + kPad);
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, F, HW, H, D;
  const long long* st;  // 16 strides: q, k, v, o x (batch, frame, position, head)
  float scale;
  int frames_valid, vec;
  cudaStream_t stream;
};

template <typename T, int FM>
int launch(const Args& a) {
  const size_t smem = smem_bytes(a.F, a.D);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(temporal_attention_kernel<T, FM>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  constexpr int NP = kThreads / FM;
  const dim3 grid((a.HW + NP - 1) / NP, a.H, a.B);
  const long long* s = a.st;
  const Strides sq{s[0], s[1], s[2], s[3]}, sk{s[4], s[5], s[6], s[7]},
      sv{s[8], s[9], s[10], s[11]}, so{s[12], s[13], s[14], s[15]};
  temporal_attention_kernel<T, FM><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.F, a.HW, a.D, sq, sk, sv, so, a.scale, a.frames_valid, a.vec);
  return 0;
}

// Frame counts are rounded up to the next instantiated power of two (FM).
template <typename T>
int dispatch(const Args& a) {
  if (a.F <= 4) return launch<T, 4>(a);
  if (a.F <= 8) return launch<T, 8>(a);
  if (a.F <= 16) return launch<T, 16>(a);
  if (a.F <= kMaxFrames) return launch<T, 32>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Shared memory one launch needs: the wrapper raises before launching when
// it exceeds the card's 227 KB (F <= 32 and D <= 256 keep it in an int).
extern "C" int rt_temporal_attention_smem(int F, int D) {
  return static_cast<int>(smem_bytes(F, D));
}

extern "C" int rt_temporal_attention(const void* q, const void* k, const void* v, void* o,
                                     int B, int F, int HW, int H, int D, const void* strides,
                                     float scale, int frames_valid, int vec, int dtype,
                                     void* stream) {
  const Args a{q, k, v, o, B, F, HW, H, D, static_cast<const long long*>(strides), scale,
               frames_valid, vec, static_cast<cudaStream_t>(stream)};
  const int bad = dtype == rt::kF32 ? dispatch<float>(a) : dispatch<__nv_bfloat16>(a);
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}
