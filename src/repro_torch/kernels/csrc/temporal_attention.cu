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
// fp32 FMAs (67 TFLOP/s) would take over from HBM (3.35 TB/s).  So the
// design keeps many bytes in flight and hides the math under the copies.
//
// Design (the launch plan, warps per block, shared memory and grid, is
// computed in Python: kernels/flash_attention/flash_attention.py::temporal_plan):
// 1. Warps are independent.  A work item is NP = 32 / FM positions of one
//    (head, batch), FM = F rounded up to a power of two (4..32), so a stage
//    holds 32 rows of each operand and one warp holds one item.  Each warp
//    walks its own stream of items (item, item + all warps, ...) through a
//    private ring of two stages; no block barrier is needed.
// 2. Copies overlap the math.  Each stage holds the q, k and v rows of one
//    item (3 x 32 rows of RS elements, in the input type).  While the warp
//    computes item t from one stage, cp.async copies of item t+1 fill the
//    other: 16-byte copies (fp32) or 8-byte (bf16), lanes on neighbouring
//    4-element chunks of a row, where D % 4 == 0 and strides and pointers
//    allow (every main-path call); otherwise plain loads.  At F = 16, D = 64
//    in fp32 a stage is 26 KB and a block of 4 warps 204 KB: each SM keeps
//    up to 8 items (~200 KB) of copies in flight.  Rows past F, positions
//    past HW and the head dim past D (up to a multiple of 8) are zero-filled.
// 3. The math on the CUDA cores, with few shared-memory loads per FMA: a
//    16-byte load serves only 8 lanes a cycle, and the k and v rows are the
//    same for all lanes of a position, so shared-memory bandwidth rather
//    than the FMAs is what the math spends.  Lane (p, h, r) takes query rows
//    r and r + FM/2 of position p over half h of the head dim: each k or v
//    load feeds 8 FMAs, and one xor shuffle per score adds the halves.  The
//    F scores of a row stay in registers, keys at or past frames_valid score
//    -1e30 (exactly weight 0 after the full softmax, as on the TPU), and P.V
//    reads the v rows of the position.  Lanes write their output over their
//    own q elements; the warp then stores the item with the same coalesced
//    pattern it loaded.  Row strides RS = 4 (mod 8) elements keep the
//    lanes' q-row reads free of bank conflicts in fp32 at F = 16 and 32,
//    while the lanes that share a k or v read see one address.  Statistics and
//    accumulation are fp32 as on the TPU.

#include "common.cuh"
#include "mma_tf32.cuh"  // cp.async

namespace {

constexpr int kStages = 2, kMaxWarps = 4, kMaxFrames = 32;

struct Strides {
  long long b, f, n, h;
};

struct Params {
  const void *q, *k, *v;
  void* o;
  int F, HW, H, D, DP, RS;  // frames, positions, heads, head dim, head dim padded to 8, row stride
  int tiles, items;         // position tiles per (batch, head); B * H * tiles
  Strides s[4];             // q, k, v, o
  float scale;
  int frames_valid, vec;
};

// 4 neighbouring elements: as floats, and as raw 16-byte / 8-byte copies.
template <typename T>
__device__ __forceinline__ float4 ld4(const T* p);
template <>
__device__ __forceinline__ float4 ld4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 ld4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ void st4(T* p, float4 v);
template <>
__device__ __forceinline__ void st4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <>
__device__ __forceinline__ void st4<__nv_bfloat16>(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
__device__ __forceinline__ void copy4(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  else
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
}

template <typename T>
__device__ __forceinline__ void cp_async4x(T* dst, const T* src, bool valid) {
  if constexpr (sizeof(T) == 4)
    rt::cp_async16(dst, src, valid);
  else
    rt::cp_async8(dst, src, valid);
}

// Where item `item` lies: its first position n0 and the offset of its
// (batch, head) in operand `op`.
struct Item {
  int n0;
  long long off[4];
};

template <int FM>
__device__ __forceinline__ Item locate(const Params& p, int item) {
  constexpr int NP = 32 / FM;
  const int h = item % p.H, rest = item / p.H;
  const int tile = rest % p.tiles, b = rest / p.tiles;
  Item it;
  it.n0 = tile * NP;
#pragma unroll
  for (int op = 0; op < 4; ++op) it.off[op] = b * p.s[op].b + h * p.s[op].h;
  return it;
}

// The lane's walk over a stage's 32 rows x D/4 chunks, 32 chunks a step:
// row r = p*FM + f, chunk c4; calls fn(r, c4) for each.
template <typename Fn>
__device__ __forceinline__ void walk_chunks(int D4, int lane, Fn fn) {
  int r = lane / D4, c4 = lane - r * D4;
  const int rstep = 32 / D4, cstep = 32 - rstep * D4;
  while (r < 32) {
    fn(r, c4);
    r += rstep;
    c4 += cstep;
    if (c4 >= D4) {
      c4 -= D4;
      ++r;
    }
  }
}

// Copy the q, k and v rows of an item into a stage (asynchronously where vec).
template <typename T, int FM>
__device__ __forceinline__ void load_item(const Params& p, const Item& it, T* stage, int lane) {
  const T* src[3] = {static_cast<const T*>(p.q) + it.off[0], static_cast<const T*>(p.k) + it.off[1],
                     static_cast<const T*>(p.v) + it.off[2]};
  const int RS = p.RS;
  if (p.vec) {
    walk_chunks(p.DP >> 2, lane, [&](int r, int c4) {
      const int f = r & (FM - 1), n = it.n0 + r / FM;
      const bool ok = f < p.F && n < p.HW && 4 * c4 < p.D;
#pragma unroll
      for (int op = 0; op < 3; ++op) {
        const T* g = ok ? src[op] + f * p.s[op].f + n * p.s[op].n + 4 * c4 : src[op];
        cp_async4x(stage + (op * 32 + r) * RS + 4 * c4, g, ok);
      }
    });
  } else {
    for (int e = lane; e < 32 * p.DP; e += 32) {
      const int r = e / p.DP, d = e - r * p.DP;
      const int f = r & (FM - 1), n = it.n0 + r / FM;
      const bool ok = f < p.F && n < p.HW && d < p.D;
#pragma unroll
      for (int op = 0; op < 3; ++op)
        stage[(op * 32 + r) * RS + d] =
            ok ? src[op][f * p.s[op].f + n * p.s[op].n + d] : rt::from_f<T>(0.f);
    }
  }
}

// Lane (position pp, half h, r) takes query rows r and r + FM/2 of its
// position over half h of the head dim: each k and v element it loads from
// shared memory feeds both rows, and one xor shuffle adds the two halves of
// each score.  Its output rows (its half) go over the same q rows.
template <typename T, int FM>
__device__ __forceinline__ void attend(const Params& p, const Item& it, T* stage, int lane) {
  constexpr int HALF = FM / 2;
  const int pp = lane / FM, h = (lane / HALF) & 1, r = lane & (HALF - 1);
  const int RS = p.RS, DH = p.DP >> 1;
  T* q0 = stage + (pp * FM + r) * RS + h * DH;
  T* q1 = q0 + HALF * RS;
  const T* kp = stage + (32 + pp * FM) * RS + h * DH;
  const T* vp = stage + (64 + pp * FM) * RS + h * DH;
  // Every row of the stage is defined (rows past F and positions past HW are
  // zero-filled, and never stored), so no lane leaves early, the shuffles
  // see the whole warp, and the loops over keys run all FM rows unguarded:
  // their shared-memory loads go out back to back.  Keys past F, like keys at
  // or past frames_valid, score -1e30 and weigh exactly 0.
  float s0[FM], s1[FM];
#pragma unroll
  for (int j = 0; j < FM; ++j) s0[j] = s1[j] = 0.f;
  for (int d = 0; d < DH; d += 4) {
    const float4 a = ld4(q0 + d), b = ld4(q1 + d);
#pragma unroll
    for (int j = 0; j < FM; ++j) {
      const float4 c = ld4(kp + j * RS + d);
      s0[j] = fmaf(a.x, c.x, fmaf(a.y, c.y, fmaf(a.z, c.z, fmaf(a.w, c.w, s0[j]))));
      s1[j] = fmaf(b.x, c.x, fmaf(b.y, c.y, fmaf(b.z, c.z, fmaf(b.w, c.w, s1[j]))));
    }
  }
  const int valid = min(p.F, p.frames_valid);
  float m0 = rt::kNegInf, m1 = rt::kNegInf;
#pragma unroll
  for (int j = 0; j < FM; ++j) {
    // both halves: the same two addends, so the same bits in both lanes
    s0[j] += __shfl_xor_sync(0xffffffffu, s0[j], HALF);
    s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], HALF);
    s0[j] = j < valid ? s0[j] * p.scale : rt::kNegInf;
    s1[j] = j < valid ? s1[j] * p.scale : rt::kNegInf;
    m0 = fmaxf(m0, s0[j]);
    m1 = fmaxf(m1, s1[j]);
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < FM; ++j) {
    s0[j] = expf(s0[j] - m0);
    s1[j] = expf(s1[j] - m1);
    l0 += s0[j];
    l1 += s1[j];
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < FM; ++j) {
    s0[j] *= inv0;
    s1[j] *= inv1;
  }
  for (int d = 0; d < DH; d += 4) {
    float4 o0 = make_float4(0.f, 0.f, 0.f, 0.f), o1 = o0;
#pragma unroll
    for (int j = 0; j < FM; ++j) {
      const float4 c = ld4(vp + j * RS + d);
      o0.x = fmaf(s0[j], c.x, o0.x);
      o0.y = fmaf(s0[j], c.y, o0.y);
      o0.z = fmaf(s0[j], c.z, o0.z);
      o0.w = fmaf(s0[j], c.w, o0.w);
      o1.x = fmaf(s1[j], c.x, o1.x);
      o1.y = fmaf(s1[j], c.y, o1.y);
      o1.z = fmaf(s1[j], c.z, o1.z);
      o1.w = fmaf(s1[j], c.w, o1.w);
    }
    st4(q0 + d, o0);  // only this lane reads these q elements
    st4(q1 + d, o1);
  }
}

template <typename T, int FM>
__device__ __forceinline__ void store_item(const Params& p, const Item& it, const T* stage,
                                           int lane) {
  T* dst = static_cast<T*>(p.o) + it.off[3];
  const Strides so = p.s[3];
  if (p.vec) {
    walk_chunks(p.D >> 2, lane, [&](int r, int c4) {
      const int f = r & (FM - 1), n = it.n0 + r / FM;
      if (f < p.F && n < p.HW) copy4(dst + f * so.f + n * so.n + 4 * c4, stage + r * p.RS + 4 * c4);
    });
  } else {
    for (int e = lane; e < 32 * p.D; e += 32) {
      const int r = e / p.D, d = e - r * p.D;
      const int f = r & (FM - 1), n = it.n0 + r / FM;
      if (f < p.F && n < p.HW) dst[f * so.f + n * so.n + d] = stage[r * p.RS + d];
    }
  }
}

template <typename T, int FM>
__global__ void __launch_bounds__(32 * kMaxWarps)
temporal_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  // The warp index through a shuffle from lane 0: the compiler then knows it
  // (and so each warp's item loop) is the same on every lane, and compiles
  // the score shuffles as plain SHFL rather than a divergence-safe loop.
  const int lane = threadIdx.x & 31, warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int warps = blockDim.x >> 5;
  const int stride = gridDim.x * warps;  // warps in the grid
  int item = blockIdx.x * warps + warp;
  if (item >= p.items) return;
  const int stage_elems = 3 * 32 * p.RS;
  T* ring = reinterpret_cast<T*>(smem) + static_cast<size_t>(warp) * kStages * stage_elems;

  Item cur = locate<FM>(p, item);
  load_item<T, FM>(p, cur, ring, lane);
  rt::cp_async_commit();
  for (int s = 0; item < p.items; item += stride, s ^= 1) {
    T* stage = ring + s * stage_elems;
    const int next = item + stride;
    Item nxt = cur;
    if (next < p.items) {  // the next item's copies fly while this one computes
      nxt = locate<FM>(p, next);
      load_item<T, FM>(p, nxt, ring + (s ^ 1) * stage_elems, lane);
    }
    rt::cp_async_commit();
    rt::cp_async_wait<1>();  // this item's copies have landed
    __syncwarp();
    attend<T, FM>(p, cur, stage, lane);
    __syncwarp();
    store_item<T, FM>(p, cur, stage, lane);
    __syncwarp();  // the stage is free for the item after next
    cur = nxt;
  }
  rt::cp_async_wait<0>();
}

template <typename T, int FM>
int launch(const Params& p, int warps, int blocks, int smem, cudaStream_t stream) {
  auto kern = temporal_attention_kernel<T, FM>;
  static int smem_set = -1;  // the opt-in above 48 KB, raised once per size
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  kern<<<blocks, 32 * warps, smem, stream>>>(p);
  return 0;
}

template <typename T>
int dispatch(const Params& p, int fm, int warps, int blocks, int smem, cudaStream_t st) {
  switch (fm) {
    case 4: return launch<T, 4>(p, warps, blocks, smem, st);
    case 8: return launch<T, 8>(p, warps, blocks, smem, st);
    case 16: return launch<T, 16>(p, warps, blocks, smem, st);
    default: return launch<T, 32>(p, warps, blocks, smem, st);
  }
}

}  // namespace

// The plan's fields (flash_attention.py::temporal_plan) come in as arguments:
// frames rounded up to a power of two, the row stride in elements, warps per
// block, blocks, and the shared-memory bytes of a block.
extern "C" int rt_temporal_attention(const void* q, const void* k, const void* v, void* o,
                                     int B, int F, int HW, int H, int D, const void* strides,
                                     float scale, int frames_valid, int vec, int fm, int rs,
                                     int warps, int blocks, int smem, int dtype, void* stream) {
  const int dp = (D + 7) & ~7;
  const size_t elem = dtype == rt::kF32 ? 4 : 2;
  if ((fm != 4 && fm != 8 && fm != 16 && fm != 32) || F > fm || F > kMaxFrames || D > 256 ||
      rs < dp || rs % 4 || warps < 1 || warps > kMaxWarps || blocks < 1 ||
      static_cast<size_t>(smem) < size_t(warps) * kStages * 3 * 32 * rs * elem || smem > 232448 ||
      (vec && D % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = static_cast<const long long*>(strides);
  Params p{q, k, v, o, F, HW, H, D, dp, rs, 0, 0, {}, scale, frames_valid, vec};
  p.tiles = (HW + 32 / fm - 1) / (32 / fm);
  p.items = B * H * p.tiles;
  for (int op = 0; op < 4; ++op)
    p.s[op] = Strides{st[4 * op], st[4 * op + 1], st[4 * op + 2], st[4 * op + 3]};
  const auto s = static_cast<cudaStream_t>(stream);
  const int bad = dtype == rt::kF32 ? dispatch<float>(p, fm, warps, blocks, smem, s)
                                    : dispatch<__nv_bfloat16>(p, fm, warps, blocks, smem, s);
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}
