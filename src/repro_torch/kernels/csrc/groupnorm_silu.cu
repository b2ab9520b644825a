// GroupNorm (+ optional SiLU) over channels-last (B, N, C) activations.
//
// Replaces: src/repro/kernels/groupnorm_silu/groupnorm_silu.py::groupnorm_silu_pallas
// (_gn_kernel), the SpatialTransformer input norm of the UNet.
//
// What bounds it on the H100: bytes.  It does ~8 flops per element against
// one read and one write of it, far below the ~20 flop/byte fp32 ridge, so
// the least it can move is x once in and y once out.
//
// Design (the launch plan, chunk width, cluster size, rows per block, shared
// memory and whether rows are re-read, is computed in Python:
// kernels/groupnorm_silu/groupnorm_silu.py::plan, and passed in):
// 1. C is cut into chunks of whole groups (at most 8, each a multiple of 4
//    channels where the group width allows), so every thread loads 4
//    neighbouring channels of a row as one vector (16 bytes in fp32, 8 in
//    bf16), neighbouring threads on neighbouring addresses.  A thread keeps
//    the same 4 channels for all its rows (row lanes x column vectors).
// 2. Each (chunk, batch) is a thread-block cluster of up to 8 blocks that
//    split its N rows.  A block loads its rows of the chunk once, keeps them
//    in shared memory, and sums x and x^2 per channel in registers.
// 3. Per-channel sums are folded over the row lanes, then over each group's
//    channels, in a fixed order; the cluster adds its blocks' group partials
//    through distributed shared memory in rank order, so every block gets the
//    same bits, and two launches on one input give identical results.
// 4. The variance is the one-pass E[x^2] - mean^2 in fp32, as on the TPU;
//    each block normalises its rows from shared memory, applies scale, bias
//    and SiLU, and writes: x is read from HBM once.  A slab whose rows do not
//    fit the cluster's shared memory takes the plan's re-read path: the
//    second pass reads its rows from global memory again.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// V neighbouring elements as floats: one 16-byte (fp32) or 8-byte (bf16)
// access for V = 4, a scalar for V = 1.
template <typename T, int V>
struct Vec {
  static __device__ __forceinline__ void load(const T* p, float (&v)[V]) {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = rt::to_f(p[e]);
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[V]) {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = rt::from_f<T>(v[e]);
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&a);
    u.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

struct Params {
  const void* x;
  const float* scale;
  const float* bias;
  void* y;
  int N, C, cpg;  // rows, channels, channels per group
  int gpc, W;     // groups per chunk, chunk width (channels)
  int rpb;        // rows per block
  int cached;     // rows kept in shared memory (1) or re-read (0)
  float eps;
  int silu;
};

// Grid (cluster, chunks, B), cluster (cluster, 1, 1): block rank r of the
// cluster of chunk blockIdx.y and batch blockIdx.z owns rows [r*rpb, (r+1)*rpb).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) gn_kernel(const Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int chunk = blockIdx.y, b = blockIdx.z;
  const int W = p.W, gpc = p.gpc, cpg = p.cpg;
  const int WV = W / V;                          // column vectors of a row
  const int CT = WV < kThreads ? WV : kThreads;  // threads across a row
  const int R = kThreads / CT;                   // row lanes
  const int rl = threadIdx.x / CT, ct = threadIdx.x - rl * CT;
  const bool active = rl < R;
  const int r0 = rank * p.rpb;
  const int nr = max(0, min(p.N, r0 + p.rpb) - r0);
  const size_t base = (static_cast<size_t>(b) * p.N + r0) * p.C + static_cast<size_t>(chunk) * W;
  const T* x = static_cast<const T*>(p.x) + base;
  T* y = static_cast<T*>(p.y) + base;

  extern __shared__ __align__(16) unsigned char smem[];
  T* cache = reinterpret_cast<T*>(smem);
  const size_t cache_bytes =
      p.cached ? (static_cast<size_t>(p.rpb) * W * sizeof(T) + 15) & ~size_t(15) : 0;
  float* part = reinterpret_cast<float*>(smem + cache_bytes);  // [2][R][W]: sums, sums of squares
  float* gpart = part + 2 * R * W;                             // [2][gpc]: read by the cluster
  float* stat = gpart + 2 * gpc;                               // [2][gpc]: mean, 1/std

  // -- 1. one read of the rows: cache them, sum x and x^2 per channel -------
  if (active) {
    for (int cv = ct; cv < WV; cv += CT) {
      float s[V], s2[V];
#pragma unroll
      for (int e = 0; e < V; ++e) s[e] = s2[e] = 0.f;
#pragma unroll 4
      for (int r = rl; r < nr; r += R) {
        float v[V];
        Vec<T, V>::load(x + static_cast<size_t>(r) * p.C + cv * V, v);
        if (p.cached) Vec<T, V>::store(cache + r * W + cv * V, v);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          s[e] += v[e];
          s2[e] += v[e] * v[e];
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        part[rl * W + cv * V + e] = s[e];
        part[(R + rl) * W + cv * V + e] = s2[e];
      }
    }
  }
  __syncthreads();

  // -- 2. fixed-order folds: row lanes per channel, channels per group ------
  for (int c = threadIdx.x; c < W; c += kThreads) {
    float a = 0.f, q = 0.f;
    for (int l = 0; l < R; ++l) {
      a += part[l * W + c];
      q += part[(R + l) * W + c];
    }
    part[c] = a;  // only this thread reads or writes column c here
    part[R * W + c] = q;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < gpc; j += kThreads) {
    float a = 0.f, q = 0.f;
    for (int c = j * cpg; c < (j + 1) * cpg; ++c) {
      a += part[c];
      q += part[R * W + c];
    }
    gpart[j] = a;
    gpart[gpc + j] = q;
  }
  // -- 3. the cluster's partials, added in rank order through DSMEM ---------
  cluster.sync();
  for (int j = threadIdx.x; j < gpc; j += kThreads) {
    float a = 0.f, q = 0.f;
    for (int k = 0; k < cs; ++k) {
      const float* rp = cluster.map_shared_rank(gpart, k);
      a += rp[j];
      q += rp[gpc + j];
    }
    const float count = static_cast<float>(p.N * cpg);
    const float mean = a / count;
    const float var = q / count - mean * mean;  // one-pass, as the TPU kernel
    stat[j] = mean;
    stat[gpc + j] = 1.0f / sqrtf(var + p.eps);
  }
  cluster.sync();  // every remote read done before any block moves on or exits

  // -- 4. normalise, scale, bias, SiLU; write --------------------------------
  if (!active) return;
  for (int cv = ct; cv < WV; cv += CT) {
    float mean[V], rstd[V], sc[V], bi[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int c = cv * V + e, j = c / cpg;
      mean[e] = stat[j];
      rstd[e] = stat[gpc + j];
      sc[e] = p.scale[chunk * W + c];
      bi[e] = p.bias[chunk * W + c];
    }
#pragma unroll 4
    for (int r = rl; r < nr; r += R) {
      float v[V];
      if (p.cached)
        Vec<T, V>::load(cache + r * W + cv * V, v);
      else
        Vec<T, V>::load(x + static_cast<size_t>(r) * p.C + cv * V, v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float t = (v[e] - mean[e]) * rstd[e];
        t = t * sc[e] + bi[e];
        v[e] = p.silu ? rt::silu_f(t) : t;
      }
      Vec<T, V>::store(y + static_cast<size_t>(r) * p.C + cv * V, v);
    }
  }
}

template <typename T, int V>
int launch(const Params& p, int B, int cluster, int smem, cudaStream_t stream) {
  auto kern = gn_kernel<T, V>;
  static int smem_set = -1;  // the opt-in above 48 KB, raised once per size
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, p.C / p.W, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kern, p));
}

}  // namespace

// The plan's fields (groupnorm_silu.py::plan) come in as arguments: groups
// per chunk, vector width (4 or 1), cluster size, rows per block, whether
// rows stay in shared memory, and the shared-memory bytes of a block.
extern "C" int rt_groupnorm_silu(const void* x, const void* scale, const void* bias, void* y,
                                 int B, int N, int C, int G, int gpc, int vec, int cluster,
                                 int rpb, int cached, int smem, float eps, int silu, int dtype,
                                 void* stream) {
  const int cpg = C / G;
  const Params p{x, static_cast<const float*>(scale), static_cast<const float*>(bias), y, N, C,
                 cpg, gpc, gpc * cpg, rpb, cached, eps, silu};
  if (C % G || G % gpc || (vec != 1 && vec != 4) || p.W % vec || cluster < 1 || cluster > 8 ||
      static_cast<long long>(cluster) * rpb < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == rt::kF32)
    err = vec == 4 ? launch<float, 4>(p, B, cluster, smem, st)
                   : launch<float, 1>(p, B, cluster, smem, st);
  else
    err = vec == 4 ? launch<__nv_bfloat16, 4>(p, B, cluster, smem, st)
                   : launch<__nv_bfloat16, 1>(p, B, cluster, smem, st);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
