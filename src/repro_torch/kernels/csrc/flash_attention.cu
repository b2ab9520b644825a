// FlashAttention-2 forward over (B, S, H, D) operands read through strides.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
// (_fa_kernel): UNet self/cross attention and the text encoder's attention.
//
// What bounds it on the H100: operations.  At Sq = Skv = 4096 the kernel
// does 4*Sq*Skv*D flops per head against (3+1)*S*D*4 bytes, thousands of
// flops per byte.  This first version runs them as fp32 FMAs on the CUDA
// cores (67 TFLOP/s peak), not on the tensor cores (wgmma is a later change).
//
// Design: one block of 256 threads per (64 query rows, head, batch).  The Q
// tile stays in shared memory; K and V stream through it in tiles of 64
// keys.  Each thread owns a 4x4 patch of the 64x64 score tile (rows ty+16i,
// cols tx+16j), so the 16 threads that share a row are the 16 lanes of one
// half-warp and the row max / row sum of the online softmax are four xor
// shuffles, with no shared-memory round.  The probabilities go through
// shared memory once for the P.V product, whose output rows are the same
// rows the thread scored, so the rescale factor never leaves registers.
// Statistics and the accumulator are fp32 as on the TPU.
//   * Head dims on the main path are 40, 64, 80 and 160: the head dim is
//     zero-filled up to a multiple of 16 (a template width) in shared memory,
//     and the score loop runs over the true D only.
//   * No padded copy in HBM: ragged query/key tails are masked in the kernel
//     (rows past Sq are not written, keys past Skv score -1e30).
//   * Causal and local-window masks use absolute query positions offset by
//     kv_offset, and tiles that the mask empties are skipped, as on the TPU.
//     Rows whose every computed score is masked give 0, as on the TPU.
//   * GQA: the kv head is h / (H / KVH), read in place.

#include "common.cuh"

namespace {

constexpr int BQ = 64, BK = 64, kThreads = 256;

template <int NJ>
constexpr size_t smem_bytes() {
  constexpr int DP = 16 * NJ;
  return sizeof(float) *
         (size_t(BQ) * (DP + 1) + size_t(BK) * (DP + 1) + size_t(BK) * DP + size_t(BQ) * (BK + 1));
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int Sq, int Skv, int H, int KVH, int D,
          long long q_sb, long long q_ss, long long q_sh,
          long long k_sb, long long k_ss, long long k_sh,
          long long v_sb, long long v_ss, long long v_sh,
          long long o_sb, long long o_ss, long long o_sh,
          float scale, int causal, int window, int kv_offset) {
  constexpr int DP = 16 * NJ;  // padded head dim
  constexpr int QS = DP + 1, KS = DP + 1, PS = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* Ps = Vs + BK * DP;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int idx = tid; idx < BQ * DP; idx += kThreads) {
    const int r = idx / DP, d = idx - r * DP;
    float val = 0.f;
    if (q0 + r < Sq && d < D) val = rt::to_f(qb[(q0 + r) * q_ss + d]);
    Qs[r * QS + d] = val;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = rt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  const int q_lo = q0 + kv_offset, q_hi = q_lo + BQ - 1;
  for (int kv0 = 0; kv0 < Skv; kv0 += BK) {
    const int kv_hi = kv0 + BK - 1;
    if (causal && q_hi < kv0) continue;                    // block-uniform skips
    if (window > 0 && q_lo - kv_hi >= window) continue;
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/Ps
    for (int idx = tid; idx < BK * DP; idx += kThreads) {
      const int r = idx / DP, d = idx - r * DP;
      const bool ok = kv0 + r < Skv && d < D;
      Ks[r * KS + d] = ok ? rt::to_f(kb[(kv0 + r) * k_ss + d]) : 0.f;
      Vs[r * DP + d] = ok ? rt::to_f(vb[(kv0 + r) * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_lo + ty + 16 * i;
      float mx = rt::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + tx + 16 * j;
        bool ok = col < Skv;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && row - col < window;
        s[i][j] = ok ? s[i][j] * scale : rt::kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float vv = Vs[kk * DP + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + b * o_sb + row * o_ss + h * o_sh;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < D) orow[c] = rt::from_f<T>(acc[i][jj] / denom);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, Sq, Skv, H, KVH, D;
  const long long* st;  // 12 strides: q, k, v, o x (batch, seq, head)
  float scale;
  int causal, window, kv_offset;
  cudaStream_t stream;
};

template <typename T, int NJ>
void launch(const Args& a) {
  constexpr size_t smem = smem_bytes<NJ>();
  cudaFuncSetAttribute(fa_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  const long long* s = a.st;
  fa_kernel<T, NJ><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.Sq, a.Skv, a.H, a.KVH, a.D, s[0], s[1], s[2], s[3], s[4],
      s[5], s[6], s[7], s[8], s[9], s[10], s[11], a.scale, a.causal, a.window,
      a.kv_offset);
}

// Head dims are padded up to the next instantiated width (16 * NJ).
template <typename T>
int dispatch(const Args& a) {
  const int nj = (a.D + 15) / 16;
  if (nj <= 1) launch<T, 1>(a);
  else if (nj <= 2) launch<T, 2>(a);
  else if (nj <= 3) launch<T, 3>(a);
  else if (nj <= 4) launch<T, 4>(a);
  else if (nj <= 5) launch<T, 5>(a);
  else if (nj <= 6) launch<T, 6>(a);
  else if (nj <= 8) launch<T, 8>(a);
  else if (nj <= 10) launch<T, 10>(a);
  else if (nj <= 12) launch<T, 12>(a);
  else if (nj <= 16) launch<T, 16>(a);
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  int B, int Sq, int Skv, int H, int KVH, int D,
                                  const void* strides, float scale, int causal,
                                  int window, int kv_offset, int dtype, void* stream) {
  const Args a{q, k, v, o, B, Sq, Skv, H, KVH, D,
               static_cast<const long long*>(strides), scale, causal, window, kv_offset,
               static_cast<cudaStream_t>(stream)};
  const int bad = dtype == rt::kF32 ? dispatch<float>(a) : dispatch<__nv_bfloat16>(a);
  if (bad) return bad;
  return static_cast<int>(cudaGetLastError());
}
