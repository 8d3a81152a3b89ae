// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_fa_kernel` / `_fa_pallas`
// (mxnet_tpu/ops/pallas_kernels.py:63-178). It computes the same function,
// not the same blocks: for each (batch*head, query row)
//   s_j   = (q . k_j) * scale, masked to -1e30 past Tk and, when causal,
//           where q_offset + row < k_offset + j (global positions, runtime
//           scalars as in the TPU kernel's SMEM prefetch);
//   out   = sum_j softmax(s)_j v_j  in the input type, accumulated in f32;
//   lse   = m + log(l) in f32, l floored at 1e-30, and -1e30 (never -inf)
//           for a fully masked row.
//
// Design. One thread block per (batch*head, 64-row query tile); a loop
// inside the block walks the keys in 32-row tiles staged in shared memory
// (on the TPU the sequential k grid axis carried that loop). The
// online-softmax state (m, l, acc) lives in registers in f32: thread
// (ty, tx) = (tid / 8, tid % 8) owns query rows 4*ty .. 4*ty+3, score
// columns tx + 8j and output columns tx + 8j, and the 8 threads of a row
// group reduce row max and row sum with warp shuffles. Both products,
// q.k^T and p.v, are f32 FMAs in the kernel body. Ragged key tiles are
// zero-filled in K and V as well as masked in the scores, so garbage past
// Tk can never reach the output through 0 * NaN.
//
// What bounds it on this card: at the serving shape (B*H = 128, T = 2048,
// D = 128) the work is 4*B*H*Tq*Tk*D FLOPs against (3 inputs + 1 output)
// of bytes, far above the ridge point, so it is bound by operations. This
// first version runs them on the CUDA cores (67 TFLOP/s f32 peak), not the
// tensor cores, and visits every key tile, masked or not, as the TPU
// kernel also does. wgmma, TMA staging and causal tile skipping are later
// work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fwd.so flash_attention_fwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockM = 64;     // query rows per block
constexpr int kBlockN = 32;     // keys per shared-memory tile
constexpr int kThreads = 128;
constexpr int kGroups = 8;      // threads sharing one row group
constexpr int kRows = 4;        // query rows per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int64_t q_sbh, q_st, k_sbh, k_st, v_sbh, v_st, o_sbh, o_st;
  int tq, tk, n_qtiles;
  float scale;
  int causal, q_offset, k_offset;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((kBlockM + 2 * kBlockN) * (D + 1) + kBlockM * (kBlockN + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fa_fwd_kernel(Params p) {
  constexpr int DP = D + 1;           // padded rows: no bank conflicts
  constexpr int NP = kBlockN + 1;
  constexpr int NJ = kBlockN / kGroups;
  constexpr int DJ = D / kGroups;
  extern __shared__ float smem[];
  float* sQ = smem;                   // kBlockM x DP
  float* sK = sQ + kBlockM * DP;      // kBlockN x DP
  float* sV = sK + kBlockN * DP;      // kBlockN x DP
  float* sP = sV + kBlockN * DP;      // kBlockM x NP

  const int tid = threadIdx.x;
  const int ty = tid / kGroups;
  const int tx = tid % kGroups;
  const int64_t bh = blockIdx.x / p.n_qtiles;
  const int m0 = (blockIdx.x % p.n_qtiles) * kBlockM;

  const T* q = static_cast<const T*>(p.q) + bh * p.q_sbh;
  const T* k = static_cast<const T*>(p.k) + bh * p.k_sbh;
  const T* v = static_cast<const T*>(p.v) + bh * p.v_sbh;
  T* o = static_cast<T*>(p.out) + bh * p.o_sbh;

  for (int e = tid; e < kBlockM * D; e += kThreads) {
    const int r = e / D, c = e % D, g = m0 + r;
    sQ[r * DP + c] = g < p.tq ? to_f32(q[g * p.q_st + c]) : 0.f;
  }

  float m_i[kRows], l_i[kRows], acc[kRows][DJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int n0 = 0; n0 < p.tk; n0 += kBlockN) {
    __syncthreads();  // the previous tile's sK/sV/sP are no longer read
    for (int e = tid; e < kBlockN * D; e += kThreads) {
      const int r = e / D, c = e % D, g = n0 + r;
      const bool in = g < p.tk;
      sK[r * DP + c] = in ? to_f32(k[g * p.k_st + c]) : 0.f;
      sV[r * DP + c] = in ? to_f32(v[g * p.v_st + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows][NJ];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[kRows], kb[NJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qa[i] = sQ[(ty * kRows + i) * DP + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kb[j] = sK[(tx + kGroups * j) * DP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty * kRows + i;
      const int64_t qpos = (int64_t)p.q_offset + m0 + row;
      float blk_max = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int key = n0 + tx + kGroups * j;
        const bool ok = key < p.tk &&
                        (!p.causal || qpos >= (int64_t)p.k_offset + key);
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        blk_max = fmaxf(blk_max, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < kGroups; off <<= 1)
        blk_max = fmaxf(blk_max, __shfl_xor_sync(0xffffffffu, blk_max, off));
      const float m_new = fmaxf(m_i[i], blk_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float pj =
            s[i][j] <= 0.5f * kNegInf ? 0.f : expf(s[i][j] - m_new);
        sP[row * NP + tx + kGroups * j] = pj;
        row_sum += pj;
      }
#pragma unroll
      for (int off = 1; off < kGroups; off <<= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float corr = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * corr + row_sum;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
      m_i[i] = m_new;
    }
    __syncthreads();  // sP complete

#pragma unroll 4
    for (int c = 0; c < kBlockN; ++c) {
      float pa[kRows], vb[DJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pa[i] = sP[(ty * kRows + i) * NP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vb[j] = sV[c * DP + tx + kGroups * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int g = m0 + ty * kRows + i;
    if (g >= p.tq) continue;
    const float l = l_i[i];
    const float safe_l = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      o[g * p.o_st + tx + kGroups * j] = from_f32<T>(acc[i][j] / safe_l);
    if (tx == 0)
      p.lse[bh * p.tq + g] = l <= 0.f ? kNegInf : m_i[i] + logf(safe_l);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)((int64_t)bh * p.n_qtiles));
  fa_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int head_dim, int bh,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(p, bh, stream);
    case 64: return launch<T, 64>(p, bh, stream);
    case 128: return launch<T, 128>(p, bh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// cudaError_t of the launch (0 = success); the wrapper raises on any other.
int mxtt_flash_attention_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int dtype, int head_dim,
                             int bh, int tq, int tk, long long q_sbh,
                             long long q_st, long long k_sbh, long long k_st,
                             long long v_sbh, long long v_st, long long o_sbh,
                             long long o_st, float scale, int causal,
                             int q_offset, int k_offset, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.q_sbh = q_sbh;
  p.q_st = q_st;
  p.k_sbh = k_sbh;
  p.k_st = k_st;
  p.v_sbh = v_sbh;
  p.v_st = v_st;
  p.o_sbh = o_sbh;
  p.o_st = o_st;
  p.tq = tq;
  p.tk = tk;
  p.n_qtiles = (tq + kBlockM - 1) / kBlockM;
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  p.k_offset = k_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(p, head_dim, bh, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(p, head_dim, bh, s);
  return (int)cudaErrorInvalidValue;
}

const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
