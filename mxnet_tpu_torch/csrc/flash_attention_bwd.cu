// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces `flash_attention_bwd` (mxnet_tpu/ops/pallas_kernels.py:220-270),
// the blockwise recompute backward that the forward kernel's custom VJP
// (`_flash_core_bwd`, :273-278) calls. It computes the same function, not
// the same blocks: for each (batch*head) with the forward's saved
// lse (BH, Tq) and delta = rowsum(dO * O) (BH, Tq), both f32,
//   p_ij  = exp(q_i . k_j * scale - lse_i)   (0 where masked)
//   dv_j  = sum_i p_ij dO_i
//   dp_ij = dO_i . v_j
//   ds_ij = p_ij (dp_ij - delta_i) scale      (0 where masked)
//   dq_i  = sum_j ds_ij k_j,   dk_j = sum_i ds_ij q_i
// in f32, with dq, dk, dv written in the input type. Masked positions are
// *selected* to 0, never multiplied by a mask: the causal mask on global
// positions (q_offset + i < k_offset + j, runtime scalars so one build
// serves every ring-attention step), keys past Tk, query rows past Tq, and
// rows whose lse is the forward's -1e30 sentinel (no visible key). There
// exp(s - lse) overflows to inf and 0 * inf would be NaN.
//
// Design. Two kernels and no atomics, so the result is deterministic:
// * dK/dV: one thread block per (batch*head, 32-key tile). dK and dV stay
//   in registers while the block loops over the 64-row query tiles;
// * dQ: one thread block per (batch*head, 64-row query tile), looping over
//   the 32-key tiles with dQ in registers.
// Both recompute p from lse (the TPU scan did too), so q.k^T and dO.v^T are
// computed twice over: seven products against the five the function
// needs. Tiles are staged in shared memory as f32, rows padded by one word
// against bank conflicts; ragged tiles are zero-filled. Within a tile the
// 128 threads own 4x4 score entries each (rows 4*(tid/8)+i, keys
// tid%8 + 8j); in the products that reduce over the tile, 4 rows by D/16
// (dK, dV) or D/8 (dQ) output columns. Under the causal mask a tile pair
// with no visible (query, key) pair is skipped whole.
//
// What bounds it on this card: at the training shape (B*H = 128, T = 2048,
// D = 128, causal) the work is 10*D FLOPs per visible (query, key) pair
// against (4 inputs + 3 outputs) of bytes, far above the ridge point, so it
// is bound by operations. This first version runs them as f32 FMAs on the
// CUDA cores (67 TFLOP/s peak), not the tensor cores; wgmma and TMA
// staging are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockM = 64;     // query rows per tile
constexpr int kBlockN = 32;     // keys per tile
constexpr int kThreads = 128;

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

// Every tensor is contiguous: q, dout, dq (BH, Tq, D); k, v, dk, dv
// (BH, Tk, D); lse, delta (BH, Tq) f32.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int tq, tk, n_tiles;
  float scale;
  int causal, q_offset, k_offset;
};

// rows [r0, r0 + rows) of a (t, D) matrix -> smem (rows x (D + 1)) in f32,
// zero past row t
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int rows, int t) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, c = e % D, g = r0 + r;
    dst[r * (D + 1) + c] = g < t ? to_f32(src[(int64_t)g * D + c]) : 0.f;
  }
}

// acc[i][j] = A[4*ty + i] . B[tx + 8*j] over D, for the 64 x 32 tile
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* B,
                                         float acc[4][4], int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(4 * ty + i) * DP + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 8 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// p and ds of the thread's 4 x 4 entries of the (m0, n0) tile pair from the
// raw products s = q.k and dp = dO.v; masked entries are selected to 0
__device__ __forceinline__ void probs_and_dscores(
    const Params& p, int m0, int n0, int ty, int tx, const float* lse_row,
    const float* delta_row, float s[4][4], float dp[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = m0 + 4 * ty + i;
    const int64_t qpos = (int64_t)p.q_offset + g;
    const float l = lse_row[i];
    const bool row_ok = g < p.tq && l > 0.5f * kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = n0 + tx + 8 * j;
      const bool ok = row_ok && key < p.tk &&
                      (!p.causal || qpos >= (int64_t)p.k_offset + key);
      const float pij = ok ? expf(s[i][j] * p.scale - l) : 0.f;
      dp[i][j] = ok ? pij * (dp[i][j] - delta_row[i]) * p.scale : 0.f;
      s[i][j] = pij;
    }
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (2 * kBlockN * (D + 1) + 2 * kBlockM * (D + 1) +
                          2 * kBlockM * (kBlockN + 1) + 2 * kBlockM);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_dkdv_kernel(Params p) {
  constexpr int DP = D + 1;
  constexpr int NP = kBlockN + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;                    // kBlockN x DP
  float* sV = sK + kBlockN * DP;       // kBlockN x DP
  float* sQ = sV + kBlockN * DP;       // kBlockM x DP
  float* sdO = sQ + kBlockM * DP;      // kBlockM x DP
  float* sP = sdO + kBlockM * DP;      // kBlockM x NP
  float* sdS = sP + kBlockM * NP;      // kBlockM x NP
  float* sL = sdS + kBlockM * NP;      // kBlockM
  float* sDelta = sL + kBlockM;        // kBlockM

  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;     // score tile entries
  const int ky = tid / 16, kx = tid % 16;   // dK/dV: keys 4ky+i, cols kx+16j
  const int64_t bh = blockIdx.x / p.n_tiles;
  const int n0 = (blockIdx.x % p.n_tiles) * kBlockN;

  const T* q = static_cast<const T*>(p.q) + bh * p.tq * D;
  const T* k = static_cast<const T*>(p.k) + bh * p.tk * D;
  const T* v = static_cast<const T*>(p.v) + bh * p.tk * D;
  const T* dout = static_cast<const T*>(p.dout) + bh * p.tq * D;
  const float* lse = p.lse + bh * p.tq;
  const float* delta = p.delta + bh * p.tq;

  stage<T, D>(sK, k, n0, kBlockN, p.tk);
  stage<T, D>(sV, v, n0, kBlockN, p.tk);

  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int64_t first_key = (int64_t)p.k_offset + n0;
  for (int m0 = 0; m0 < p.tq; m0 += kBlockM) {
    const int last_row = min(m0 + kBlockM, p.tq) - 1;
    if (p.causal && (int64_t)p.q_offset + last_row < first_key) continue;
    __syncthreads();  // the previous tile's sQ/sdO/sP/sdS are no longer read
    stage<T, D>(sQ, q, m0, kBlockM, p.tq);
    stage<T, D>(sdO, dout, m0, kBlockM, p.tq);
    for (int e = tid; e < kBlockM; e += kThreads) {
      const int g = m0 + e;
      sL[e] = g < p.tq ? lse[g] : 0.f;
      sDelta[e] = g < p.tq ? delta[g] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4], l[4], dl[4];
    tile_dot<D>(sQ, sK, s, ty, tx);
    tile_dot<D>(sdO, sV, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] = sL[4 * ty + i];
      dl[i] = sDelta[4 * ty + i];
    }
    probs_and_dscores(p, m0, n0, ty, tx, l, dl, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sP[(4 * ty + i) * NP + tx + 8 * j] = s[i][j];
        sdS[(4 * ty + i) * NP + tx + 8 * j] = dp[i][j];
      }
    __syncthreads();  // sP, sdS complete

#pragma unroll 4
    for (int m = 0; m < kBlockM; ++m) {
      float pa[4], sa[4], ob[DJ], qb[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = sP[m * NP + 4 * ky + i];
        sa[i] = sdS[m * NP + 4 * ky + i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ob[j] = sdO[m * DP + kx + 16 * j];
        qb[j] = sQ[m * DP + kx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv[i][j] = fmaf(pa[i], ob[j], dv[i][j]);
          dk[i][j] = fmaf(sa[i], qb[j], dk[i][j]);
        }
    }
  }

  T* dk_out = static_cast<T*>(p.dk) + bh * p.tk * D;
  T* dv_out = static_cast<T*>(p.dv) + bh * p.tk * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = n0 + 4 * ky + i;
    if (g >= p.tk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk_out[(int64_t)g * D + kx + 16 * j] = from_f32<T>(dk[i][j]);
      dv_out[(int64_t)g * D + kx + 16 * j] = from_f32<T>(dv[i][j]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * kBlockM * (D + 1) + 2 * kBlockN * (D + 1) +
                          kBlockM * (kBlockN + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fa_bwd_dq_kernel(Params p) {
  constexpr int DP = D + 1;
  constexpr int NP = kBlockN + 1;
  constexpr int DJ = D / 8;
  extern __shared__ float smem[];
  float* sQ = smem;                    // kBlockM x DP
  float* sdO = sQ + kBlockM * DP;      // kBlockM x DP
  float* sK = sdO + kBlockM * DP;      // kBlockN x DP
  float* sV = sK + kBlockN * DP;       // kBlockN x DP
  float* sdS = sV + kBlockN * DP;      // kBlockM x NP

  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;   // rows 4ty+i; keys / cols tx+8j
  const int64_t bh = blockIdx.x / p.n_tiles;
  const int m0 = (blockIdx.x % p.n_tiles) * kBlockM;

  const T* q = static_cast<const T*>(p.q) + bh * p.tq * D;
  const T* k = static_cast<const T*>(p.k) + bh * p.tk * D;
  const T* v = static_cast<const T*>(p.v) + bh * p.tk * D;
  const T* dout = static_cast<const T*>(p.dout) + bh * p.tq * D;

  stage<T, D>(sQ, q, m0, kBlockM, p.tq);
  stage<T, D>(sdO, dout, m0, kBlockM, p.tq);
  float l[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = m0 + 4 * ty + i;
    l[i] = g < p.tq ? p.lse[bh * p.tq + g] : 0.f;
    dl[i] = g < p.tq ? p.delta[bh * p.tq + g] : 0.f;
  }

  float dq[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;

  const int64_t last_query = (int64_t)p.q_offset + min(m0 + kBlockM, p.tq) - 1;
  for (int n0 = 0; n0 < p.tk; n0 += kBlockN) {
    // this key tile and every later one lie past the tile's last query
    if (p.causal && (int64_t)p.k_offset + n0 > last_query) break;
    __syncthreads();  // the previous tile's sK/sV/sdS are no longer read
    stage<T, D>(sK, k, n0, kBlockN, p.tk);
    stage<T, D>(sV, v, n0, kBlockN, p.tk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(sQ, sK, s, ty, tx);
    tile_dot<D>(sdO, sV, dp, ty, tx);
    probs_and_dscores(p, m0, n0, ty, tx, l, dl, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sdS[(4 * ty + i) * NP + tx + 8 * j] = dp[i][j];
    __syncthreads();  // sdS complete

#pragma unroll 4
    for (int c = 0; c < kBlockN; ++c) {
      float sa[4], kb[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = sdS[(4 * ty + i) * NP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kb[j] = sK[c * DP + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dq[i][j] = fmaf(sa[i], kb[j], dq[i][j]);
    }
  }

  T* dq_out = static_cast<T*>(p.dq) + bh * p.tq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int g = m0 + 4 * ty + i;
    if (g >= p.tq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dq_out[(int64_t)g * D + tx + 8 * j] = from_f32<T>(dq[i][j]);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int blocks, const Params& p,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkdv(Params p, int bh, cudaStream_t stream) {
  p.n_tiles = (p.tk + kBlockN - 1) / kBlockN;
  return launch(fa_bwd_dkdv_kernel<T, D>, dkdv_smem_bytes<D>(),
                bh * p.n_tiles, p, stream);
}

template <typename T, int D>
cudaError_t launch_dq(Params p, int bh, cudaStream_t stream) {
  p.n_tiles = (p.tq + kBlockM - 1) / kBlockM;
  return launch(fa_bwd_dq_kernel<T, D>, dq_smem_bytes<D>(), bh * p.n_tiles,
                p, stream);
}

template <typename T>
cudaError_t dispatch(bool dkdv, const Params& p, int head_dim, int bh,
                     cudaStream_t s) {
  switch (head_dim) {
    case 32: return dkdv ? launch_dkdv<T, 32>(p, bh, s) : launch_dq<T, 32>(p, bh, s);
    case 64: return dkdv ? launch_dkdv<T, 64>(p, bh, s) : launch_dq<T, 64>(p, bh, s);
    case 128: return dkdv ? launch_dkdv<T, 128>(p, bh, s) : launch_dq<T, 128>(p, bh, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool dkdv, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* delta, void* dq,
        void* dk, void* dv, int dtype, int head_dim, int bh, int tq, int tk,
        float scale, int causal, int q_offset, int k_offset, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.tq = tq;
  p.tk = tk;
  p.n_tiles = 0;
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  p.k_offset = k_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(dkdv, p, head_dim, bh, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(dkdv, p, head_dim, bh, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, dout and the outputs.
// Every tensor contiguous. Returns the cudaError_t of the launch (0 =
// success); the wrapper raises on any other.
int mxtt_flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, void* dk,
                                  void* dv, int dtype, int head_dim, int bh,
                                  int tq, int tk, float scale, int causal,
                                  int q_offset, int k_offset, void* stream) {
  return run(true, q, k, v, dout, lse, delta, dq, dk, dv, dtype, head_dim, bh,
             tq, tk, scale, causal, q_offset, k_offset, stream);
}

int mxtt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, void* dk,
                                void* dv, int dtype, int head_dim, int bh,
                                int tq, int tk, float scale, int causal,
                                int q_offset, int k_offset, void* stream) {
  return run(false, q, k, v, dout, lse, delta, dq, dk, dv, dtype, head_dim,
             bh, tq, tk, scale, causal, q_offset, k_offset, stream);
}

const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
