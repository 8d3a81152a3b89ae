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
//           for a fully masked row, whose out is 0.
//
// Design. One block of 8 warps per (batch*head, 128-row query tile); each
// warp owns 16 query rows. A loop inside the block walks the keys in
// 32-row tiles (on the TPU the sequential k grid axis carried that loop),
// staged by cp.async into a two-stage ring so that tile n + 1 loads while
// tile n computes; the query tile is staged once. Both products run on the
// tensor cores (flash_mma.cuh): s = q.k^T comes out of the MMAs into
// accumulator fragments, the online softmax (m, l) runs on those fragments
// with quad shuffles, and p goes from the accumulator registers straight
// into the A operand of p.v. float32 inputs take the split-TF32 product
// (three TF32 MMAs, f32 error), bfloat16 one bf16 MMA with p rounded to
// bf16. Ragged tiles are zero-filled as well as masked in the scores, so
// garbage past Tk never reaches the output through 0 * NaN; masked scores
// are selected to -1e30 and their p to 0.
//
// Causal tile skipping. Under the mask a query tile [m0, m0 + 128) visits
// key tiles only up to n_end = min(Tk, q_offset + last_row - k_offset + 1);
// only tiles that reach past the first row's last visible key, or past Tk,
// take the element mask, and a warp skips a tile none of its 16 rows can
// see (an exact no-op of the online softmax). A tile with n_end <= 0 writes
// out = 0 and lse = -1e30 and returns. Rows of a visited tile that see no
// key end with l = 0, which gives the same sentinel. Blocks take their query
// tiles last to first, so the heaviest causal tiles start first and the
// light ones fill the tail.
//
// What bounds it on this card: at the serving shape (B*H = 128, T = 2048,
// D = 128, causal) the work is 4*D FLOPs per visible (query, key) pair
// against (3 inputs + 1 output) of bytes, far above the ridge point, so it
// is bound by operations: at best three TF32 passes at 495 TFLOP/s (0.83
// ms), against 2.05 ms for one f32 pass on the CUDA cores. The fragment
// loads, operand splits and partial sums are four to five instructions
// beside each MMA, and at ~240 registers a thread only 8 warps fit an SM
// to hide their latency: those, not the tensor cores, limit it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fwd.so flash_attention_fwd.cu

#include "flash_mma.cuh"

namespace {

using namespace flash;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = 16 * kWarps;  // query rows per block
constexpr int kBlockN = 32;           // keys per tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int64_t q_sbh, q_st, k_sbh, k_st, v_sbh, v_st, o_sbh, o_st;
  int bh, tq, tk, n_qtiles;
  float scale;
  int causal, q_offset, k_offset;
  int aligned;   // cp.async staging (see flash_mma.cuh)
};

// Q tile, then a two-stage ring of (K, V) tiles
template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(T) * row_pitch<T, D>() * (kBlockM + 4 * kBlockN);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) fa_fwd_kernel(Params p) {
  constexpr int LD = row_pitch<T, D>();
  constexpr int NT = kBlockN / 8;   // score n-tiles
  constexpr int DT = D / 8;         // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);            // kBlockM x LD
  T* sK = sQ + kBlockM * LD;                         // 2 x kBlockN x LD
  T* sV = sK + 2 * kBlockN * LD;                     // 2 x kBlockN x LD

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x % p.bh;
  const int m0 = (p.n_qtiles - 1 - (int)(blockIdx.x / p.bh)) * kBlockM;
  const bool aligned = p.aligned != 0;

  const T* q = static_cast<const T*>(p.q) + bh * p.q_sbh;
  const T* k = static_cast<const T*>(p.k) + bh * p.k_sbh;
  const T* v = static_cast<const T*>(p.v) + bh * p.v_sbh;
  T* o = static_cast<T*>(p.out) + bh * p.o_sbh;

  int n_end = p.tk;
  if (p.causal) {
    const int64_t last_row = min(m0 + kBlockM, p.tq) - 1;
    const int64_t lim = (int64_t)p.q_offset + last_row - p.k_offset + 1;
    n_end = lim <= 0 ? 0 : (lim < p.tk ? (int)lim : p.tk);
  }
  if (n_end <= 0) {   // no row of the tile sees a key
    const int rows = min(kBlockM, p.tq - m0);
    for (int e = threadIdx.x; e < rows * D; e += kThreads)
      o[(m0 + e / D) * p.o_st + e % D] = from_f32<T>(0.f);
    for (int r = threadIdx.x; r < rows; r += kThreads)
      p.lse[bh * p.tq + m0 + r] = kNegInf;
    return;
  }
  const int n_tiles = (n_end + kBlockN - 1) / kBlockN;

  stage_rows<T, kBlockM, D, LD, kThreads>(sQ, q, p.q_st, m0, p.tq, aligned);
  stage_rows<T, kBlockN, D, LD, kThreads>(sK, k, p.k_st, 0, p.tk, aligned);
  stage_rows<T, kBlockN, D, LD, kThreads>(sV, v, p.v_st, 0, p.tk, aligned);
  cp_async_commit();

  const int row0 = m0 + 16 * warp;                 // the warp's first row
  const int64_t qpos0 = (int64_t)p.q_offset + row0;
  const T* wQ = sQ + 16 * warp * LD;
  float acc[DT][4];
  zero(acc);
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = it * kBlockN;
    cp_async_wait<0>();
    // tile it has landed for every thread, and every warp is done with
    // tile it - 1, whose buffers the next tile takes
    __syncthreads();
    if (it + 1 < n_tiles) {   // the next tile loads while this one computes
      const int nb = (it + 1) & 1;
      stage_rows<T, kBlockN, D, LD, kThreads>(sK + nb * kBlockN * LD, k,
                                              p.k_st, n0 + kBlockN, p.tk,
                                              aligned);
      stage_rows<T, kBlockN, D, LD, kThreads>(sV + nb * kBlockN * LD, v,
                                              p.v_st, n0 + kBlockN, p.tk,
                                              aligned);
      cp_async_commit();
    }
    const T* cK = sK + (it & 1) * kBlockN * LD;
    const T* cV = sV + (it & 1) * kBlockN * LD;
    // a warp whose rows are all past Tq, or before the tile's first key,
    // has nothing to add
    const bool active = row0 < p.tq &&
                        (!p.causal || qpos0 + 15 >= (int64_t)p.k_offset + n0);
    if (active) {
      float s[NT][4];
      zero(s);
      gemm_nt<NT, D, LD, LD>(s, wQ, cK, g, t);
      const bool need_mask =
          n0 + kBlockN > p.tk ||
          (p.causal && (int64_t)p.k_offset + n0 + kBlockN - 1 > qpos0);
      float bmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * p.scale;
          if (need_mask) {
            const int key = n0 + 8 * j + 2 * t + (e & 1);
            const int64_t qpos = qpos0 + g + 8 * (e >> 1);
            const bool ok = key < p.tk &&
                            (!p.causal || qpos >= (int64_t)p.k_offset + key);
            x = ok ? x : kNegInf;
          }
          s[j][e] = x;
          bmax[e >> 1] = fmaxf(bmax[e >> 1], x);
        }
      float m_new[2], corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_new[r] = fmaxf(m_i[r], quad_max(bmax[r]));
        corr[r] = exp_fast(m_i[r] - m_new[r]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e];
          const float pj =
              x <= 0.5f * kNegInf ? 0.f : exp_fast(x - m_new[e >> 1]);
          s[j][e] = pj;
          rsum[e >> 1] += pj;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_i[r] = l_i[r] * corr[r] + quad_sum(rsum[r]);
        m_i[r] = m_new[r];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
      gemm_rn<NT, DT, LD>(acc, s, cV, g, t);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= p.tq) continue;
    const float l = l_i[r];
    const float safe_l = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      T* dst = o + row * p.o_st + 8 * j + 2 * t;
      dst[0] = from_f32<T>(acc[j][2 * r] / safe_l);
      dst[1] = from_f32<T>(acc[j][2 * r + 1] / safe_l);
    }
    if (t == 0)
      p.lse[bh * p.tq + row] = l <= 0.f ? kNegInf : m_i[r] + logf(safe_l);
  }
}

template <typename T, int D>
cudaError_t launch_d(Params p, cudaStream_t stream) {
  const void* ptrs[] = {p.q, p.k, p.v};
  const int64_t strides[] = {p.q_sbh, p.q_st, p.k_sbh, p.k_st, p.v_sbh,
                             p.v_st};
  p.aligned = aligned16(ptrs, 3, strides, 6, (int)sizeof(T));
  return flash::launch(fa_fwd_kernel<T, D>, p, p.bh * p.n_qtiles, kThreads,
                       smem_bytes<T, D>(), stream);
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch_d<T, 32>(p, stream);
    case 64: return launch_d<T, 64>(p, stream);
    case 128: return launch_d<T, 128>(p, stream);
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
  p.bh = bh;
  p.tq = tq;
  p.tk = tk;
  p.n_qtiles = (tq + kBlockM - 1) / kBlockM;
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  p.k_offset = k_offset;
  p.aligned = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(p, head_dim, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(p, head_dim, s);
  return (int)cudaErrorInvalidValue;
}

const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
