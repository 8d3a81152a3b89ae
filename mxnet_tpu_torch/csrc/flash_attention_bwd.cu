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
// * dK/dV: one block of 8 warps per (batch*head, 128-key tile), each warp
//   owning 16 keys, with dK and dV in registers while the block loops over
//   32-row query tiles, from the first that sees the key tile;
// * dQ: one block of 8 warps per (batch*head, 128-row query tile), each
//   warp owning 16 query rows, looping over 32-key tiles up to the last
//   key the tile's last row sees, with dQ in registers.
// Both recompute p from lse (the TPU scan did too). The loop's tiles come
// in by cp.async into a two-stage ring, the block's own tiles once. Every
// product runs on the tensor cores (flash_mma.cuh): split-TF32 for f32
// inputs, bf16 MMAs (p and ds rounded to bf16) for bf16 inputs.
//
// The transposed products. dv += p^T.dO and dk += ds^T.q take p^T and
// ds^T as A operands whose rows are keys. The dK/dV kernel therefore
// computes the transposed tiles from the start: s^T = k.q^T and
// dp^T = v.dO^T, whose rows are the warp's keys, so p^T and ds^T come out
// of the MMAs already in the accumulator layout that gemm_rn takes as its
// A operand, and dO and q are read as plain row-major B operands. Writing
// p and ds to shared memory and reading them back transposed would cost a
// round trip and a barrier per tile; this costs nothing. lse and delta,
// per query, then index the accumulator's columns (staged with the tile).
//
// Causal skipping: a (query tile, key tile) pair with no visible pair is
// never visited, and a warp skips a tile none of its 16 rows can reach
// (its contribution would be exactly 0).
//
// What bounds it on this card: at the training shape (B*H = 128, T = 2048,
// D = 128, causal) the function needs 10*D FLOPs per visible (query, key)
// pair against (4 inputs + 3 outputs) of bytes, far above the ridge point,
// so it is bound by operations: three TF32 passes at 495 TFLOP/s (2.09 ms)
// at best. The recomputation of s and dp in both kernels makes it 14*D.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu

#include "flash_mma.cuh"

namespace {

using namespace flash;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kOwn = 16 * kWarps;   // keys (dK/dV) or query rows (dQ) a block
constexpr int kQTile = 32;          // query rows a loop tile of dK/dV
constexpr int kKTile = 32;          // keys a loop tile of dQ

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
  int bh, tq, tk, n_tiles;
  float scale;
  int causal, q_offset, k_offset;
  int aligned;   // cp.async staging (see flash_mma.cuh)
};

// two own tiles, a two-stage ring of two loop tiles, and (dK/dV) the
// loop tile's lse and delta
template <typename T, int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(T) * row_pitch<T, D>() * (2 * kOwn + 4 * kQTile) +
         sizeof(float) * 4 * kQTile;
}

template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(T) * row_pitch<T, D>() * (2 * kOwn + 4 * kKTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dkdv_kernel(Params p) {
  constexpr int LD = row_pitch<T, D>();
  constexpr int QT = kQTile / 8;   // query n-tiles of s^T
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);      // kOwn x LD
  T* sV = sK + kOwn * LD;                      // kOwn x LD
  T* sQ = sV + kOwn * LD;                      // 2 x kQTile x LD
  T* sdO = sQ + 2 * kQTile * LD;               // 2 x kQTile x LD
  float* sL = reinterpret_cast<float*>(sdO + 2 * kQTile * LD);  // 2 x kQTile
  float* sDelta = sL + 2 * kQTile;                              // 2 x kQTile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x % p.bh;
  // under the causal mask the first key tiles see the most queries: they
  // come first
  const int n0 = (int)(blockIdx.x / p.bh) * kOwn;
  const bool aligned = p.aligned != 0;

  const T* q = static_cast<const T*>(p.q) + bh * p.tq * D;
  const T* k = static_cast<const T*>(p.k) + bh * p.tk * D;
  const T* v = static_cast<const T*>(p.v) + bh * p.tk * D;
  const T* dout = static_cast<const T*>(p.dout) + bh * p.tq * D;
  const float* lse = p.lse + bh * p.tq;
  const float* delta = p.delta + bh * p.tq;
  T* dk_out = static_cast<T*>(p.dk) + bh * p.tk * D;
  T* dv_out = static_cast<T*>(p.dv) + bh * p.tk * D;

  // the first query tile that sees the block's first key
  int m_begin = 0;
  if (p.causal) {
    const int64_t first = (int64_t)p.k_offset + n0 - p.q_offset;
    if (first >= p.tq) {   // no query sees any key of the tile
      const int rows = min(kOwn, p.tk - n0);
      for (int e = threadIdx.x; e < rows * D; e += kThreads) {
        dk_out[(int64_t)n0 * D + e] = from_f32<T>(0.f);
        dv_out[(int64_t)n0 * D + e] = from_f32<T>(0.f);
      }
      return;
    }
    m_begin = first <= 0 ? 0 : (int)first / kQTile * kQTile;
  }
  const int n_it = (p.tq - m_begin + kQTile - 1) / kQTile;

  auto stage_loop_tile = [&](int m0, int buf) {
    stage_rows<T, kQTile, D, LD, kThreads>(sQ + buf * kQTile * LD, q, D, m0,
                                           p.tq, aligned);
    stage_rows<T, kQTile, D, LD, kThreads>(sdO + buf * kQTile * LD, dout, D,
                                           m0, p.tq, aligned);
    for (int e = threadIdx.x; e < kQTile; e += kThreads) {
      const int gm = m0 + e;
      sL[buf * kQTile + e] = gm < p.tq ? lse[gm] : 0.f;
      sDelta[buf * kQTile + e] = gm < p.tq ? delta[gm] : 0.f;
    }
  };
  stage_rows<T, kOwn, D, LD, kThreads>(sK, k, D, n0, p.tk, aligned);
  stage_rows<T, kOwn, D, LD, kThreads>(sV, v, D, n0, p.tk, aligned);
  stage_loop_tile(m_begin, 0);
  cp_async_commit();

  const int key0 = n0 + 16 * warp;                  // the warp's first key
  const int64_t kpos0 = (int64_t)p.k_offset + key0;
  const T* wK = sK + 16 * warp * LD;
  const T* wV = sV + 16 * warp * LD;
  float dk[DT][4], dv[DT][4];
  zero(dk);
  zero(dv);

  for (int it = 0; it < n_it; ++it) {
    const int m0 = m_begin + it * kQTile;
    const int buf = it & 1;
    cp_async_wait<0>();
    // tile it has landed for every thread, and every warp is done with
    // tile it - 1, whose buffers the next tile takes
    __syncthreads();
    if (it + 1 < n_it) {   // the next tile loads while this one computes
      stage_loop_tile(m0 + kQTile, buf ^ 1);
      cp_async_commit();
    }
    const T* cQ = sQ + buf * kQTile * LD;
    const T* cdO = sdO + buf * kQTile * LD;
    const float* cL = sL + buf * kQTile;
    const float* cDelta = sDelta + buf * kQTile;
    const bool active =
        key0 < p.tk &&
        (!p.causal || (int64_t)p.q_offset + m0 + kQTile - 1 >= kpos0);
    if (active) {
      float pt[QT][4];   // s^T, then p^T: rows the warp's keys
      zero(pt);
      gemm_nt<QT, D, LD, LD>(pt, wK, cQ, g, t);
      const bool need_mask =
          m0 + kQTile > p.tq ||
          (p.causal && (int64_t)p.q_offset + m0 < kpos0 + 15);
#pragma unroll
      for (int j = 0; j < QT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const float l = cL[col];
          bool ok = l > 0.5f * kNegInf;
          if (need_mask) {
            const int qi = m0 + col;
            ok = ok && qi < p.tq &&
                 (!p.causal ||
                  (int64_t)p.q_offset + qi >= kpos0 + g + 8 * (e >> 1));
          }
          pt[j][e] = ok ? exp_fast(pt[j][e] * p.scale - l) : 0.f;
        }
      gemm_rn<QT, DT, LD>(dv, pt, cdO, g, t);        // dv += p^T . dO
      float dst[QT][4];  // dp^T, then ds^T
      zero(dst);
      gemm_nt<QT, D, LD, LD>(dst, wV, cdO, g, t);
#pragma unroll
      for (int j = 0; j < QT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pj = pt[j][e];
          const float d = cDelta[8 * j + 2 * t + (e & 1)];
          dst[j][e] = pj == 0.f ? 0.f : pj * (dst[j][e] - d) * p.scale;
        }
      gemm_rn<QT, DT, LD>(dk, dst, cQ, g, t);        // dk += ds^T . q
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + g + 8 * r;
    if (key >= p.tk) continue;
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int64_t at = (int64_t)key * D + 8 * j + 2 * t + c;
        dk_out[at] = from_f32<T>(dk[j][2 * r + c]);
        dv_out[at] = from_f32<T>(dv[j][2 * r + c]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) fa_bwd_dq_kernel(Params p) {
  constexpr int LD = row_pitch<T, D>();
  constexpr int KT = kKTile / 8;   // key n-tiles of s
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);      // kOwn x LD
  T* sdO = sQ + kOwn * LD;                     // kOwn x LD
  T* sK = sdO + kOwn * LD;                     // 2 x kKTile x LD
  T* sV = sK + 2 * kKTile * LD;                // 2 x kKTile x LD

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x % p.bh;
  // under the causal mask the last query tiles see the most keys: they
  // come first
  const int m0 = (p.n_tiles - 1 - (int)(blockIdx.x / p.bh)) * kOwn;
  const bool aligned = p.aligned != 0;

  const T* q = static_cast<const T*>(p.q) + bh * p.tq * D;
  const T* k = static_cast<const T*>(p.k) + bh * p.tk * D;
  const T* v = static_cast<const T*>(p.v) + bh * p.tk * D;
  const T* dout = static_cast<const T*>(p.dout) + bh * p.tq * D;
  T* dq_out = static_cast<T*>(p.dq) + bh * p.tq * D;

  int n_end = p.tk;
  if (p.causal) {
    const int64_t last_row = min(m0 + kOwn, p.tq) - 1;
    const int64_t lim = (int64_t)p.q_offset + last_row - p.k_offset + 1;
    n_end = lim <= 0 ? 0 : (lim < p.tk ? (int)lim : p.tk);
  }
  if (n_end <= 0) {   // no row of the tile sees a key
    const int rows = min(kOwn, p.tq - m0);
    for (int e = threadIdx.x; e < rows * D; e += kThreads)
      dq_out[(int64_t)m0 * D + e] = from_f32<T>(0.f);
    return;
  }
  const int n_it = (n_end + kKTile - 1) / kKTile;

  stage_rows<T, kOwn, D, LD, kThreads>(sQ, q, D, m0, p.tq, aligned);
  stage_rows<T, kOwn, D, LD, kThreads>(sdO, dout, D, m0, p.tq, aligned);
  stage_rows<T, kKTile, D, LD, kThreads>(sK, k, D, 0, p.tk, aligned);
  stage_rows<T, kKTile, D, LD, kThreads>(sV, v, D, 0, p.tk, aligned);
  cp_async_commit();

  const int row0 = m0 + 16 * warp;                  // the warp's first row
  const int64_t qpos0 = (int64_t)p.q_offset + row0;
  const T* wQ = sQ + 16 * warp * LD;
  const T* wdO = sdO + 16 * warp * LD;
  float l_r[2], dl_r[2];   // rows past Tq take the sentinel: p = 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    l_r[r] = row < p.tq ? p.lse[bh * p.tq + row] : kNegInf;
    dl_r[r] = row < p.tq ? p.delta[bh * p.tq + row] : 0.f;
  }
  float dq[DT][4];
  zero(dq);

  for (int it = 0; it < n_it; ++it) {
    const int n0 = it * kKTile;
    const int buf = it & 1;
    cp_async_wait<0>();
    // tile it has landed for every thread, and every warp is done with
    // tile it - 1, whose buffers the next tile takes
    __syncthreads();
    if (it + 1 < n_it) {   // the next tile loads while this one computes
      stage_rows<T, kKTile, D, LD, kThreads>(sK + (buf ^ 1) * kKTile * LD, k,
                                             D, n0 + kKTile, p.tk, aligned);
      stage_rows<T, kKTile, D, LD, kThreads>(sV + (buf ^ 1) * kKTile * LD, v,
                                             D, n0 + kKTile, p.tk, aligned);
      cp_async_commit();
    }
    const T* cK = sK + buf * kKTile * LD;
    const T* cV = sV + buf * kKTile * LD;
    const bool active = row0 < p.tq &&
                        (!p.causal || qpos0 + 15 >= (int64_t)p.k_offset + n0);
    if (active) {
      float s[KT][4];   // s, then p
      zero(s);
      gemm_nt<KT, D, LD, LD>(s, wQ, cK, g, t);
      const bool need_mask =
          n0 + kKTile > p.tk ||
          (p.causal && (int64_t)p.k_offset + n0 + kKTile - 1 > qpos0);
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = l_r[e >> 1];
          bool ok = l > 0.5f * kNegInf;
          if (need_mask) {
            const int key = n0 + 8 * j + 2 * t + (e & 1);
            ok = ok && key < p.tk &&
                 (!p.causal || qpos0 + g + 8 * (e >> 1) >=
                                   (int64_t)p.k_offset + key);
          }
          s[j][e] = ok ? exp_fast(s[j][e] * p.scale - l) : 0.f;
        }
      float ds[KT][4];   // dp, then ds
      zero(ds);
      gemm_nt<KT, D, LD, LD>(ds, wdO, cV, g, t);
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pj = s[j][e];
          const float dp = ds[j][e] - dl_r[e >> 1];
          ds[j][e] = pj == 0.f ? 0.f : pj * dp * p.scale;
        }
      gemm_rn<KT, DT, LD>(dq, ds, cK, g, t);         // dq += ds . k
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= p.tq) continue;
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        dq_out[(int64_t)row * D + 8 * j + 2 * t + c] =
            from_f32<T>(dq[j][2 * r + c]);
  }
}

template <typename T, int D>
cudaError_t launch_d(bool dkdv, Params p, cudaStream_t stream) {
  const void* ptrs[] = {p.q, p.k, p.v, p.dout};
  p.aligned = aligned16(ptrs, 4, nullptr, 0, (int)sizeof(T));
  p.n_tiles = ((dkdv ? p.tk : p.tq) + kOwn - 1) / kOwn;
  void (*kernel)(Params) =
      dkdv ? &fa_bwd_dkdv_kernel<T, D> : &fa_bwd_dq_kernel<T, D>;
  return flash::launch(kernel, p, p.bh * p.n_tiles, kThreads,
                       dkdv ? dkdv_smem_bytes<T, D>() : dq_smem_bytes<T, D>(),
                       stream);
}

template <typename T>
cudaError_t dispatch(bool dkdv, const Params& p, int head_dim,
                     cudaStream_t s) {
  switch (head_dim) {
    case 16: return launch_d<T, 16>(dkdv, p, s);
    case 32: return launch_d<T, 32>(dkdv, p, s);
    case 64: return launch_d<T, 64>(dkdv, p, s);
    case 128: return launch_d<T, 128>(dkdv, p, s);
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
  p.bh = bh;
  p.tq = tq;
  p.tk = tk;
  p.n_tiles = 0;
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  p.k_offset = k_offset;
  p.aligned = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(dkdv, p, head_dim, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(dkdv, p, head_dim, s);
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
