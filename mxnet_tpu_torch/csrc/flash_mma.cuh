// Warp-level tensor-core pieces shared by the flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu), for Hopper (sm_90a).
//
// Products. Every product of the two kernels is one of two warp-level
// shapes on `mma.sync` tiles of 16 rows:
// * gemm_nt:  C[16][8*NT] += A[16][D] . B[8*NT][D]^T, both operands read
//   from row-major shared-memory tiles (q.k^T, k.q^T, dO.v^T, v.dO^T);
// * gemm_rn:  C[16][8*NT] += P[16][8*KT] . B[8*KT][8*NT], with P held in
//   registers as the accumulator fragments a previous gemm_nt produced and
//   B read from a row-major shared-memory tile (p.v, p^T.dO, ds^T.q, ds.k).
//   The accumulator layout of m16n8k8 gives each thread the columns 2t and
//   2t+1 of its rows; the A layout wants columns t and t+4. A product sums
//   over k in any order, so k is relabelled: logical column t is physical
//   column 2t, logical t+4 is 2t+1, and B's rows are read in the same
//   order. P goes from accumulator to operand with no shuffle and no trip
//   through shared memory. (bf16's m16n8k16 A layout already matches two
//   neighbouring accumulator tiles, as in FlashAttention-2.)
//
// float32 operands take the split-TF32 product (CUTLASS's
// OpMultiplyAddFastF32, which PyTorch's memory-efficient attention uses for
// float32): each operand is split in registers as its fragment is loaded,
// hi = rna(x), lo = rna(x - hi) in TF32 (split_tf32), and the product
// is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, three m16n8k8 TF32 MMAs with the
// small terms first, accumulated in f32. The dropped a_lo.b_lo term is
// below 2^-22 of |a||b|, so the result keeps float32's error where one
// TF32 pass (2^-11) would not. Shared memory holds plain f32 tiles;
// nothing is stored split. bfloat16 operands take one m16n8k16 pass with
// f32 accumulation (a product of two bf16 values is exact in f32).
//
// Accumulation. An MMA adds into its f32 accumulator with truncation, not
// round-to-nearest, so a long chain of MMAs into one accumulator drifts
// toward zero by about half an ulp each: on an H100 a version that chained
// them read 1.2e-5 in out at (4, 32, 2048, 128) causal (768 MMAs a row of
// p.v) and 1.1e-5 relative in dv at T = 1000, past the backward's 1e-5
// gate. So no accumulator lives across more than one loop tile: the
// products sum into fresh fragments over a 32-wide slice of D (gemm_nt)
// or one key or query tile (gemm_rn, with the small terms in an
// accumulator of their own so that their truncation is relative to their
// own size), and the partial is added to the running f32 sum on the CUDA
// cores, rounded to nearest.
//
// Staging: 16-byte cp.async copies into tiles whose rows are padded by 16
// bytes, so the fragment loads of a warp hit 32 distinct banks; rows past
// the end of a tensor are zero-filled by the copy (src-size 0). Where a
// pointer or a row stride is not 16-byte aligned the same tile is staged
// with plain loads.
//
// Why mma.sync and not wgmma: wgmma's TF32 form takes both operands
// K-major from shared memory, so v in p.v and the transposed operands of
// dK and dV would first need a transposed copy, and the library call these
// kernels are held against (memory-efficient attention, m16n8k8
// OpMultiplyAddFastF32) reaches its time with mma.sync. wgmma and TMA are
// the next step for whichever kernel still trails it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;   // the TPU kernel's sentinel, never -inf
constexpr float kLog2e = 1.4426950408889634f;

// e^x as 2^(x log2 e): one multiply and the hardware's exp2, fewer
// instructions than expf's range reduction, and an error (a few ulp) far
// inside the kernels' gates
__device__ __forceinline__ float exp_fast(float x) {
  return exp2f(x * kLog2e);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// elements in a padded shared-memory row of a (rows, D) tile
template <typename T, int D>
__host__ __device__ constexpr int row_pitch() {
  return D + 16 / (int)sizeof(T);
}

// ------------------------------------------------------------- staging

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of a (n_rows, D) matrix with row stride `stride`
// (elements) -> a (ROWS, LD) shared-memory tile, zero past row n_rows.
// Asynchronous (cp.async) when `aligned`; the caller commits and waits.
template <typename T, int ROWS, int D, int LD, int THREADS>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           int64_t stride, int r0,
                                           int n_rows, bool aligned) {
  constexpr int EPC = 16 / (int)sizeof(T);   // elements a 16-byte chunk
  constexpr int CPR = D / EPC;               // chunks a row
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * EPC, gr = r0 + r;
    const bool in = gr < n_rows;
    T* d = dst + r * LD + col;
    const T* s = src + (in ? (int64_t)gr * stride + col : 0);
    if (aligned) {
      cp_async16(d, s, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) d[e] = in ? s[e] : from_f32<T>(0.f);
    }
  }
}

// ------------------------------------------------------------- products

// x = hi + lo in TF32, both rounded to nearest (ties away from zero), as
// cvt.rna.tf32.f32 rounds. That instruction compiles to a guard for inf and
// NaN, an add of half a TF32 ulp to the bits and a mask of the 13 low bits;
// the MMA ignores those 13 bits of a .tf32 operand, so the add alone hands
// it the same rounded value (CUTLASS's round_half_ulp_truncate), and only
// the subtraction needs the masked hi. Four instructions a split instead
// of eight; finite operands only, which attention's are.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the split-TF32 product, small terms first
__device__ __forceinline__ void mma_split_tf32(float (&c)[4],
                                               const uint32_t (&ahi)[4],
                                               const uint32_t (&alo)[4],
                                               const uint32_t (&bhi)[2],
                                               const uint32_t (&blo)[2]) {
  mma_tf32(c, alo, bhi);
  mma_tf32(c, ahi, blo);
  mma_tf32(c, ahi, bhi);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four 8x8 matrices of 16-bit elements from shared memory (ldmatrix x4):
// lane L gives the address of row L % 8 of matrix L / 8, and register i of
// lane 4g + t holds the 32-bit word t of row g of matrix i. For float32
// tiles a "row" is four floats, so one x4 loads an m16n8k8 A fragment, or
// the B fragments of two n-tiles.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// two bf16 from shared memory (neighbours in a row) as one register
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from two rows (low half = the first), for a B operand read
// down the k axis
__device__ __forceinline__ uint32_t pack_rows(const __nv_bfloat16* lo,
                                              const __nv_bfloat16* hi) {
  return (uint32_t)__bfloat16_as_ushort(*lo)
         | ((uint32_t)__bfloat16_as_ushort(*hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// Fragment coordinates: lane = 4*g + t. Accumulator c[j] of an n-tile j
// holds rows g (c[0], c[1]) and g + 8 (c[2], c[3]) at columns 8j + 2t and
// 8j + 2t + 1.

// C[16][8*NT] += A[16][D] . B[8*NT][D]^T; sA, sB point at the first row.
// Fragments come in by ldmatrix (one x4 for A, one for each two n-tiles of
// B). The MMAs sum into a fresh accumulator over each 32-wide slice of D,
// which is then added to C on the CUDA cores (see the note on
// accumulation).
template <int NT, int D, int LDA, int LDB>
__device__ __forceinline__ void gemm_nt(float (&c)[NT][4], const float* sA,
                                        const float* sB, int g, int t) {
  static_assert(NT % 2 == 0, "B fragments load two n-tiles at a time");
  constexpr int KC = D < 32 ? D : 32;
  const int lane = 4 * g + t, lr = lane & 7, lm = lane >> 3;
  // A: matrices (rows 0-7 | 8-15) x (k 0-3 | 4-7); B: (k 0-3 | 4-7) x
  // (n-tile j | j + 1)
  const float* pa = sA + (8 * (lm & 1) + lr) * LDA + 4 * (lm >> 1);
  const float* pb = sB + (8 * (lm >> 1) + lr) * LDB + 4 * (lm & 1);
  for (int kc = 0; kc < D; kc += KC) {
    float d[NT][4];
    zero(d);
#pragma unroll
    for (int k0 = kc; k0 < kc + KC; k0 += 8) {
      uint32_t a[4], ahi[4], alo[4];
      ldsm_x4(a, pa + k0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_tf32(__uint_as_float(a[i]), ahi[i], alo[i]);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, pb + 8 * j * LDB + k0);
        uint32_t bhi[2][2], blo[2][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(__uint_as_float(b[i]), bhi[i >> 1][i & 1],
                     blo[i >> 1][i & 1]);
        mma_split_tf32(d[j], ahi, alo, bhi[0], blo[0]);
        mma_split_tf32(d[j + 1], ahi, alo, bhi[1], blo[1]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] += d[j][e];
  }
}

template <int NT, int D, int LDA, int LDB>
__device__ __forceinline__ void gemm_nt(float (&c)[NT][4],
                                        const __nv_bfloat16* sA,
                                        const __nv_bfloat16* sB, int g,
                                        int t) {
#pragma unroll 2
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t a[4];
    a[0] = ld_pair(sA + g * LDA + k0 + 2 * t);
    a[1] = ld_pair(sA + (g + 8) * LDA + k0 + 2 * t);
    a[2] = ld_pair(sA + g * LDA + k0 + 2 * t + 8);
    a[3] = ld_pair(sA + (g + 8) * LDA + k0 + 2 * t + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* b = sB + (8 * j + g) * LDB + k0 + 2 * t;
      const uint32_t bb[2] = {ld_pair(b), ld_pair(b + 8)};
      mma_bf16(c[j], a, bb);
    }
  }
}

// C[16][8*NT] += P[16][8*KT] . B[8*KT][8*NT]; P in accumulator fragments,
// sB points at B's first row. P is split four k-steps at a time; four
// output n-tiles at a time then sum their small terms and their big term
// over those k-steps in fresh accumulators (eight independent MMA chains),
// added to C on the CUDA cores.
template <int KT, int NT, int LDB>
__device__ __forceinline__ void gemm_rn(float (&c)[NT][4],
                                        const float (&p)[KT][4],
                                        const float* sB, int g, int t) {
  constexpr int KC = KT < 4 ? KT : 4;   // k-steps split at a time
  constexpr int JG = 4;                 // n-tiles summed at a time
  static_assert(KT % KC == 0 && NT % JG == 0, "tile shapes");
#pragma unroll
  for (int kc = 0; kc < KT; kc += KC) {
    uint32_t ahi[KC][4], alo[KC][4];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      // logical column t <- physical 2t, logical t + 4 <- physical 2t + 1
      split_tf32(p[kc + kk][0], ahi[kk][0], alo[kk][0]);
      split_tf32(p[kc + kk][2], ahi[kk][1], alo[kk][1]);
      split_tf32(p[kc + kk][1], ahi[kk][2], alo[kk][2]);
      split_tf32(p[kc + kk][3], ahi[kk][3], alo[kk][3]);
    }
    const float* b = sB + (8 * kc + 2 * t) * LDB + g;
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += JG) {
      float small[JG][4], big[JG][4];
      zero(small);
      zero(big);
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
#pragma unroll
        for (int jj = 0; jj < JG; ++jj) {
          const float* bk = b + 8 * kk * LDB + 8 * (j0 + jj);
          uint32_t bhi[2], blo[2];
          split_tf32(bk[0], bhi[0], blo[0]);
          split_tf32(bk[LDB], bhi[1], blo[1]);
          mma_tf32(small[jj], alo[kk], bhi);
          mma_tf32(small[jj], ahi[kk], blo);
          mma_tf32(big[jj], ahi[kk], bhi);
        }
#pragma unroll
      for (int jj = 0; jj < JG; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[j0 + jj][e] += small[jj][e] + big[jj][e];
    }
  }
}

template <int KT, int NT, int LDB>
__device__ __forceinline__ void gemm_rn(float (&c)[NT][4],
                                        const float (&p)[KT][4],
                                        const __nv_bfloat16* sB, int g,
                                        int t) {
  static_assert(KT % 2 == 0, "bf16 takes 16 keys a step");
#pragma unroll
  for (int kk = 0; kk < KT; kk += 2) {
    uint32_t a[4];
    a[0] = pack_f32(p[kk][0], p[kk][1]);
    a[1] = pack_f32(p[kk][2], p[kk][3]);
    a[2] = pack_f32(p[kk + 1][0], p[kk + 1][1]);
    a[3] = pack_f32(p[kk + 1][2], p[kk + 1][3]);
    const __nv_bfloat16* b = sB + (8 * kk + 2 * t) * LDB + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* bj = b + 8 * j;
      const uint32_t bb[2] = {pack_rows(bj, bj + LDB),
                              pack_rows(bj + 8 * LDB, bj + 9 * LDB)};
      mma_bf16(c[j], a, bb);
    }
  }
}

// max and sum over the four lanes (one quad) that share a fragment row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// every pointer 16-byte aligned and every row stride a whole number of
// 16-byte chunks: the tiles may be staged with cp.async
inline bool aligned16(const void* const* ptrs, int n, const int64_t* strides,
                      int m, int elem_bytes) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < m; ++i)
    if ((strides[i] * elem_bytes) % 16 != 0) return false;
  return true;
}

// launch `kernel` on `blocks` blocks, raising the dynamic shared-memory
// limit first where the tiles need more than the 48 KB default
template <typename Params>
cudaError_t launch(void (*kernel)(Params), const Params& p, int blocks,
                   int threads, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace flash
