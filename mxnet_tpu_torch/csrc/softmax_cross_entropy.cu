// Fused softmax cross-entropy forward for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel `_ce_kernel` / `_ce_fwd`
// (mxnet_tpu/ops/pallas_kernels.py:325-367). It computes the same
// function: for each row i of (N, C) logits, in f32,
//   lse_i  = log(sum_j exp(x_ij))
//   loss_i = lse_i - x_i[label_i]
// with the label gather fused in (the TPU kernel left it to XLA). A label
// in [-C, 0) picks class C + label and any other outside [0, C) gives a NaN
// loss, as the JAX package's take_along_axis does. The wrapper hands it
// exactly N labels (one label broadcasts to every row there). Any N and C: the TPU kernel only ran when C % 128 == 0 and
// N % 8 == 0, and OPT's vocabulary (50272) is not a multiple of 128. The
// gradient, (softmax - onehot) * g, is plain PyTorch from the saved lse, as
// the JAX package left `_ce_bwd` to XLA.
//
// Design. One thread block of 256 threads per row. Each thread walks the row
// with stride 256 (neighbouring threads on neighbouring addresses) keeping
// an online (max, sum of exp(x - max)) pair, so the row is read from device
// memory once; the pairs merge across the warp with shuffles and across
// the block through shared memory.
//
// What bounds it on this card: one read of the logits (N*C elements) and a
// few bytes a row written; a handful of operations per element, far below
// the ridge point, so it is bound by bytes (3.35 TB/s).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsoftmax_cross_entropy.so softmax_cross_entropy.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// fold one value into the running (m, s): s = sum exp(x - m), m = max x
__device__ __forceinline__ void online_add(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;   // m = -inf: exp(-inf) = 0
    m = x;
  } else if (x > -INFINITY) {
    s += expf(x - m);
  } else if (x != x) {
    s = NAN;                     // NaN in, NaN out
  }                              // x = -inf adds nothing
}

__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) {
    s = s + s2;                  // both empty so far (or NaN)
  } else {
    s = s * expf(m - mn) + s2 * expf(m2 - mn);
  }
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(const T* logits, const int64_t* labels, float* lse,
                  float* loss, int64_t c) {
  const int64_t row = blockIdx.x;
  const T* x = logits + row * c;
  float m = -INFINITY, s = 0.f;
  for (int64_t j = threadIdx.x; j < c; j += kThreads)
    online_add(m, s, to_f32(x[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  __shared__ float sm[kWarps], ss[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = sm[0];
    s = ss[0];
    for (int w = 1; w < kWarps; ++w) merge(m, s, sm[w], ss[w]);
    const float r = m == -INFINITY ? -INFINITY : m + logf(s);
    int64_t label = labels[row];
    if (label < 0) label += c;  // [-C, 0) wraps, as take_along_axis does
    const float picked =
        (label >= 0 && label < c) ? to_f32(x[label]) : NAN;
    lse[row] = r;
    loss[row] = r - picked;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 logits (N, C), contiguous; labels (N,)
// int64; lse, loss (N,) f32. Returns the cudaError_t of the launch (0 =
// success); the wrapper raises on any other.
int mxtt_softmax_cross_entropy_fwd(const void* logits, const void* labels,
                                   void* lse, void* loss, int dtype,
                                   long long n, long long c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  float* l = static_cast<float*>(lse);
  float* o = static_cast<float*>(loss);
  if (n <= 0) return (int)cudaSuccess;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n);
  if (dtype == 0) {
    ce_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(logits), lab, l, o, c);
  } else if (dtype == 1) {
    ce_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), lab, l, o, c);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
