#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure (non-zero exit, no result line):

1. set-up: refuse to run without CUDA; print the card's name and power
   limit and the TF32 flags (TF32 stays off: float32 products run in full
   float32); build every Hopper kernel from ``mxnet_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together).
2. kernels: hold each kernel against its plain PyTorch version on the card
   — the flash-attention forward and backward over a grid of dtypes, head
   dims, masks, ragged lengths and offsets (and the edges of their tiles:
   ``attention_edge_cases``), the fused cross-entropy on ragged and
   full-vocabulary shapes — with controls (the plain versions in TF32, or
   on TF32-rounded logits) that must miss each float32 tolerance; launch
   each flash kernel twice at the main shape and require bitwise-equal
   results (and of Embedding's backward at the training shape, beside
   the ``index_select`` it replaced); then time each kernel, its plain version and the library's
   call at the shapes the main paths give it. Each bound is the least time
   over the routes that meet the gates (``roofline_ms``): float32 products
   as three TF32 passes on the tensor cores, bf16 on the tensor cores, or
   bytes at the HBM rate; the old float32 CUDA-core bound is printed
   beside the attention kernels'.
3. serving: the repo's causal TransformerLM graph at the published widths
   of OPT-6.7B (``facebook/opt-6.7b`` config.json: hidden 4096, 32 heads of
   128, FFN 16384, vocab 50272, context 2048), cut to 4 of its 32 layers,
   with seeded random weights, written with ``nd.save`` and served through
   ``model_config_from_files`` and ``ModelServer`` on the card. Every
   response's logits are held against a plain PyTorch float32 forward of
   the same model, and the kernels' launch counts against the dispatches.
4. training: the same LM as ``gluon.contrib.transformer.TransformerLM``
   (untied head, dropout 0), trained three Adam steps on 4 × 2048 tokens
   through ``autograd.record()``, the ``softmax_cross_entropy`` op and
   ``gluon.Trainer``. Step 1's loss and every gradient are held against a
   plain float32 forward and backward of the same weights (the kernels'
   plain versions under torch autograd), with TF32 and bf16 controls that
   must miss; the launch counts against the steps.
5. user kernels: the user's CUDA sources below (axpy, ``softmax_fwd``,
   ``softmax_ce_bwd``), compiled at run time by NVRTC through
   ``mx.rtc.CudaModule`` (compile times printed as set-up), held against
   their plain versions with TF32-rounded controls that must miss, and
   timed with one launch's host overhead.
6. extension: the same LM trained three Adam steps (lr 1e-4, a
   ``FactorScheduler`` whose first drop falls on step 3) with the user's
   ``CustomOp`` loss head (``mx.nd.Custom``; its forward and backward are
   the NVRTC kernels) and ``trainer.step(1)``. Step 1 is held against the
   B2 head on the same weights (bitwise logits, gradients, loss); after
   step 2 ``save_parameters`` and ``save_states`` write a checkpoint that a
   fresh net and trainer load, and their step 3 must equal the
   uninterrupted one. Launch counts per step.

7. module: the same LM written as a checkpoint of the symbolic route
   (``build_lm_symbol``'s graph and the weights under its names, through
   ``model.save_checkpoint``), loaded with ``model.load_checkpoint`` and
   trained three Adam steps (MXNet's rule, ``rescale_grad`` 1/8192) by
   ``mx.mod.Module`` with a ``MakeLoss(softmax_cross_entropy)`` head, fed
   by an ``NDArrayIter``. Step 1's loss and the executor's gradients are
   held against the plain reference as in phase 4, the loss also against
   phase 4's on the same weights; the host time of one
   ``forward_backward`` dispatch is reported apart from its device time.
8. fused: the same files through ``gluon.SymbolBlock.imports`` and a
   one-card ``parallel.DataParallelTrainer`` (optax's SGD, momentum 0.9,
   lr 10 for the checked first step and 1 after it) with
   ``gluon.loss.SoftmaxCrossEntropyLoss``, three steps. Step 1's loss
   is held against the plain reference's mean, and the weights after it
   against ``w0 − lr·g_plain`` (with a TF32 control and the f32 rounding
   floor of that subtraction); ``sync_to_net`` must give the block the
   trainer's weights bitwise. Both routes check their launch counts per
   step: B1 4, B3 4 + 4, and B2 1 (Module) or 0 (fused).
9. mixed: the same files through ``SymbolBlock.imports`` with the table
   as a data input and ``DataParallelTrainer(compute_dtype="bfloat16")``
   on int32 token ids (B1 and B3 in bf16): three steps for each of
   ``remat=None``, ``"dots"`` and ``"full"`` from the file's weights (the
   losses and weights of the three bitwise equal, B1 launched 4 or 8 times
   a step, peak memory printed and lower under ``"full"``), then one step
   with loss scaling (bitwise the unscaled step) and one on a batch
   holding an ``inf`` (skipped: weights and momentum unchanged, the scale
   halved). Step 1's gradient against the plain float32 step may be at
   most 1.25× as far as the plain bf16 control's, tensor by tensor.
10. bucketing: ``BucketingModule`` over the LM graph at buckets T = 2048
   and 1024 with the ``MakeLoss`` head, steps on 2048, 1024 and 2048: the
   first loss bitwise the Module route's, the 1024 step through the
   Module route's gates at T = 1024, one storage for every parameter in
   both buckets.
11. sequential: one step of ``SequentialModule`` (the LM up to its logits,
   then the loss module): loss and weights those of the Module route.
12. ResNet-50, route A (the headline, ``bench.py``'s ResNet step):
   ``vision.resnet50_v1(classes=1000, layout="NHWC")`` at its published
   depth and widths, Xavier, ``SoftmaxCrossEntropyLoss`` and the fused
   trainer's SGD (lr 0.1, momentum 0.9, wd 1e-4) in bf16 on 256 images
   of 224x224x3 (uniform(-1, 1), random labels, seed 0): a first step,
   ten timed ones (step ms, host dispatch ms, images/s, peak memory), one
   under ``ConvCensus`` (every convolution, forward and backward, must take
   bf16 inputs; copies that change a tensor's memory format are counted)
   and one under ``torch.profiler`` (busy share, device time by class, the
   optimizer's range apart); a second trainer from the same weights
   repeats step 1 (bitwise or not is printed).
13. route C: the trained net exported and served through ``ModelServer``
   (8 requests of one image, buckets 1/2/4/8): the logits of the gluon
   net's inference forward.
14. the gates at batch 32, against the same step in float64 on the card:
   route B (the NCHW net through gluon in float32, TF32 off; a TF32
   control must miss), the NHWC net against the NCHW net with its weights
   transposed, and route A's bf16 fused step (loss and output layer; a
   control with moved labels must miss), then route B's ``gluon.Trainer``
   step. Below the output layer the freshly initialised net's backward is
   chaotic (see the tolerances), which the printed errors show.
15. the zoo: one net of each family (AlexNet, VGG-11 BN, ResNet-18 v2,
   SqueezeNet 1.0, MobileNet 1.0 and v2, DenseNet-121, Inception v3 at
   299), its float32 forward against its float64 forward.
16. route D, the word-level LSTM LM (``example/gluon/word_language_model/
   train_torch.py``, the recipe twin) at the large PTB widths (vocabulary
   10,000, 1500 x 1500, 2 layers, bptt 35, batch 32, SGD lr 1.0, the
   recipe's clip): step 1 against float64 on the card (loss, clipped
   gradients, update) with a TF32 control that must miss; the clip in the
   ``.grad`` buffers themselves; the hidden state detached into step 2; a
   repeat of step 1 (bitwise or not); ten timed steps at dropout 0.65 (step
   ms, host dispatch ms, tokens/s, peak memory), the packing copies of one
   step (``RnnCensus``, none allowed), a ``torch.profiler`` breakdown, and
   cuDNN's ``nn.LSTM`` at the same shape as the library's yardstick.
17. the other modes at route D's widths: ``gluon.rnn.GRU``, ``RNN`` (relu,
   tanh) and a bidirectional ``LSTM``, forward and backward against
   float64; ``LSTMCell.unroll`` against the fused layer.
18. route E, the symbolic route: the bucketing twin's ``sym_gen`` at
   ``lstm_bucketing.py``'s defaults (two ``LSTMCell``s of 200, embedding
   200, batch 32, buckets 10..60) at vocabulary 10,000 through
   ``BucketSentenceIter`` and ``BucketingModule`` (Adam): the first loss
   against float64, one storage across the buckets, perplexity falling,
   the RNN checkpoint round trip.
19. route F, the detection family: SSD300 with the VGG16-reduced body
   (``build_ssd300``: Liu et al. 2016's widths as the reference
   ``example/ssd`` builds them, 8,732 anchors, VOC's 20 classes and the
   background; nothing cut) trained on the card through ``mx.mod.Module``
   at batch 32 in float32 (SGD lr 1e-3, momentum 0.9, wd 5e-4), its
   batches read by ``ImageDetRecordIter`` from 128 synthetic VOC-style
   300x300 JPEG records that ``example/ssd/dataset_torch.py`` writes. Step
   1 against the same step in float64 on the card (loss, heads, the
   gradients: the heads' tightly, the body's loosely); ``Module.fit`` for
   three epochs (the loss must fall); ten steps timed with their batches on
   the card (step ms, host dispatch, images/s, peak memory; a
   ``torch.profiler`` breakdown with ``--profile``) and the iterator's
   batch timed apart; ``MultiBoxTarget`` and ``MultiBoxDetection`` at
   8,732 anchors and batch 32 on the card against the CPU (discrete
   outputs equal) and timed; then the trained weights served through the
   detection graph (``MultiBoxDetection``, nms_topk 400).
Before 16, the ``transformer_lm`` recipe twin trains three epochs at its
own size (its accuracy must pass the JAX recipe's test threshold, 0.5).

``--profile`` adds a ``torch.profiler`` breakdown of one serving dispatch,
one training step, one custom-head step, one Module step, one fused step,
one bf16 fused step and one route F step (route A's and route D's steps
are profiled in every run). Apart from the ``transformer_lm`` twin, no
phase from 12 on launches a Hopper kernel: the conv nets, the recurrent
family and the detection family reach no TPU kernel (the JAX package
lowers their convolutions, pools, recurrence and multibox ops through
XLA; cuDNN, cuBLAS and plain torch run the port's). The line before
the last is a JSON object with one entry per kernel (the flash kernels'
bf16 times at the main shape under ``"bf16"``); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mxnet_tpu_torch as mx

# the model: OPT-6.7B widths, depth cut to 4 of 32 (one layer is a whole
# period of the pattern)
OPT_6_7B = dict(vocab=50272, units=4096, heads=32, ffn=16384, max_len=2048,
                layers=4)
SERVE_BUCKETS = (1, 2, 4)
SERVE_REQUESTS = 8
TRAIN_BATCH = 4       # sequences of the full 2048-token context
TRAIN_STEPS = 3
TRAIN_LR = 1e-4
# the fused trainer's SGD (optax's rule, momentum 0.9). Its step-1 weights
# are held against w0 - lr·g_plain, so the first step's lr must put the
# f32 rounding of that subtraction 10x below the gates: fused_gate prints
# the rounding floor at each candidate and fails if the chosen one is not
# there (10: 2.9e-6 above the last ReLU, 3.6e-5 over all tensors, against
# 1e-4 and 5e-3). Three steps at 10 with momentum 0.9 overshoot (the loss
# at step 3 rose from 11.66 to 24.07), so the later steps take lr 1: an
# optax schedule of the update count.
FUSED_LR = 10.0
FUSED_LR_LATER = 1.0
FUSED_LR_CANDIDATES = (1.0, 3.0, 10.0, 30.0, 100.0)
FUSED_MOMENTUM = 0.9
SEED = 0

# card peaks for the roofline bound (NVIDIA H100 SXM data sheet, dense)
PEAK_F32_FLOPS = 67e12          # float32 on the CUDA cores
PEAK_TF32_FLOPS = 495e12        # TF32 on the tensor cores
PEAK_BF16_FLOPS = 989e12        # bf16 on the tensor cores
PEAK_BYTES_S = 3.35e12          # HBM3
# The routes a product can take and still meet the gates below, as
# seconds per FLOP of the product. One TF32 pass misses the float32 gates
# (its control does), so float32 on the tensor cores is the split-TF32
# product: three TF32 passes (a_lo.b_hi + a_hi.b_lo + a_hi.b_hi).
TF32_PASSES = 3
PRODUCT_ROUTES = {
    "f32": {"f32 CUDA cores": 1.0 / PEAK_F32_FLOPS,
            "3-pass TF32 tensor cores": TF32_PASSES / PEAK_TF32_FLOPS},
    "bf16": {"bf16 tensor cores": 1.0 / PEAK_BF16_FLOPS},
    # elementwise work and reductions: no tensor-core route
    None: {"f32 CUDA cores": 1.0 / PEAK_F32_FLOPS},
}

# tolerances, with their reasons; each run also computes the plain
# versions with TF32 (and the LM in bf16) as controls, and fails unless
# every control lies outside the tolerance it stands beside
TOL_OUT_F32 = 1e-4    # same f32 math, another summation order, T <= 2048
TOL_OUT_BF16 = 2e-2   # bf16 output rounding vs the f32 answer on bf16 inputs
TOL_LSE = 1e-4        # lse stays f32 in both
TOL_LOGITS = 1e-4     # x max|logit|: 4 f32 layers, cuBLAS vs kernel order
TOL_GRAD_F32 = 1e-5   # dq, dk, dv, x max|plain|: f32 sums over <= 2048 keys
TOL_GRAD_BF16 = 1e-2  # bf16 rounding (2^-8) of each gradient written
TOL_CE = 2e-5         # lse and loss, absolute: f32 sums of <= 50272 terms
TOL_TRAIN_LOSS = 1e-5  # step-1 loss, relative
# step-1 gradients, ||g - plain|| / ||plain|| per tensor. Below a ReLU the
# two float32 runs disagree on the few units whose pre-activation lies
# within rounding of zero, and each such flip moves a whole token's term
# of the gradient: about 1e-3 in norm (and 8e-3 in max|.|) at every tensor
# a ReLU's backward reaches, against 2e-2 for the TF32 control. The
# tensors above the last ReLU (head, final LayerNorm, last fc2) see no
# flip and are held at 1e-4.
TOL_TRAIN_GRAD = 5e-3
TOL_TRAIN_GRAD_TOP = 1e-4
# the Module route's step-1 loss against the gluon path's on the same
# weights: the same ops on the same values, one summation order apart
TOL_ROUTE_LOSS = 1e-6
# the user kernels (mx.rtc) against their plain versions: axpy is exact
# (2x is exact, so fma and mul-then-add round alike); softmax differs by
# expf and the order of a row's sum, (p - onehot)*scale by at most an ulp
TOL_RTC_SOFTMAX = 1e-5    # max|dp| / max p
TOL_RTC_CE_BWD = 1e-5     # max|dg| / max|g|
# the extension path: the custom head's step-1 gradients x N against the
# B2 head's (same forward, bitwise; only p's rounding differs), per tensor
# ||dg||/||g||; the step-1 loss -mean log p[label] against B2's loss / N,
# relative; the resumed step 3 against the uninterrupted one, x max|w|.
# The gradient's norm is mostly its one-hot term, so the control (the head
# on TF32-rounded logits) moves the parameters' gradients by only 2.7e-6
# to 8.1e-6: 1e-4 could not tell it apart. The port read 1.8e-6 at its
# worst tensors (the embedding, layer 0's attention) in two full runs
# although the logits are bitwise equal, and a resumed step that should
# repeat the uninterrupted one differs by 2e-9 of max|w|: some op of the
# backward is not deterministic on the card.
TOL_EXT_GRAD = 4e-6
TOL_EXT_LOSS = 1e-6
TOL_RESUME = 1e-6
EXT_LR_STEP, EXT_LR_FACTOR = 2, 0.5   # FactorScheduler: first drop at step 3
AXPY_N = 1 << 24


# ------------------------------------------------- user code: mx.rtc kernels
# CUDA sources a user of the port writes, compiled at run time by NVRTC
# (mx.rtc.CudaModule), and the CustomOp loss head that launches them: the
# reference's example/numpy-ops/custom_softmax_rtc.py recipe. Plain PyTorch
# versions of each kernel sit beside them; the tests import this code.
AXPY_C_SOURCE = r"""
extern "C" __global__ void axpy(const float* x, float* y, float a, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = a * x[i] + y[i];
}
"""

# softmax_fwd: one block a row. Bound by bytes (each logit read once, each
# probability written once). Where the row fits in shared memory (C <= 55K
# floats: OPT's 50272 is 201 KB, above the 48 KB default, so the launch
# raises the limit) the first pass keeps it there and the write pass reads
# it back, so the row leaves device memory once; otherwise it is read
# twice. The first pass carries an online (max, sum) per thread, merged
# across the block by warp shuffles; any N and C.
# softmax_ce_bwd: (p - onehot(label)) * scale over (N, C), the label gather
# fused in. Labels are floats truncated to integers, a negative one counts
# from the end of the row (numpy's indexing), and one outside [-C, C)
# gives a row of NaN (numpy raises; a kernel cannot).
USER_KERNELS_SOURCE = r"""
#define NEG_INF __int_as_float(0xff800000)

template <typename T>
__global__ void axpy(const T* x, T* y, T a, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = a * x[i] + y[i];
}

__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  float mn = fmaxf(m, m2);
  if (mn == NEG_INF) return;               // both empty: stays (-inf, 0)
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void push(float& m, float& s, float v) {
  if (v > m) { s = s * expf(m - v) + 1.f; m = v; }
  else if (m != NEG_INF) s += expf(v - m);
}

template <typename T>
__global__ void softmax_fwd(const T* __restrict__ x, T* __restrict__ p,
                            int C, int cached) {
  extern __shared__ float row[];
  __shared__ float wm[32], ws[32];
  const T* xr = x + (long long)blockIdx.x * C;
  T* pr = p + (long long)blockIdx.x * C;
  const int stride = blockDim.x;
  float m = NEG_INF, s = 0.f;
  int j = threadIdx.x;
  for (; j + 3 * stride < C; j += 4 * stride) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = static_cast<float>(xr[j + u * stride]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (cached) row[j + u * stride] = v[u];
      push(m, s, v[u]);
    }
  }
  for (; j < C; j += stride) {
    float v = static_cast<float>(xr[j]);
    if (cached) row[j] = v;
    push(m, s, v);
  }
  for (int off = 16; off > 0; off >>= 1)
    merge(m, s, __shfl_xor_sync(0xffffffffu, m, off),
          __shfl_xor_sync(0xffffffffu, s, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { wm[warp] = m; ws[warp] = s; }
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    m = lane < nw ? wm[lane] : NEG_INF;
    s = lane < nw ? ws[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      merge(m, s, __shfl_xor_sync(0xffffffffu, m, off),
            __shfl_xor_sync(0xffffffffu, s, off));
    if (lane == 0) { wm[0] = m; ws[0] = s; }
  }
  __syncthreads();
  m = wm[0];
  const float inv = 1.f / ws[0];
#pragma unroll 4
  for (j = threadIdx.x; j < C; j += stride) {
    float v = cached ? row[j] : static_cast<float>(xr[j]);
    pr[j] = static_cast<T>(expf(v - m) * inv);
  }
}

template <typename T>
__global__ void softmax_ce_bwd(const T* __restrict__ p,
                               const float* __restrict__ label,
                               T* __restrict__ g, int C, float scale) {
  const long long r = blockIdx.x;
  long long lab = (long long)label[r];
  if (lab < 0) lab += C;
  const bool ok = lab >= 0 && lab < C;
  const float nan = __int_as_float(0x7fc00000);
  const T* pr = p + r * C;
  T* gr = g + r * C;
#pragma unroll 4
  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    float v = static_cast<float>(pr[j]) - (j == lab ? 1.f : 0.f);
    gr[j] = static_cast<T>(ok ? v * scale : nan);
  }
}
"""
SMEM_ROW_LIMIT = 220 * 1024     # bytes of a row kept in shared memory


def axpy_plain(x, y, a):
    """``a·x + y``, the plain version of both axpy exports."""
    return a * x + y


def softmax_plain(x):
    """Row softmax of (N, C) logits, the plain version of ``softmax_fwd``."""
    e = torch.exp(x - x.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


def softmax_ce_bwd_plain(p, label, scale):
    """``(p - onehot(label))·scale``, the plain version of
    ``softmax_ce_bwd`` (labels truncated, negative ones wrapped, a row
    with a label outside [-C, C) all NaN)."""
    N, C = p.shape
    lab = label.to(torch.int64)
    lab = torch.where(lab < 0, lab + C, lab)
    ok = (lab >= 0) & (lab < C)
    g = p.float().clone()
    rows = torch.arange(N, device=p.device)
    g[rows[ok], lab[ok]] -= 1.0
    g.mul_(scale)
    g[~ok] = float("nan")
    return g.to(p.dtype)


class UserKernels:
    """The user's three kernels on ``mx.rtc``: axpy (an ``extern "C"``
    module and a template export), ``softmax_fwd<float>`` and
    ``softmax_ce_bwd<float>``. Nothing compiles before the first launch on
    a card; each wrapper checks its inputs and launches (each kernel counts
    its launches in ``.launches``)."""

    def __init__(self):
        sig = "const float* x, float* y, float a, int n"
        self.c_module = mx.rtc.CudaModule(AXPY_C_SOURCE)
        self.module = mx.rtc.CudaModule(
            USER_KERNELS_SOURCE,
            exports=("axpy<float>", "softmax_fwd<float>",
                     "softmax_ce_bwd<float>"))
        self.axpy_c = self.c_module.get_kernel("axpy", sig)
        self.axpy_t = self.module.get_kernel("axpy<float>", sig)
        self.softmax = self.module.get_kernel(
            "softmax_fwd<float>", "const float* x, float* p, int C, int cached")
        self.ce_bwd = self.module.get_kernel(
            "softmax_ce_bwd<float>",
            "const float* p, const float* label, float* g, int C, float scale")

    def kernels(self):
        return {"rtc_axpy": (self.axpy_c, self.axpy_t),
                "rtc_softmax_fwd": (self.softmax,),
                "rtc_softmax_ce_bwd": (self.ce_bwd,)}

    def reset_launch_counts(self):
        for ks in self.kernels().values():
            for k in ks:
                k.launches = 0

    def launch_counts(self):
        return {name: sum(k.launches for k in ks)
                for name, ks in self.kernels().items()}

    @staticmethod
    def _ctx(t):
        return mx.Context.from_torch(t.device)

    def axpy(self, x, y, a=2.0, template=False):
        """``y ← a·x + y`` on 1-d float32 CUDA tensors."""
        n = x.numel()
        if y.numel() != n:
            raise mx.MXNetError(f"axpy: {n} and {y.numel()} elements")
        k = self.axpy_t if template else self.axpy_c
        k.launch([x, y, float(a), n], self._ctx(x), ((n + 255) // 256,),
                 (256,))

    def softmax_fwd(self, x, p):
        """``p ← softmax(x)`` by rows of (N, C) float32 CUDA tensors."""
        N, C = x.shape
        if tuple(p.shape) != (N, C):
            raise mx.MXNetError(f"softmax_fwd: out {tuple(p.shape)} for "
                                f"logits {(N, C)}")
        cached = 4 * C <= SMEM_ROW_LIMIT
        threads = min(1024, max(32, (C + 31) // 32 * 32))
        self.softmax.launch([x, p, C, int(cached)], self._ctx(x), (N,),
                            (threads,), 4 * C if cached else 0)

    def softmax_ce_bwd(self, p, label, g, scale):
        """``g ← (p − onehot(label))·scale`` on (N, C) float32 CUDA tensors,
        float32 labels (N,)."""
        N, C = p.shape
        if tuple(g.shape) != (N, C) or tuple(label.shape) != (N,):
            raise mx.MXNetError(f"softmax_ce_bwd: grad {tuple(g.shape)}, "
                                f"labels {tuple(label.shape)} for p {(N, C)}")
        threads = min(512, max(32, (C + 31) // 32 * 32))
        self.ce_bwd.launch([p, label, g, C, float(scale)], self._ctx(p),
                           (N,), (threads,))


KERNELS = UserKernels()


def _on_card(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise mx.MXNetError(f"rtc_softmax_ce: no kernel for {t.device}")


class RtcSoftmaxCE(mx.operator.CustomOp):
    """Softmax loss head: forward ``p = softmax(x)``, backward
    ``(p − onehot(label))/N``, the gradient of the mean cross-entropy. On
    the card each launches its ``mx.rtc`` kernel straight into the buffer
    the bridge allocated (the imperative bridge asks for ``write``); on
    the CPU it takes the plain version."""

    def forward(self, is_train, req, in_data, out_data, aux):
        x, out = in_data[0]._data, out_data[0]
        if _on_card(x):
            KERNELS.softmax_fwd(x, out._data)
        else:
            self.assign(out, req[0], softmax_plain(x))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        p, label = out_data[0]._data, in_data[1]._data
        scale = 1.0 / label.shape[0]
        if _on_card(p):
            KERNELS.softmax_ce_bwd(p, label, in_grad[0]._data, scale)
        else:
            self.assign(in_grad[0], req[0],
                        softmax_ce_bwd_plain(p, label, scale))
        self.assign(in_grad[1], req[1], 0.0)    # labels take no gradient


@mx.operator.register("rtc_softmax_ce")
class RtcSoftmaxCEProp(mx.operator.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def create_operator(self, ctx, shapes, dtypes):
        return RtcSoftmaxCE()


def sinusoid_table(max_len: int, units: int) -> np.ndarray:
    """The fixed sin/cos table of ``SinusoidalPositionalEmbedding``
    (mxnet_tpu/gluon/contrib/transformer.py)."""
    pos = np.arange(max_len)[:, None]
    dim = np.arange(0, units, 2)[None, :]
    angle = pos / np.power(10000.0, dim / units)
    table = np.zeros((max_len, units), "float32")
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle[:, : units // 2])
    return table


def build_lm_symbol(sym, vocab, units, layers, heads, ffn, max_len=None):
    """The causal TransformerLM graph exactly as the JAX package's gluon
    ``export()`` writes it (Embedding, sinusoidal positions, pre-norm blocks
    with fused-QKV flash attention and a ReLU FFN, final LayerNorm, untied
    head), built with ``sym`` — either package's ``mx.sym``. Inputs: ``data``
    (B, T) token ids; argument ``pos_table`` (max_len, units), its shape
    declared on the variable when ``max_len`` is given (so that a Module
    can infer it from the data shapes alone)."""
    d = units // heads
    x = sym.Embedding(sym.Variable("data"), input_dim=vocab,
                      output_dim=units, name="embed")
    table = sym.Variable("pos_table", shape=None if max_len is None
                         else (max_len, units))
    tab = sym.slice_like(sym.expand_dims(table, axis=0), x, axes=(1,))
    x = sym.broadcast_add(x, tab)
    for i in range(layers):
        p = f"layer{i}_"
        h = sym.LayerNorm(x, axis=-1, eps=1e-5, name=p + "ln1")
        qkv = sym.FullyConnected(h, num_hidden=3 * units, no_bias=False,
                                 flatten=False, name=p + "qkv")
        qkv = sym.reshape(qkv, shape=(0, 0, 3 * heads, d))
        qkv = sym.transpose(qkv, axes=(0, 2, 1, 3))
        q = sym.slice_axis(qkv, axis=1, begin=0, end=heads)
        k = sym.slice_axis(qkv, axis=1, begin=heads, end=2 * heads)
        v = sym.slice_axis(qkv, axis=1, begin=2 * heads, end=3 * heads)
        a = sym.contrib_flash_attention(q, k, v, causal=True)
        a = sym.reshape(sym.transpose(a, axes=(0, 2, 1, 3)), shape=(0, 0, -1))
        a = sym.FullyConnected(a, num_hidden=units, no_bias=False,
                               flatten=False, name=p + "proj")
        x = sym.broadcast_add(x, sym.Dropout(a, p=0.0, axes=()))
        h = sym.LayerNorm(x, axis=-1, eps=1e-5, name=p + "ln2")
        h = sym.FullyConnected(h, num_hidden=ffn, no_bias=False,
                               flatten=False, name=p + "fc1")
        h = sym.Activation(h, act_type="relu")
        h = sym.FullyConnected(h, num_hidden=units, no_bias=False,
                               flatten=False, name=p + "fc2")
        x = sym.broadcast_add(x, sym.Dropout(h, p=0.0, axes=()))
    x = sym.LayerNorm(x, axis=-1, eps=1e-5, name="lnf")
    return sym.FullyConnected(x, num_hidden=vocab, no_bias=True,
                              flatten=False, name="head")


def plain_forward(w, tokens, vocab, units, layers, heads, attend=None,
                  norm=None):
    """The same LM as one plain float32 PyTorch function: no registry, no
    executor, no kernel. ``w`` maps argument names to tensors; ``tokens``
    (B, T) int64; ``attend(q, k, v)`` on (B, H, T, D) is causal attention,
    by default a dense masked softmax; ``norm(x, gamma, beta)`` is the
    LayerNorm, by default ``F.layer_norm``."""
    import torch
    import torch.nn.functional as F
    B, T = tokens.shape
    d = units // heads
    x = w["embed_weight"][tokens.clamp(0, vocab - 1)] + w["pos_table"][:T]
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()

    def dense_attention(q, k, v):
        s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        att = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        return torch.matmul(att, v)

    attend = attend or dense_attention

    def ln(x, name):
        if norm is not None:
            return norm(x, w[name + "_gamma"], w[name + "_beta"])
        return F.layer_norm(x, (units,), w[name + "_gamma"],
                            w[name + "_beta"], eps=1e-5)

    for i in range(layers):
        p = f"layer{i}_"
        qkv = F.linear(ln(x, p + "ln1"), w[p + "qkv_weight"],
                       w[p + "qkv_bias"])
        q, k, v = qkv.reshape(B, T, 3, heads, d).permute(2, 0, 3, 1, 4)
        a = attend(q, k, v).transpose(1, 2).reshape(B, T, units)
        x = x + F.linear(a, w[p + "proj_weight"], w[p + "proj_bias"])
        h = torch.relu(F.linear(ln(x, p + "ln2"), w[p + "fc1_weight"],
                                w[p + "fc1_bias"]))
        x = x + F.linear(h, w[p + "fc2_weight"], w[p + "fc2_bias"])
    return F.linear(ln(x, "lnf"), w["head_weight"])


def _time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def attention_edge_cases(dtype, head_dims):
    """Grid entries (dtype, (B, H, Tq, Tk, D), causal, q_offset, k_offset)
    at the edges of the tensor-core kernels' tiles (128 query rows or keys
    a block, 64 or 32 a loop tile), at every head dim: Tq and Tk that are
    multiples of neither; a whole 128-row query tile with no visible key
    (k_offset 150: rows 0..149 see none), which the forward and dQ skip
    and the dK/dV kernel's first key tile never visits; and a later query
    block (q_offset > 0) with Tq < Tk, whose last keys no row sees."""
    grid = []
    for D in head_dims:
        grid.append((dtype, (1, 2, 200, 300, D), True, 0, 150))
        grid.append((dtype, (1, 2, 150, 333, D), True, 100, 0))
        grid.append((dtype, (1, 2, 150, 333, D), False, 0, 0))
    return grid


def attention_pairs(BH, Tq, Tk, causal, q_offset=0, k_offset=0) -> float:
    """(query, key) pairs the mask lets through, over all heads."""
    if not causal:
        return float(BH) * Tq * Tk
    rows = np.arange(Tq, dtype=np.int64) + q_offset - k_offset + 1
    return float(BH) * float(np.clip(rows, 0, Tk).sum())


def attention_flops(BH, Tq, Tk, D, causal, q_offset=0, k_offset=0):
    """Multiply-adds (x2) that attention needs on these inputs: q.k^T and
    p.v over the keys each row sees, none for masked keys."""
    return 4.0 * D * attention_pairs(BH, Tq, Tk, causal, q_offset, k_offset)


def roofline_ms(flops: float, nbytes: float, products=None):
    """(least time in ms on this card for the work, "operations" or
    "bytes", the route of that time): the operations at the fastest route
    of ``PRODUCT_ROUTES[products]`` (``"f32"`` or ``"bf16"`` matrix
    products; ``None`` for work the tensor cores cannot take), the bytes at
    the HBM rate; the larger of the two bounds it."""
    route, s_per_flop = min(PRODUCT_ROUTES[products].items(),
                            key=lambda kv: kv[1])
    t_ops, t_bytes = flops * s_per_flop, nbytes / PEAK_BYTES_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations", route
    return t_bytes * 1e3, "bytes", "HBM"


@contextlib.contextmanager
def tf32_matmuls():
    """Let float32 matmuls run in TF32 inside the block (controls only)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def kernel_resources(libs) -> None:
    """Print each built kernel's registers and spill stack per thread
    (``cuobjdump -res-usage``), for the records; a card without
    ``cuobjdump`` prints that it has none."""
    import re
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin",
                                                     "cuobjdump")
    if not os.path.exists(tool):
        print("build: cuobjdump not found; registers not read")
        return
    for src, path in sorted(libs.items()):
        out = subprocess.run([tool, "-res-usage", str(path)],
                             capture_output=True, text=True).stdout
        found = re.findall(r"Function (\S+):\s*REG:(\d+) STACK:(\d+)", out)
        for name, reg, stack in found:
            m = re.search(r"(fa_fwd|fa_bwd_dkdv|fa_bwd_dq|ce_fwd)_kernelI"
                          r"(f|13__nv_bfloat16)(?:Li(\d+)E)?", name)
            label = name
            if m:
                args = ["float" if m.group(2) == "f" else "bf16"]
                args += [m.group(3)] if m.group(3) else []
                label = f"{m.group(1)}_kernel<{', '.join(args)}>"
            print(f"build: {src} {label}: {reg} registers, {stack} bytes "
                  f"of spill stack a thread")


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


# --------------------------------------------------------------- kernels
def kernel_phase(hk, dev):
    """Flash-attention forward vs its plain version; returns the record of
    the serving shape (causal, (4, 32, 2048, 128)): float32, and bfloat16
    under ``"bf16"``."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def qkv(B, H, Tq, Tk, D, dtype):
        return [torch.randn(B, H, t, D, generator=gen, device=dev)
                .to(dtype) for t in (Tq, Tk, Tk)]

    grid = []
    for dtype in (torch.float32, torch.bfloat16):
        for D in hk.SUPPORTED_HEAD_DIMS:
            for causal in (False, True):
                for (B, H, T) in ((2, 3, 77), (1, 2, 1000)):
                    grid.append((dtype, (B, H, T, T, D), causal, 0, 0))
        # ring-attention step (q block after the k block), Tq != Tk
        grid.append((dtype, (1, 2, 77, 1000, 64), True, 923, 0))
        # k block past q: rows 0..29 see no key at all (lse = -1e30)
        grid.append((dtype, (2, 2, 64, 100, 128), True, 0, 30))
        grid += attention_edge_cases(dtype, hk.SUPPORTED_HEAD_DIMS)
        grid.append((dtype, (4, 32, 2048, 2048, 128), True, 0, 0))
    worst = {}
    mains = {}
    for dtype, (B, H, Tq, Tk, D), causal, qo, ko in grid:
        q, k, v = qkv(B, H, Tq, Tk, D, dtype)
        out, lse = hk.flash_attention_with_lse(q, k, v, causal, None, qo, ko)
        ref, ref_lse = hk.flash_attention_reference(
            q.float(), k.float(), v.float(), causal, None, qo, ko)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        lerr = (lse - ref_lse).abs().max().item()
        tol = TOL_OUT_F32 if dtype == torch.float32 else TOL_OUT_BF16
        tag = (f"{str(dtype)[6:]} B={B} H={H} Tq={Tq} Tk={Tk} D={D} "
               f"causal={causal} q_offset={qo} k_offset={ko}")
        print(f"flash_attention_fwd {tag}: max|out-plain|={err:.3e} "
              f"(tol {tol}) max|lse-plain|={lerr:.3e} (tol {TOL_LSE})")
        if not (err <= tol and lerr <= TOL_LSE):
            raise AssertionError(f"flash_attention_fwd disagrees with its "
                                 f"plain version at {tag}")
        key = str(dtype)
        worst[key] = max(worst.get(key, 0.0), err)
        if (B, H, Tq, D) == (4, 32, 2048, 128):
            mains[dtype] = dict(q=q, k=k, v=v, err=err, ref=ref)
        if dtype == torch.float32 and (B, H, Tq, D) == (4, 32, 2048, 128):
            # control: the plain version with TF32 matmuls must fail both
            # f32 tolerances, or they could not tell a TF32 path apart
            with tf32_matmuls():
                c_out, c_lse = hk.flash_attention_reference(
                    q, k, v, causal, None, qo, ko)
            c_err = (c_out - ref).abs().max().item()
            c_lerr = (c_lse - ref_lse).abs().max().item()
            print(f"flash_attention_fwd control, plain version in TF32 at "
                  f"{tag}: max|out-plain|={c_err:.3e} max|lse-plain|="
                  f"{c_lerr:.3e}")
            if not (c_err > TOL_OUT_F32 and c_lerr > TOL_LSE):
                raise AssertionError("the TF32 control passes the f32 "
                                     "tolerances: they are too loose")
            del c_out, c_lse
        del q, k, v, out, lse, ref, ref_lse

    main = mains[torch.float32]
    q, k, v = main["q"], main["k"], main["v"]
    BH, T, D = 4 * 32, 2048, 128
    # the same inputs twice: the kernel has no atomics, so bitwise equal
    runs = [hk.flash_attention_with_lse(q, k, v, True) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"flash_attention_fwd determinism, f32 causal (4, 32, 2048, 128) "
          f"launched twice: out and lse bitwise equal: {same}")
    if not same:
        raise AssertionError("flash_attention_fwd is not deterministic")
    del runs
    ms = _time_ms(lambda: hk.flash_attention(q, k, v, True), reps=5)
    plain_ms = _time_ms(lambda: hk.flash_attention_reference(q, k, v, True),
                        reps=5)
    lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True), reps=5)
    flops = attention_flops(BH, T, T, D, causal=True)
    nbytes = 4.0 * (4 * BH * T * D + BH * T)   # q, k, v, out, lse (f32)
    bound_ms, bound_by, route = roofline_ms(flops, nbytes, "f32")
    cuda_core_ms = roofline_ms(flops, nbytes)[0]
    print(f"flash_attention_fwd f32 causal (4, 32, 2048, 128): kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention {lib_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}, {route}; {flops:.3e} FLOP, "
          f"{nbytes:.3e} B), f32 CUDA-core bound {cuda_core_ms:.3f} ms; "
          f"worst errors {worst}; card {_card_line()}")
    # the grid's bf16 case at this shape, the mixed-precision route's
    mb = mains[torch.bfloat16]
    qb, kb, vb = mb["q"], mb["k"], mb["v"]
    timed = {}

    def run_bf16():
        timed["out"] = hk.flash_attention(qb, kb, vb, True)

    bf16 = {
        "max_abs_err": mb["err"],
        "ms": _time_ms(run_bf16, reps=5),
        "plain_ms": _time_ms(lambda: hk.flash_attention_reference(
            qb, kb, vb, True), reps=5),
        "library_ms": _time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qb, kb, vb, is_causal=True), reps=5)}
    # the last timed launch's output, held to the grid's tolerance
    t_err = (timed["out"].float() - mb["ref"]).abs().max().item()
    if not t_err <= TOL_OUT_BF16:
        raise AssertionError(f"flash_attention_fwd's timed bf16 launch "
                             f"disagrees with its plain version: {t_err}")
    bnbytes = 2.0 * 4 * BH * T * D + 4.0 * BH * T   # bf16 q, k, v, out; lse
    bf16["bound_ms"], bf16["bound_by"], _ = roofline_ms(flops, bnbytes,
                                                        "bf16")
    print(f"flash_attention_fwd bf16 causal (4, 32, 2048, 128): "
          f"max|out-plain| {mb['err']:.3e} in the grid, {t_err:.3e} at the "
          f"last timed launch (tol {TOL_OUT_BF16}); kernel "
          f"{bf16['ms']:.3f} ms, plain {bf16['plain_ms']:.3f} ms, "
          f"scaled_dot_product_attention {bf16['library_ms']:.3f} ms, bound "
          f"{bf16['bound_ms']:.3f} ms ({bf16['bound_by']}, bf16 tensor "
          f"cores; {bnbytes:.3e} B); card {_card_line()}")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:63",
            "max_abs_err": main["err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_route": route, "library_ms": lib_ms, "bf16": bf16}


def _max_rel(got, ref) -> float:
    return ((got.float() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


def backward_kernel_phase(hk, dev):
    """The flash-attention backward kernels vs their plain version; returns
    the records of the dK/dV and dQ kernels at the training shape (causal,
    (4, 32, 2048, 128)): float32, and bfloat16 under ``"bf16"``."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    grid = []
    for dtype in (torch.float32, torch.bfloat16):
        for D in hk.SUPPORTED_HEAD_DIMS:
            for causal in (False, True):
                for (B, H, T) in ((2, 3, 77), (1, 2, 1000)):
                    grid.append((dtype, (B, H, T, T, D), causal, 0, 0))
        grid.append((dtype, (1, 2, 77, 1000, 64), True, 923, 0))
        grid.append((dtype, (2, 2, 64, 100, 128), True, 0, 30))
        grid += attention_edge_cases(dtype, hk.SUPPORTED_HEAD_DIMS)
        grid.append((dtype, (4, 32, 2048, 2048, 128), True, 0, 0))
    mains = {}
    for dtype, (B, H, Tq, Tk, D), causal, qo, ko in grid:
        q, k, v = (torch.randn(B * H, t, D, generator=gen, device=dev)
                   .to(dtype) for t in (Tq, Tk, Tk))
        g = torch.randn(B * H, Tq, D, generator=gen, device=dev).to(dtype)
        sc = D ** -0.5
        out, lse = hk._fa_fwd_dispatch(q, k, v, sc, causal, qo, ko)
        got = hk._fa_bwd_dispatch(q, k, v, out, lse, g, sc, causal, qo, ko)
        ref = hk.flash_attention_bwd_reference(
            q.float(), k.float(), v.float(), out.float(), lse, g.float(), sc,
            causal, qo, ko)
        torch.cuda.synchronize()
        errs = [_max_rel(a, b) for a, b in zip(got, ref)]
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        tol = TOL_GRAD_F32 if dtype == torch.float32 else TOL_GRAD_BF16
        tag = (f"{str(dtype)[6:]} B={B} H={H} Tq={Tq} Tk={Tk} D={D} "
               f"causal={causal} q_offset={qo} k_offset={ko}")
        print(f"flash_attention_bwd {tag}: max|d-plain|/max|plain| dq "
              f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (tol {tol})")
        if not (finite and max(errs) <= tol):
            raise AssertionError(f"flash_attention_bwd disagrees with its "
                                 f"plain version at {tag}")
        if causal and ko > qo and bool(got[0][:, :ko - qo].any()):
            raise AssertionError("rows that see no key got a gradient")
        if Tq == 2048:
            mains[dtype] = dict(
                q=q, k=k, v=v, out=out, lse=lse, g=g, sc=sc, ref=ref,
                err_dq=(got[0].float() - ref[0]).abs().max().item(),
                err_dkdv=max((got[1].float() - ref[1]).abs().max().item(),
                             (got[2].float() - ref[2]).abs().max().item()))
        if Tq == 2048 and dtype == torch.float32:
            with tf32_matmuls():
                ctl = hk.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                                       sc, True)
            c_err = min(_max_rel(a, b) for a, b in zip(ctl, ref))
            print(f"flash_attention_bwd control, plain version in TF32 at "
                  f"{tag}: smallest of dq/dk/dv max|d-plain|/max|plain| "
                  f"{c_err:.3e}")
            if not c_err > TOL_GRAD_F32:
                raise AssertionError("the TF32 control passes the f32 "
                                     "gradient tolerance: it is too loose")
            del ctl
        del got, ref

    main = mains[torch.float32]
    q, k, v, out, lse, g, sc = (main[n] for n in
                                ("q", "k", "v", "out", "lse", "g", "sc"))
    BH, T, D = q.shape
    runs = [hk._fa_bwd_dispatch(q, k, v, out, lse, g, sc, True, 0, 0)
            for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"flash_attention_bwd determinism, f32 causal (4, 32, 2048, 128) "
          f"launched twice: dq, dk and dv bitwise equal: {same}")
    if not same:
        raise AssertionError("flash_attention_bwd is not deterministic")
    del runs
    delta = (g * out).sum(-1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    times = {which: _time_ms(lambda w=which: hk._fa_bwd_launch(
        w, q, k, v, g, lse, delta, dq, dk, dv, sc, True, 0, 0), reps=5)
        for which in ("dkdv", "dq")}
    whole_ms = _time_ms(lambda: hk._fa_bwd_dispatch(q, k, v, out, lse, g, sc,
                                                    True, 0, 0), reps=5)
    plain_ms = _time_ms(lambda: hk.flash_attention_bwd_reference(
        q, k, v, out, lse, g, sc, True), reps=3)
    q4, k4, v4 = (t.reshape(4, 32, T, D).detach().requires_grad_()
                  for t in (q, k, v))
    o4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                          is_causal=True)
    g4 = g.reshape(4, 32, T, D)
    lib_ms = _time_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), g4,
                                                  retain_graph=True), reps=5)
    pairs = attention_pairs(BH, T, T, True)
    tile = 4.0 * BH * T * D          # one (BH, T, D) f32 tensor
    # dK/dV needs s = q.k and dp = dO.v to form p and ds, then dv and dk:
    # 8*D FLOP a visible pair; dQ needs s, dp and dq: 6*D. Each reads q,
    # k, v, dO, lse and delta once and writes its outputs once.
    work = {"dkdv": (8.0 * D * pairs, 6 * tile + 8.0 * BH * T),
            "dq": (6.0 * D * pairs, 5 * tile + 8.0 * BH * T),
            "function": (10.0 * D * pairs, 7 * tile + 8.0 * BH * T)}
    bounds = {w: roofline_ms(f, b, "f32") for w, (f, b) in work.items()}
    cuda_core = {w: roofline_ms(f, b)[0] for w, (f, b) in work.items()}
    print(f"flash_attention_bwd f32 causal (4, 32, 2048, 128): dK/dV kernel "
          f"{times['dkdv']:.3f} ms (bound {bounds['dkdv'][0]:.3f}), dQ "
          f"kernel {times['dq']:.3f} ms (bound {bounds['dq'][0]:.3f}), whole "
          f"backward {whole_ms:.3f} ms (bound of the function "
          f"{bounds['function'][0]:.3f} ms at 10*D FLOP a pair), bounds "
          f"{bounds['dkdv'][1]}, {bounds['dkdv'][2]}; f32 CUDA-core bounds "
          f"{cuda_core['dkdv']:.3f}, {cuda_core['dq']:.3f}, function "
          f"{cuda_core['function']:.3f} ms; plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention backward {lib_ms:.3f} ms; card "
          f"{_card_line()}")
    del o4, q4, k4, v4
    # the grid's bf16 case at this shape, the mixed-precision route's
    mb = mains[torch.bfloat16]
    qb, kb, vb, gb, ob, lseb = (mb[n] for n in
                                ("q", "k", "v", "g", "out", "lse"))
    deltab = (gb.float() * ob.float()).sum(-1)
    dqb, dkb, dvb = (torch.empty_like(t) for t in (qb, kb, vb))
    bf16_ms = {which: _time_ms(lambda w=which: hk._fa_bwd_launch(
        w, qb, kb, vb, gb, lseb, deltab, dqb, dkb, dvb, sc, True, 0, 0),
        reps=5) for which in ("dkdv", "dq")}
    # the timed launches' outputs, held to the grid's tolerance
    t_errs = [_max_rel(a, b) for a, b in zip((dqb, dkb, dvb), mb["ref"])]
    print(f"flash_attention_bwd bf16 causal (4, 32, 2048, 128), the timed "
          f"launches' outputs: max|d-plain|/max|plain| dq {t_errs[0]:.3e} "
          f"dk {t_errs[1]:.3e} dv {t_errs[2]:.3e} (tol {TOL_GRAD_BF16})")
    if not max(t_errs) <= TOL_GRAD_BF16:
        raise AssertionError("flash_attention_bwd's timed bf16 launches "
                             "disagree with their plain version")
    del dqb, dkb, dvb
    bf16_whole = _time_ms(lambda: hk._fa_bwd_dispatch(
        qb, kb, vb, ob, lseb, gb, sc, True, 0, 0), reps=5)
    bf16_plain = _time_ms(lambda: hk.flash_attention_bwd_reference(
        qb, kb, vb, ob, lseb, gb, sc, True), reps=3)
    q4, k4, v4 = (t.reshape(4, 32, T, D).detach().requires_grad_()
                  for t in (qb, kb, vb))
    o4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                          is_causal=True)
    g4 = gb.reshape(4, 32, T, D)
    bf16_lib = _time_ms(lambda: torch.autograd.grad(
        o4, (q4, k4, v4), g4, retain_graph=True), reps=5)
    btile = tile / 2.0
    bwork = {"dkdv": (work["dkdv"][0], 6 * btile + 8.0 * BH * T),
             "dq": (work["dq"][0], 5 * btile + 8.0 * BH * T),
             "function": (work["function"][0], 7 * btile + 8.0 * BH * T)}
    bbounds = {w: roofline_ms(f, b, "bf16") for w, (f, b) in bwork.items()}
    print(f"flash_attention_bwd bf16 causal (4, 32, 2048, 128): dK/dV kernel "
          f"{bf16_ms['dkdv']:.3f} ms (bound {bbounds['dkdv'][0]:.3f}), dQ "
          f"kernel {bf16_ms['dq']:.3f} ms (bound {bbounds['dq'][0]:.3f}), "
          f"whole backward {bf16_whole:.3f} ms (bound of the function "
          f"{bbounds['function'][0]:.3f} ms, {bbounds['function'][1]}); "
          f"plain {bf16_plain:.3f} ms, scaled_dot_product_attention "
          f"backward {bf16_lib:.3f} ms; card {_card_line()}")
    del o4, q4, k4, v4
    records = []
    for which in ("dkdv", "dq"):
        records.append({
            "name": f"flash_attention_bwd_{which}", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:220",
            "max_abs_err": main[f"err_{which}"], "ms": times[which],
            "plain_ms": plain_ms, "bound_ms": bounds[which][0],
            "bound_by": bounds[which][1], "bound_route": bounds[which][2],
            "library_ms": lib_ms,
            "bf16": {"max_abs_err": mb[f"err_{which}"],
                     "ms": bf16_ms[which], "whole_ms": bf16_whole,
                     "plain_ms": bf16_plain, "library_ms": bf16_lib,
                     "bound_ms": bbounds[which][0],
                     "bound_by": bbounds[which][1]}})
    return records


def _tf32_round(x):
    """float32 values rounded to TF32's 10-bit mantissa (a control)."""
    import torch
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def ce_phase(hk, dev):
    """The fused softmax cross-entropy vs its plain version; returns its
    record at the training shape (8192, 50272) f32."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    V = OPT_6_7B["vocab"]
    N = TRAIN_BATCH * OPT_6_7B["max_len"]
    rec = None
    for dtype, (n, c) in ((torch.float32, (N, V)), (torch.bfloat16, (N, V)),
                          (torch.float32, (7, 37)), (torch.bfloat16, (7, 37)),
                          (torch.float32, (7, V))):
        x = (2.0 * torch.randn(n, c, generator=gen, device=dev)).to(dtype)
        labels = torch.randint(0, c, (n,), generator=gen, device=dev)
        loss, lse = hk._ce_fwd_dispatch(x, labels)
        ref_loss, ref_lse = hk.softmax_cross_entropy_reference(x, labels)
        torch.cuda.synchronize()
        err = max((lse - ref_lse).abs().max().item(),
                  (loss - ref_loss).abs().max().item())
        tag = f"{str(dtype)[6:]} N={n} C={c}"
        print(f"softmax_cross_entropy_fwd {tag}: max|lse, loss - plain| "
              f"{err:.3e} (tol {TOL_CE})")
        if not err <= TOL_CE:
            raise AssertionError(f"softmax_cross_entropy_fwd disagrees with "
                                 f"its plain version at {tag}")
        if dtype == torch.float32 and n == N:
            c_loss, c_lse = hk.softmax_cross_entropy_reference(
                _tf32_round(x), labels)
            c_err = min((c_lse - ref_lse).abs().max().item(),
                        (c_loss - ref_loss).abs().max().item())
            print(f"softmax_cross_entropy_fwd control, plain version on "
                  f"TF32-rounded logits at {tag}: {c_err:.3e}")
            if not c_err > TOL_CE:
                raise AssertionError("the TF32 control passes the CE "
                                     "tolerance: it is too loose")
            ms = _time_ms(lambda: hk._ce_fwd_dispatch(x, labels), reps=20)
            plain_ms = _time_ms(lambda: hk.softmax_cross_entropy_reference(
                x, labels), reps=5)
            lib_ms = _time_ms(lambda: torch.nn.functional.cross_entropy(
                x, labels, reduction="none"), reps=20)
            lse_ms = _time_ms(lambda: torch.logsumexp(x, dim=1), reps=20)
            # logits read once, labels read, lse and loss written; about
            # 4 operations an element (max, subtract, exp, add)
            bound_ms, bound_by, route = roofline_ms(4.0 * n * c,
                                                    4.0 * n * c + 16.0 * n)
            print(f"softmax_cross_entropy_fwd f32 ({n}, {c}): kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"F.cross_entropy(reduction='none') {lib_ms:.3f} ms, "
                  f"torch.logsumexp (the lse alone) {lse_ms:.3f} ms, bound "
                  f"{bound_ms:.3f} ms ({bound_by})")
            rec = {"name": "softmax_cross_entropy_fwd", "route": "cuda",
                   "source": "mxnet_tpu_torch/csrc/softmax_cross_entropy.cu",
                   "replaces": "mxnet_tpu/ops/pallas_kernels.py:325",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_route": route, "library_ms": lib_ms}
        del x, labels, loss, lse, ref_loss, ref_lse
    ce_label_cases(hk, dev, gen)
    return rec


def ce_label_cases(hk, dev, gen):
    """B2 with labels outside [0, C) and with one label for every row,
    against its plain version: a label in [-C, 0) picks class C + label,
    one at C or below -C gives NaN (as the JAX package's
    ``take_along_axis``), and one label broadcasts to every row (the
    wrapper hands the kernel N labels)."""
    import torch
    V = OPT_6_7B["vocab"]
    x = 2.0 * torch.randn(8, V, generator=gen, device=dev)
    cases = {"negative and out-of-range labels": torch.tensor(
                 [-1, -V, 0, V - 1, V, -V - 1, -7, 3], device=dev),
             "one label for every row": torch.tensor([5], device=dev)}
    for what, labels in cases.items():
        before = hk.launch_counts["softmax_cross_entropy_fwd"]
        loss = hk.softmax_cross_entropy(x, labels)
        ref_loss = hk.softmax_cross_entropy_reference(
            x, labels.expand(x.shape[0]))[0]
        torch.cuda.synchronize()
        same_nan = torch.equal(loss.isnan(), ref_loss.isnan())
        ok = ~ref_loss.isnan()
        err = (loss[ok] - ref_loss[ok]).abs().max().item()
        launched = hk.launch_counts["softmax_cross_entropy_fwd"] - before
        print(f"softmax_cross_entropy_fwd, {what} {labels.tolist()}: "
              f"max|loss - plain| {err:.3e} over {int(ok.sum())} finite "
              f"rows (tol {TOL_CE}), NaN rows as the plain version's: "
              f"{same_nan}, launches {launched}")
        if not (err <= TOL_CE and same_nan and launched == 1):
            raise AssertionError(f"softmax_cross_entropy_fwd with {what} "
                                 f"disagrees with its plain version")


def embedding_determinism(dev) -> None:
    """The op of the LM's backward that did not repeat: Embedding's gather
    at the training shape (8192 ids, a quarter of them one id, into the
    (50272, 4096) float32 table). The port's op (``F.embedding`` on the
    clamped ids) must give the same weight gradient twice, bitwise; the
    ``index_select`` it replaced, whose CUDA backward is an atomic
    ``index_add_`` over repeated ids, is printed beside it."""
    import torch
    from mxnet_tpu_torch.ops.registry import get_op
    V, D = OPT_6_7B["vocab"], OPT_6_7B["units"]
    N = TRAIN_BATCH * OPT_6_7B["max_len"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    ids = torch.randint(0, V, (N,), generator=gen, device=dev)
    ids[: N // 4] = ids[0]
    w = torch.randn(V, D, generator=gen, device=dev, requires_grad=True)
    up = torch.randn(N, D, generator=gen, device=dev)
    embedding = get_op("Embedding").fn

    def twice(fn):
        a, b = (torch.autograd.grad(fn(), w, up)[0] for _ in range(2))
        return torch.equal(a, b), (a - b).abs().max().item()

    port = twice(lambda: embedding(ids.float(), w, input_dim=V,
                                   output_dim=D))
    old = twice(lambda: w.index_select(0, ids))
    print(f"Embedding backward at ({N} ids, {V} x {D}), run twice: the "
          f"op's (F.embedding) bitwise equal {port[0]}; index_select's "
          f"(index_add_) bitwise equal {old[0]}, max|a - b| {old[1]:.3e}")
    if not port[0]:
        raise AssertionError("Embedding's backward does not repeat")


def rtc_kernel_phase(dev):
    """The user's NVRTC kernels vs their plain versions on the card, with
    TF32-rounded controls that must miss; compile times, kernel times at
    the extension path's shapes, and one launch's host overhead. Returns
    their records."""
    ctx = mx.gpu(dev.index)
    k = KERNELS
    for mod, what in ((k.c_module, 'extern "C" axpy'),
                      (k.module, "axpy<float>, softmax_fwd<float>, "
                                 "softmax_ce_bwd<float>")):
        t = mod.compile(ctx)
        print(f"build: NVRTC compiled and loaded {what} in {t * 1e3:.1f} ms")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)

    x = torch.randn(AXPY_N, generator=gen, device=dev)
    y = torch.randn(AXPY_N, generator=gen, device=dev)
    ref = axpy_plain(x, y, 2.0)
    for template in (False, True):
        got = y.clone()
        k.axpy(x, got, 2.0, template)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        print(f"rtc axpy ({'axpy<float>' if template else 'extern C'}) n="
              f"{AXPY_N}: max|y - plain| = {err:.3e} (exact)")
        if err != 0.0:
            raise AssertionError("rtc axpy disagrees with 2x + y")
    c_err = (axpy_plain(_tf32_round(x), y, 2.0) - ref).abs().max().item()
    print(f"rtc axpy control, TF32-rounded x: {c_err:.3e}")
    if not c_err > 0.0:
        raise AssertionError("the TF32 control of axpy is exact")
    out = y.clone()
    axpy_ms = _time_ms(lambda: k.axpy(x, out, 2.0, True), reps=20)
    axpy_plain_ms = _time_ms(lambda: axpy_plain(x, y, 2.0), reps=20)
    axpy_lib_ms = _time_ms(lambda: out.add_(x, alpha=2.0), reps=20)
    axpy_bound = roofline_ms(2.0 * AXPY_N, 12.0 * AXPY_N)
    xs, ys = x[:16].clone(), y[:16].clone()
    host_us = []
    for _ in range(1000):
        t0 = time.perf_counter()
        k.axpy(xs, ys, 2.0, True)
        host_us.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    print(f"rtc axpy n={AXPY_N}: kernel {axpy_ms:.3f} ms, plain "
          f"{axpy_plain_ms:.3f} ms, Tensor.add_(alpha=2) {axpy_lib_ms:.3f} ms,"
          f" bound {axpy_bound[0]:.3f} ms ({axpy_bound[1]}); host time of "
          f"one launch (16 elements): median {np.median(host_us):.1f} us, "
          f"p90 {np.percentile(host_us, 90):.1f} us")
    records = [{"name": "rtc_axpy", "max_abs_err": 0.0, "ms": axpy_ms,
                "plain_ms": axpy_plain_ms, "bound_ms": axpy_bound[0],
                "bound_by": axpy_bound[1], "bound_route": axpy_bound[2],
                "library_ms": axpy_lib_ms}]
    del x, y, ref, out

    V, N = OPT_6_7B["vocab"], TRAIN_BATCH * OPT_6_7B["max_len"]
    main = {}
    for n, c in ((7, 37), (7, V), (N, V)):
        logits = 2.0 * torch.randn(n, c, generator=gen, device=dev)
        labels = torch.randint(0, c, (n,), generator=gen,
                               device=dev).float()
        if n == 7:   # a negative label wraps; one past the row is NaN
            labels[0], labels[1] = -1.0, float(c)
        p = torch.empty_like(logits)
        k.softmax_fwd(logits, p)
        ref_p = softmax_plain(logits)
        g = torch.empty_like(logits)
        k.softmax_ce_bwd(ref_p, labels, g, 1.0 / n)
        ref_g = softmax_ce_bwd_plain(ref_p, labels, 1.0 / n)
        torch.cuda.synchronize()
        p_err = _max_rel(p, ref_p)
        nan_rows = torch.isnan(ref_g).any(1)
        same_nan = torch.equal(torch.isnan(g), torch.isnan(ref_g))
        g_err = _max_rel(g[~nan_rows], ref_g[~nan_rows])
        ctl_p = softmax_plain(_tf32_round(logits))
        c_p = _max_rel(ctl_p, ref_p)
        ctl_g = softmax_ce_bwd_plain(ctl_p, labels, 1.0 / n)
        c_g = _max_rel(ctl_g[~nan_rows], ref_g[~nan_rows])
        print(f"rtc softmax_fwd ({n}, {c}): max|p - plain|/max p {p_err:.3e} "
              f"(tol {TOL_RTC_SOFTMAX}); softmax_ce_bwd max|g - plain|/"
              f"max|plain| {g_err:.3e} (tol {TOL_RTC_CE_BWD}), NaN rows "
              f"{int(nan_rows.sum())} alike {same_nan}; controls on "
              f"TF32-rounded logits {c_p:.3e}, {c_g:.3e}")
        if not (p_err <= TOL_RTC_SOFTMAX and g_err <= TOL_RTC_CE_BWD
                and same_nan):
            raise AssertionError(f"an rtc kernel disagrees with its plain "
                                 f"version at ({n}, {c})")
        if not (c_p > TOL_RTC_SOFTMAX and c_g > TOL_RTC_CE_BWD):
            raise AssertionError("a TF32 control passes an rtc tolerance: "
                                 "it is too loose")
        if n == N:
            main = dict(x=logits, labels=labels, p=ref_p,
                        p_err=(p - ref_p).abs().max().item(),
                        g_err=(g - ref_g).abs().max().item())
        del logits, labels, p, ref_p, g, ref_g, ctl_p, ctl_g
    x, labels, p = main["x"], main["labels"], main["p"]
    out = torch.empty_like(x)
    sm_ms = _time_ms(lambda: k.softmax_fwd(x, out), reps=20)
    sm_plain = _time_ms(lambda: softmax_plain(x), reps=5)
    sm_lib = _time_ms(lambda: torch.softmax(x, dim=1), reps=20)
    ce_ms = _time_ms(lambda: k.softmax_ce_bwd(p, labels, out, 1.0 / N),
                     reps=20)
    ce_plain = _time_ms(lambda: softmax_ce_bwd_plain(p, labels, 1.0 / N),
                        reps=5)
    # each reads an (N, C) f32 array once and writes one; softmax ~5
    # operations an element (max, subtract, exp, add, scale), the
    # gradient 2 (subtract, scale)
    sm_bound = roofline_ms(5.0 * N * V, 8.0 * N * V)
    ce_bound = roofline_ms(2.0 * N * V, 8.0 * N * V + 4.0 * N)
    print(f"rtc softmax_fwd f32 ({N}, {V}): kernel {sm_ms:.3f} ms, plain "
          f"{sm_plain:.3f} ms, torch.softmax {sm_lib:.3f} ms, bound "
          f"{sm_bound[0]:.3f} ms ({sm_bound[1]}); softmax_ce_bwd: kernel "
          f"{ce_ms:.3f} ms, plain {ce_plain:.3f} ms, no single library call,"
          f" bound {ce_bound[0]:.3f} ms ({ce_bound[1]}); card {_card_line()}")
    records.append({"name": "rtc_softmax_fwd", "max_abs_err": main["p_err"],
                    "ms": sm_ms, "plain_ms": sm_plain,
                    "bound_ms": sm_bound[0], "bound_by": sm_bound[1],
                    "bound_route": sm_bound[2], "library_ms": sm_lib})
    records.append({"name": "rtc_softmax_ce_bwd",
                    "max_abs_err": main["g_err"], "ms": ce_ms,
                    "plain_ms": ce_plain, "bound_ms": ce_bound[0],
                    "bound_by": ce_bound[1], "bound_route": ce_bound[2],
                    "library_ms": None})
    for rec in records:
        rec.update(route="cuda", compiler="nvrtc", source="chip_smoke.py",
                   replaces="mxnet_tpu/rtc.py:78")
    return records


# --------------------------------------------------------------- serving
def _kernel_class(key: str) -> str:
    low = key.lower()
    if "fa_fwd_kernel" in key:
        return "flash_attention_fwd"
    if "fa_bwd_" in key:
        return "flash_attention_bwd (dK/dV, dQ)"
    if "ce_fwd_kernel" in key:
        return "softmax_cross_entropy_fwd"
    if "softmax_fwd" in key:
        return "rtc softmax_fwd"
    if "softmax_ce_bwd" in key:
        return "rtc softmax_ce_bwd"
    if "memcpy" in low:
        return "memcpy"
    for part, cls in (("dgrad", "conv dgrad (cuDNN)"),
                      ("wgrad", "conv wgrad (cuDNN)"),
                      ("fprop", "conv forward (cuDNN)"),
                      ("implicit_convolve", "conv forward (cuDNN)"),
                      ("nchwtonhwc", "layout conversion"),
                      ("nhwctonchw", "layout conversion")):
        if part in low:
            return cls
    if "gemm" in low or "cutlass" in low or "nvjet" in low:
        return "matmul (cuBLAS GEMMs; cuDNN's GEMM convolutions)"
    for part, cls in (("pool", "pooling"),
                      ("reduce_kernel", "reductions (statistics, sums)"),
                      ("copy", "copies and casts"),
                      ("clamp", "ReLU and its backward"),
                      ("threshold", "ReLU and its backward"),
                      ("elementwise", "elementwise arithmetic")):
        if part in low:
            return cls
    return "other kernels"


def profile_breakdown(what: str, run, ranges=()) -> None:
    """Run ``run()`` once under ``torch.profiler``: device time by kernel
    class and by kernel, and the device events' share of the wall window
    (one stream, so their sum is the busy time); and the device time of
    the kernels launched inside each ``record_function`` range named in
    ``ranges``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    rows = [(e.self_device_time_total, e.count, e.key) for e in events
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key not in ranges]
    if not rows:
        print(f"profile: {what}: torch.profiler recorded no device time")
        return
    classes = {}
    for us, _, key in rows:
        cls = _kernel_class(key)
        classes[cls] = classes.get(cls, 0.0) + us
    busy = sum(r[0] for r in rows)
    print(f"profile: {what}: wall {wall_us / 1e3:.1f} ms, device events "
          f"{busy / 1e3:.1f} ms (busy share {busy / wall_us:.3f}); card "
          f"{_card_line()}")
    for cls, us in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"profile: class {cls}: {us / 1e3:.2f} ms "
              f"({us / busy:.3f} of device time)")
    for e in events:
        if e.key in ranges and e.device_type == DeviceType.CPU:
            print(f"profile: range {e.key}: {e.device_time_total / 1e3:.2f}"
                  f" ms of device time ({e.device_time_total / busy:.3f})")
    for us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"profile: kernel {us / 1e3:9.2f} ms x{count:<4d} {key[:90]}")


def _rel_err(got, ref) -> float:
    """max|got - ref| / max|ref| over the last two axes (one response),
    the largest over any leading ones."""
    err = (got - ref).abs().amax(dim=(-2, -1))
    return (err / ref.abs().amax(dim=(-2, -1))).max().item()


def serving_phase(mx, hk, dev, workdir, profile=False):
    """Serve the 4-layer OPT-6.7B-width LM through ModelServer on the card;
    returns {kernel name: launches in the request run}. ``profile`` adds
    one profiled dispatch after the checked run."""
    import torch
    from mxnet_tpu_torch.serving import ModelServer
    from mxnet_tpu_torch.serving.load import model_config_from_files
    cfg = OPT_6_7B
    V, C, L, H, T = (cfg["vocab"], cfg["units"], cfg["layers"],
                     cfg["heads"], cfg["max_len"])
    lm = build_lm_symbol(mx.sym, V, C, L, H, cfg["ffn"])
    arg_shapes, _, _ = lm.infer_shape(data=(1, T),
                                      pos_table=(cfg["max_len"], C))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    w = {}
    for name, shape in zip(lm.list_arguments(), arg_shapes):
        if name == "data":
            continue
        if name == "pos_table":
            w[name] = torch.from_numpy(sinusoid_table(T, C)).to(dev)
            continue
        t = torch.randn(shape, generator=gen, device=dev) * 0.02
        w[name] = t + 1.0 if name.endswith("_gamma") else t
    n_params = sum(t.numel() for t in w.values())
    os.makedirs(workdir, exist_ok=True)
    sym_path = os.path.join(workdir, "lm-symbol.json")
    par_path = os.path.join(workdir, "lm-0000.params")
    lm.save(sym_path)
    t0 = time.perf_counter()
    mx.nd.save(par_path, {"arg:" + n: mx.nd.NDArray(t) for n, t in w.items()})
    print(f"serving: {n_params} parameters ({4 * n_params / 1e9:.2f} GB "
          f"f32) written in {time.perf_counter() - t0:.1f} s")

    deadline_ms = 120000.0   # f32 at this width: a bucket-4 forward is ~1 s
    server_cfg = model_config_from_files(
        sym_path, params=par_path, feature_shape=str(T), name="lm",
        buckets=",".join(map(str, SERVE_BUCKETS)), deadline_ms=deadline_ms,
        max_wait_ms=50.0, max_queue=64)
    os.remove(par_path)
    t0 = time.perf_counter()
    server = ModelServer([server_cfg]).start(warm=True)
    print(f"serving: start(warm=True) over buckets {SERVE_BUCKETS} took "
          f"{time.perf_counter() - t0:.1f} s")
    try:
        rng = np.random.RandomState(SEED)
        reqs = [rng.randint(0, V, size=T).astype(np.float32)
                for _ in range(SERVE_REQUESTS)]
        def one(r):
            t = time.perf_counter()
            out = server.predict("lm", r, timeout=deadline_ms / 1e3)
            return out, (time.perf_counter() - t) * 1e3

        hk.reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_REQUESTS) as pool:
            outs, lat_ms = zip(*pool.map(one, reqs))
        wall = time.perf_counter() - t0
        launches = dict(hk.launch_counts)
        st = server.stats("lm")
        if profile:
            def dispatch(reqs=reqs[:max(SERVE_BUCKETS)]):
                for f in [server.submit("lm", r) for r in reqs]:
                    f.result(timeout=120.0)
            profile_breakdown(f"one serving dispatch of {max(SERVE_BUCKETS)}"
                              f" x {T} tokens", dispatch)
    finally:
        server.close(timeout=60.0)
    dispatches = st["batches"] + st["singles"]
    print(f"serving: {SERVE_REQUESTS} requests x {T} tokens in {wall:.3f} s "
          f"({SERVE_REQUESTS * T / wall:.1f} tokens/s), client latency "
          f"median {np.median(lat_ms):.1f} ms, max {max(lat_ms):.1f} ms, "
          f"{st['batches']} batches, {st['singles']} singles, counts "
          f"{st['counts']}, launches {launches}; card {_card_line()}")
    if st["counts"]["ok"] != SERVE_REQUESTS or st["deadline_violations"]:
        raise AssertionError(f"serving outcomes wrong: {st}")
    if launches["flash_attention_fwd"] != L * dispatches:
        raise AssertionError(
            f"flash_attention_fwd launched {launches['flash_attention_fwd']}"
            f" times for {dispatches} forward dispatches of {L} layers")

    worst = 0.0
    with torch.inference_mode():
        for i in range(0, SERVE_REQUESTS, max(SERVE_BUCKETS)):
            chunk = outs[i:i + max(SERVE_BUCKETS)]
            toks = torch.from_numpy(np.stack(reqs[i:i + len(chunk)])).to(dev)
            ref = plain_forward(w, toks.long(), V, C, L, H)
            for j, o in enumerate(chunk):
                got = torch.from_numpy(o).to(dev)
                if got.shape != ref[j].shape \
                        or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"response {i + j}: shape "
                                         f"{tuple(got.shape)} or non-finite")
                worst = max(worst, _rel_err(got, ref[j]))
            if i == 0:
                # controls: the same plain forward with TF32 matmuls, and
                # in bf16, must both fail the tolerance
                with tf32_matmuls():
                    c_tf32 = _rel_err(plain_forward(w, toks.long(), V, C, L,
                                                    H), ref)
                with torch.autocast("cuda", dtype=torch.bfloat16):
                    c_bf16 = _rel_err(plain_forward(w, toks.long(), V, C, L,
                                                    H).float(), ref)
            del ref
    print(f"serving: max|logits - plain| / max|logit| = {worst:.3e} "
          f"(tol {TOL_LOGITS}); controls: plain forward in TF32 "
          f"{c_tf32:.3e}, in bf16 {c_bf16:.3e}")
    if not worst <= TOL_LOGITS:
        raise AssertionError("served logits disagree with the plain forward")
    if not (c_tf32 > TOL_LOGITS and c_bf16 > TOL_LOGITS):
        raise AssertionError("a TF32 or bf16 control passes the logits "
                             "tolerance: it is too loose")
    return launches


# --------------------------------------------------------------- training
def lm_param_map(net):
    """{``build_lm_symbol`` argument name: parameter} of a
    ``TransformerLM`` of either package (untied head)."""
    body = net.body
    params = {"embed_weight": net.embed.weight, "pos_table": net.pos.table,
              "lnf_gamma": body.final_ln.gamma, "lnf_beta": body.final_ln.beta,
              "head_weight": net.head.weight}
    for i in range(len(body.layers)):
        cell, p = body.layers[i], f"layer{i}_"
        for name, blk in (("ln1", cell.ln1), ("ln2", cell.ln2)):
            params[p + name + "_gamma"] = blk.gamma
            params[p + name + "_beta"] = blk.beta
        for name, blk in (("qkv", cell.attn.qkv), ("proj", cell.attn.proj),
                          ("fc1", cell.ffn.fc1), ("fc2", cell.ffn.fc2)):
            params[p + name + "_weight"] = blk.weight
            params[p + name + "_bias"] = blk.bias
    return params


def _plain_step_grads(hk, tensors, tokens, labels, names):
    """Loss and gradients of the plain float32 LM at ``tensors`` ({argument
    name: tensor}): ``plain_forward`` with the attention kernels' plain
    version (recomputed in the backward, so the (T, T) scores of one layer
    live at a time) and the cross-entropy kernel's plain version, under
    torch autograd; the loss is the sum over tokens."""
    import torch
    from torch.utils.checkpoint import checkpoint
    cfg = OPT_6_7B

    def attend(q, k, v):
        return checkpoint(lambda q, k, v: hk.flash_attention_reference(
            q, k, v, causal=True)[0], q, k, v, use_reentrant=False)

    w = {n: t.detach().requires_grad_(n in names)
         for n, t in tensors.items()}
    logits = plain_forward(w, tokens, cfg["vocab"], cfg["units"],
                           cfg["layers"], cfg["heads"], attend=attend)
    loss = hk.softmax_cross_entropy_reference(
        logits.reshape(-1, cfg["vocab"]), labels.reshape(-1))[0].sum()
    grads = torch.autograd.grad(loss, [w[n] for n in names])
    return loss.detach(), dict(zip(names, grads))


def _norm_rel(got, ref) -> float:
    return ((got.float() - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def _top(names):
    """The tensors above the last ReLU: the head, the final LayerNorm and
    the last fc2."""
    last = f"layer{OPT_6_7B['layers'] - 1}_fc2_"
    return [n for n in names if n.startswith(("head_", "lnf_", last))]


def _plain_controls(hk, tensors, tokens, labels, names, score):
    """``score(plain gradients)`` for the plain reference in TF32 and in
    bf16: the controls, which must miss each gate."""
    import torch
    out = []
    for ctx in (tf32_matmuls(), torch.autocast("cuda", dtype=torch.bfloat16)):
        with ctx:
            ctl = _plain_step_grads(hk, tensors, tokens, labels, names)[1]
        out.append(score(ctl))
        del ctl
    return out


def grad_gate(hk, what, tensors, port, x, y, loss):
    """Step 1's loss (the sum over tokens) and gradients ``port`` ({name:
    gradient}) against the plain float32 reference at ``tensors``; the
    reference in TF32 and in bf16 must miss. Returns the worst
    ``||g - plain|| / ||plain||`` (all, top)."""
    names = list(port)
    top = _top(names)
    tokens, labels = x._data.long(), y._data.long()
    ref_loss, ref = _plain_step_grads(hk, tensors, tokens, labels, names)
    loss_err = abs(loss - ref_loss.item()) / abs(ref_loss.item())

    def worst(grads):
        """(worst norm error over all tensors, over the top ones)."""
        errs = {n: _norm_rel(grads[n], ref[n]) for n in names}
        return max(errs.values()), max(errs[n] for n in top), errs

    w_all, w_top, errs = worst(port)
    max_err = max(_max_rel(port[n], ref[n]) for n in names)
    c_tf32, c_bf16 = _plain_controls(hk, tensors, tokens, labels, names,
                                     lambda g: worst(g)[:2])
    print(f"{what}: step-1 loss {loss:.6f}, plain {ref_loss.item():.6f} "
          f"(relative {loss_err:.3e}, tol {TOL_TRAIN_LOSS}); "
          f"||g-plain||/||plain||: worst of {len(names)} tensors "
          f"{w_all:.3e} ({max(errs, key=errs.get)}; tol {TOL_TRAIN_GRAD}),"
          f" worst of the {len(top)} above the last ReLU {w_top:.3e} (tol "
          f"{TOL_TRAIN_GRAD_TOP}); worst max|g-plain|/max|plain| "
          f"{max_err:.3e}; controls (all, top): plain in TF32 "
          f"{c_tf32[0]:.3e}, {c_tf32[1]:.3e}, in bf16 {c_bf16[0]:.3e}, "
          f"{c_bf16[1]:.3e}")
    if not (loss_err <= TOL_TRAIN_LOSS and w_all <= TOL_TRAIN_GRAD
            and w_top <= TOL_TRAIN_GRAD_TOP):
        raise AssertionError(f"{what}: step-1 loss or gradients disagree "
                             f"with the plain float32 reference")
    for ctl_all, ctl_top in (c_tf32, c_bf16):
        if not (ctl_all > TOL_TRAIN_GRAD and ctl_top > TOL_TRAIN_GRAD_TOP):
            raise AssertionError("a TF32 or bf16 control passes a gradient "
                                 "tolerance: it is too loose")
    return w_all, w_top


def training_gate(hk, net, x, y, loss):
    """Step 1 of the gluon path against the plain reference."""
    params = lm_param_map(net)
    grad_gate(hk, "training", {n: p.data()._data for n, p in params.items()},
              {n: p.grad._data for n, p in params.items()
               if p.grad_req != "null"}, x, y, loss)


def seeded_lm(mx):
    """The 4-layer OPT-6.7B-width TransformerLM (untied head, dropout 0)
    with ``init.Normal(0.02)`` weights from the seed, on the card."""
    from mxnet_tpu_torch.gluon.contrib import transformer as tfm
    cfg = OPT_6_7B
    mx.random.seed(SEED)
    net = tfm.TransformerLM(vocab_size=cfg["vocab"], units=cfg["units"],
                            num_layers=cfg["layers"], num_heads=cfg["heads"],
                            hidden_size=cfg["ffn"], max_len=cfg["max_len"])
    net.initialize(mx.init.Normal(0.02))
    return net


def train_batch():
    """The training batch, tokens and next-token labels, (4, 2048) float32
    numpy arrays from the seed."""
    rng = np.random.RandomState(SEED)
    shape = (TRAIN_BATCH, OPT_6_7B["max_len"])
    return (rng.randint(0, OPT_6_7B["vocab"], shape).astype(np.float32),
            rng.randint(0, OPT_6_7B["vocab"], shape).astype(np.float32))


def per_step_launches(b2: int):
    """Kernel launches a training step of the LM makes: B1 once a layer,
    B3's two kernels once a layer, B2 ``b2`` times."""
    L = OPT_6_7B["layers"]
    return {"flash_attention_fwd": L, "flash_attention_bwd_dkdv": L,
            "flash_attention_bwd_dq": L, "softmax_cross_entropy_fwd": b2}


def training_phase(mx, hk, dev, profile=False):
    """Train the 4-layer OPT-6.7B-width TransformerLM three Adam steps
    through gluon on the card; returns ({kernel name: launches in the
    three steps}, the step-1 loss)."""
    import torch
    from mxnet_tpu_torch import autograd, gluon
    cfg = OPT_6_7B
    V, T, B = cfg["vocab"], cfg["max_len"], TRAIN_BATCH
    torch.cuda.reset_peak_memory_stats()
    net = seeded_lm(mx)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": TRAIN_LR})
    x, y = (mx.nd.array(a) for a in train_batch())

    def forward_backward():
        with autograd.record():
            logits = net(x)
            loss = mx.nd.softmax_cross_entropy(logits.reshape((-1, V)),
                                               y.reshape((-1,)))
        loss.backward()
        return loss

    losses, step_ms = [], []
    hk.reset_launch_counts()
    for step in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = forward_backward()
        torch.cuda.synchronize()
        t_fb = time.perf_counter() - t0
        losses.append(loss.asscalar().item())
        if step == 0:
            n_params = sum(p.data().size
                           for p in net.collect_params().values())
            print(f"training: {n_params} parameters ({4 * n_params / 1e9:.2f}"
                  f" GB f32), {B} x {T} tokens a step")
            seen = dict(hk.launch_counts)
            training_gate(hk, net, x, y, losses[0])
            if dict(hk.launch_counts) != seen:
                raise AssertionError("the plain reference launched a kernel")
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(B * T)
        torch.cuda.synchronize()
        step_ms.append((t_fb + time.perf_counter() - t0) * 1e3)
    launches = dict(hk.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"training: losses {losses}; step times {step_ms} ms "
          f"({B * T / (step_ms[-1] / 1e3):.1f} tokens/s at the last step); "
          f"peak memory {peak_gb:.2f} GB; launches {launches}; card "
          f"{_card_line()}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses} not finite and "
                             f"falling")
    _check_launches("training", launches, 1)
    if profile:
        def one_step():
            forward_backward()
            trainer.step(B * T)
        profile_breakdown(f"one training step of {B} x {T} tokens",
                          one_step)
    return launches, losses[0]


# ------------------------------------------------------------- extension
def _ext_net(V, T):
    """The LM and an Adam trainer with the lr schedule, from the seed."""
    from mxnet_tpu_torch import gluon
    net = seeded_lm(mx)
    sched = mx.lr_scheduler.FactorScheduler(step=EXT_LR_STEP,
                                            factor=EXT_LR_FACTOR)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": TRAIN_LR,
                             "lr_scheduler": sched})
    return net, trainer


def _head_loss(probs, y) -> float:
    """-mean log p[label] of the custom head's probabilities, in float64."""
    lab = y._data.reshape(-1, 1).long()
    return -probs._data.gather(1, lab).double().log().mean().item()


def extension_phase(hk, dev, workdir, profile=False):
    """Train the same LM three Adam steps through gluon with the user's
    CustomOp loss head (``mx.nd.Custom``, its forward and backward NVRTC
    kernels), ``trainer.step(1)`` and a FactorScheduler, checkpointed after
    step 2 and resumed into a fresh net and trainer for step 3. Returns
    {kernel name: launches on this path}."""
    from mxnet_tpu_torch import autograd
    cfg = OPT_6_7B
    V, T, B = cfg["vocab"], cfg["max_len"], TRAIN_BATCH
    N = B * T
    torch.cuda.reset_peak_memory_stats()
    x, y = (mx.nd.array(a) for a in train_batch())
    launches = {}

    def counted(fn):
        """Run ``fn`` with every count set to 0 first; add the counts."""
        hk.reset_launch_counts()
        KERNELS.reset_launch_counts()
        out = fn()
        got = dict(hk.launch_counts, **KERNELS.launch_counts())
        for name, c in got.items():
            launches[name] = launches.get(name, 0) + c
        return out, got

    # the user's first call: axpy through both exports
    def hello():
        a = (torch.arange(AXPY_N, device=dev) % 4096).float()  # 4a+1 exact
        b = torch.ones_like(a)
        KERNELS.axpy(a, b, 2.0)
        KERNELS.axpy(a, b, 2.0, template=True)
        return bool(torch.equal(b, 4.0 * a + 1.0))
    ok, _ = counted(hello)
    if not ok:
        raise AssertionError("extension: axpy twice gave no 4a + 1")

    def custom_step(net, trainer):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with autograd.record():
            logits = net(x)
            probs = mx.nd.Custom(logits.reshape((-1, V)), y.reshape((-1,)),
                                 op_type="rtc_softmax_ce")
        probs.backward()
        trainer.step(1)   # the head's gradient is already a mean
        torch.cuda.synchronize()
        return logits, probs, (time.perf_counter() - t0) * 1e3

    per_step = {"flash_attention_fwd": cfg["layers"],
                "flash_attention_bwd_dkdv": cfg["layers"],
                "flash_attention_bwd_dq": cfg["layers"],
                "softmax_cross_entropy_fwd": 0, "rtc_axpy": 0,
                "rtc_softmax_fwd": 1, "rtc_softmax_ce_bwd": 1}

    def step(net, trainer, what):
        (logits, probs, ms), got = counted(lambda: custom_step(net, trainer))
        if got != per_step:
            raise AssertionError(f"extension {what} launched {got}, "
                                 f"expected {per_step}")
        return logits, probs, ms

    net, trainer = _ext_net(V, T)
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    # step-1 gates. The B2 head on the same weights (its launches are not
    # counted with the path's), then the plain head on TF32-rounded logits
    # as the control, then the timed custom-head step.
    with autograd.record():
        logits_b2 = net(x)
        loss_b2 = mx.nd.softmax_cross_entropy(logits_b2.reshape((-1, V)),
                                              y.reshape((-1,)))
    loss_b2.backward()
    loss_b2 = loss_b2.asscalar().item()
    g_b2 = {p.name: p.grad._data.clone() for p in params}
    with autograd.record():
        logits_c = net(x)
    lc = logits_c._data.detach().reshape(-1, V)
    g_head = softmax_ce_bwd_plain(softmax_plain(_tf32_round(lc)),
                                  y._data.reshape(-1), 1.0 / N)
    autograd.backward(logits_c, [mx.nd.NDArray(g_head.reshape(
        logits_c.shape))])
    c_errs = {p.name: _norm_rel(p.grad._data * N, g_b2[p.name])
              for p in params}
    del logits_c, lc, g_head
    torch.cuda.empty_cache()

    logits, probs, ms1 = step(net, trainer, "step 1")
    same = bool(torch.equal(logits._data, logits_b2._data))
    errs = {p.name: _norm_rel(p.grad._data * N, g_b2[p.name])
            for p in params}
    losses = [_head_loss(probs, y)]
    loss_err = abs(losses[0] - loss_b2 / N) / abs(loss_b2 / N)
    ranked = sorted(errs, key=errs.get, reverse=True)
    worst = ranked[0]
    print(f"extension: step 1 logits bitwise equal to the B2 head's: {same};"
          f" ||N*g - g_B2||/||g_B2|| worst of {len(errs)} tensors "
          f"{', '.join(f'{n} {errs[n]:.3e}' for n in ranked[:3])} (tol "
          f"{TOL_EXT_GRAD}), TF32 control "
          f"worst {max(c_errs.values()):.3e}, least "
          f"{min(c_errs.values()):.3e}; loss -mean log p[label] "
          f"{losses[0]:.7f}, B2 loss / N {loss_b2 / N:.7f} (relative "
          f"{loss_err:.3e}, tol {TOL_EXT_LOSS})")
    if not (same and errs[worst] <= TOL_EXT_GRAD
            and loss_err <= TOL_EXT_LOSS):
        raise AssertionError("the custom head's step 1 disagrees with the "
                             "B2 head's")
    if not max(c_errs.values()) > TOL_EXT_GRAD:
        raise AssertionError("the TF32 control passes the extension "
                             "gradient tolerance: it is too loose")
    del logits_b2, g_b2, logits, probs
    torch.cuda.empty_cache()

    step_ms = [ms1]
    _, probs, ms = step(net, trainer, "step 2")
    losses.append(_head_loss(probs, y))
    step_ms.append(ms)
    del probs
    os.makedirs(workdir, exist_ok=True)
    par_path = os.path.join(workdir, "ext.params")
    st_path = os.path.join(workdir, "ext.states")
    t0 = time.perf_counter()
    net.save_parameters(par_path)
    t_par = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.save_states(st_path)
    t_st = time.perf_counter() - t0
    print(f"extension: checkpoint after step 2: save_parameters "
          f"{os.path.getsize(par_path) / 1e9:.3f} GB in {t_par:.1f} s, "
          f"save_states {os.path.getsize(st_path) / 1e9:.3f} GB in "
          f"{t_st:.1f} s")
    _, probs, ms = step(net, trainer, "step 3")
    losses.append(_head_loss(probs, y))
    step_ms.append(ms)
    lr3 = trainer.learning_rate
    w3 = {k: p.data()._data.cpu()
          for k, p in net._collect_params_with_prefix().items()}
    del probs, net, trainer, params
    torch.cuda.empty_cache()

    net, trainer = _ext_net(V, T)
    t0 = time.perf_counter()
    net.load_parameters(par_path)
    trainer.load_states(st_path)
    print(f"extension: a fresh net and trainer loaded the checkpoint in "
          f"{time.perf_counter() - t0:.1f} s")
    _, probs, ms = step(net, trainer, "resumed step 3")
    if trainer.learning_rate != lr3:
        raise AssertionError(f"resumed lr {trainer.learning_rate} after "
                             f"step 3, uninterrupted {lr3}")
    loss_r = _head_loss(probs, y)
    step_ms.append(ms)
    del probs
    worst_r, bitwise = 0.0, True
    for k, p in net._collect_params_with_prefix().items():
        ref = w3[k].to(dev)
        bitwise = bitwise and torch.equal(p.data()._data, ref)
        worst_r = max(worst_r, ((p.data()._data - ref).abs().max()
                                / ref.abs().max()).item())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"extension: losses (mean CE a token) {losses}, resumed step 3 "
          f"{loss_r}; lr after step 3 {lr3:.3e} in both; resumed step-3 "
          f"weights vs uninterrupted: max|dw|/"
          f"max|w| {worst_r:.3e} (tol {TOL_RESUME}), bitwise equal: "
          f"{bitwise}; step times {step_ms} ms"
          f" ({N / (step_ms[2] / 1e3):.1f} tokens/s at step 3); peak memory "
          f"{peak_gb:.2f} GB; launches {launches}; card {_card_line()}")
    if not (bitwise and worst_r <= TOL_RESUME):
        raise AssertionError("the resumed step 3 differs from the "
                             "uninterrupted one")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"extension losses {losses} not finite and "
                             f"falling")
    if not peak_gb < 75.0:
        raise AssertionError(f"extension peak memory {peak_gb:.2f} GB")
    if profile:
        profile_breakdown(f"one custom-head step of {B} x {T} tokens",
                          lambda: custom_step(net, trainer))
    return launches


# ------------------------------------------------ symbolic and fused routes
def lm_loss_head(sym, lm, vocab):
    """``MakeLoss(softmax_cross_entropy(logits, labels))`` over the LM
    graph ``lm``: the summed CE of every token (B2 on the card), labels in
    the argument ``label``."""
    return sym.MakeLoss(sym.softmax_cross_entropy(
        sym.reshape(lm, shape=(-1, vocab)),
        sym.reshape(sym.Variable("label"), shape=(-1,))))


def export_lm(mx, prefix) -> float:
    """Write the seeded LM as a checkpoint of the symbolic route: its graph
    (``build_lm_symbol``, the table's shape declared) and its weights under
    the graph's names, through ``model.save_checkpoint``. Returns the
    seconds it took."""
    cfg = OPT_6_7B
    t0 = time.perf_counter()
    net = seeded_lm(mx)
    net(mx.nd.array(np.zeros((1, 1), np.float32)))  # the deferred shapes
    graph = build_lm_symbol(mx.sym, cfg["vocab"], cfg["units"],
                            cfg["layers"], cfg["heads"], cfg["ffn"],
                            max_len=cfg["max_len"])
    mx.model.save_checkpoint(prefix, 0, graph,
                             {n: p.data() for n, p in
                              lm_param_map(net).items()}, {})
    return time.perf_counter() - t0


def _free() -> None:
    """Release what the last phase held: a gluon net is a reference cycle
    (each block's name scope points back at it), so its weights, gradients
    and optimizer states wait for the cycle collector, not for the last
    name to go."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _timed_step(run):
    """(host seconds until ``run()`` returns, device ms between CUDA events
    around it, wall seconds to its end on the card)."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    run()
    t_host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return t_host, start.elapsed_time(end), time.perf_counter() - t0


def _check_launches(what, launches, b2):
    want = {n: c * TRAIN_STEPS for n, c in per_step_launches(b2).items()}
    if launches != want:
        raise AssertionError(f"{what} launched {launches}, expected {want} "
                             f"({TRAIN_STEPS} steps)")


def module_phase(mx, hk, dev, prefix, gluon_loss, profile=False):
    """Train the exported LM three Adam steps through ``mx.mod.Module``
    with the ``MakeLoss(softmax_cross_entropy)`` head, fed by an
    ``NDArrayIter``; returns {kernel name: launches in the three steps}."""
    import torch
    cfg = OPT_6_7B
    V, T, B = cfg["vocab"], cfg["max_len"], TRAIN_BATCH
    print(f"module: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
          f"on entry")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm, arg_params, aux_params = mx.model.load_checkpoint(prefix, 0)
    t_load = time.perf_counter() - t0
    x, y = train_batch()
    it = mx.io.NDArrayIter({"data": x}, {"label": y}, batch_size=B)
    mod = mx.mod.Module(lm_loss_head(mx.sym, lm, V), data_names=("data",),
                        label_names=("label",), context=mx.gpu(dev.index),
                        fixed_param_names=["pos_table"])
    t0 = time.perf_counter()
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=arg_params, aux_params=aux_params)
    del arg_params, aux_params
    mod.init_optimizer(optimizer="adam", optimizer_params={
        "learning_rate": TRAIN_LR, "rescale_grad": 1.0 / (B * T)})
    torch.cuda.synchronize()
    print(f"module: load_checkpoint {t_load:.1f} s (host), bind + "
          f"init_params + init_optimizer {time.perf_counter() - t0:.1f} s")
    ex = mod._exec_group.execs[0]
    losses, step_ms, host_ms, device_ms = [], [], [], []
    hk.reset_launch_counts()
    for step in range(TRAIN_STEPS):
        it.reset()
        batch = it.next()
        t_host, t_dev, t_fb = _timed_step(lambda: mod.forward_backward(batch))
        host_ms.append(t_host * 1e3)
        device_ms.append(t_dev)
        losses.append(mod.get_outputs()[0].asscalar().item())
        if step == 0:
            seen = dict(hk.launch_counts)
            grad_gate(hk, "module", {n: a._data for n, a in
                                     ex.arg_dict.items()},
                      {n: g._data for n, g in ex.grad_dict.items()},
                      mx.nd.array(x), mx.nd.array(y), losses[0])
            if dict(hk.launch_counts) != seen:
                raise AssertionError("the plain reference launched a kernel")
            rel = abs(losses[0] - gluon_loss) / abs(gluon_loss)
            print(f"module: step-1 loss {losses[0]:.6f}, the gluon path's "
                  f"on the same weights {gluon_loss:.6f} (relative "
                  f"{rel:.3e}, tol {TOL_ROUTE_LOSS})")
            if not rel <= TOL_ROUTE_LOSS:
                raise AssertionError("the Module's step-1 loss differs from "
                                     "the gluon path's")
            torch.cuda.empty_cache()
            gate_peak = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mod.update()
        torch.cuda.synchronize()
        step_ms.append((t_fb + time.perf_counter() - t0) * 1e3)
        if step == 0:
            # the step-1 weights, on the host, for the sequential route
            w1 = _host({n: a._data for n, a in ex.arg_dict.items()
                        if n in ex.grad_dict})
    launches = dict(hk.launch_counts)
    print(f"module: losses {losses}; step times {step_ms} ms "
          f"({B * T / (step_ms[-1] / 1e3):.1f} tokens/s at the last step); "
          f"forward_backward: host dispatch {host_ms} ms, device (events) "
          f"{device_ms} ms; peak memory of steps 2-3 "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (step 1 with "
          f"its gate {gate_peak:.2f} GB); launches {launches}; card "
          f"{_card_line()}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"module losses {losses} not finite and "
                             f"falling")
    _check_launches("module", launches, 1)
    if profile:
        def one_step():
            it.reset()
            mod.forward_backward(it.next())
            mod.update()
        profile_breakdown(f"one Module step of {B} x {T} tokens", one_step)
    return launches, losses[0], w1


def fused_gate(hk, w0, w1, x, y, loss, lr):
    """Step 1 of the fused trainer: its loss against the plain reference's
    mean, and each weight's step ``w0 − w1`` against ``lr·g_plain`` (at
    optax's first SGD-momentum step ``m = g``), by
    ``||(w0 − w1) − lr·g|| / ||lr·g||`` per tensor; the same made with the
    plain gradient in TF32 must miss. The f32 rounding of ``w0 − lr·g``
    alone (the noise floor) must lie 10× below each gate."""
    import torch
    names = list(w1)
    top = _top(names)
    tokens, labels = x._data.long(), y._data.long()
    n_tok = tokens.numel()
    ref_sum, ref = _plain_step_grads(hk, w0, tokens, labels, names)
    ref_loss = ref_sum.item() / n_tok
    loss_err = abs(loss - ref_loss) / abs(ref_loss)

    def step_err(n, w_new, step_lr=lr):
        """||(w0 - w_new) - lr·g_plain|| / ||lr·g_plain||, in float64."""
        want = ref[n].double() * (step_lr / n_tok)
        got = w0[n].double() - w_new.double()
        return ((got - want).norm() / want.norm().clamp_min(1e-300)).item()

    def sgd_step(n, g_sum, step_lr=lr):
        """w0 − fl32(lr·g) in float32, as the trainer's first step."""
        return w0[n] - g_sum * (step_lr / n_tok)

    def worst(errs):
        return max(errs.values()), max(errs[n] for n in top)

    errs = {n: step_err(n, w1[n]) for n in names}
    w_all, w_top = worst(errs)
    floors = {}
    for cand in FUSED_LR_CANDIDATES:
        floors[cand] = worst({n: step_err(n, sgd_step(n, ref[n], cand),
                                          cand) for n in names})
    floor_all, floor_top = floors[lr]
    with tf32_matmuls():
        ctl = _plain_step_grads(hk, w0, tokens, labels, names)[1]
    c_all, c_top = worst({n: step_err(n, sgd_step(n, ctl[n]))
                          for n in names})
    del ctl
    print(f"fused: step-1 loss {loss:.6f}, plain mean {ref_loss:.6f} "
          f"(relative {loss_err:.3e}, tol {TOL_TRAIN_LOSS}); "
          f"||(w0-w1) - lr·g_plain|| / ||lr·g_plain|| at lr {lr}: worst of "
          f"{len(names)} tensors {w_all:.3e} ({max(errs, key=errs.get)}; "
          f"tol {TOL_TRAIN_GRAD}), worst of the {len(top)} above the last "
          f"ReLU {w_top:.3e} (tol {TOL_TRAIN_GRAD_TOP}); f32 rounding floor "
          f"(all, top) by lr: "
          + ", ".join(f"{c}: {a:.2e}, {t:.2e}" for c, (a, t) in
                      floors.items())
          + f"; control, the step made with the plain gradient in TF32: "
          f"{c_all:.3e}, {c_top:.3e}")
    if not (loss_err <= TOL_TRAIN_LOSS and w_all <= TOL_TRAIN_GRAD
            and w_top <= TOL_TRAIN_GRAD_TOP):
        raise AssertionError("fused: step-1 loss or weights disagree with "
                             "the plain float32 reference")
    if not (floor_all * 10 <= TOL_TRAIN_GRAD
            and floor_top * 10 <= TOL_TRAIN_GRAD_TOP):
        raise AssertionError(f"fused: the f32 rounding of w - lr·g at lr "
                             f"{lr} is not 10x below the gates")
    if not (c_all > TOL_TRAIN_GRAD and c_top > TOL_TRAIN_GRAD_TOP):
        raise AssertionError("the TF32 control passes a weight-step "
                             "tolerance: it is too loose")
    return w_all, w_top


def fused_lr(count):
    """``FUSED_LR`` for the first update and ``FUSED_LR_LATER`` after, as
    arithmetic: the trainer calls a schedule with its update count, a 0-d
    tensor on the card, and the step reads nothing back to the host."""
    return FUSED_LR_LATER + (FUSED_LR - FUSED_LR_LATER) * (count == 0)


def fused_phase(mx, hk, dev, prefix, profile=False):
    """Train the exported LM three steps through ``gluon.SymbolBlock.
    imports`` and ``parallel.DataParallelTrainer`` (optax's SGD with
    momentum) on one card with ``gluon.loss.SoftmaxCrossEntropyLoss``;
    returns {kernel name: launches in the three steps}."""
    import torch
    from mxnet_tpu_torch import gluon, parallel
    cfg = OPT_6_7B
    T, B = cfg["max_len"], TRAIN_BATCH
    print(f"fused: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
          f"on entry")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    block = gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                      prefix + "-0000.params",
                                      ctx=mx.gpu(dev.index))
    # an argument of the graph; frozen, it is the gluon LM's Constant
    block.collect_params()["pos_table"].grad_req = "null"
    torch.cuda.synchronize()
    print(f"fused: SymbolBlock.imports {time.perf_counter() - t0:.1f} s")
    trainer = parallel.DataParallelTrainer(
        block, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": fused_lr, "momentum": FUSED_MOMENTUM})
    x, y = (mx.nd.array(a) for a in train_batch())
    losses, step_ms, host_ms = [], [], []
    hk.reset_launch_counts()
    for step in range(TRAIN_STEPS):
        out = []
        t_host, _, t_step = _timed_step(lambda: out.append(trainer.step(x, y)))
        host_ms.append(t_host * 1e3)
        step_ms.append(t_step * 1e3)
        losses.append(out[0].asscalar().item())
        if step == 0:
            names = sorted(n for n in block.collect_params()
                           if n != "pos_table")
            if sorted(trainer._param_names) != names:
                raise AssertionError(f"the trainer's parameters "
                                     f"{sorted(trainer._param_names)} are "
                                     f"not the file's")
            seen = dict(hk.launch_counts)
            f32_errs = fused_gate(hk, {n: p.data()._data for n, p in
                                       block.collect_params().items()},
                                  trainer._params, x, y, losses[0], FUSED_LR)
            if dict(hk.launch_counts) != seen:
                raise AssertionError("the plain reference launched a kernel")
            torch.cuda.empty_cache()
            gate_peak = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
    launches = dict(hk.launch_counts)
    trainer.sync_to_net()
    params = block.collect_params()
    same = all(torch.equal(params[n].data()._data, t)
               for src in (trainer._params, trainer._aux)
               for n, t in src.items())
    print(f"fused: losses {losses}; step times {step_ms} ms "
          f"({B * T / (step_ms[-1] / 1e3):.1f} tokens/s at the last step); "
          f"host dispatch {host_ms} ms; peak memory of steps 2-3 "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (step 1 with "
          f"its gate {gate_peak:.2f} GB); launches {launches}; "
          f"sync_to_net bitwise: {same}; card {_card_line()}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"fused losses {losses} not finite and falling")
    if not same:
        raise AssertionError("sync_to_net did not give the block the "
                             "trainer's weights")
    _check_launches("fused", launches, 0)
    if profile:
        profile_breakdown(f"one fused step of {B} x {T} tokens",
                          lambda: trainer.step(x, y))
    return launches, f32_errs


# ------------------------------------------------- mixed precision (bf16)
MIXED_MODES = (None, "dots", "full")
MIXED_SCALE = 2.0 ** 15
# the mixed step's gradients against the plain float32 step may be no
# worse, tensor by tensor, than this multiple of the plain bf16 control's
# (the plain versions under the same cast rule)
MIXED_GRAD_RATIO = 1.25


def jax_layer_norm(x, gamma, beta, eps=1e-5):
    """The LayerNorm op's rule (both packages): statistics in float32, the
    normalised value cast back to the input's dtype before the affine."""
    import torch
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


def _plain_mixed_grads(hk, tensors, tokens, labels, names):
    """Gradients of the mean token loss of the plain LM under the
    trainer's cast rule: every weight and the table cast to bf16, the
    plain attention (float32 inside, bf16 out) and the gluon loss's
    ``log_softmax`` and ``pick`` in bf16, the mean in float32; the
    gradients land on the float32 weights (the control)."""
    import torch
    from torch.utils.checkpoint import checkpoint
    cfg = OPT_6_7B
    bf16 = torch.bfloat16

    def attend(q, k, v):
        return checkpoint(lambda q, k, v: hk.flash_attention_reference(
            q, k, v, causal=True)[0], q, k, v, use_reentrant=False)

    w = {n: t.detach().requires_grad_(n in names)
         for n, t in tensors.items()}
    logits = plain_forward({n: t.to(bf16) for n, t in w.items()}, tokens,
                           cfg["vocab"], cfg["units"], cfg["layers"],
                           cfg["heads"], attend=attend, norm=jax_layer_norm)
    picked = torch.log_softmax(logits, -1).gather(-1, labels[..., None])
    loss = (-picked).mean(dim=(1, 2)).float().mean()
    grads = torch.autograd.grad(loss, [w[n] for n in names])
    return dict(zip(names, grads))


def mixed_gate(hk, w0, w1, tokens, labels, table, f32_errs):
    """Step 1 of the bf16 trainer: its gradient ``(w0 − w1)/lr`` (optax's
    first SGD-momentum step) against the plain float32 step's, per tensor
    ``||Δg|| / ||g||``, may be at most ``MIXED_GRAD_RATIO`` times the plain
    bf16 control's. Prints the TF32 control and the float32 fused route's
    errors beside it."""
    import torch
    names = sorted(w1)
    top = _top(names)
    n_tok = tokens.numel()
    full = dict(w0, pos_table=table)
    ref = {n: g / n_tok for n, g in
           _plain_step_grads(hk, full, tokens, labels, names)[1].items()}

    def err(n, g):
        r = ref[n].double()
        return ((g.double() - r).norm() / r.norm().clamp_min(1e-300)).item()

    port = {n: err(n, (w0[n].double() - w1[n].to(w0[n].device).double())
                   / FUSED_LR) for n in names}
    ctl = _plain_mixed_grads(hk, full, tokens, labels, names)
    ctl_err = {n: err(n, ctl[n]) for n in names}
    del ctl
    with tf32_matmuls():
        tf32 = _plain_step_grads(hk, full, tokens, labels, names)[1]
    tf32_err = {n: err(n, tf32[n] / n_tok) for n in names}
    del tf32
    ratio = {n: port[n] / max(ctl_err[n], 1e-30) for n in names}
    worst = max(ratio, key=ratio.get)

    def pair(e):
        return max(e.values()), max(e[n] for n in top)

    print(f"mixed: step-1 gradient ||g-plain f32||/||plain f32||, worst of "
          f"{len(names)} tensors and of the {len(top)} above the last ReLU:"
          f" bf16 trainer {pair(port)[0]:.3e}, {pair(port)[1]:.3e}; plain "
          f"bf16 control {pair(ctl_err)[0]:.3e}, {pair(ctl_err)[1]:.3e}; "
          f"TF32 control {pair(tf32_err)[0]:.3e}, {pair(tf32_err)[1]:.3e}; "
          f"float32 fused route {f32_errs[0]:.3e}, {f32_errs[1]:.3e}; "
          f"worst ratio trainer/control {ratio[worst]:.3f} ({worst}: "
          f"{port[worst]:.3e} vs {ctl_err[worst]:.3e}; tol "
          f"{MIXED_GRAD_RATIO})")
    if not ratio[worst] <= MIXED_GRAD_RATIO:
        raise AssertionError(f"mixed: the bf16 step's gradient of {worst} "
                             f"is further from the float32 step than the "
                             f"plain bf16 control allows")


def _host(params):
    """Copies of ``params`` on the host."""
    return {n: t.detach().to("cpu", copy=True) for n, t in params.items()}


def _equal_to_host(params, host) -> bool:
    import torch
    return all(torch.equal(t, host[n].to(t.device))
               for n, t in params.items())


def mixed_phase(mx, hk, dev, prefix, f32_errs, profile=False):
    """Train the exported LM through ``SymbolBlock.imports`` (the table an
    input) and ``DataParallelTrainer(compute_dtype="bfloat16")`` on int32
    token ids: three optax SGD-momentum steps for each ``remat`` mode, each
    from the file's float32 weights; one step with loss scaling, then one
    on a batch holding an ``inf``, which the guard skips. Returns {kernel
    name: launches}."""
    import torch
    from mxnet_tpu_torch import gluon, parallel
    cfg = OPT_6_7B
    T, B = cfg["max_len"], TRAIN_BATCH
    print(f"mixed: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
          f"on entry")
    block = gluon.SymbolBlock.imports(prefix + "-symbol.json",
                                      ["data", "pos_table"],
                                      prefix + "-0000.params",
                                      ctx=mx.gpu(dev.index))
    w0 = {n: p.data()._data for n, p in block.collect_params().items()}
    x, y = train_batch()
    ids = x.astype(np.int32)
    table = sinusoid_table(T, cfg["units"])
    total = {}

    def trainer_for(remat, **kw):
        return parallel.DataParallelTrainer(
            block, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": fused_lr, "momentum": FUSED_MOMENTUM},
            compute_dtype="bfloat16", remat=remat, **kw)

    def counted(run):
        # launches of the step by kernel and by (kernel, dtype): every
        # flash launch must take bf16 q, k and v
        before = dict(hk.launch_counts)
        before_dt = dict(hk.launch_dtypes)
        out = run()
        step = {k: v - before[k] for k, v in hk.launch_counts.items()}
        by_dtype = {k: v - before_dt.get(k, 0)
                    for k, v in hk.launch_dtypes.items()
                    if v != before_dt.get(k, 0)}
        if any(dt != "bfloat16" for (_, dt) in by_dtype):
            raise AssertionError(f"mixed: a kernel took inputs other than "
                                 f"bf16: {by_dtype}")
        for k, v in step.items():
            total[k] = total.get(k, 0) + v
        return out, step

    def want(remat):
        L = cfg["layers"]
        return {"flash_attention_fwd": L * (1 if remat is None else 2),
                "flash_attention_bwd_dkdv": L, "flash_attention_bwd_dq": L,
                "softmax_cross_entropy_fwd": 0}

    hk.reset_launch_counts()
    runs = {}
    for remat in MIXED_MODES:
        _free()
        trainer = trainer_for(remat)
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, host_ms, launches = [], [], [], []
        for step in range(TRAIN_STEPS):
            out = []
            (t_host, _, t_step), n = counted(lambda: _timed_step(
                lambda: out.append(trainer.step(ids, table, y))))
            losses.append(out[0].asscalar().item())
            step_ms.append(t_step * 1e3)
            host_ms.append(t_host * 1e3)
            launches.append(n)
            if step == 0 and remat is None:
                w1 = _host(trainer._params)
        peak = torch.cuda.max_memory_allocated() / 1e9
        runs[remat] = {"losses": losses, "peak": peak}
        print(f"mixed remat={remat}: losses {losses}; step times {step_ms} "
              f"ms ({B * T / (step_ms[-1] / 1e3):.1f} tokens/s at the last "
              f"step); host dispatch {host_ms} ms; peak memory "
              f"{peak:.2f} GB; launches a step {launches}; card "
              f"{_card_line()}")
        if any(n != want(remat) for n in launches):
            raise AssertionError(f"mixed remat={remat} launched {launches}, "
                                 f"expected {want(remat)} a step")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"mixed losses {losses} not finite and "
                                 f"falling")
        if remat is None:
            final = _host(trainer._params)
            if profile:
                profile_breakdown(f"one bf16 fused step of {B} x {T} tokens",
                                  lambda: trainer.step(ids, table, y))
        else:
            same = _equal_to_host(trainer._params, final)
            same_loss = losses == runs[None]["losses"]
            print(f"mixed remat={remat}: losses bitwise those of remat=None: "
                  f"{same_loss}; weights after {TRAIN_STEPS} steps bitwise "
                  f"equal: {same}")
            if not (same and same_loss):
                raise AssertionError(f"mixed remat={remat} differs from "
                                     f"remat=None")
        del trainer
    del final
    print(f"mixed: launches by (kernel, input dtype) over the remat modes "
          f"{dict(hk.launch_dtypes)}")
    peaks = {str(m): runs[m]["peak"] for m in MIXED_MODES}
    print(f"mixed: peak memory by remat mode {peaks} GB")
    if not runs["full"]["peak"] < runs[None]["peak"]:
        raise AssertionError("mixed: remat='full' does not lower the peak")

    # loss scaling: the scaled step's weights are the unscaled step's
    _free()
    trainer = trainer_for(None, loss_scaling={"init_scale": MIXED_SCALE})
    (_, _, t_step), n = counted(lambda: _timed_step(
        lambda: trainer.step(ids, table, y)))
    same = _equal_to_host(trainer._params, w1)
    stats = trainer.anomaly_stats()
    print(f"mixed loss_scaling init_scale {MIXED_SCALE:g}: step {t_step * 1e3:.1f}"
          f" ms, weights bitwise those of the unscaled step: {same}; "
          f"launches {n}; {stats}")
    if not (same and n == want(None) and not stats["last_step_skipped"]):
        raise AssertionError("mixed: the loss-scaled step differs from the "
                             "unscaled one")
    # a batch holding an inf: the guard skips it
    state = {n: tuple(t.clone() for t in s)
             for n, s in trainer._opt_state.items()}
    kept = {n: t.clone() for n, t in trainer._params.items()}
    bad = table.copy()
    bad[7, 11] = np.inf
    loss_inf, n = counted(lambda: trainer.step(ids, bad, y))
    stats = trainer.anomaly_stats()
    unchanged = (all(torch.equal(t, kept[k])
                     for k, t in trainer._params.items())
                 and all(torch.equal(a, b) for k, s in
                         trainer._opt_state.items()
                         for a, b in zip(s, state[k])))
    print(f"mixed: a batch holding an inf: loss {loss_inf.asscalar().item()}"
          f", weights and optimizer state unchanged: {unchanged}; launches "
          f"{n}; {stats}")
    if not (unchanged and stats["last_step_skipped"]
            and stats["grad_skipped_steps"] == 1
            and stats["loss_scale"] == MIXED_SCALE / 2):
        raise AssertionError("mixed: the guard did not skip the inf batch "
                             "and halve the scale")
    del trainer, state, kept
    _free()
    mixed_gate(hk, w0, w1, torch.from_numpy(x).long().to(dev),
               torch.from_numpy(y).long().to(dev),
               torch.from_numpy(table).to(dev), f32_errs)
    return total


# ------------------------------------------------- bucketing and sequential
BUCKETS = (2048, 1024)


def _lm_batch(mx, x, y, T):
    """A ``DataBatch`` of the first ``T`` tokens of each sequence, keyed by
    its bucket."""
    B = x.shape[0]
    return mx.io.DataBatch(
        [mx.nd.array(x[:, :T])], [mx.nd.array(y[:, :T])], bucket_key=T,
        provide_data=[mx.io.DataDesc("data", (B, T))],
        provide_label=[mx.io.DataDesc("label", (B, T))])


def bucketing_phase(mx, hk, dev, prefix, module_loss):
    """Train the exported LM three Adam steps through ``BucketingModule``
    at buckets T = 2048 and 1024 (the table declared at 2048 and sliced by
    the graph), with the ``MakeLoss(softmax_cross_entropy)`` head: steps
    on 2048, 1024 and 2048. Returns {kernel name: launches}."""
    import torch
    cfg = OPT_6_7B
    V, B = cfg["vocab"], TRAIN_BATCH
    print(f"bucketing: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated on entry")
    torch.cuda.reset_peak_memory_stats()
    lm, arg_params, aux_params = mx.model.load_checkpoint(prefix, 0)
    mod = mx.mod.BucketingModule(
        lambda T: (lm_loss_head(mx.sym, lm, V), ("data",), ("label",)),
        default_bucket_key=BUCKETS[0], context=mx.gpu(dev.index),
        fixed_param_names=["pos_table"])
    x, y = train_batch()
    first = _lm_batch(mx, x, y, BUCKETS[0])
    mod.bind(first.provide_data, first.provide_label)
    mod.init_params(arg_params=arg_params, aux_params=aux_params)
    del arg_params, aux_params
    mod.init_optimizer(optimizer="adam", optimizer_params={
        "learning_rate": TRAIN_LR, "rescale_grad": 1.0 / (B * BUCKETS[0])})
    hk.reset_launch_counts()
    losses, step_ms = [], []
    for i, T in enumerate((BUCKETS[0], BUCKETS[1], BUCKETS[0])):
        batch = _lm_batch(mx, x, y, T)
        before = dict(hk.launch_counts)
        _, _, t_fb = _timed_step(lambda: mod.forward_backward(batch))
        launched = {k: v - before[k] for k, v in hk.launch_counts.items()}
        losses.append(mod.get_outputs()[0].asscalar().item())
        if i == 0 and losses[0] != module_loss:
            raise AssertionError(f"bucketing: the 2048 bucket's step-1 loss "
                                 f"{losses[0]} is not the Module route's "
                                 f"{module_loss}")
        if i == 1:
            ex = mod._curr_module._exec_group.execs[0]
            grad_gate(hk, f"bucketing T={T}",
                      {n: a._data for n, a in ex.arg_dict.items()},
                      {n: g._data for n, g in ex.grad_dict.items()},
                      mx.nd.array(x[:, :T]), mx.nd.array(y[:, :T]),
                      losses[1])
        t0 = time.perf_counter()
        mod.update()
        torch.cuda.synchronize()
        step_ms.append((t_fb + time.perf_counter() - t0) * 1e3)
        if launched != per_step_launches(1):
            raise AssertionError(f"bucketing T={T} launched {launched}")
    big, small = (mod._buckets[T]._exec_group.execs[0] for T in BUCKETS)
    shared = [n for n in big.arg_dict if n not in ("data", "label")]
    one_storage = all(
        big.arg_dict[n]._data.data_ptr() == small.arg_dict[n]._data.data_ptr()
        for n in shared) and all(
        big.grad_dict[n]._data.data_ptr() == small.grad_dict[n]._data.data_ptr()
        for n in small.grad_dict)
    launches = dict(hk.launch_counts)
    print(f"bucketing: buckets {BUCKETS}, steps on T = {BUCKETS[0]}, "
          f"{BUCKETS[1]}, {BUCKETS[0]}: losses {losses} (step 1 bitwise "
          f"the Module route's {module_loss}); step times {step_ms} ms; "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"{len(shared)} parameters and {len(small.grad_dict)} gradients "
          f"on one storage in both buckets: {one_storage}; launches "
          f"{launches}; card {_card_line()}")
    if not one_storage:
        raise AssertionError("bucketing: the buckets hold separate storages")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"bucketing losses {losses} not finite")
    return launches


def sequential_phase(mx, hk, dev, prefix, module_loss, module_w1):
    """One Adam step of ``SequentialModule``: the LM up to its logits, then
    a loss module (``take_labels=True, auto_wiring=True``) whose input
    gradient is the LM's head gradient. Its loss and weights must be the
    Module route's step 1. Returns {kernel name: launches}."""
    import torch
    cfg = OPT_6_7B
    V, T, B = cfg["vocab"], cfg["max_len"], TRAIN_BATCH
    print(f"sequential: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated on entry")
    torch.cuda.reset_peak_memory_stats()
    lm, arg_params, aux_params = mx.model.load_checkpoint(prefix, 0)
    ctx = mx.gpu(dev.index)
    body = mx.mod.Module(lm, data_names=("data",), label_names=(),
                         context=ctx, fixed_param_names=["pos_table"])
    head = mx.mod.Module(lm_loss_head(mx.sym, mx.sym.Variable("logits"), V),
                         data_names=("logits",), label_names=("label",),
                         context=ctx)
    seq = mx.mod.SequentialModule()
    seq.add(body).add(head, take_labels=True, auto_wiring=True)
    x, y = train_batch()
    batch = _lm_batch(mx, x, y, T)
    seq.bind(batch.provide_data, batch.provide_label)
    seq.init_params(arg_params=arg_params, aux_params=aux_params)
    w0 = {n: a for n, a in arg_params.items() if n in module_w1}
    seq.init_optimizer(optimizer="adam", optimizer_params={
        "learning_rate": TRAIN_LR, "rescale_grad": 1.0 / (B * T)})
    hk.reset_launch_counts()
    _, _, t_fb = _timed_step(lambda: seq.forward_backward(batch))
    loss = seq.get_outputs()[0].asscalar().item()
    t0 = time.perf_counter()
    seq.update()
    torch.cuda.synchronize()
    step_ms = (t_fb + time.perf_counter() - t0) * 1e3
    launches = dict(hk.launch_counts)
    ex = body._exec_group.execs[0]
    worst = 0.0
    for n, w1 in module_w1.items():
        start = w0[n]._data.cpu() if hasattr(w0[n], "_data") else w0[n]
        got = ex.arg_dict[n]._data.cpu() - start
        want = w1 - start
        worst = max(worst, ((got - want).abs().max()
                            / want.abs().max().clamp_min(1e-30)).item())
    rel = abs(loss - module_loss) / abs(module_loss)
    print(f"sequential: step-1 loss {loss} (the Module route's "
          f"{module_loss}, relative {rel:.3e}, tol {TOL_ROUTE_LOSS}); weight "
          f"step vs the Module route's, worst max|Δ|/max|step| {worst:.3e} "
          f"(tol {TOL_ROUTE_LOSS}); step {step_ms:.1f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{launches}; card {_card_line()}")
    if not (rel <= TOL_ROUTE_LOSS and worst <= TOL_ROUTE_LOSS):
        raise AssertionError("sequential: step 1 differs from the Module "
                             "route's")
    if launches != per_step_launches(1):
        raise AssertionError(f"sequential launched {launches}")
    return launches


# ------------------------------------------------- ResNet-50 and the zoo
# bench.py's ResNet step (bench.py:157-197): resnet50_v1 at its published
# depth and widths (50 layers, channels 64-2048), 1000 classes, NHWC
# 224x224x3 images uniform(-1, 1) with random labels from the seed,
# Xavier, SoftmaxCrossEntropyLoss and the fused trainer's SGD (lr 0.1,
# momentum 0.9, wd 1e-4) in bf16, at bench.py's accelerator batch
RESNET_BATCH = 256
RESNET_IMAGE = 224
RESNET_CLASSES = 1000
RESNET_STEPS = 10            # timed, after the first (capture) step
RESNET_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
# The gates run at the reference's batch, 32, against the same step in
# float64 on the card. Below its output layer a freshly initialised
# ResNet-50 v1 is chaotic in its backward: rounding anywhere in the net
# is amplified on the way down, so two float32 steps (NCHW, NHWC) lie
# about 2e-2 from the float64 step's gradient (per tensor, median and
# worst alike) and 3e-2 from each other, and bf16's lies as far from it
# as a random vector, while the losses and logits agree (an H100 run of
# this phase: 2.2e-7 and 2.8e-5). Route B, the float32 gluon step (TF32
# off): the loss relative, the logits against their largest, every
# tensor's ||g - g64|| / ||g64|| at 0.1 and the output layer's (2.0e-5
# on the H100) at 1e-3; a TF32 control must miss (it read 0.88 and
# 1.7e-2). NHWC against NCHW with the weights transposed: the same gates.
GATE_BATCH = 32
TOL_RN_LOSS = 1e-5
TOL_RN_LOGITS = 2e-4     # x max|logit|: 4.0e-5 NHWC against NCHW (H100)
TOL_RN_GRAD = 0.1
TOL_RN_GRAD_TOP = 1e-3
# Route A, the bf16 fused trainer's step 1: what the chaos leaves
# well-posed, the loss (relative; 2.2e-3 on the H100, most of it the bf16
# rounding of each image's loss) and the output layer's gradient (0.12).
# At this state the net's output hardly depends on its input (random
# weights, random images): the same step on the images' bytes read in
# the wrong layout moves the output layer's gradient by only 0.21, and
# rounding every convolution's output to fp8 e4m3 (three mantissa bits to
# bf16's seven) by 0.19, both printed. The control that must miss is the
# same step with each label moved to the next class (1.35).
TOL_RN_BF16_LOSS = 2e-2
TOL_RN_BF16_TOP = 0.25
# the served logits against the gluon net's inference forward (float32
# both, other batch sizes: other cuDNN kernels), x max|logit|
TOL_RN_SERVE = 1e-4
RN_SERVE_REQUESTS = 8
RN_SERVE_BUCKETS = (1, 2, 4, 8)
# one net of each zoo family at its input size, float32 forward (TF32
# off) against float64, max|d| / max|f64|
ZOO_SWEEP = (("alexnet", 224), ("vgg11_bn", 224), ("resnet18_v2", 224),
             ("squeezenet1.0", 224), ("mobilenet1.0", 224),
             ("mobilenetv2_1.0", 224), ("densenet121", 224),
             ("inceptionv3", 299))
ZOO_BATCH = 2
TOL_ZOO = 1e-4


def resnet_batch(n, layout="NHWC"):
    """``n`` images uniform(-1, 1) at 224x224x3 and labels, float32 numpy
    arrays from the seed (``bench.py``'s draws); NCHW on request."""
    rng = np.random.RandomState(SEED)
    x = rng.uniform(-1, 1, (n, RESNET_IMAGE, RESNET_IMAGE, 3)).astype(
        np.float32)
    y = rng.randint(0, RESNET_CLASSES, (n,)).astype(np.float32)
    if layout == "NCHW":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    return x, y


def seeded_resnet(mx, layout="NHWC", prefix=None):
    """``vision.resnet50_v1`` with Xavier weights from the seed, on the
    card (its deferred shapes finish at the first forward)."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=RESNET_CLASSES, layout=layout,
                             prefix=prefix)
    net.initialize(mx.init.Xavier())
    return net


def _mem_format(t) -> str:
    """A 4-D tensor's memory format, as cuDNN sees the NCHW-ordered view:
    ``channels_last``, ``contiguous``, ``either`` (a unit axis makes both
    hold) or ``strided``."""
    last = t.is_contiguous(memory_format=torch.channels_last)
    first = t.is_contiguous()
    return {(True, False): "channels_last", (False, True): "contiguous",
            (True, True): "either"}.get((last, first), "strided")


class ConvCensus(TorchDispatchMode):
    """Counts what reaches torch under it: the convolutions, forward and
    backward, by (direction, input dtype, input memory format), and the
    copies that give a 4-D tensor another memory format (a layout
    conversion on the path)."""

    def __init__(self):
        super().__init__()
        self.convs, self.relayouts = {}, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        aten = torch.ops.aten
        if func in (aten.convolution.default,
                    aten.convolution_backward.default):
            back = func is aten.convolution_backward.default
            x = args[1] if back else args[0]
            key = ("backward" if back else "forward",
                   str(x.dtype).replace("torch.", ""), _mem_format(x))
            self.convs[key] = self.convs.get(key, 0) + 1
        elif func in (aten.clone.default, aten._to_copy.default,
                      aten.copy_.default):
            src = args[1] if func is aten.copy_.default else args[0]
            if isinstance(src, torch.Tensor) and src.dim() == 4:
                pair = (_mem_format(src), _mem_format(out))
                if "either" not in pair and pair[0] != pair[1]:
                    key = (str(func), *pair)
                    self.relayouts[key] = self.relayouts.get(key, 0) + 1
        return out


# A conv's bias ahead of a BatchNorm (BottleneckV1's 1x1 convs) has a
# gradient of zero: the normalisation takes the mean out. Its float64
# value is rounding noise, 1e-16 of the others, so its relative error
# says nothing: a tensor whose float64 gradient's norm is below NULL_GRAD
# of the largest is left out of the per-tensor gates, and the norm of
# the step's gradient there is printed against the largest tensor's
NULL_GRAD = 1e-9


class RoundConvOutputs(TorchDispatchMode):
    """Rounds every convolution's output to ``dtype`` and back (a control
    of coarser precision than the route's)."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.convolution.default:
            out = out.to(self.dtype).to(out.dtype)
        return out


def _null_grads(ref):
    """The tensors whose gradient ``ref`` ({name: float64}) is null."""
    norms = {n: r.norm().item() for n, r in ref.items()}
    big = max(norms.values())
    return {n for n, v in norms.items() if v <= NULL_GRAD * big}


def _rn_grads_rel(grads, ref, null):
    """({name: ||g - ref|| / ||ref||} over the tensors not in ``null``,
    {name: ||g|| / max ||ref||} over those in it), in float64."""
    big = max(r.norm().item() for r in ref.values())
    errs, nulls = {}, {}
    for n, g in grads.items():
        g = g.double()
        if n in null:
            nulls[n] = g.norm().item() / big
        else:
            errs[n] = ((g - ref[n]).norm() / ref[n].norm()).item()
    return errs, nulls


def _to_nchw(name, t):
    """An NHWC net's tensor in its NCHW twin's layout (conv weights
    OHWI -> OIHW)."""
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def _gluon_grads(mx, net, x, y, dtype=None):
    """Loss (a float), {name: gradient} and the logits of one recorded
    gluon step of ``net`` on the batch ``(x, y)``: the mean
    SoftmaxCrossEntropyLoss, as the fused trainer takes it."""
    from mxnet_tpu_torch import autograd, gluon
    xa = mx.nd.array(x, dtype=dtype)
    with autograd.record():
        logits = net(xa)
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            logits, mx.nd.array(y)).mean()
    loss.backward()
    return float(loss.asscalar()), {
        n: p.grad._data.detach().clone()
        for n, p in net.collect_params().items()
        if p.grad_req != "null"}, logits._data.detach()


def resnet_gate_phase(mx):
    """At batch 32: route B (the float32 NCHW step through gluon, TF32
    off) and route A's numerics (the NHWC net against the NCHW net with
    its weights transposed; the bf16 fused trainer's step-1 gradient)
    against the same step in float64 on the card, each with a control
    that must miss; then route B's ``gluon.Trainer`` step."""
    from mxnet_tpu_torch import gluon, interop, parallel
    from mxnet_tpu_torch.gluon.model_zoo import vision
    x, y = resnet_batch(GATE_BATCH, "NCHW")
    xh = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    net = seeded_resnet(mx, "NCHW", prefix="gate_")
    net(mx.nd.array(x[:1]))                       # the deferred shapes
    w0 = {n: p.data()._data.detach().clone()
          for n, p in net.collect_params().items()}
    top = [n for n in w0 if "_dense" in n]

    def twin(layout, dtype="float32"):
        """A fresh resnet50_v1 holding ``w0`` (transposed under NHWC), its
        parameters cast to ``dtype``."""
        other = vision.resnet50_v1(classes=RESNET_CLASSES, layout=layout,
                                   prefix="gate_")
        other.initialize()
        interop.load_block_params(other, {
            n: (t.permute(0, 2, 3, 1) if layout == "NHWC" and t.dim() == 4
                else t).contiguous().cpu().numpy() for n, t in w0.items()})
        if dtype != "float32":
            for p in other.collect_params().values():
                p.cast(dtype)
        return other

    ref = twin("NCHW", "float64")
    loss64, g64, logits64 = _gluon_grads(mx, ref, x.astype(np.float64), y,
                                         dtype="float64")
    del ref
    _free()
    null = _null_grads(g64)

    def score(what, loss, grads, logits=None, nhwc=False, against=None):
        """Errors of a step's loss and gradients against the float64
        step's (or ``against``: a step's (loss, gradients, logits))."""
        rloss, rgrads, rlogits = against or (loss64, g64, logits64)
        if nhwc:
            grads = {n: _to_nchw(n, g) for n, g in grads.items()}
        errs, null_norms = _rn_grads_rel(
            grads, {n: g.double() for n, g in rgrads.items()}, null)
        vals = sorted(errs.values())
        worst = max(errs, key=errs.get)
        g = torch.cat([grads[n].double().flatten() for n in errs])
        r = torch.cat([rgrads[n].double().flatten() for n in errs])
        s = {"loss_err": abs(loss - rloss) / abs(rloss), "all": errs[worst],
             "top": max(errs[n] for n in top), "median": vals[len(vals) // 2],
             "logits": float("nan") if logits is None else (
                 (logits.double() - rlogits.double()).abs().max()
                 / rlogits.double().abs().max()).item()}
        print(f"resnet gate: {what}: loss relative {s['loss_err']:.3e}, "
              f"logits max|d|/max|ref| {s['logits']:.3e}; "
              f"||g-ref||/||ref|| over {len(errs)} tensors: worst "
              f"{s['all']:.3e} ({worst}), median {s['median']:.3e}, the "
              f"output layer {s['top']:.3e}; all tensors as one vector: "
              f"cosine {(g @ r / (g.norm() * r.norm())).item():.4f}; "
              f"{len(null_norms)} tensors with a null gradient (conv "
              f"biases ahead of a BatchNorm): ||g|| up to "
              f"{max(null_norms.values(), default=0.0):.3e} of the "
              f"largest tensor's")
        return s

    def f32_ok(s):
        return (s["loss_err"] <= TOL_RN_LOSS and s["logits"] <= TOL_RN_LOGITS
                and s["all"] <= TOL_RN_GRAD and s["top"] <= TOL_RN_GRAD_TOP)

    def bf16_ok(s):
        return (s["loss_err"] <= TOL_RN_BF16_LOSS
                and s["top"] <= TOL_RN_BF16_TOP)

    # route B: float32 through gluon; the TF32 control first (a recorded
    # step leaves the weights where they are)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with tf32_matmuls():
            ctl = score("float32 NCHW gluon step in TF32 (control)",
                        *_gluon_grads(mx, net, x, y))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    b_run = _gluon_grads(mx, net, x, y)
    b = score("route B, the float32 NCHW gluon step", *b_run)
    print(f"resnet gate: route B against float64: tolerances loss "
          f"{TOL_RN_LOSS}, logits {TOL_RN_LOGITS}, each tensor "
          f"{TOL_RN_GRAD}, the output layer {TOL_RN_GRAD_TOP}; card "
          f"{_card_line()}")
    if not f32_ok(b):
        raise AssertionError("resnet gate: route B's float32 step is not "
                             "within its tolerances of the float64 step")
    if f32_ok(ctl):
        raise AssertionError("resnet gate: the TF32 control passes route "
                             "B's tolerances: they are too loose")
    # NHWC against NCHW, both float32 through gluon, and each against
    # float64
    nhwc = twin("NHWC")
    h_run = _gluon_grads(mx, nhwc, xh, y)
    h = score("the NHWC float32 gluon step", *h_run, nhwc=True)
    hc = score("the NHWC step against the NCHW step", *h_run, nhwc=True,
               against=b_run)
    if not (f32_ok(h) and f32_ok(hc)):
        raise AssertionError("resnet gate: the NHWC net differs from the "
                             "NCHW net")
    # route A's numerics: the bf16 fused trainer's first step; optax's SGD
    # leaves its gradient in (w0 - w1) / lr - wd * w0
    lr, wd = RESNET_OPT["learning_rate"], RESNET_OPT["wd"]
    w0h = {n: p.data()._data.double()
           for n, p in nhwc.collect_params().items()}

    def fused_step(images, labels):
        trainer = parallel.DataParallelTrainer(
            nhwc, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            dict(RESNET_OPT), compute_dtype="bfloat16")
        loss = float(trainer.step(mx.nd.array(images),
                                  mx.nd.array(labels)).asscalar())
        return loss, {n: (w0h[n] - t.double()) / lr - wd * w0h[n]
                      for n, t in trainer._params.items()}

    a = score("route A, the bf16 fused trainer's step 1",
              *fused_step(xh, y), nhwc=True)
    _free()
    score("the bf16 fused step on the images in the wrong layout",
          *fused_step(x.reshape(xh.shape), y), nhwc=True)
    _free()
    wrong = score("the bf16 fused step with each label moved to the next "
                  "class (control)",
                  *fused_step(xh, (y + 1) % RESNET_CLASSES), nhwc=True)
    del w0h
    _free()
    coarse = twin("NHWC", "bfloat16")
    with RoundConvOutputs(torch.float8_e4m3fn):
        score("the bf16 gluon step with fp8 e4m3 convolution outputs",
              *_gluon_grads(mx, coarse, xh, y, dtype="bfloat16"), nhwc=True)
    del coarse
    print(f"resnet gate: route A against float64: bounds loss "
          f"{TOL_RN_BF16_LOSS}, the output layer {TOL_RN_BF16_TOP}")
    if not bf16_ok(a):
        raise AssertionError("resnet gate: route A's bf16 step is not "
                             "within its bounds of the float64 step")
    if bf16_ok(wrong):
        raise AssertionError("resnet gate: the moved-label control passes "
                             "route A's bounds: they are too loose")
    # route B's update: gluon.Trainer, MXNet's SGD
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(RESNET_OPT))
    _gluon_grads(mx, net, x, y)
    trainer.step(1)
    moved = max((p.data()._data - w0[n]).abs().max().item()
                for n, p in net.collect_params().items()
                if p.grad_req != "null")
    print(f"resnet gate: route B's gluon.Trainer step moved the weights by "
          f"up to {moved:.3e}")
    if not moved > 0:
        raise AssertionError("resnet gate: gluon.Trainer did not step")


def _profile_resnet_step(trainer, xs, ys):
    """``profile_breakdown`` of one step, with the optimizer's device time
    apart (its kernels launch inside a ``record_function`` range)."""
    from torch.profiler import record_function
    rule = trainer._rule
    plain_step = rule.step

    def step(*a, **kw):
        with record_function("fused optimizer"):
            return plain_step(*a, **kw)

    rule.step = step
    try:
        profile_breakdown(
            f"one bf16 fused step of ResNet-50 at {RESNET_BATCH} images",
            lambda: trainer.step(xs, ys), ranges=("fused optimizer",))
    finally:
        del rule.step


def resnet_phase(mx):
    """Route A, the headline: ``bench.py``'s ResNet-50 step through the
    fused trainer in bf16 at batch 256 on the card. A first step (the
    capture), then ``RESNET_STEPS`` timed ones; one more under
    ``ConvCensus`` (every convolution must take bf16 inputs) and one under
    ``torch.profiler``. A second trainer from the same weights repeats
    step 1: bitwise or not is reported. Returns the trained net, its
    trainer synced into it."""
    from mxnet_tpu_torch import gluon, parallel
    B = RESNET_BATCH
    torch.cuda.reset_peak_memory_stats()
    net = seeded_resnet(mx, "NHWC")
    x, y = resnet_batch(B)
    xs, ys = mx.nd.array(x), mx.nd.array(y)      # on the card: set-up
    del x

    def trainer_for():
        return parallel.DataParallelTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            dict(RESNET_OPT), compute_dtype="bfloat16")

    trainer = trainer_for()
    t0 = time.perf_counter()
    losses = [trainer.step(xs, ys)]
    w1 = {n: t.detach().clone() for n, t in trainer._params.items()}
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    step_ms, host_ms = [], []
    for _ in range(RESNET_STEPS):
        out = []
        t_host, _, t_step = _timed_step(
            lambda: out.append(trainer.step(xs, ys)))
        losses.append(out[0])
        step_ms.append(t_step * 1e3)
        host_ms.append(t_host * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS):
        losses.append(trainer.step(xs, ys))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(v.asscalar()) for v in losses]
    census = ConvCensus()
    with census:
        trainer.step(xs, ys)
    print(f"resnet: route A, resnet50_v1 NHWC bf16 fused step at {B} x "
          f"{RESNET_IMAGE}x{RESNET_IMAGE}x3: first step (capture) "
          f"{first:.2f} s; {RESNET_STEPS} timed steps {step_ms} ms, host "
          f"dispatch {host_ms} ms; {RESNET_STEPS} more back to back "
          f"{run_s * 1e3 / RESNET_STEPS:.2f} ms a step, "
          f"{B * RESNET_STEPS / run_s:.1f} images/s; peak memory "
          f"{peak:.2f} GB; card {_card_line()}")
    print(f"resnet: losses {losses}")
    print(f"resnet: convolutions of one step by (direction, input dtype, "
          f"memory format) {census.convs}; copies that change a 4-D "
          f"tensor's memory format {census.relayouts or 'none'}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"resnet: losses {losses} not finite")
    if not census.convs or any(dt != "bfloat16" for _, dt, _ in
                               census.convs):
        raise AssertionError(f"resnet: a convolution took other than bf16 "
                             f"inputs: {census.convs}")
    n_fwd = sum(v for k, v in census.convs.items() if k[0] == "forward")
    if n_fwd != 53:
        raise AssertionError(f"resnet: {n_fwd} forward convolutions a "
                             f"step, ResNet-50 has 53")
    _profile_resnet_step(trainer, xs, ys)
    # a second trainer from the same weights (the net's, untouched until
    # sync_to_net) takes step 1 again
    again = trainer_for()
    again.step(xs, ys)
    same = all(torch.equal(t, w1[n]) for n, t in again._params.items())
    diff = max((t - w1[n]).abs().max().item()
               for n, t in again._params.items())
    print(f"resnet: step 1 repeated by a second trainer from the same "
          f"weights: bitwise {same} (max |d| {diff:.3e})")
    del again, w1, xs, ys
    trainer.sync_to_net()
    del trainer
    _free()
    return net


def resnet_serving_phase(mx, net, workdir):
    """Route C: the trained ResNet-50, exported (hybridized, one inference
    forward) and served through ``ModelServer`` on the card, 8 requests of
    one image each at buckets 1/2/4/8; every response against the gluon
    net's inference forward (moving statistics) of the same images."""
    from mxnet_tpu_torch.serving import ModelConfig, ModelServer
    x, _ = resnet_batch(RN_SERVE_REQUESTS)
    net.hybridize()
    want = net(mx.nd.array(x))._data.float()
    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    sym_file, param_file = net.export(os.path.join(workdir, "resnet50"))
    with open(sym_file) as f:
        sym_json = f.read()
    with open(param_file, "rb") as f:
        param_bytes = f.read()
    server = ModelServer([ModelConfig(
        "resnet50", sym_json, param_bytes,
        feature_shape=(RESNET_IMAGE, RESNET_IMAGE, 3),
        buckets=RN_SERVE_BUCKETS, deadline_ms=0)])
    server.start()
    setup = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        pending = [server.submit("resnet50", x[i])
                   for i in range(RN_SERVE_REQUESTS)]
        got = [p.result(timeout=300) for p in pending]
        wall = time.perf_counter() - t0
        stats = server.stats("resnet50")
    finally:
        server.close()
    got = torch.from_numpy(np.stack(got)).to(want.device)
    err = ((got - want).abs().max() / want.abs().max()).item()
    print(f"resnet serving: route C, export + ModelServer set-up "
          f"{setup:.2f} s; {RN_SERVE_REQUESTS} requests of one image in "
          f"{wall * 1e3:.1f} ms; buckets {RN_SERVE_BUCKETS}; {stats}; logits "
          f"max|d|/max|gluon| {err:.3e} (tol {TOL_RN_SERVE})")
    if not err <= TOL_RN_SERVE:
        raise AssertionError("resnet serving: the served logits differ from "
                             "the gluon net's inference forward")


def zoo_phase(mx):
    """One net of each zoo family at its input size, batch 2: the float32
    forward (TF32 off, inference: moving statistics, drawn at random)
    against the same net's float64 forward on the card."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    rng = np.random.RandomState(SEED)
    for name, size in ZOO_SWEEP:
        mx.random.seed(SEED)
        net = vision.get_model(name)
        net.initialize(mx.init.Xavier())
        x = rng.uniform(-1, 1, (ZOO_BATCH, 3, size, size)).astype(np.float32)
        net(mx.nd.array(x))                          # the deferred shapes
        for n, p in net.collect_params().items():
            if n.endswith(("running_mean", "beta")):
                p.set_data(0.1 * rng.randn(*p.shape).astype(np.float32))
            elif n.endswith(("running_var", "gamma")):
                p.set_data(rng.uniform(0.5, 1.5, p.shape).astype(np.float32))
        t0 = time.perf_counter()
        got = net(mx.nd.array(x))._data.double()
        torch.cuda.synchronize()
        t32 = time.perf_counter() - t0
        for p in net.collect_params().values():
            p.cast("float64")
        want = net(mx.nd.array(x, dtype="float64"))._data
        err = ((got - want).abs().max() / want.abs().max()).item()
        print(f"zoo: {name} at {size}x{size}, batch {ZOO_BATCH}: output "
              f"{tuple(want.shape)}, float32 forward {t32 * 1e3:.1f} ms, "
              f"max|f32 - f64|/max|f64| {err:.3e} (tol {TOL_ZOO})")
        if not (err <= TOL_ZOO and tuple(want.shape) == (ZOO_BATCH, 1000)):
            raise AssertionError(f"zoo: {name}'s float32 forward differs "
                                 f"from its float64 forward")
        del net, got, want
        _free()


# ------------------------------------------------- the recurrent family
# Route D: the word-level LSTM language model of the reference's
# example/gluon/word_language_model at the widths of the large PTB LSTM
# (Zaremba et al. 2014, arXiv:1409.2329, the README's largest
# configuration): vocabulary 10,000, 1500 embedding and hidden units, 2
# layers, an untied decoder (the JAX recipe ignores tie_weights), bptt 35
# and batch 32 (the recipe's defaults), SGD at lr 1.0 with the recipe's
# clip of 0.2 · bptt · batch; about 66 M parameters, so nothing is cut. The
# corpus is a seeded synthetic one at the vocabulary (the recipe's own
# stand-in without --data).
WLM = dict(vocab=10000, emsize=1500, nhid=1500, nlayers=2, bptt=35,
           batch=32, lr=1.0, clip=0.2)
WLM_DROPOUT = 0.65       # the reference's large setting, for the timing
WLM_STEPS = 10           # timed, after a warm-up step
# Step 1 of route D in float32 (TF32 off) against the same step in float64
# on the card: the logits (relative to the largest), the clipped
# gradients (||dg||/||g|| per tensor) and the weights after the update
# (relative to each tensor's largest), each of which a TF32 control must
# miss; and the loss, relative. Freshly initialised, the net's logits are
# ~1e-2 and its loss is ln(10,000) to within them, so the TF32 step's loss
# rounds to the float32 step's (the control cannot miss it: printed). The
# weights start at 0 for the biases, so their error is the gradients'. On
# an H100 (700 W): loss 8.8e-8; logits 1.9e-6 (TF32 4.7e-4); gradients
# 1.1e-6 (TF32 4.9e-4); weights 1.3e-6 (TF32 3.0e-4).
TOL_WLM_LOSS = 1e-6
TOL_WLM_LOGITS = 5e-5
TOL_WLM_GRAD = 5e-5
TOL_WLM_WEIGHTS = 2e-5
# Phase 17: each mode's float32 forward and backward against float64 at
# route D's widths (outputs relative to their largest entry, gradients by
# ||dg||/||g|| per tensor); the unrolled LSTMCell against the fused layer
# (both float32, another order of the same sums). The relu RNN's
# backward goes through 35 steps of ReLU masks: a pre-activation within
# float32 rounding of zero flips its mask, so its gradients are held to
# TOL_MODES_GRAD_RELU (2.39e-3 on an H100; the saturating modes 1e-6).
TOL_MODES_OUT = 1e-5
TOL_MODES_GRAD = 5e-5
TOL_MODES_GRAD_RELU = 1e-2
TOL_CELL_FUSED = 1e-5
# Route E: the reference's lstm_bucketing.py defaults (two LSTMCells of
# 200, embedding 200, batch 32, buckets 10..60) at vocabulary 10,000 on
# synthetic Markov sentences; its first batch's loss against float64
# (4.2e-11 on an H100: freshly initialised, each token's -log p is ln(V)
# to within float32's rounding, averaged over about a thousand tokens).
BUCKET_CFG = dict(vocab=10000, hidden=200, embed=200, layers=2, batch=32,
                  buckets=[10, 20, 30, 40, 50, 60], lr=0.01)
BUCKET_SENTENCES = 6400
TOL_BUCKET_LOSS = 1e-7


def _ctx(mx, dev):
    return mx.gpu(dev.index) if dev.type == "cuda" else mx.cpu()


def _load_example(rel, name):
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class RnnCensus(TorchDispatchMode):
    """Counts the concatenations that reach torch under it, and the
    packing copies among them: a ``cat`` whose output holds at least
    ``packed`` elements (the recurrent layer's whole parameter vector)."""

    def __init__(self, packed):
        super().__init__()
        self.packed, self.cats, self.cat_elems, self.packs = packed, 0, 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.cat.default:
            self.cats += 1
            self.cat_elems += out.numel()
            self.packs += out.numel() >= self.packed
        return out


class ClipRecorder:
    """Stands in for ``gluon.utils.clip_global_norm`` while it is entered:
    keeps each call's arrays, copies of them before the clip, the norm,
    and the host's wait for the card before the norm is read."""

    def __init__(self, utils):
        self.utils, self.orig, self.calls, self.wait_s = \
            utils, utils.clip_global_norm, [], 0.0

    def __enter__(self):
        self.utils.clip_global_norm = self
        return self

    def __exit__(self, *exc):
        self.utils.clip_global_norm = self.orig

    def __call__(self, arrays, max_norm, check_isfinite=True):
        t0 = time.perf_counter()
        if arrays and arrays[0]._data.is_cuda:
            torch.cuda.synchronize()
        self.wait_s += time.perf_counter() - t0
        before = [a._data.clone() for a in arrays]
        norm = self.orig(arrays, max_norm, check_isfinite)
        self.calls.append((arrays, before, norm, max_norm))
        return norm


def _wlm_step(wlm, net, trainer, data, target, hidden, clipper=None):
    """One step of the recipe (``train_step``): returns (mean loss, the
    hidden state detached for the next step)."""
    from mxnet_tpu_torch import gluon
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    c = WLM
    hidden = wlm.detach(hidden)
    if clipper is None:
        L, hidden = wlm.train_step(net, trainer, loss_fn, data, target,
                                   hidden, c["clip"], c["bptt"], c["batch"])
    else:
        with clipper:
            L, hidden = wlm.train_step(net, trainer, loss_fn, data, target,
                                       hidden, c["clip"], c["bptt"],
                                       c["batch"])
    return L.mean(), hidden


def _wlm_net(wlm, mx, ctx, weights, dropout=0.0, dtype="float32"):
    c = WLM
    net, trainer = wlm.build(c["vocab"], "lstm", c["emsize"], c["nhid"],
                             c["nlayers"], c["lr"], dropout, ctx)
    params = net._collect_params_with_prefix()
    for k, p in params.items():
        if dtype != "float32":
            p.cast(dtype)
        p.set_data(mx.nd.NDArray(weights[k].to(mx.nd.torch_dtype(dtype))))
    return net, trainer


def _grads_and_weights(net):
    params = net._collect_params_with_prefix()
    return ({k: p.grad._data.double() for k, p in params.items()},
            {k: p.data()._data.double() for k, p in params.items()})


def _wlm_logits(net, data, dtype="float32"):
    """The decoder's logits of ``data`` from zero states (no gradient)."""
    from mxnet_tpu_torch import autograd
    hidden = net.begin_state(batch_size=WLM["batch"],
                             ctx=data.context, dtype=dtype)
    with autograd.pause():
        return net(data, hidden)[0]._data.detach().double()


def _wlm_errors(step, ref, w0):
    """(loss relative error, logits relative to the largest, worst
    ||dg||/||g|| of the clipped gradients, worst max|w1 - w1_ref| /
    max|w1_ref| of the weights after the update, worst max|w1 - w1_ref| /
    max|w1_ref - w0| of the update) of ``step`` against ``ref``, each
    (loss, logits, grads, weights). The last is printed: a float32 weight
    holds its update only to half an ulp of the weight."""
    loss = abs(step[0] - ref[0]) / abs(ref[0])
    logits = ((step[1] - ref[1]).abs().max() / ref[1].abs().max()).item()
    grad = max(_norm_rel(step[2][k], g) for k, g in ref[2].items()
               if g.norm() > 0)
    weights = max(((step[3][k] - w).abs().max() / w.abs().max()).item()
                  for k, w in ref[3].items())
    upd = max(((step[3][k] - w).abs().max() /
               (w - w0[k].double()).abs().max()).item()
              for k, w in ref[3].items() if (w - w0[k].double()).abs().max()
              > 0)
    return loss, logits, grad, weights, upd


def word_lm_phase(mx, dev):
    """Route D (phase 16): the recipe twin's ``RNNModel`` at the large PTB
    widths through gluon. Step 1 (dropout 0) against float64 on the card
    (loss, clipped gradients, update) with a TF32 control that must miss;
    the clip in the gradient buffers themselves; the hidden state detached
    into step 2; a second model repeats step 1 (bitwise or not). Then ten
    timed steps at dropout 0.65 (step, host dispatch, tokens/s, peak
    memory), one under ``RnnCensus`` and one under ``torch.profiler``, and
    cuDNN's ``nn.LSTM`` at the same shape beside the port's layer."""
    from mxnet_tpu_torch import gluon
    wlm = _load_example("example/gluon/word_language_model/train_torch.py",
                        "train_torch")
    c, ctx = WLM, _ctx(mx, dev)
    rng = np.random.RandomState(SEED)
    corpus = rng.randint(0, c["vocab"], c["batch"] * (
        c["bptt"] * (WLM_STEPS + 4) + 1)).astype("float32")
    train_data = wlm.batchify(corpus, c["batch"], ctx=ctx)
    batches = [wlm.get_batch(train_data, i, c["bptt"])
               for i in range(0, c["bptt"] * (WLM_STEPS + 3), c["bptt"])]
    mx.random.seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    net, trainer = wlm.build(c["vocab"], "lstm", c["emsize"], c["nhid"],
                             c["nlayers"], c["lr"], 0.0, ctx)
    params = net._collect_params_with_prefix()
    n_params = sum(p.data().size for p in params.values())
    w0 = {k: p.data()._data.detach().clone() for k, p in params.items()}
    packed = sum(p.data().size for k, p in params.items()
                 if k.startswith("rnn."))
    hidden = net.begin_state(batch_size=c["batch"], ctx=ctx)
    data, target = batches[0]
    logits1 = _wlm_logits(net, data)
    census = RnnCensus(packed)
    clipper = ClipRecorder(gluon.utils)
    with census:
        loss1, hidden = _wlm_step(wlm, net, trainer, data, target,
                                  hidden, clipper)
    step1 = (loss1.asscalar().item(), logits1) + _grads_and_weights(net)
    arrays, before, norm, max_norm = clipper.calls[0]
    scale = max_norm / (norm + 1e-8)
    grads = [p.grad for p in net.collect_params().values()
             if p.grad_req != "null"]
    in_buffers = all(a is g for a, g in zip(arrays, grads))
    scaled = all(torch.equal(a._data, b * scale) for a, b in
                 zip(arrays, before)) if scale < 1.0 else all(
        torch.equal(a._data, b) for a, b in zip(arrays, before))
    print(f"wordlm: route D, RNNModel('lstm') vocab {c['vocab']}, "
          f"{c['emsize']}x{c['nhid']} x {c['nlayers']} layers, bptt "
          f"{c['bptt']} x batch {c['batch']} ({c['bptt'] * c['batch']} "
          f"tokens a step), {n_params / 1e6:.2f} M parameters; step 1 "
          f"loss {step1[0]:.6f}; global norm {norm:.3f} against the clip "
          f"{max_norm:.1f} (scale {min(scale, 1.0):.6f}); the .grad "
          f"buffers are the clipped arrays: {in_buffers}, scaled in place "
          f"by exactly the factor: {scaled}; card {_card_line()}")
    if not (in_buffers and scaled):
        raise AssertionError("wordlm: clip_global_norm did not scale the "
                             "gradient buffers in place")
    # the same buffers clipped to half their norm: every one scaled in
    # place by the factor (the recipe's clip may not bind at step 1)
    before = [g._data.clone() for g in grads]
    half = gluon.utils.clip_global_norm(grads, norm / 2)
    factor = (norm / 2) / (half + 1e-8)
    halved = all(torch.equal(g._data, b * factor)
                 for g, b in zip(grads, before)) and factor < 1.0
    print(f"wordlm: the step's gradient buffers clipped to half their "
          f"norm ({half:.3f} -> {norm / 2:.3f}): each is the factor "
          f"{factor:.6f} times itself, in place: {halved}")
    if not halved:
        raise AssertionError("wordlm: clip_global_norm at half the norm "
                             "did not scale the buffers in place")
    del before
    # the hidden state carried into step 2 leaves step 1's graph
    carried = wlm.detach(hidden)
    detached = all(not h._data.requires_grad and h._data.grad_fn is None
                   for h in carried)
    loss2, _ = _wlm_step(wlm, net, trainer, batches[1][0],
                         batches[1][1], hidden)
    loss2 = loss2.asscalar().item()
    print(f"wordlm: step 2 on the detached state (detached: {detached}): "
          f"loss {loss2:.6f}")
    if not detached or not math.isfinite(loss2):
        raise AssertionError("wordlm: the carried state is not detached")
    # the same step in float64 (the reference) and with TF32 (the control)
    del net, trainer
    _free()
    ref_net, ref_trainer = _wlm_net(wlm, mx, ctx, w0, dtype="float64")
    ref_hidden = ref_net.begin_state(batch_size=c["batch"], ctx=ctx,
                                     dtype="float64")
    ref_logits = _wlm_logits(ref_net, data, "float64")
    ref_loss, _ = _wlm_step(wlm, ref_net, ref_trainer, data, target,
                            ref_hidden)
    ref = (ref_loss.asscalar().item(), ref_logits) + \
        _grads_and_weights(ref_net)
    del ref_net, ref_trainer
    _free()
    errs = _wlm_errors(step1, ref, w0)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tnet, ttrainer = _wlm_net(wlm, mx, ctx, w0)
        tlogits = _wlm_logits(tnet, data)
        tloss, _ = _wlm_step(wlm, tnet, ttrainer, data, target,
                             tnet.begin_state(batch_size=c["batch"],
                                              ctx=ctx))
        tf32 = (tloss.asscalar().item(), tlogits) + \
            _grads_and_weights(tnet)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    del tnet, ttrainer
    _free()
    ctrl = _wlm_errors(tf32, ref, w0)
    print(f"wordlm: step 1 against float64 on the card: loss "
          f"{errs[0]:.3e} (tol {TOL_WLM_LOSS}), logits {errs[1]:.3e} (tol "
          f"{TOL_WLM_LOGITS}, |logit| up to {ref[1].abs().max().item():.3e})"
          f", clipped gradients' worst tensor {errs[2]:.3e} (tol "
          f"{TOL_WLM_GRAD}), weights after the update, worst tensor "
          f"{errs[3]:.3e} (tol {TOL_WLM_WEIGHTS}; of the update itself "
          f"{errs[4]:.3e}); TF32 control: loss {ctrl[0]:.3e} (it rounds to "
          f"the float32 loss: not gated), logits {ctrl[1]:.3e}, gradients "
          f"{ctrl[2]:.3e}, weights {ctrl[3]:.3e} ({ctrl[4]:.3e}), each of "
          f"the three must miss")
    if not errs[0] <= TOL_WLM_LOSS:
        raise AssertionError(f"wordlm: step 1 loss {errs[0]:.3e}")
    for what, err, tol, control in zip(
            ("logits", "gradient", "weights"), errs[1:4],
            (TOL_WLM_LOGITS, TOL_WLM_GRAD, TOL_WLM_WEIGHTS), ctrl[1:4]):
        if not err <= tol:
            raise AssertionError(f"wordlm: step 1 {what} {err:.3e} above "
                                 f"{tol}")
        if control <= tol:
            raise AssertionError(f"wordlm: the TF32 control's {what} "
                                 f"{control:.3e} meets {tol}")
    # a second model from the same weights repeats step 1
    again, again_trainer = _wlm_net(wlm, mx, ctx, w0)
    aloss, _ = _wlm_step(wlm, again, again_trainer, data, target,
                         again.begin_state(batch_size=c["batch"], ctx=ctx))
    rep = (aloss.asscalar().item(), None) + _grads_and_weights(again)
    same = rep[0] == step1[0] and all(
        torch.equal(rep[3][k], w) for k, w in step1[3].items())
    print(f"wordlm: step 1 repeated by a second model from the same "
          f"weights: bitwise {same} (loss {rep[0]:.9f} vs {step1[0]:.9f})")
    del again, again_trainer, rep, step1, ref, tf32
    _free()
    # timing at the reference's large dropout
    net, trainer = _wlm_net(wlm, mx, ctx, w0, dropout=WLM_DROPOUT)
    hidden = net.begin_state(batch_size=c["batch"], ctx=ctx)
    losses = []
    loss, hidden = _wlm_step(wlm, net, trainer, *batches[0], hidden)
    losses.append(loss.asscalar().item())
    torch.cuda.reset_peak_memory_stats()
    step_ms, dispatch_ms = [], []
    for i in range(WLM_STEPS):
        clip = ClipRecorder(gluon.utils)
        out = []

        def run():
            out[:] = _wlm_step(wlm, net, trainer, *batches[1 + i],
                               hidden, clip)
            out.append(time.perf_counter())
            out.append(out[0].asscalar().item())   # the recipe's read

        t0 = time.perf_counter()
        _, _, t_step = _timed_step(run)
        hidden = out[1]
        losses.append(out[3])
        step_ms.append(t_step * 1e3)
        dispatch_ms.append((out[2] - t0 - clip.wait_s) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = c["bptt"] * c["batch"]
    mean_ms = float(np.mean(step_ms))
    print(f"wordlm: {WLM_STEPS} timed steps at dropout {WLM_DROPOUT}: "
          f"{[round(t, 3) for t in step_ms]} ms (mean {mean_ms:.3f}), host "
          f"dispatch {[round(t, 3) for t in dispatch_ms]} ms (mean "
          f"{np.mean(dispatch_ms):.3f}), {tokens * 1e3 / mean_ms:.1f} "
          f"tokens/s (the recipe's wps), peak memory {peak:.2f} GB; losses "
          f"{[round(v, 4) for v in losses]}; card {_card_line()}")
    print(f"wordlm: one step's concatenations {census.cats} "
          f"({census.cat_elems / 1e6:.2f} M elements); packing copies (a "
          f"cat of >= {packed / 1e6:.2f} M elements, the LSTM's packed "
          f"vector): {census.packs}")
    if census.packs:
        raise AssertionError(f"wordlm: {census.packs} packing copies")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"wordlm: losses {losses} not finite")
    state = {"hidden": hidden, "i": 0}

    def one_step():
        state["hidden"] = _wlm_step(wlm, net, trainer, *batches[1],
                                    state["hidden"])[1]

    profile_breakdown("route D step (word LM, dropout 0.65)", one_step)
    cudnn_yardstick(mx, net, batches[0][0])
    del net, trainer, w0, batches, train_data
    _free()


def cudnn_yardstick(mx, net, data):
    """The library's yardstick, not on the path: ``torch.nn.LSTM`` (cuDNN)
    with route D's LSTM weights copied in, forward and backward at
    (35, 32, 1500) with dropout 0.65 between its layers, beside the port's
    ``rnn_forward`` on the same input and weights; their outputs at
    dropout 0 are compared (printed)."""
    from mxnet_tpu_torch.ops.rnn import rnn_forward
    c = WLM
    rnn = net.rnn
    p = {k: v.data()._data.detach() for k, v in rnn._reg_params.items()}
    with torch.no_grad():
        emb = net.encoder(data)._data.detach()
    lstm = torch.nn.LSTM(c["emsize"], c["nhid"], c["nlayers"],
                         dropout=WLM_DROPOUT).to(emb.device)
    with torch.no_grad():
        for layer in range(c["nlayers"]):
            for mine, theirs in (("i2h_weight", "weight_ih"),
                                 ("h2h_weight", "weight_hh"),
                                 ("i2h_bias", "bias_ih"),
                                 ("h2h_bias", "bias_hh")):
                getattr(lstm, f"{theirs}_l{layer}").copy_(
                    p[f"l{layer}_{mine}"])
    weights = [tuple(p[f"l{layer}_{k}"].requires_grad_() for k in
                     ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"))
               for layer in range(c["nlayers"])]
    zeros = torch.zeros(c["nlayers"], c["batch"], c["nhid"],
                        device=emb.device)
    x = emb.clone().requires_grad_()
    ct = torch.randn(x.shape[0], c["batch"], c["nhid"], device=x.device,
                     generator=torch.Generator(x.device).manual_seed(SEED))
    gen = torch.Generator(x.device).manual_seed(SEED)

    def port(p_drop=WLM_DROPOUT, backward=True):
        out = rnn_forward(x, weights, zeros, zeros, mode="lstm", p=p_drop,
                          rng=gen, is_train=True)
        if backward:
            out.backward(ct)
        return out

    def library(p_drop=WLM_DROPOUT, backward=True):
        lstm.dropout = p_drop
        out, _ = lstm(x, (zeros, zeros))
        if backward:
            out.backward(ct)
        return out

    lstm.train()
    port_ms = _time_ms(port, 10, warmup=2)
    library_ms = _time_ms(library, 10, warmup=2)
    with torch.no_grad():
        a, b = port(0.0, False), library(0.0, False)
    err = ((a - b).abs().max() / b.abs().max()).item()
    print(f"wordlm: the LSTM alone, forward and backward at ({x.shape[0]}, "
          f"{c['batch']}, {c['emsize']}), dropout {WLM_DROPOUT}: the port's "
          f"rnn_forward {port_ms:.3f} ms, cuDNN's nn.LSTM {library_ms:.3f} "
          f"ms (not on the path); outputs at dropout 0 differ by {err:.2e} "
          f"of the largest; card {_card_line()}")
    for t in [x] + [w for ws in weights for w in ws]:
        t.requires_grad_(False)


def _layer_grads(mx, layer, x, states, ct):
    from mxnet_tpu_torch import autograd
    xs = mx.nd.NDArray(x.clone())
    xs.attach_grad()
    with autograd.record():
        out, new = layer(xs, [mx.nd.NDArray(s) for s in states])
        loss = (out * mx.nd.NDArray(ct)).sum()
    loss.backward()
    grads = {k: p.grad._data.double()
             for k, p in layer._collect_params_with_prefix().items()}
    grads["data"] = xs.grad._data.double()
    return out._data.double(), grads


def other_modes_phase(mx, dev):
    """Phase 17: one forward and backward of ``gluon.rnn.GRU``, ``RNN``
    (relu, tanh) and a bidirectional ``LSTM`` at route D's widths, each in
    float32 against float64 on the card; then ``LSTMCell.unroll`` against
    the fused ``LSTM`` on the same weights."""
    from mxnet_tpu_torch import gluon
    c, ctx = WLM, _ctx(mx, dev)
    T, B, H = c["bptt"], c["batch"], c["nhid"]
    gen = torch.Generator(dev).manual_seed(SEED)
    x = torch.randn(T, B, c["emsize"], device=dev, generator=gen)
    for name, make, n_states, d in (
            ("GRU", lambda: gluon.rnn.GRU(H, c["nlayers"]), 1, 1),
            ("RNN relu", lambda: gluon.rnn.RNN(H, c["nlayers"]), 1, 1),
            ("RNN tanh", lambda: gluon.rnn.RNN(H, c["nlayers"],
                                               activation="tanh"), 1, 1),
            ("LSTM bidirectional",
             lambda: gluon.rnn.LSTM(H, c["nlayers"], bidirectional=True),
             2, 2)):
        mx.random.seed(SEED)
        states = [torch.randn(c["nlayers"] * d, B, H, device=dev,
                              generator=gen) * 0.5 for _ in range(n_states)]
        ct = torch.randn(T, B, d * H, device=dev, generator=gen)
        runs = []
        for dtype in ("float32", "float64"):
            layer = make()
            layer.initialize(mx.init.Xavier(), ctx=ctx)
            layer(mx.nd.NDArray(x[:1]))      # the deferred input size
            params = layer._collect_params_with_prefix()
            if runs:
                for k, p in params.items():
                    p.cast(dtype)
                    p.set_data(mx.nd.NDArray(runs[0][2][k].double()))
            w = {k: p.data()._data.detach().clone()
                 for k, p in params.items()}
            t = torch.float32 if dtype == "float32" else torch.float64
            out, grads = _layer_grads(mx, layer, x.to(t),
                                      [s.to(t) for s in states], ct.to(t))
            runs.append((out, grads, w))
            del layer
        (out, grads, _), (ref, ref_grads, _) = runs
        out_err = ((out - ref).abs().max() / ref.abs().max()).item()
        grad_err = max(_norm_rel(grads[k], g) for k, g in ref_grads.items())
        tol_grad = TOL_MODES_GRAD_RELU if name == "RNN relu" \
            else TOL_MODES_GRAD
        print(f"modes: {name} ({c['nlayers']} layers of {H}, ({T}, {B}, "
              f"{c['emsize']})) against float64: output {out_err:.3e} (tol "
              f"{TOL_MODES_OUT}), gradients' worst tensor {grad_err:.3e} "
              f"(tol {tol_grad}); |output| up to "
              f"{ref.abs().max().item():.3e}")
        if not (out_err <= TOL_MODES_OUT and grad_err <= tol_grad):
            raise AssertionError(f"modes: {name} misses its float64 gate")
        del runs, out, grads, ref, ref_grads
        _free()
    mx.random.seed(SEED)
    fused = gluon.rnn.LSTM(H, 1, input_size=c["emsize"])
    fused.initialize(mx.init.Xavier(), ctx=ctx)
    cell = gluon.rnn.LSTMCell(H, input_size=c["emsize"])
    cell.initialize(ctx=ctx)
    for k in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        getattr(cell, k).set_data(getattr(fused, f"l0_{k}").data())
    with torch.no_grad():
        want = fused(mx.nd.NDArray(x))._data
        got, _ = cell.unroll(T, mx.nd.NDArray(x), layout="TNC",
                             merge_outputs=True)
    err = ((got._data - want).abs().max() / want.abs().max()).item()
    print(f"modes: LSTMCell.unroll against the fused LSTM on the same "
          f"weights: {err:.3e} of the largest output (tol {TOL_CELL_FUSED})"
          f"; card {_card_line()}")
    if not err <= TOL_CELL_FUSED:
        raise AssertionError("modes: the unrolled cell is not the layer")


def bucket_sentences(n, vocab, rng):
    """Markov sentences over ids 1..vocab-1 (0 pads): the next word is
    ``(7·w + 3) % (vocab - 1) + 1`` with probability 0.85, else uniform;
    lengths uniform over 5..60."""
    sents = []
    for _ in range(n):
        w = int(rng.randint(1, vocab))
        sent = [w]
        for _ in range(int(rng.randint(5, 61)) - 1):
            w = (7 * w + 3) % (vocab - 1) + 1 if rng.rand() < 0.85 \
                else int(rng.randint(1, vocab))
            sent.append(w)
        sents.append(sent)
    return sents


def _bucket_loss(probs, label) -> float:
    """Mean -log p of the label over the unpadded positions (the
    Perplexity metric's log)."""
    p = probs.reshape(-1, probs.shape[-1])
    lab = label.reshape(-1).long()
    keep = lab != 0
    picked = p[torch.arange(p.shape[0], device=p.device), lab]
    return float(-torch.log(picked[keep]).mean())


def bucketing_route_phase(mx, dev, workdir):
    """Route E (phase 18): the bucketing twin's ``sym_gen`` at
    ``lstm_bucketing.py``'s defaults through ``BucketSentenceIter`` and
    ``BucketingModule`` (Adam) on the card: the first batch's loss against
    the same graph bound in float64; one storage for every parameter
    across the buckets; perplexity falls over the pass;
    ``save_rnn_checkpoint``/``load_rnn_checkpoint`` round-trip bitwise."""
    import random
    from mxnet_tpu_torch import rnn
    bk = _load_example("example/rnn/bucketing/lstm_bucketing_torch.py",
                       "lstm_bucketing_torch")
    c, ctx = BUCKET_CFG, _ctx(mx, dev)
    rng = np.random.RandomState(SEED)
    random.seed(SEED)
    np.random.seed(SEED)
    sents = bucket_sentences(BUCKET_SENTENCES, c["vocab"], rng)
    it = rnn.BucketSentenceIter(sents, c["batch"], buckets=list(c["buckets"]),
                                invalid_label=0)
    sym_gen = bk.sym_gen_factory(c["hidden"], c["embed"], c["layers"],
                                 vocab=c["vocab"])
    mx.random.seed(SEED)
    mod = mx.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key,
                                 context=ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(kvstore=None, optimizer="adam",
                       optimizer_params={"learning_rate": c["lr"]})
    arg0, _ = mod.get_params()
    metric = mx.metric.Perplexity(ignore_label=0)
    ppl, first, step_ms, n_batches = [], None, [], 0
    t_pass = time.perf_counter()
    for batch in it:
        t0 = time.perf_counter()
        mod.forward(batch, is_train=True)
        if first is None:
            probs = mod.get_outputs()[0]._data.detach().clone()
            first = (batch, probs)
        one = mx.metric.Perplexity(ignore_label=0)
        mod.update_metric(one, batch.label)
        mod.update_metric(metric, batch.label)
        mod.backward()
        mod.update()
        ppl.append(one.get()[1])    # reads the card
        step_ms.append((time.perf_counter() - t0) * 1e3)
        n_batches += 1
    t_pass = time.perf_counter() - t_pass
    # the first batch in float64: the same graph bound at its bucket
    batch, probs = first
    sym, _, _ = sym_gen(batch.bucket_key)
    args = {n: mx.nd.NDArray(arg0[n]._data.to(ctx.torch_device()).double())
            for n in arg0 if n in sym.list_arguments()}
    args["data"] = mx.nd.NDArray(batch.data[0]._data.to(
        ctx.torch_device()).double())
    args["softmax_label"] = mx.nd.NDArray(batch.label[0]._data.to(
        ctx.torch_device()).double())
    ref = sym.bind(ctx, args).forward()[0]._data
    label = batch.label[0]._data.to(ref.device)
    loss, ref_loss = _bucket_loss(probs.double(), label), \
        _bucket_loss(ref, label)
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    # every bucket's executor on the default bucket's storages
    base = mod._buckets[it.default_bucket_key]._exec_group.execs[0]
    names = [n for n in base.arg_dict if n not in ("data", "softmax_label")]
    one_storage = all(
        b._exec_group.execs[0].arg_dict[n]._data.data_ptr() ==
        base.arg_dict[n]._data.data_ptr()
        for b in mod._buckets.values() for n in names)
    early, late = float(np.mean(ppl[:20])), float(np.mean(ppl[-20:]))
    # the checkpoint, unpacked per gate and packed back
    cells = rnn.SequentialRNNCell()
    for i in range(c["layers"]):
        cells.add(rnn.LSTMCell(num_hidden=c["hidden"], prefix=f"lstm_l{i}_"))
    arg, aux = mod.get_params()
    prefix = os.path.join(workdir, "bucketing")
    os.makedirs(workdir, exist_ok=True)
    rnn.save_rnn_checkpoint(cells, prefix, 1, sym, arg, aux)
    _, arg_back, _ = rnn.load_rnn_checkpoint(cells, prefix, 1)
    round_trip = sorted(arg_back) == sorted(arg) and all(
        np.array_equal(arg_back[n].asnumpy(), arg[n].asnumpy())
        for n in arg)
    print(f"bucketing route: lstm_bucketing defaults ({c['layers']} "
          f"LSTMCells of {c['hidden']}, embedding {c['embed']}, batch "
          f"{c['batch']}, buckets {c['buckets']}, vocab {c['vocab']}, Adam "
          f"lr {c['lr']}): {n_batches} batches over {len(mod._buckets)} "
          f"buckets in {t_pass:.1f} s (median batch "
          f"{np.median(step_ms):.1f} ms); first batch (bucket "
          f"{first[0].bucket_key}) loss {loss:.6f} against float64 "
          f"{ref_loss:.6f}: {loss_err:.3e} (tol {TOL_BUCKET_LOSS}); "
          f"perplexity of the first 20 batches {early:.1f}, of the last 20 "
          f"{late:.1f} (epoch {metric.get()[1]:.1f}); {len(names)} "
          f"parameters on one storage in every bucket: {one_storage}; "
          f"checkpoint round trip bitwise: {round_trip}; card "
          f"{_card_line()}")
    if not loss_err <= TOL_BUCKET_LOSS:
        raise AssertionError("bucketing route: first loss misses float64")
    if not (one_storage and round_trip and late < early):
        raise AssertionError("bucketing route: storage, checkpoint or "
                             "learning failed")


def transformer_recipe_phase(mx, dev):
    """The ``transformer_lm`` recipe twin at its own size, three epochs:
    the losses fall and the next-token accuracy passes the JAX recipe's
    own test threshold (``tests/test_transformer.py``: ``acc > 0.5``)."""
    tl = _load_example("example/gluon/transformer_lm_torch.py",
                       "transformer_lm_torch")
    losses = []
    t0 = time.perf_counter()
    first, last, acc = tl.train(epochs=3, verbose=False,
                                ctx=_ctx(mx, dev), losses=losses)
    print(f"transformer_lm: the recipe twin, 3 epochs of 30 steps in "
          f"{time.perf_counter() - t0:.1f} s: epoch mean losses {first:.4f}"
          f" -> {last:.4f}; step losses {[round(v, 4) for v in losses[:3]]}"
          f" ... {[round(v, 4) for v in losses[-3:]]}; next-token accuracy "
          f"{acc:.3f} (must exceed 0.5)")
    if not (acc > 0.5 and last < first):
        raise AssertionError(f"transformer_lm: accuracy {acc}")


# --------------------------------------------------------------- route F
# SSD300 with the VGG16-reduced body (Liu et al. 2016, arXiv:1512.02325;
# the reference example/ssd's symbol_factory.get_config("vgg16_reduced",
# 300)): six sources, 8,732 anchors, VOC's 20 classes plus background,
# batch 32 in float32, SGD lr 1e-3, momentum 0.9, wd 5e-4 (the paper's VOC
# fine-tuning). Nothing is cut; the images are synthetic.
SSD = dict(classes=20, image=300, batch=32, lr=1e-3, momentum=0.9, wd=5e-4,
           max_objs=8)
SSD_SOURCES = ("relu4_3", "relu7", "multi_feat_2", "multi_feat_3",
               "multi_feat_4", "multi_feat_5")
SSD_SIZES = ((0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
             (0.71, 0.79), (0.88, 0.961))
SSD_RATIOS = ((1.0, 2.0, 0.5),) + ((1.0, 2.0, 0.5, 3.0, 1.0 / 3),) * 3 \
    + ((1.0, 2.0, 0.5),) * 2
SSD_STEPS = tuple(s / 300.0 for s in (8, 16, 32, 64, 100, 300))
SSD_ANCHORS = 8732
SSD_IMAGES = 128            # four batches an epoch
SSD_EPOCHS = 3              # Module.fit after the gated step 1
SSD_TIMED = 10              # steps timed with the batches on the card
SSD_MEAN = (123.68, 116.779, 103.939)   # the reference's mean_r/g/b
SSD_STD = (58.395, 57.12, 57.375)       # ImageNet's: random weights
# Step 1 in float32 (TF32 off) against the same step in float64 on the
# card from the same weights and batch, the float64 graph given the
# float32 step's targets (MultiBoxTarget's choices are discrete; it is held
# apart, card against CPU, below). On an H100 (700 W): loss 2.1e-9
# relative; cls_prob 7.2e-6 and loc_loss 1.8e-6 of their largest; the
# heads' and the scale's gradients at most 2.4e-6 (||dg||/||g||); the
# body's up to 6.7e-4 (conv5_1: ReLUs whose input sits within float32
# rounding of zero flip between the two runs), which the body's gate
# leaves room for, as ResNet-50's does.
TOL_SSD_LOSS = 1e-6         # relative
TOL_SSD_HEADS = 5e-5        # cls_prob and loc_loss, of their largest entry
TOL_SSD_GRAD_HEAD = 5e-5    # ||dg|| / ||g||: the heads and the scale
TOL_SSD_GRAD = 1e-2         # ||dg|| / ||g||: the body (ReLU flips)
TOL_SSD_LOC_TARGET = 1e-6   # MultiBoxTarget, card against CPU
TOL_SSD_DET = 1e-6          # MultiBoxDetection boxes and scores, card/CPU


def ssd_conv(sym, data, name, num_filter, kernel=(3, 3), pad=(1, 1),
             stride=(1, 1), dilate=(1, 1)):
    conv = sym.Convolution(data, kernel=kernel, pad=pad, stride=stride,
                           dilate=dilate, num_filter=num_filter,
                           name=f"conv{name}" if name[0].isdigit() else name)
    return sym.Activation(conv, act_type="relu",
                          name=f"relu{name}" if name[0].isdigit()
                          else f"{name}_relu")


def build_ssd300(sym, num_classes, mode="train", given_targets=False):
    """The SSD300 graph from the port's ``mx.sym``: VGG16-reduced (conv1_1
    … conv5_3 at 64/128/256/512/512, ``pool3`` with the "full" convention,
    75 → 38, ``pool5`` 3×3 stride 1, ``fc6`` a 3×3 conv of 1,024 dilated
    6, ``fc7`` 1×1 of 1,024), extra layers of 512, 256, 256 and 256 (a 1×1
    of half their width, at least 128, before each 3×3; strides 2, 2, 1,
    1), and per source a 3×3 class and box head and its anchors.
    ``relu4_3`` is ``L2Normalization(mode="channel")`` times a learned
    per-channel scale (``relu4_3_scale``, 20 at the start). The training
    graph is ``example/ssd/symbol_ssd.py``'s with the reference's
    arguments (with ``given_targets`` its targets are the inputs
    ``loc_target``, ``loc_mask`` and ``cls_target`` instead of
    ``MultiBoxTarget``'s); the detection graph decodes with
    ``MultiBoxDetection``. Returns (the graph, {"cls_pred", "loc_pred",
    "anchor"})."""
    data = sym.Variable("data")
    net = data
    for i, (width, convs) in enumerate(((64, 2), (128, 2), (256, 3),
                                        (512, 3), (512, 3)), start=1):
        for j in range(1, convs + 1):
            net = ssd_conv(sym, net, f"{i}_{j}", width)
            if (i, j) == (4, 3):
                relu4_3 = net
        if i < 5:
            net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2),
                              pool_type="max", name=f"pool{i}",
                              pooling_convention="full" if i == 3
                              else "valid")
    net = sym.Pooling(net, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                      pool_type="max", name="pool5")
    net = ssd_conv(sym, net, "fc6", 1024, pad=(6, 6), dilate=(6, 6))
    relu7 = ssd_conv(sym, net, "fc7", 1024, kernel=(1, 1), pad=(0, 0))
    sources = [relu4_3, relu7]
    net = relu7
    for k, (width, stride, pad) in enumerate(((512, 2, 1), (256, 2, 1),
                                              (256, 1, 0), (256, 1, 0)),
                                             start=2):
        net = ssd_conv(sym, net, f"multi_feat_{k}_conv_1x1",
                       max(128, width // 2), kernel=(1, 1), pad=(0, 0))
        net = ssd_conv(sym, net, f"multi_feat_{k}_conv_3x3", width,
                       stride=(stride, stride), pad=(pad, pad))
        sources.append(net)
    scale = sym.Variable("relu4_3_scale", shape=(1, 512, 1, 1),
                         init=mx.init.Constant(20.0),
                         attr={"__wd_mult__": "0.1"})
    sources[0] = sym.broadcast_mul(scale, sym.L2Normalization(
        relu4_3, mode="channel", name="relu4_3_norm"))
    classes = num_classes + 1
    cls_preds, loc_preds, anchors = [], [], []
    for name, src, sizes, ratios, step in zip(
            SSD_SOURCES, sources, SSD_SIZES, SSD_RATIOS, SSD_STEPS):
        na = len(sizes) + len(ratios) - 1
        loc = sym.Convolution(src, kernel=(3, 3), pad=(1, 1),
                              num_filter=na * 4,
                              name=f"{name}_loc_pred_conv")
        cls = sym.Convolution(src, kernel=(3, 3), pad=(1, 1),
                              num_filter=na * classes,
                              name=f"{name}_cls_pred_conv")
        loc_preds.append(sym.Flatten(sym.transpose(loc, axes=(0, 2, 3, 1))))
        cls_preds.append(sym.Flatten(sym.transpose(cls, axes=(0, 2, 3, 1))))
        anchors.append(sym.Reshape(sym._contrib_MultiBoxPrior(
            src, sizes=sizes, ratios=ratios, clip=False, steps=(step, step),
            name=f"{name}_anchors"), shape=(1, -1, 4)))
    loc_pred = sym.Concat(*loc_preds, dim=1, name="multibox_loc_pred")
    anchor = sym.Concat(*anchors, dim=1, name="multibox_anchors")
    cls_pred = sym.transpose(sym.Reshape(
        sym.Concat(*cls_preds, dim=1), shape=(0, -1, classes)),
        axes=(0, 2, 1), name="multibox_cls_pred")
    heads = {"cls_pred": cls_pred, "loc_pred": loc_pred, "anchor": anchor}
    if mode == "det":
        return sym._contrib_MultiBoxDetection(
            sym.softmax(cls_pred, axis=1, name="cls_prob"), loc_pred, anchor,
            name="detection", nms_threshold=0.45, nms_topk=400,
            threshold=0.01), heads
    if given_targets:
        loc_target, loc_mask, cls_target = (sym.Variable(n) for n in (
            "loc_target", "loc_mask", "cls_target"))
    else:
        loc_target, loc_mask, cls_target = sym._contrib_MultiBoxTarget(
            anchor, sym.Variable("label"), cls_pred, overlap_threshold=0.5,
            ignore_label=-1, negative_mining_ratio=3,
            minimum_negative_samples=0, negative_mining_thresh=0.5,
            variances=(0.1, 0.1, 0.2, 0.2), name="multibox_target")
    cls_prob = sym.SoftmaxOutput(cls_pred, cls_target, ignore_label=-1,
                                 use_ignore=True, multi_output=True,
                                 normalization="valid", name="cls_prob")
    loc_loss = sym.MakeLoss(sym.smooth_l1(loc_pred * loc_mask - loc_target,
                                          scalar=1.0),
                            grad_scale=1.0, normalization="valid",
                            name="loc_loss")
    return sym.Group([cls_prob, loc_loss, sym.BlockGrad(cls_target),
                      sym.BlockGrad(loc_target)]), heads


def ssd_initializer(mx):
    """Xavier (gaussian, fan-out, magnitude 2, as the reference's
    train_net) for the weights, and the conv4_3 scale at 20 through
    ``Mixed``: the JAX package's ``Variable`` drops ``init=``, so a user of
    it has to set the scale so (ROADMAP C)."""
    return mx.init.Mixed([".*_scale", ".*"], [
        mx.init.Constant(20.0),
        mx.init.Xavier(rnd_type="gaussian", factor_type="out", magnitude=2)])


def ssd_loss(outputs):
    """The recipe's metric on one batch: cross-entropy over the anchors
    whose target is not ignored plus the smooth-L1 sum, each per valid
    anchor (``example/ssd/train_torch.py``'s ``MultiBoxMetric``)."""
    cls_prob, loc_loss, cls_target = (o._data if hasattr(o, "_data") else o
                                      for o in outputs[:3])
    valid = cls_target >= 0
    picked = torch.gather(cls_prob, 1, cls_target.clamp_min(0).long()
                          .unsqueeze(1))[:, 0]
    ce = -torch.log(picked.clamp_min(1e-12))[valid].sum()
    n = max(int(valid.sum()), 1)
    return float((ce + loc_loss.abs().sum()) / n)


class SsdStepLosses(mx.metric.EvalMetric):
    """Keeps each batch's :func:`ssd_loss`."""

    def __init__(self):
        super().__init__("ssd_loss")
        self.losses = []

    def update(self, labels, preds):
        self.losses.append(ssd_loss(preds))

    def get(self):
        return self.name, self.losses[-1] if self.losses else float("nan")


def _ssd_bind64(mx, ctx, w0, aux0, batch, targets):
    """The training graph in float64 from the float32 weights, with
    gradient buffers, on ``batch``, its targets given: the float32 step's
    (``MultiBoxTarget``'s choices are discrete, and a float64 run of it
    would choose again wherever float32 rounding ties: saturated
    background probabilities give many equal hardnesses at the start)."""
    sym, _ = build_ssd300(mx.sym, SSD["classes"], given_targets=True)
    f64 = {k: mx.nd.NDArray(v._data.double()) for k, v in w0.items()}
    cls_target, loc_target = targets
    n = cls_target.shape[1]
    loc_mask = (cls_target > 0).unsqueeze(-1).expand(-1, n, 4).reshape(
        cls_target.shape[0], -1)
    args = dict(f64, data=batch.data[0]._data, cls_target=cls_target,
                loc_target=loc_target, loc_mask=loc_mask)
    args = {k: mx.nd.NDArray(v._data if hasattr(v, "_data") else
                             v.double()) for k, v in args.items()}
    grads = {k: mx.nd.NDArray(torch.zeros_like(v._data))
             for k, v in f64.items()}
    reqs = {k: ("write" if k in grads else "null") for k in args}
    aux = {k: mx.nd.NDArray(v._data.double()) for k, v in aux0.items()}
    return sym.bind(ctx, args, grads, reqs, aux)


def ssd_records(mx, workdir):
    """Write SSD_IMAGES synthetic VOC-style 300x300 images (1-3 rectangles
    of VOC's 20 classes) with ``example/ssd/dataset_torch.py``."""
    ds = _load_example("example/ssd/dataset_torch.py", "dataset_torch")
    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    rec = ds.write_records(os.path.join(workdir, "voc_synth"),
                           num_images=SSD_IMAGES, size=SSD["image"],
                           seed=SEED, num_classes=SSD["classes"])
    print(f"route F: {SSD_IMAGES} synthetic {SSD['image']}x{SSD['image']} "
          f"JPEG records of {SSD['classes']} classes written in "
          f"{time.perf_counter() - t0:.2f} s (set-up)")
    return rec


def ssd_phase(mx, dev, workdir, profile=False):
    """Route F (phase 19): SSD300-VGG16-reduced trained on the card through
    ``mx.mod.Module``, batches from ``ImageDetRecordIter``. Step 1 against
    the same step in float64 on the card; then ``Module.fit`` for
    SSD_EPOCHS epochs (the loss must fall), SSD_TIMED steps timed with
    their batches already on the card, the iterator's batch timed apart;
    ``MultiBoxTarget`` and ``MultiBoxDetection`` on the card against the
    CPU and timed at 8,732 anchors and batch 32; then the trained weights
    served through the detection graph."""
    c, ctx = SSD, _ctx(mx, dev)
    rec = ssd_records(mx, workdir)
    it = mx.io.ImageDetRecordIter(
        rec, data_shape=(3, c["image"], c["image"]), batch_size=c["batch"],
        max_objs=c["max_objs"], shuffle=True, seed=SEED,
        mean_r=SSD_MEAN[0], mean_g=SSD_MEAN[1], mean_b=SSD_MEAN[2],
        std_r=SSD_STD[0], std_g=SSD_STD[1], std_b=SSD_STD[2], ctx=ctx)
    feed = []
    for _ in range(2):
        it.reset()
        for _ in range(SSD_IMAGES // c["batch"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = it.next()
            torch.cuda.synchronize()
            feed.append(time.perf_counter() - t0)
    it.reset()
    batches = list(it)
    it.reset()
    print(f"route F: ImageDetRecordIter: {len(feed)} batches of "
          f"{c['batch']} decoded (Pillow, 4 threads) and copied to the card:"
          f" {1e3 * float(np.median(feed)):.1f} ms a batch (median; "
          f"{c['batch'] / float(np.median(feed)):.0f} images/s), "
          f"label {tuple(batch.label[0].shape)}")
    if batch.data[0].context != ctx or batch.label[0].shape != (
            c["batch"], c["max_objs"], 5):
        raise AssertionError("route F: the iterator's batch is not what "
                             "the graph takes")

    net, heads = build_ssd300(mx.sym, c["classes"], "train")
    torch.cuda.reset_peak_memory_stats()
    mod = mx.mod.Module(net, context=ctx, data_names=["data"],
                        label_names=["label"])
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mx.random.seed(SEED)
    mod.init_params(ssd_initializer(mx))
    mod.init_optimizer(kvstore=None, optimizer="sgd", optimizer_params={
        "learning_rate": c["lr"], "momentum": c["momentum"], "wd": c["wd"]})
    w0, aux0 = mod.get_params()
    n_params = sum(v.size for v in w0.values())
    scale = w0["relu4_3_scale"].asnumpy()
    if not np.all(scale == 20.0):
        raise AssertionError("route F: the conv4_3 scale did not start at 20")

    # step 1, its outputs and gradients kept before the update
    exe = mod._exec_group.execs[0]
    gate_batch = batches[0]
    mod.forward_backward(gate_batch)
    outs32 = [o._data.clone() for o in mod.get_outputs()]
    grads32 = {k: exe.grad_dict[k]._data.double().clone() for k in w0}
    mod.update()
    if outs32[0].shape != (c["batch"], c["classes"] + 1, SSD_ANCHORS):
        raise AssertionError(f"route F: cls_prob {tuple(outs32[0].shape)}, "
                             f"expected {SSD_ANCHORS} anchors")
    loss1 = ssd_loss(outs32)
    n_pos = int((outs32[2] > 0).sum())
    n_valid = int((outs32[2] >= 0).sum())

    ex64 = _ssd_bind64(mx, ctx, w0, aux0, gate_batch, outs32[2:4])
    outs64 = [o._data for o in ex64.forward(is_train=True)]
    ex64.backward()
    loss64 = ssd_loss(outs64)
    errs = {"loss": abs(loss1 - loss64) / abs(loss64),
            "cls_prob": _max_rel(outs32[0], outs64[0]),
            "loc_loss": _max_rel(outs32[1], outs64[1])}
    grad_errs = {k: _norm_rel(grads32[k], ex64.grad_dict[k]._data)
                 for k in w0}
    worst = max(grad_errs, key=grad_errs.get)
    head = [k for k in w0 if "_pred_conv" in k or k.endswith("_scale")]
    worst_head = max(head, key=grad_errs.get)
    print(f"route F: step 1 against float64 on the card: loss {loss1:.6f} "
          f"(float64 {loss64:.6f}, rel {errs['loss']:.3e}); cls_prob "
          f"{errs['cls_prob']:.3e}, loc_loss {errs['loc_loss']:.3e} of their "
          f"largest (the float32 step's targets: {n_pos} positives, "
          f"{n_valid} anchors not ignored); gradients ||dg||/||g|| worst "
          f"{grad_errs[worst]:.3e} ({worst}), of the heads and the scale "
          f"{grad_errs[worst_head]:.3e} ({worst_head}), median "
          f"{float(np.median(list(grad_errs.values()))):.3e}; by layer "
          f"{ {k: float('%.2e' % v) for k, v in grad_errs.items()} }")
    del ex64, outs64
    _free()
    if not (errs["loss"] <= TOL_SSD_LOSS and errs["cls_prob"] <= TOL_SSD_HEADS
            and errs["loc_loss"] <= TOL_SSD_HEADS
            and grad_errs[worst] <= TOL_SSD_GRAD
            and grad_errs[worst_head] <= TOL_SSD_GRAD_HEAD):
        raise AssertionError(f"route F: step 1 misses float64: {errs}, "
                             f"{worst} {grad_errs[worst]}")

    # Module.fit for SSD_EPOCHS epochs over the iterator
    metric = SsdStepLosses()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=SSD_EPOCHS, eval_metric=metric, kvstore=None,
            optimizer="sgd")
    fit_s = time.perf_counter() - t0
    losses = [loss1] + metric.losses
    per = SSD_IMAGES // c["batch"]
    first = float(np.mean(losses[1:1 + per]))
    last = float(np.mean(losses[-per:]))
    print(f"route F: Module.fit, {SSD_EPOCHS} epochs of {per} steps after "
          f"step 1, in {fit_s:.1f} s (decoding included): step losses "
          f"{[round(v, 4) for v in losses]}; epoch means {first:.4f} -> "
          f"{last:.4f}")
    if not (last < first and losses[-1] < losses[0]):
        raise AssertionError(f"route F: the loss did not fall: {losses}")

    # timed steps, the batches already on the card
    times = [_timed_step(lambda b=batches[i % len(batches)]: (
        mod.forward_backward(b), mod.update()))
        for i in range(SSD_TIMED)]
    host = float(np.median([t[0] for t in times])) * 1e3
    step = float(np.median([t[1] for t in times]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"route F: SSD300-VGG16 step (Module forward_backward + update, "
          f"batch {c['batch']}, {n_params:,} parameters, float32, TF32 off):"
          f" {step:.1f} ms (median of {SSD_TIMED}; "
          f"{[round(t[1], 1) for t in times]}), host dispatch {host:.1f} ms, "
          f"{1e3 * c['batch'] / step:.1f} images/s, peak memory "
          f"{peak:.2f} GB; card {_card_line()}")
    if profile:
        profile_breakdown("route F SSD300 Module step", lambda: (
            mod.forward_backward(batches[0]), mod.update()))

    # the multibox ops at 8,732 anchors and batch 32, card against CPU
    arg, aux = mod.get_params()
    probe = mx.sym.Group([heads["cls_pred"], heads["loc_pred"],
                          heads["anchor"]])
    args = {k: v for k, v in arg.items() if k in probe.list_arguments()}
    args["data"] = batches[1].data[0]
    pex = probe.bind(ctx, args, aux_states={
        k: v for k, v in aux.items() if k in probe.list_auxiliary_states()})
    cls_pred, loc_pred, anchor = (o._data for o in pex.forward())
    label = batches[1].label[0]._data
    from mxnet_tpu_torch.ops.registry import get_op
    target = get_op("_contrib_MultiBoxTarget").fn
    detect = get_op("_contrib_MultiBoxDetection").fn
    tkw = dict(overlap_threshold=0.5, negative_mining_ratio=3,
               negative_mining_thresh=0.5)
    dkw = dict(nms_threshold=0.45, nms_topk=400, threshold=0.01)
    on = target(anchor, label, cls_pred, **tkw)
    off = target(anchor.cpu(), label.cpu(), cls_pred.cpu(), **tkw)
    t_target = _time_ms(lambda: target(anchor, label, cls_pred, **tkw), 10)
    prob = torch.softmax(cls_pred, dim=1)
    det_on = detect(prob, loc_pred, anchor, **dkw)
    det_off = detect(prob.cpu(), loc_pred.cpu(), anchor.cpu(), **dkw)
    t_detect = _time_ms(lambda: detect(prob, loc_pred, anchor, **dkw), 10)
    kept = int((det_on[..., 0] >= 0).sum())
    tgt_err = _max_rel(on[0].cpu(), off[0])
    det_err = float((det_on[..., 1:].cpu() - det_off[..., 1:]).abs().max())
    print(f"route F: MultiBoxTarget at {SSD_ANCHORS} anchors, batch "
          f"{c['batch']}: {t_target:.2f} ms on the card; against the CPU: "
          f"cls_target equal {torch.equal(on[2].cpu(), off[2])}, loc_mask "
          f"equal {torch.equal(on[1].cpu(), off[1])}, loc_target "
          f"{tgt_err:.3e}. MultiBoxDetection (nms_topk 400): "
          f"{t_detect:.2f} ms on the card, {kept} rows kept; against the "
          f"CPU: classes and order equal "
          f"{torch.equal(det_on[..., 0].cpu(), det_off[..., 0])}, boxes and"
          f" scores {det_err:.3e}")
    if not (torch.equal(on[2].cpu(), off[2]) and torch.equal(on[1].cpu(),
                                                             off[1])
            and tgt_err <= TOL_SSD_LOC_TARGET
            and torch.equal(det_on[..., 0].cpu(), det_off[..., 0])
            and det_err <= TOL_SSD_DET and kept > 0):
        raise AssertionError("route F: the multibox ops on the card differ "
                             "from the CPU")

    # serve the trained weights through the detection graph
    det_sym, _ = build_ssd300(mx.sym, c["classes"], "det")
    det = mx.mod.Module(det_sym, context=ctx, data_names=["data"],
                        label_names=None)
    det.bind(data_shapes=it.provide_data, for_training=False)
    det.set_params(arg, aux)
    t_host, t_dev, _ = _timed_step(lambda: det.forward(batches[1],
                                                       is_train=False))
    out = det.get_outputs()[0]._data
    scores = out[..., 1]
    ok = (out.shape == (c["batch"], SSD_ANCHORS, 6)
          and bool(torch.isfinite(out).all())
          and bool((scores[:, :-1] >= scores[:, 1:]).all()))
    print(f"route F: detection graph served on one batch in {t_dev:.1f} ms "
          f"(host {1e3 * t_host:.1f} ms): {tuple(out.shape)}, "
          f"{int((out[..., 0] >= 0).sum())} detections kept, best score "
          f"{float(scores.max()):.3f}; equal to the op on the probe's "
          f"outputs {torch.equal(out, det_on)}")
    if not ok:
        raise AssertionError("route F: the detection graph's output is not "
                             "sorted or not finite")
    return {"step_ms": step, "images_s": 1e3 * c["batch"] / step,
            "peak_gb": peak, "target_ms": t_target, "detect_ms": t_detect}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one served dispatch, one training "
                         "step, one custom-head step, one Module step, one "
                         "fused step, one bf16 fused step and one route F "
                         "step (torch.profiler)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on the GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import hopper_kernels as hk
    dev = torch.device("cuda", 0)
    print(_card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision="
          f"{torch.get_float32_matmul_precision()}")

    t0 = time.perf_counter()
    libs = hk.build()
    print(f"build: {sorted(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s")
    kernel_resources(libs)

    records = [kernel_phase(hk, dev)]
    records += backward_kernel_phase(hk, dev)
    records.append(ce_phase(hk, dev))
    embedding_determinism(dev)
    _free()
    workdir = os.path.join(os.path.dirname(os.path.abspath(mx.__file__)),
                           "_build", "smoke_lm")
    try:
        served = serving_phase(mx, hk, dev, workdir, args.profile)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    _free()
    trained, gluon_loss = training_phase(mx, hk, dev, args.profile)
    _free()
    for rec in records:
        rec["compiler"] = "nvcc"
    records += rtc_kernel_phase(dev)
    _free()
    try:
        extended = extension_phase(hk, dev, workdir, args.profile)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    _free()
    try:
        os.makedirs(workdir, exist_ok=True)
        prefix = os.path.join(workdir, "lm")
        print(f"module: export_lm wrote the LM's graph and weights with "
              f"model.save_checkpoint in {export_lm(mx, prefix):.1f} s")
        _free()
        moduled, module_loss, module_w1 = module_phase(
            mx, hk, dev, prefix, gluon_loss, args.profile)
        _free()
        fused, f32_errs = fused_phase(mx, hk, dev, prefix, args.profile)
        _free()
        mixed = mixed_phase(mx, hk, dev, prefix, f32_errs, args.profile)
        _free()
        bucketed = bucketing_phase(mx, hk, dev, prefix, module_loss)
        _free()
        sequenced = sequential_phase(mx, hk, dev, prefix, module_loss,
                                     module_w1)
        del module_w1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    _free()
    # the conv nets: no TPU kernel is on their path (XLA lowered the JAX
    # package's convolutions and pools; cuDNN runs the port's)
    hk.reset_launch_counts()
    net = resnet_phase(mx)
    try:
        resnet_serving_phase(mx, net, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del net
    _free()
    resnet_gate_phase(mx)
    _free()
    zoo_phase(mx)
    if any(hk.launch_counts.values()):
        raise AssertionError(f"the conv nets launched a Hopper kernel: "
                             f"{dict(hk.launch_counts)}")
    _free()
    # the transformer_lm recipe twin: B1 and B3 on its path
    hk.reset_launch_counts()
    transformer_recipe_phase(mx, dev)
    recipe = dict(hk.launch_counts)
    _free()
    # the recurrent family: no TPU kernel on its path (XLA lowered the JAX
    # package's recurrence; cuBLAS runs the port's)
    hk.reset_launch_counts()
    word_lm_phase(mx, dev)
    _free()
    other_modes_phase(mx, dev)
    _free()
    try:
        bucketing_route_phase(mx, dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if any(hk.launch_counts.values()):
        raise AssertionError(f"the recurrent family launched a Hopper "
                             f"kernel: {dict(hk.launch_counts)}")
    _free()
    # route F, the detection family: no TPU kernel on its path (XLA
    # lowered the JAX package's multibox ops and convolutions; torch and
    # cuDNN run the port's)
    hk.reset_launch_counts()
    try:
        ssd_phase(mx, dev, workdir, args.profile)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if any(hk.launch_counts.values()):
        raise AssertionError(f"route F launched a Hopper kernel: "
                             f"{dict(hk.launch_counts)}")
    for rec in records:
        name = rec["name"]
        rec["launches"] = sum(path.get(name, 0) for path in
                              (served, trained, extended, moduled, fused,
                               mixed, bucketed, sequenced, recipe))
        if rec["launches"] == 0:
            raise AssertionError(f"{name} never launched on the main paths")
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s, the build included")
    keys = ("name", "route", "compiler", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_route", "library_ms", "bf16")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys
                                   if k != "bf16" or k in rec}
                                  for rec in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
