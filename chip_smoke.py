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
20. route G1, the image-classification recipe's north-star command
   (``example/image-classification/train_imagenet_torch.py --network
   resnet-v1 --num-layers 50 --gpus 0 --kv-store device --benchmark 1
   --batch-size 32``, 640 synthetic images: 20 updates): ResNet-50 v1 as
   ``symbols/resnet.py`` builds it, uncut, 224², 1,000 classes, float32,
   through ``fit()``, ``Module``, the ``device`` store and the device
   feed. Step 1 against float64 on the card (route B's gates); update 1
   through the store bitwise a direct update of the same gradients; the
   losses finite and the rate not yet cut (the schedule's first cut falls
   at update 30: the synthetic iterator has no ``.idx``); step ms, images/s,
   peak memory, host dispatch, the pull's copies a step and a
   ``torch.profiler`` breakdown of one more step.
21. route G2: the same command on 512 synthetic 256x256 JPEG records
   through ``ImageRecordIter`` (random crop and mirror) and the device
   feed: images/s end to end beside G1's, the iterator's time a batch,
   the time ``next()`` waited; one batch through the feed on the card
   against the CPU's.
22. route G3, ``BASELINE.json`` config #1: ``train_mnist_torch.py
   --network lenet --gpus 0`` over ``MNISTIter`` on 60,000 + 10,000
   synthetic idx images, the recipe's two epochs; validation accuracy
   above 0.95; step 1 against float64 (loss, logits).
23. route G4: every registered optimizer, three LeNet updates through
   ``Module`` and the ``device`` store on the card against the CPU (1e-5
   of each tensor's largest entry; the sign and threshold rules, and those
   that divide by ``√v + ε``, by their count of flipped entries, against
   a control that must miss); SGD and
   NAG with ``multi_precision`` on float16 weights through the store;
   each rule's update time on ResNet-50's 161 parameter tensors.
24. the op grid: every op of slice 11 (``DENSE_OP_GROUPS``: the unary
   math, the binaries, comparisons and scalar ops, the reductions,
   ``norm`` and the arg reductions, ``LeakyReLU``, ``InstanceNorm``,
   ``LRN``, ``softmin``, the regression and SVM outputs, ``UpSampling``,
   ``sort``/``argsort``/``topk``, the creation ops), the six activation
   layers, ``InstanceNorm`` and every loss, forward and gradient, on the
   card against the CPU: discrete outputs equal, the rest within 1e-6 of
   the largest entry; rrelu by its statistics. Then every op of slice 12
   (``LIBRARY_OP_GROUPS``: ``batch_dot``, ``slice``, ``tile``, ``take``,
   ``one_hot``, the gathers and scatters, the spatial transformer, the
   tail ops, linalg within 1e-5, the ``*_update`` ops and the legacy and
   contrib tail; ``boolean_mask``), and every random op at 10^6 draws a
   row against the CPU's draws by mean and variance, each repeated from
   its seed bitwise; a bound ``Dropout(mode="always")`` at inference.
25. route H: the 64x64 DCGAN of Radford, Metz & Chintala
   (``build_dcgan64``: ngf = ndf = 64, nz 100, nothing cut) trained
   through gluon at batch 128 (Adam lr 2e-4, β1 0.5,
   ``SigmoidBinaryCrossEntropyLoss``) on synthetic images: iteration 1
   (the D step on real and fake, then the G step) against float64 on the
   card with a TF32 control that must miss; ten timed iterations (ms,
   images/s, peak memory, host dispatch beside device time, for the
   iteration and each half), the losses finite, a ``torch.profiler``
   breakdown.
26. route I: ``gluon.loss.CTCLoss`` at a speech batch (32 x 400 frames,
   29 classes, labels 40-120, one row given fewer frames than it needs)
   in float32 against float64 on the card, timed beside ``F.ctc_loss``;
   the ``lstm_ocr`` and ``speech_ctc`` twins trained on the card to the
   JAX recipes' test thresholds.
27. route J: CapsNet of Sabour, Frosst & Hinton at the paper's widths
   (``build_capsnet``: Conv1 256 9x9, 1,152 primary capsules of 8-D, 3
   routing iterations, 10 x 16-D digit capsules, the margin loss and the
   512-1024-784 reconstruction decoder; 8,215,568 parameters) trained
   through ``MNISTIter``, gluon and Adam (lr 1e-3) at batch 100 on
   synthetic idx images: iteration 1 against float64 on the card with a
   TF32 control that must miss; ten timed iterations (wall ms, host
   dispatch, images/s, peak memory, the ops one iteration dispatches).
28. route K: the reference's ``example/sparse/linear_classification`` at
   avazu's widths (1,000,001 feature columns, batch 8192): a seeded
   synthetic LibSVM file of 16 batches with one nonzero a field (15) read
   by ``LibSVMIter`` onto the card as ``CSRNDArray`` batches; each step
   ``sp.dot`` forward, the ``transpose_a`` gradient as a
   ``RowSparseNDArray`` of the batch's feature ids, and the lazy SGD
   ``Updater``. Step 1 against float64 on the card (loss, gradient rows,
   updated rows), the rows outside every batch bitwise unchanged,
   ``row_sparse_pull`` from a ``local`` store, an unmerged-duplicates
   control that must miss; timed steps (rows/s, the iterator apart, host
   dispatch, peak memory; a profile with ``--profile``).
29. route L: the committed reference checkpoint ``tests/fixtures/refmlp``
   through ``model.load_checkpoint``, ``Module`` and ``FeedForward`` on the
   card against its pinned logits (1e-5); ResNet-50 v1 written with
   ``save_reference_params`` and served through ``ModelServer`` from those
   bytes, bitwise the ``MXTPU001`` bytes' logits; write and load times and
   bytes of both formats.
30. route M: Faster R-CNN with the VGG16 body (``RCNN``: Ren et al.'s
   recipe as the reference ``example/rcnn`` trains it end to end with
   py-faster-rcnn's defaults; random weights, synthetic images, no
   dropout) on one 600x1000 image a step through gluon, ``MultiProposal``
   (12,000 -> 2,000), sampling as ``mx.nd`` ops on the card, ``ROIPooling``
   and SGD: MultiProposal on the card keeps the CPU's anchors and
   ROIPooling is bitwise the CPU's (each with a control that must miss);
   step 1 against float64 on the card fed the step's proposals and
   samples; timed steps (ms, images/s, host dispatch, peak memory), the
   two ops' times and the NMS's steps; the test-time detection forward
   (6,000 -> 300, per-class ``box_nms``).
31. route N: the contrib ops at the shapes of the models that use them
   (``route_n_cases``: Mask R-CNN's ROIAlign, R-FCN's PSROI poolings,
   Deformable ConvNets' res5 convolution, FlowNetC's correlation, compact
   bilinear pooling's count sketch and FFTs, PSPNet's pyramid pooling and
   resize) and a ``Conv2DLSTMCell`` unroll, forward and gradients on the
   card against the CPU within 1e-5 of the largest entry, each timed.
32. route O: ResNet-50 v1 in int8 as MXNet 1.5's
   ``example/quantization/imagenet_gen_qsym.py`` quantizes it (``INT8``:
   naive calibration over 10 batches of 32 synthetic images on the card,
   the first convolution and the classifier in float, 52 int8
   convolutions; random weights): the pass route against the direct
   route (graph, extra parameters, outputs bitwise), scoring at batch 32
   through ``Module``, each int8 convolution's int32 output bitwise the
   CPU's given the CPU's inputs, the logits against the CPU's plain path
   with a control that must miss, the float model served in its int8
   tier (``ModelConfig(tier="int8")``) bitwise a ``Module`` of its graph,
   beside the float tier, and each int8 convolution timed against
   cuDNN's float32 one at its shape.

Between 9 and 10 runs route P (``route_p_phase``): the bf16 fused route of
phase 9 with ``grad_guard`` takes three steps, is saved by
``checkpoint.ShardedCheckpointer`` asynchronously (parameters, momentum,
update count and guard state, ~9.8 GB at the four layers) while steps 4-5
run, and a fresh trainer restored from step 3 must take steps 4-5 to the
uninterrupted run's state bitwise; a truncated payload file must fail
``verify`` and ``restore``. The LM's ``Module`` route then trains two
batches under ``fit(monitor=Monitor(1))`` (each value against
``abs(x).mean()`` of the output on the host, launch counts unchanged),
and ``mx.viz.print_summary`` counts the LM's graph.
Every ``Module`` and fused trainer runs the default graph-pass pipeline
(``passes=None``); ``PassAudit`` prints each one's
``passes_provenance()`` by route group and fails a group whose pipeline
fell back or whose counts differ from a recount on the host; route G1
also counts its layout copies under the pipeline and with
``passes=False`` (``g1_layout_copies``).
Before 16, the ``transformer_lm`` recipe twin trains three epochs at its
own size (its accuracy must pass the JAX recipe's test threshold, 0.5).

``--profile`` adds a ``torch.profiler`` breakdown of one serving dispatch,
one training step, one custom-head step, one Module step, one fused step,
one bf16 fused step, one route F step, one route J iteration, one
route K step and one route M step (route A's and route D's steps
are profiled in every run, and one route G1 step and one route H
iteration). Apart from the ``transformer_lm`` twin, no phase from 12 on
launches a Hopper kernel: the conv nets, the recurrent family, the
detection family, the image-classification recipe, the dense ops, the GAN,
CTC, the op library of slice 12, CapsNet, the sparse arrays, the
reference's formats, Faster R-CNN, the contrib ops and the int8 family reach no TPU kernel (the JAX package
lowers their convolutions, pools, recurrence and multibox ops through
XLA; cuDNN, cuBLAS and plain torch run the port's). The line before
the last is a JSON object with one entry per kernel (the flash kernels'
bf16 times at the main shape under ``"bf16"``); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import io
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


# --------------------------------------------- route P: checkpoint, monitor
ROUTE_P_STEPS = 5            # the uninterrupted run; the save after step 3
ROUTE_P_SAVE_AT = 3
ROUTE_P_MONITOR_BATCHES = 2
TOL_MONITOR_HOST = 1e-6      # a toc() value against abs(x).mean() in float64


def route_p_batches(n):
    """``n`` training batches (int32 token ids, float32 next-token labels)
    of the full context from the seed, one for each step."""
    rng = np.random.RandomState(SEED + 17)
    shape = (TRAIN_BATCH, OPT_6_7B["max_len"])
    return [(rng.randint(0, OPT_6_7B["vocab"], shape).astype(np.int32),
             rng.randint(0, OPT_6_7B["vocab"], shape).astype(np.float32))
            for _ in range(n)]


def summary_rule_count(sym, shapes) -> int:
    """The parameter count ``print_summary`` gives ``sym`` by its counting
    rules (the JAX package's and the reference's): Embedding's table, a
    FullyConnected's ``num_hidden`` times the product of its input's
    dimensions after the first (0 where the input's node has several
    outputs, whose shapes are not keyed by its name) plus the bias,
    Convolution and BatchNorm; LayerNorm's gamma and beta are not
    counted."""
    internals = sym.get_internals()
    _, out_shapes, _ = internals.infer_shape(**shapes)
    known = dict(zip(internals.list_outputs(), out_shapes))
    total = 0
    for node in sym.topo_nodes():
        if node.op == "Embedding":
            total += int(node.attrs["input_dim"]) * int(
                node.attrs["output_dim"])
        elif node.op == "FullyConnected":
            src = node.inputs[0][0]
            width = known.get(src.name + "_output", known.get(src.name))
            hidden = int(node.attrs["num_hidden"])
            total += hidden * (int(np.prod(width[1:])) if width else 0)
            if node.attrs.get("no_bias") not in ("True", "true", True):
                total += hidden
        elif node.op in ("Convolution", "BatchNorm"):
            raise AssertionError("the LM has no convolution or BatchNorm")
    return total


def route_p_phase(mx, hk, dev, prefix, workdir):
    """Route P: the bf16 fused route checkpointed, resumed and monitored.

    1. ``DataParallelTrainer(compute_dtype="bfloat16", grad_guard=True)``
       over ``SymbolBlock.imports`` of the exported LM takes three steps;
       ``ShardedCheckpointer.save(3, params, aux=<optimizer and guard
       state>, async_save=True)`` writes while steps 4-5 run; a fresh
       trainer restores step 3 onto its own tensors (``like=``) and takes
       steps 4-5 on the same batches: its parameters, optimizer and guard
       state must equal the uninterrupted run's bitwise. A second async
       save (step 5) times the page-locked buffer's reuse. A payload file of
       the committed step is then truncated: ``verify`` must say False and
       ``restore`` must raise. ``Monitor.install_trainer`` reports the
       uninterrupted trainer's ``anomaly_stats``.
    2. The LM's ``Module`` route (B1, B3, B2 in float32) through
       ``fit(monitor=Monitor(1))`` for two batches: every value ``toc()``
       reports against ``abs(x).mean()`` of the same output on the host,
       and the launches of each batch against ``per_step_launches(1)``.
    3. ``mx.viz.print_summary`` of the LM's symbol: its total against the
       counting rules (``summary_rule_count``), beside the trainer's
       parameter count.

    Returns {kernel name: launches} of parts 1 and 2."""
    import torch
    from mxnet_tpu_torch import gluon, parallel
    from mxnet_tpu_torch.checkpoint import ShardedCheckpointer
    t_phase = time.perf_counter()
    cfg = OPT_6_7B
    T, B, L = cfg["max_len"], TRAIN_BATCH, cfg["layers"]
    table = sinusoid_table(T, cfg["units"])
    batches = route_p_batches(ROUTE_P_STEPS)
    total = {}
    hk.reset_launch_counts()

    def trainer_for():
        block = gluon.SymbolBlock.imports(prefix + "-symbol.json",
                                          ["data", "pos_table"],
                                          prefix + "-0000.params",
                                          ctx=mx.gpu(dev.index))
        return parallel.DataParallelTrainer(
            block, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": fused_lr, "momentum": FUSED_MOMENTUM},
            compute_dtype="bfloat16", grad_guard=True)

    def run_step(trainer, i):
        ids, y = batches[i]
        before = dict(hk.launch_counts)
        before_dt = dict(hk.launch_dtypes)
        out = []
        t_host, _, t_step = _timed_step(
            lambda: out.append(trainer.step(ids, table, y)))
        step = {k: v - before.get(k, 0) for k, v in hk.launch_counts.items()}
        if step != per_step_launches(0):
            raise AssertionError(f"route P step {i + 1} launched {step}, "
                                 f"expected {per_step_launches(0)}")
        if any(dt != "bfloat16" for (k, dt), v in hk.launch_dtypes.items()
               if v != before_dt.get((k, dt), 0)):
            raise AssertionError(f"route P: a kernel took inputs other "
                                 f"than bf16: {dict(hk.launch_dtypes)}")
        for k, v in step.items():
            total[k] = total.get(k, 0) + v
        return out[0].asscalar().item(), t_step * 1e3, t_host * 1e3

    # part 1: the uninterrupted run, saved after step 3 while 4-5 run
    ckdir = os.path.join(workdir, "route_p")
    ck = ShardedCheckpointer(ckdir)
    full = trainer_for()
    losses, step_ms, host_ms = [], [], []
    for i in range(ROUTE_P_SAVE_AT):
        loss, ms, hms = run_step(full, i)
        losses.append(loss), step_ms.append(ms), host_ms.append(hms)
    params, aux = full._checkpoint_trees()
    nbytes = sum(t.numel() * t.element_size()
                 for t in list(params.values()) + list(aux.values()))
    n_params = sum(t.numel() for t in params.values())
    def save(step, params, aux):
        """An async save: (seconds until save() returned, seconds until
        the snapshot's copy to page-locked memory was done on the card)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(step, params, aux=aux, async_save=True,
                manifest={"step": step, "seed": SEED, "route": "P"})
        t_call = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t0, t_call, time.perf_counter() - t0 - t_call

    t0, t_call, t_copy = save(ROUTE_P_SAVE_AT, params, aux)
    del params, aux
    for i in range(ROUTE_P_SAVE_AT, ROUTE_P_STEPS):
        loss, ms, hms = run_step(full, i)
        losses.append(loss), step_ms.append(ms), host_ms.append(hms)
    t1 = time.perf_counter()
    ck.wait_until_finished()
    t_done = time.perf_counter()
    t_wait = t_done - t1
    save_s = t_done - t0
    # a second save reuses the page-locked buffer the first one made
    params, aux = full._checkpoint_trees()
    t2, t_call2, t_copy2 = save(ROUTE_P_STEPS, params, aux)
    del params, aux
    ck.wait_until_finished()
    save2_s = time.perf_counter() - t2
    print(f"route P: depth {L} of 32 (OPT-6.7B widths), {n_params:,} "
          f"parameters; the checkpoint holds {nbytes / 1e9:.3f} GB "
          f"(parameters float32, the SGD momentum, the update count, the "
          f"guard's state); losses {losses}; step times {step_ms} ms "
          f"(steps 4-5 overlap the save), host dispatch {host_ms} ms")
    print(f"route P: the first save() returned in {t_call * 1e3:.1f} ms "
          f"(page-locking the {nbytes / 1e9:.3f} GB buffer, then the "
          f"snapshot's copy enqueued), the copy done on the card "
          f"{t_copy * 1e3:.1f} ms later ({nbytes / 1e9 / t_copy:.1f} GB/s); "
          f"wait_until_finished after step {ROUTE_P_STEPS} took "
          f"{t_wait:.2f} s; the save took {save_s:.2f} s from the call to "
          f"the commit ({nbytes / 1e9 / save_s:.2f} GB/s). A second save "
          f"(step {ROUTE_P_STEPS}, the buffer reused) returned in "
          f"{t_call2 * 1e3:.1f} ms, its copy done {t_copy2 * 1e3:.1f} ms "
          f"later, committed in {save2_s:.2f} s "
          f"({nbytes / 1e9 / save2_s:.2f} GB/s); card {_card_line()}")
    mon = mx.monitor.Monitor(1)
    mon.install_trainer(full)
    mon.tic()
    stats = full.anomaly_stats()
    tapped = mon.toc()
    print(f"route P: Monitor.install_trainer reports {tapped}")
    if [(k, v) for _, k, v in tapped] != [(k, str(v)) for k, v in
                                          sorted(stats.items())] \
            or stats["grad_skipped_steps"] != 0:
        raise AssertionError(f"route P: the monitor's trainer taps "
                             f"{tapped} are not anomaly_stats {stats}")
    # the resumed run: a fresh trainer, step 3 restored onto its tensors
    resumed = trainer_for()
    rparams, raux = resumed._checkpoint_trees(batches[0][0], table,
                                              batches[0][1])
    like = dict(rparams, **{"__aux__" + k: v for k, v in raux.items()})
    del rparams, raux
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = ck.restore(ROUTE_P_SAVE_AT, like=like)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    resumed._load_checkpoint(restored)
    del restored, like
    r_losses, r_ms = [], []
    for i in range(ROUTE_P_SAVE_AT, ROUTE_P_STEPS):
        loss, ms, _ = run_step(resumed, i)
        r_losses.append(loss), r_ms.append(ms)
    fp, fa = full._checkpoint_trees()
    rp, ra = resumed._checkpoint_trees()
    differ = sorted(n for n in list(fp) + list(fa)
                    if not torch.equal((fp.get(n, fa.get(n))),
                                       rp.get(n, ra.get(n))))
    print(f"route P: restore of step {ROUTE_P_SAVE_AT} (verify, read, "
          f"copy onto the card) {t_restore:.2f} s "
          f"({nbytes / 1e9 / t_restore:.2f} GB/s); resumed losses "
          f"{r_losses} against {losses[ROUTE_P_SAVE_AT:]}; resumed step "
          f"times (no save) {r_ms} ms against {step_ms[ROUTE_P_SAVE_AT:]} "
          f"ms with the save; tensors that differ from the uninterrupted "
          f"run: {differ}")
    if differ or r_losses != losses[ROUTE_P_SAVE_AT:]:
        raise AssertionError(f"route P: the resumed run differs from the "
                             f"uninterrupted one in {differ}")
    del fp, fa, rp, ra, full, resumed
    # the torn-file control
    man = ck.read_manifest(ROUTE_P_SAVE_AT)
    victim = next(e["path"] for e in man["files"]
                  if e["path"].startswith("data/"))
    path = os.path.join(ckdir, f"step_{ROUTE_P_SAVE_AT}", victim)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    ok = ck.verify(ROUTE_P_SAVE_AT)
    try:
        ck.restore(ROUTE_P_SAVE_AT)
        refused = False
    except mx.MXNetError:
        refused = True
    print(f"route P: {victim} truncated: verify {ok}, restore refused "
          f"{refused}")
    if ok or not refused:
        raise AssertionError("route P: a torn checkpoint was accepted")
    ck.close()
    shutil.rmtree(ckdir, ignore_errors=True)
    _free()

    # part 2: the Module route under Monitor(1)
    lm, arg_params, aux_params = mx.model.load_checkpoint(prefix, 0)
    xs = np.concatenate([b[0] for b in batches[:ROUTE_P_MONITOR_BATCHES]])
    ys = np.concatenate([b[1] for b in batches[:ROUTE_P_MONITOR_BATCHES]])
    it = mx.io.NDArrayIter({"data": xs.astype(np.float32)}, {"label": ys},
                           batch_size=B)
    mod = mx.mod.Module(lm_loss_head(mx.sym, lm, cfg["vocab"]),
                        data_names=("data",), label_names=("label",),
                        context=mx.gpu(dev.index),
                        fixed_param_names=["pos_table"])
    mon = mx.monitor.Monitor(1)
    seen, tocs, per_batch = [], [], []
    stat = mon.stat_func
    mon.stat_func = lambda x: (seen.append(x.asnumpy()), stat(x))[1]
    toc = mon.toc

    def recording_toc():
        raw = [(n, k, float(v.asnumpy().reshape(-1)[0]))
               for n, k, v in mon.queue]
        out = toc()
        tocs.append((raw, out))
        return out

    mon.toc = recording_toc
    marks = [dict(hk.launch_counts)]

    def batch_end(param):
        marks.append(dict(hk.launch_counts))

    mod.fit(it, num_epoch=1, optimizer="adam", optimizer_params={
        "learning_rate": TRAIN_LR, "rescale_grad": 1.0 / (B * T)},
        arg_params=arg_params, aux_params=aux_params, monitor=mon,
        eval_metric=mx.metric.Loss(), batch_end_callback=batch_end)
    del arg_params, aux_params
    for a, b in zip(marks, marks[1:]):
        step = {k: v - a.get(k, 0) for k, v in b.items()}
        per_batch.append(step)
        for k, v in step.items():
            total[k] = total.get(k, 0) + v
    errs = []
    for (raw, out), x in zip(tocs, seen):
        for (n, k, v), (_, _, text) in zip(raw, out):
            ref = float(np.abs(x.astype(np.float64)).mean())
            errs.append(abs(v - ref) / abs(ref))
            if text != f"{v:.5f}":
                raise AssertionError(f"route P: toc() printed {text} for "
                                     f"{v}")
    print(f"route P: Module.fit(monitor=Monitor(1)) over "
          f"{ROUTE_P_MONITOR_BATCHES} batches: toc() {[o for _, o in tocs]};"
          f" largest relative difference from abs(x).mean() on the host "
          f"{max(errs):.3e} (tol {TOL_MONITOR_HOST}); launches a batch "
          f"{per_batch}")
    if len(tocs) != ROUTE_P_MONITOR_BATCHES or len(errs) != len(tocs) \
            or not max(errs) <= TOL_MONITOR_HOST:
        raise AssertionError("route P: the monitor's values differ from "
                             "the host's")
    if any(step != per_step_launches(1) for step in per_batch):
        raise AssertionError(f"route P: the monitored Module launched "
                             f"{per_batch}, expected {per_step_launches(1)}"
                             f" a batch")
    del mod, it
    _free()

    # part 3: the symbol's summary
    graph = build_lm_symbol(mx.sym, cfg["vocab"], cfg["units"], L,
                            cfg["heads"], cfg["ffn"], max_len=T)
    shapes = {"data": (B, T), "pos_table": (T, cfg["units"])}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        counted = mx.viz.print_summary(graph, shape=shapes)
    want = summary_rule_count(graph, shapes)
    ln = sum(2 * cfg["units"] for n in graph.topo_nodes()
             if n.op == "LayerNorm")
    print(f"route P: mx.viz.print_summary: {len(buf.getvalue().splitlines())}"
          f" lines, {buf.getvalue().splitlines()[-2]}; by its counting "
          f"rules {want:,}; the trainer holds {n_params:,} (LayerNorm's "
          f"{ln:,} are not counted, and a FullyConnected with "
          f"flatten=False counts its input's sequence axis or, after a "
          f"LayerNorm, 0)")
    if counted != want:
        raise AssertionError(f"route P: print_summary counted {counted}, "
                             f"its rules give {want}")
    print(f"route P: {time.perf_counter() - t_phase:.1f} s; launches "
          f"{total}")
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


def net_layout(trainer, name, t):
    """A fused trainer's parameter in the net's own layout: the graph
    passes may have re-homed it (the stem's space-to-depth weight)."""
    res = trainer._pass_result
    if res is not None and name in res.var_transforms:
        return res.inverse_var(name, t)
    return t


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
        return loss, {n: (w0h[n] - net_layout(trainer, n, t).double()) / lr
                      - wd * w0h[n] for n, t in trainer._params.items()}

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
    del again, w1
    # the pipeline's cost: the same step with passes=False, in turns
    off = parallel.DataParallelTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd", dict(RESNET_OPT),
        compute_dtype="bfloat16", passes=False)
    off.step(xs, ys)
    turns = {"default pipeline": [], "passes=False": []}
    for _ in range(3):
        for label, tr in (("default pipeline", trainer),
                          ("passes=False", off)):
            turns[label].append(_timed_step(lambda: tr.step(xs, ys))[2]
                                * 1e3)
    print(f"resnet: route A's step in turns, ms: "
          f"{ {k: [round(v, 2) for v in ms] for k, ms in turns.items()} } "
          f"(the default pipeline: {trainer.passes_provenance()})")
    del off, xs, ys
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



# ---- route G: the image-classification recipe (phases 20-23) ----------
IC_DIR = os.path.join("example", "image-classification")
# the north star's command on one card; 640 synthetic images are 20
# updates of the batch (the recipe's default reads 1,281,167)
G1_ARGV = ("--network", "resnet-v1", "--num-layers", "50", "--gpus", "0",
           "--kv-store", "device", "--benchmark", "1", "--batch-size", "32",
           "--num-examples", "640")
G1_UPDATES = 20
G1_CUT_AT = 30          # lr_step_epochs 30 of a one-batch epoch
G2_IMAGES = 512         # 16 batches of 32
G2_SIZE = 256
G2_CHECK_TOL = 1.0      # one level of a uint8 pixel (mean only, std 1)
G3_TRAIN, G3_VAL = 60000, 10000
G3_BAR = 0.95           # validation accuracy after the recipe's 2 epochs
G4_BATCH = 64
G4_STEPS = 3
TOL_G4 = 1e-5           # of each tensor's largest entry, card against CPU
G4_FLIPS = 1e-2         # flipped entries allowed a sign or threshold rule
G4_CONTROL_LR = 1.01    # the control's learning rate factor: must miss
G4_RULES = (
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 1e-3}),
    ("adagrad", {"learning_rate": 1e-3}),
    ("adadelta", {}),
    ("rmsprop", {"learning_rate": 1e-3}),
    ("rmsprop", {"learning_rate": 1e-3, "centered": True,
                 "clip_weights": 1.0}),
    ("ftrl", {"learning_rate": 0.1}),
    ("signum", {"learning_rate": 1e-3}),
    ("ftml", {"learning_rate": 2.5e-3}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adamax", {"learning_rate": 2e-3}),
    ("nadam", {"learning_rate": 1e-3}),
    ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("test", {"learning_rate": 0.1}),
)
# held by their flipped entries: the sign and threshold rules, and the
# rules that divide by a root of the squared gradients plus a small ε: an
# entry whose gradient is near ε answers to its rounding with a slope up
# to lr/ε, a soft threshold (as in the port's Adam parity test)
G4_THRESHOLD = ("ftrl", "signum", "lbsgd", "adam", "nadam", "adamax",
                "adagrad", "rmsprop", "ftml")


def _g1_value(flag, default=None):
    """A flag's value in G1_ARGV."""
    return G1_ARGV[G1_ARGV.index(flag) + 1] if flag in G1_ARGV else default


def run_recipe(script, argv):
    """Run a recipe twin of ``example/image-classification`` as its
    command line would (``__main__``, ``sys.argv``); its module globals."""
    import runpy
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), IC_DIR,
                        script)
    saved = sys.argv
    sys.argv = [path] + list(argv)
    try:
        return runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = saved


class FitRecorder:
    """While a recipe runs, wraps ``Module.forward_backward`` and
    ``update`` and the device feed: the first training module's parameters
    before step 1, its batch, gradients and outputs, the weights after
    update 1, each step's start (host clock and a CUDA event), host
    dispatch and loss (a 0-d tensor on the card), and the feeds made."""

    def __init__(self, mx, cuda: bool):
        self.mx, self.cuda = mx, cuda
        self.module = self.batch = self.w0 = self.aux0 = None
        self.grads1 = self.probs1 = self.w1 = None
        self.starts, self.host, self.losses, self.feeds = [], [], [], []

    def __enter__(self):
        mx, rec = self.mx, self
        M = mx.mod.Module
        self._saved = (M.forward_backward, M.update, mx.io.DeviceFeedIter)
        fb, up, feed_cls = self._saved

        def forward_backward(mod, batch):
            if rec.module is None:
                rec.module, rec.batch = mod, batch
                arg, aux = mod.get_params()
                rec.w0 = {k: v._data for k, v in arg.items()}
                rec.aux0 = {k: v._data for k, v in aux.items()}
            if mod is rec.module:
                event = None
                if rec.cuda:
                    event = torch.cuda.Event(enable_timing=True)
                    event.record()
                rec.starts.append((time.perf_counter(), event))
                rec._batch = batch
            return fb(mod, batch)

        def update(mod):
            if mod is rec.module:
                probs = mod.get_outputs()[0]._data
                label = rec._batch.label[0]._data.long()
                rec.losses.append(-torch.log(probs.gather(
                    1, label[:, None]).clamp_min(1e-30)).mean())
                if rec.grads1 is None:
                    exe = mod._exec_group.execs[0]
                    rec.grads1 = {k: exe.grad_dict[k]._data.clone()
                                  for k in rec.w0}
                    rec.probs1 = probs.clone()
            out = up(mod)
            if mod is rec.module:
                if rec.w1 is None:
                    rec.w1 = {k: v._data for k, v in
                              mod.get_params()[0].items()}
                rec.host.append(time.perf_counter() - rec.starts[-1][0])
            return out

        class RecordedFeed(feed_cls):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                rec.feeds.append(self)

        M.forward_backward, M.update = forward_backward, update
        mx.io.DeviceFeedIter = RecordedFeed
        return self

    def __exit__(self, *exc):
        M = self.mx.mod.Module
        M.forward_backward, M.update, self.mx.io.DeviceFeedIter = self._saved
        return False

    def step_ms(self):
        """Device ms between consecutive step starts, step 1 left out."""
        torch.cuda.synchronize()
        ev = [e for _, e in self.starts]
        return [a.elapsed_time(b) for a, b in zip(ev[1:-1], ev[2:])]

    def wall_s(self):
        """Host seconds between consecutive step starts, step 1 left
        out."""
        t = [h for h, _ in self.starts]
        return [b - a for a, b in zip(t[1:-1], t[2:])]


def classifier_step(mx, sym, logits_name, w0, aux0, batch, ctx, dtype):
    """One training forward and backward of a ``SoftmaxOutput`` net in
    ``dtype`` from the weights ``w0``: (probabilities, logits, {name:
    gradient}); the logits come out beside it through ``BlockGrad``."""
    logits = sym.get_internals()[logits_name + "_output"]
    group = mx.sym.Group([sym, mx.sym.BlockGrad(logits)])
    nd = mx.nd.NDArray
    args = {k: nd(v.to(dtype).clone()) for k, v in w0.items()}
    args["data"] = nd(batch.data[0]._data.to(dtype))
    args["softmax_label"] = nd(batch.label[0]._data.to(dtype))
    grads = {k: nd(torch.zeros_like(args[k]._data)) for k in w0}
    reqs = {k: ("write" if k in grads else "null") for k in args}
    aux = {k: nd(v.to(dtype).clone()) for k, v in aux0.items()}
    ex = group.bind(ctx, args, grads, reqs, aux)
    probs, lg = (o._data for o in ex.forward(is_train=True))
    ex.backward()
    return probs, lg, {k: g._data for k, g in grads.items()}


def _ce(probs, label) -> float:
    return float(-torch.log(probs.double().gather(
        1, label.long()[:, None]).clamp_min(1e-300)).mean())


def classifier_gate(mx, what, sym, rec, ctx, top, tol_grad=None,
                    tol_top=None):
    """Step 1 of a recorded recipe run against the same step in float64
    on the card: the loss, the logits (the float32 step's, from the same
    weights, beside the recorded probabilities) and, if asked, the
    gradients (the output layer ``top`` and the rest apart)."""
    probs32, logits32, g32 = classifier_step(mx, sym, top, rec.w0, rec.aux0,
                                             rec.batch, ctx, torch.float32)
    probs64, logits64, g64 = classifier_step(mx, sym, top, rec.w0, rec.aux0,
                                             rec.batch, ctx, torch.float64)
    label = rec.batch.label[0]._data
    loss32, loss64 = _ce(rec.probs1, label), _ce(probs64, label)
    s = {"loss": abs(loss32 - loss64) / abs(loss64),
         "logits": _rel_err(logits32, logits64),
         "probs_rerun": float((probs32 - rec.probs1).abs().max())}
    if tol_grad is not None:
        null = _null_grads(g64)
        errs, nulls = _rn_grads_rel(rec.grads1, g64, null)
        s["top"] = max(v for k, v in errs.items() if k.startswith(top))
        s["all"] = max(errs.values())
        s["null"] = sorted(null)
    print(f"{what}: step 1 against float64 on the card: loss {loss32:.6f} "
          f"(relative {s['loss']:.3e}), logits {s['logits']:.3e} of the "
          f"largest, the recorded probabilities against a rerun "
          f"{s['probs_rerun']:.3e}" + (
              f", gradients ||dg||/||g||: output layer {s['top']:.3e}, "
              f"largest {s['all']:.3e} (null: {s['null']})"
              if tol_grad is not None else ""))
    bad = s["loss"] > TOL_RN_LOSS or s["logits"] > TOL_RN_LOGITS
    if tol_grad is not None:
        bad = bad or s["top"] > tol_top or s["all"] > tol_grad
    if bad:
        raise AssertionError(f"{what}: step 1 misses its float64 gates: {s}")
    return s


def _timings(what, rec, batch, n_updates):
    """Print the recorded steps' times: device ms between step starts,
    host dispatch, images/s and peak memory."""
    dev_ms = float(np.median(rec.step_ms()))
    host_ms = 1e3 * float(np.median(rec.host[1:]))
    wall_ms = 1e3 * float(np.median(rec.wall_s()))
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{what}: {n_updates} updates; step {dev_ms:.2f} ms on the card "
          f"(median of steps 2-{n_updates}), {wall_ms:.2f} ms on the host "
          f"clock, {1e3 * batch / wall_ms:.1f} images/s end to end "
          f"({1e3 * batch / dev_ms:.1f} by the card's step); host dispatch "
          f"{host_ms:.2f} ms a step; peak memory {peak:.2f} GB; card "
          f"{_card_line()}")
    return dev_ms, wall_ms


def recipe_resnet_phase(mx, dev, profile=False):
    """G1 (phase 20): the north star's command, ``train_imagenet_torch.py
    --network resnet-v1 --num-layers 50 --gpus 0 --kv-store device
    --benchmark 1 --batch-size 32``: ResNet-50 v1 uncut at 224² and 1,000
    classes in float32, SGD (momentum 0.9, wd 1e-4, lr 0.1) and Xavier
    through ``fit()``, ``Module``, the store and the device feed for
    G1_UPDATES updates. Step 1 against float64 on the card; the store's
    update 1 bitwise a direct update of the same gradients; the loss finite
    and the rate still 0.1 (the cut falls at update 30)."""
    ctx = _ctx(mx, dev)
    torch.cuda.reset_peak_memory_stats()
    argv = list(G1_ARGV)
    if dev.type != "cuda":
        argv[argv.index("--gpus") + 1] = ""
    with FitRecorder(mx, dev.type == "cuda") as rec:
        g = run_recipe("train_imagenet_torch.py", argv)
    mod, args = rec.module, g["args"]
    if len(rec.starts) != G1_UPDATES:
        raise AssertionError(f"route G1: {len(rec.starts)} updates, "
                             f"expected {G1_UPDATES}")
    dev_ms, wall_ms = _timings("route G1", rec, args.batch_size, G1_UPDATES)
    losses = torch.stack(rec.losses).tolist()
    opt = mod._optimizer
    lr_now = opt.learning_rate
    print(f"route G1: losses {losses[0]:.4f} -> {losses[-1]:.4f}; lr after "
          f"{opt.num_update} updates {lr_now} (schedule steps "
          f"{opt.lr_scheduler.step}: one batch an epoch, the train "
          f"iterator has no .idx)")
    if not all(math.isfinite(v) for v in losses) or lr_now != args.lr \
            or opt.lr_scheduler.step[0] != G1_CUT_AT:
        raise AssertionError("route G1: a loss is not finite, or the rate "
                             "was cut before update 30")
    kv = mod._kvstore
    stats = kv.comm_stats
    print(f"route G1: the store ({kv.type}): {stats['pushes']} pushes, "
          f"{stats['bucket_reduces']} buckets, {stats['pull_copies']} pull "
          f"copies ({stats['pull_copies'] / G1_UPDATES:.0f} a step, "
          f"{stats['pull_bytes'] / G1_UPDATES / 1e6:.1f} MB a step)")
    feed = rec.feeds[0]
    print(f"route G1: the device feed: {feed.feed_stats['batches']} "
          f"batches, next() waited {1e3 * feed.feed_stats['wait_s']:.2f} ms"
          f" in all, {feed.feed_stats['copied_bytes']} bytes copied (the "
          f"synthetic batch is made on the card)")

    # the store's update 1 against a direct update of the same gradients
    direct = mx.optimizer.get_updater(mx.optimizer.create(
        "sgd", learning_rate=args.lr, wd=args.wd, momentum=args.mom,
        rescale_grad=1.0 / args.batch_size))
    same = True
    for i, name in enumerate(mod._param_names):
        w = mx.nd.NDArray(rec.w0[name].clone())
        direct(i, mx.nd.NDArray(rec.grads1[name]), w)
        same = same and torch.equal(w._data, rec.w1[name])
    print(f"route G1: update 1 through the store against the direct "
          f"updater on the same gradients: bitwise {same}")
    if not same:
        raise AssertionError("route G1: the store's update 1 differs from "
                             "the direct update")

    sym = g["sym"]
    classifier_gate(mx, "route G1", sym, rec, ctx, "fc1",
                    tol_grad=TOL_RN_GRAD, tol_top=TOL_RN_GRAD_TOP)
    batch = rec.batch
    g1_layout_copies(mx, mod, sym, batch, ctx)

    def step():
        mod.forward_backward(batch)
        mod.update()
    profile_breakdown("route G1 step (ResNet-50 v1, batch 32, float32, "
                      "Module over the store)", step)
    if profile:
        t_host, t_dev, _ = _timed_step(step)
        print(f"route G1: one more step: host dispatch "
              f"{1e3 * t_host:.2f} ms, device {t_dev:.2f} ms")
    return dev_ms, wall_ms


def g1_layout_copies(mx, mod, sym, batch, ctx):
    """The copies that change a tensor's memory format (``ConvCensus``) in
    one forward and backward of G1's Module, which binds the default
    pipeline's rewrite (its convolutions NHWC over views), against a
    Module of the same graph and weights with ``passes=False``: the
    pipeline may add none."""
    plain = mx.mod.Module(sym, context=ctx, passes=False)
    plain.bind(mod.data_shapes, mod.label_shapes)
    arg, aux = mod.get_params()
    plain.init_params(arg_params=arg, aux_params=aux)
    copies = {}
    for label, m in (("default pipeline", mod), ("passes=False", plain)):
        census = ConvCensus()
        with census:
            m.forward_backward(batch)
        copies[label] = (sum(census.relayouts.values()),
                         sum(census.convs.values()))
        print(f"route G1: {label}: passes_provenance() = "
              f"{json.dumps(m.passes_provenance(), sort_keys=True)}; one "
              f"forward and backward: {copies[label][1]} convolutions, "
              f"{copies[label][0]} layout copies "
              f"{dict(census.relayouts)}")
    turns = {"default pipeline": [], "passes=False": []}
    for _ in range(3):
        for label, m in (("default pipeline", mod), ("passes=False", plain)):
            t_host, t_dev, _ = _timed_step(lambda: m.forward_backward(batch))
            turns[label].append((round(1e3 * t_host, 2), round(t_dev, 2)))
    print(f"route G1: forward_backward in turns, (host dispatch ms, device "
          f"ms): {turns}")
    del plain
    _free()
    if copies["default pipeline"][0] > copies["passes=False"][0]:
        raise AssertionError("route G1: the default pipeline adds layout "
                             "copies")


def g2_records(mx, workdir):
    """G2_IMAGES synthetic G2_SIZE² JPEGs (smooth colour fields with a
    rectangle, labels in [0, 1000)) in an indexed ``.rec``."""
    from PIL import Image  # noqa: F401  (pack_img encodes with Pillow)
    os.makedirs(workdir, exist_ok=True)
    rec, idx = (os.path.join(workdir, "g2" + e) for e in (".rec", ".idx"))
    rng = np.random.RandomState(SEED)
    yy, xx = np.mgrid[0:G2_SIZE, 0:G2_SIZE].astype(np.float32) / G2_SIZE
    t0 = time.perf_counter()
    w = mx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(G2_IMAGES):
        a, b, c = rng.uniform(0, 255, (3, 3))
        img = np.stack([a[0] + (a[1] - a[0]) * yy + (a[2] - a[0]) * xx * 0.5,
                        b[0] + (b[1] - b[0]) * xx,
                        c[0] + (c[1] - c[0]) * yy * xx], -1)
        y0, x0 = rng.randint(0, G2_SIZE // 2, 2)
        h, wd = rng.randint(16, G2_SIZE // 2, 2)
        img[y0:y0 + h, x0:x0 + wd] = rng.uniform(0, 255, 3)
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255)
        header = mx.recordio.IRHeader(0, float(rng.randint(0, 1000)), i, 0)
        w.write_idx(i, mx.recordio.pack_img(header, img.astype(np.uint8),
                                            quality=90))
    w.close()
    print(f"route G2: {G2_IMAGES} synthetic {G2_SIZE}x{G2_SIZE} JPEG records"
          f" written in {time.perf_counter() - t0:.2f} s (set-up)")
    return rec


def recipe_records_phase(mx, dev, workdir, g1_ms):
    """G2 (phase 21): the same command on a ``.rec`` of G2_IMAGES JPEGs
    through ``ImageRecordIter`` (``rand_crop``, ``rand_mirror``, the
    recipe's mean), the device feed and ``Module``: images/s end to end
    beside G1's, the iterator's time a batch, what ``next()`` waited, and
    one batch through the feed on the card against the same batch on the
    CPU."""
    rec_path = g2_records(mx, workdir)
    shape = tuple(int(v) for v in _g1_value("--image-shape",
                                             "3,224,224").split(","))
    batch = int(_g1_value("--batch-size"))
    mean = dict(mean_r=123.68, mean_g=116.779, mean_b=103.939)

    def iterator(seed=None, threads=4):
        return mx.io.ImageRecordIter(
            path_imgrec=rec_path, data_shape=shape, batch_size=batch,
            shuffle=True, rand_crop=True, rand_mirror=True, ctx=mx.cpu(),
            seed=seed, preprocess_threads=threads, **mean)

    it = iterator()
    times = []
    for _ in range(min(6, G2_IMAGES // batch)):
        t0 = time.perf_counter()
        it.next()
        times.append(time.perf_counter() - t0)
    it_ms = 1e3 * float(np.median(times))
    print(f"route G2: ImageRecordIter: {it_ms:.1f} ms a batch of {batch} "
          f"(median of {len(times)}; decode, crop, mirror, normalise on 4 "
          f"threads)")

    # one batch through the feed on the card against the CPU's
    pair = []
    for ctx in (_ctx(mx, dev), mx.cpu()):
        np.random.seed(SEED)
        base = iterator(seed=SEED, threads=1)
        feed = mx.io.DeviceFeedIter(base, ctx=ctx)
        b = feed.next()
        pair.append((b.data[0]._data.cpu(), b.label[0]._data.cpu(),
                     b.data[0]._data.device))
        feed.close()
    d_err = float((pair[0][0] - pair[1][0]).abs().max())
    same_labels = torch.equal(pair[0][1], pair[1][1])
    print(f"route G2: one batch on {pair[0][2]} against the CPU: labels "
          f"equal {same_labels}, data max |diff| {d_err:.3e} (bound "
          f"{G2_CHECK_TOL}: one uint8 level)")
    if not same_labels or d_err > G2_CHECK_TOL or \
            pair[0][2].type != dev.type:
        raise AssertionError("route G2: the fed batch differs from the "
                             "CPU's")

    torch.cuda.reset_peak_memory_stats()
    argv = [a for a in G1_ARGV]
    k = argv.index("--benchmark")
    argv[k + 1] = "0"
    argv[argv.index("--num-examples") + 1] = str(G2_IMAGES)
    argv += ["--data-train", rec_path]
    if dev.type != "cuda":
        argv[argv.index("--gpus") + 1] = ""
    n_updates = G2_IMAGES // batch
    with FitRecorder(mx, dev.type == "cuda") as rec:
        run_recipe("train_imagenet_torch.py", argv)
    if len(rec.starts) != n_updates:
        raise AssertionError(f"route G2: {len(rec.starts)} updates, "
                             f"expected {n_updates}")
    dev_ms, wall_ms = _timings("route G2", rec, batch, n_updates)
    feed = rec.feeds[0]
    fs = feed.feed_stats
    copy_ms = fs["copied_bytes"] / fs["batches"] / 25e9 * 1e3
    print(f"route G2: end to end {batch * 1e3 / wall_ms:.1f} images/s "
          f"against G1's {batch * 1e3 / g1_ms:.1f} on synthetic batches; "
          f"next() waited "
          f"{1e3 * fs['wait_s'] / fs['batches']:.2f} ms a batch (the "
          f"iterator alone {it_ms:.1f} ms, the step {dev_ms:.2f} ms on the "
          f"card, {fs['copied_bytes'] / fs['batches'] / 1e6:.1f} MB copied a"
          f" batch, ~{copy_ms:.2f} ms at 25 GB/s)")
    losses = torch.stack(rec.losses).tolist()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("route G2: a loss is not finite")


def mnist_files(root, n_train, n_val):
    """MNIST idx files of a learnable synthetic task: digit c is a bright
    bar at one of ten places (five rows, five columns), on noise, shifted
    by up to a pixel, so that no two digits' bars meet (MNIST itself is
    not in the repo)."""
    import struct
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(SEED)
    for prefix, n in (("train", n_train), ("t10k", n_val)):
        y = rng.randint(0, 10, n).astype(np.uint8)
        x = rng.randint(0, 90, (n, 28, 28)).astype(np.uint8)
        dy, dx = rng.randint(-1, 2, (2, n))
        for i, c in enumerate(y):
            pos = 3 + 5 * (c % 5) + dy[i]
            if c < 5:
                x[i, pos:pos + 2, 4 + dx[i]:24 + dx[i]] = 255
            else:
                x[i, 4 + dx[i]:24 + dx[i], pos:pos + 2] = 255
        for kind, magic, arr in (("images-idx3-ubyte", 2051, x),
                                 ("labels-idx1-ubyte", 2049, y)):
            with open(os.path.join(root, f"{prefix}-{kind}"), "wb") as f:
                dims = arr.shape if arr.ndim == 3 else (n,)
                f.write(struct.pack(">I" + "I" * len(dims), magic, *dims))
                f.write(arr.tobytes())


def recipe_mnist_phase(mx, dev, workdir):
    """G3 (phase 22): ``BASELINE.json`` config #1, ``train_mnist_torch.py
    --network lenet --gpus 0`` over ``MNISTIter`` on idx files of
    G3_TRAIN and G3_VAL synthetic images: the recipe's two epochs (SGD lr
    0.05, momentum 0.9, batch 64; the rate cut after update 10, the
    ``.idx`` quirk), validation accuracy above G3_BAR; step 1 against
    float64 (loss and logits)."""
    root = os.path.join(workdir, "mnist")
    t0 = time.perf_counter()
    mnist_files(root, G3_TRAIN, G3_VAL)
    print(f"route G3: {G3_TRAIN} + {G3_VAL} synthetic 28x28 idx images "
          f"written in {time.perf_counter() - t0:.2f} s (set-up)")
    torch.cuda.reset_peak_memory_stats()
    argv = ["--network", "lenet", "--gpus",
            "0" if dev.type == "cuda" else "", "--data-dir", root]
    t0 = time.perf_counter()
    with FitRecorder(mx, dev.type == "cuda") as rec:
        g = run_recipe("train_mnist_torch.py", argv)
    fit_s = time.perf_counter() - t0
    args, mod = g["args"], rec.module
    n_updates = len(rec.starts)
    _timings("route G3", rec, args.batch_size, n_updates)
    val = mx.io.MNISTIter(image=os.path.join(root, "t10k-images-idx3-ubyte"),
                          label=os.path.join(root, "t10k-labels-idx1-ubyte"),
                          batch_size=args.batch_size, shuffle=False)
    acc = dict(mod.score(val, "acc"))["accuracy"]
    print(f"route G3: LeNet, {args.num_epochs} epochs of {n_updates // args.num_epochs} "
          f"updates in {fit_s:.1f} s (validation included); validation "
          f"accuracy {acc:.4f} (bar {G3_BAR}); lr after the run "
          f"{mod._optimizer.learning_rate:g}")
    if acc <= G3_BAR:
        raise AssertionError(f"route G3: validation accuracy {acc:.4f} is "
                             f"not above {G3_BAR}")
    classifier_gate(mx, "route G3", g["sym"], rec, _ctx(mx, dev), "fc2")


def _lenet_run(mx, sym, ctx, name, params, values, batches):
    """G4_STEPS updates of LeNet through Module and the ``device`` store on
    ``ctx``: the weights after."""
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", (G4_BATCH, 1, 28, 28))],
             label_shapes=[("softmax_label", (G4_BATCH,))])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=ctx)
                                for k, v in values.items()})
    mod.init_optimizer(kvstore="device", optimizer=name,
                       optimizer_params=dict(params))
    for x, y in batches:
        mod.forward_backward(mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                                             [mx.nd.array(y, ctx=ctx)]))
        mod.update()
    return {k: v._data.double().cpu() for k, v in mod.get_params()[0].items()}


def _flips(got, want):
    """(entries beyond TOL_G4 of their tensor's largest, all entries,
    the largest error relative to its tensor's largest)."""
    n = total = 0
    worst = 0.0
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-30)
        d = (got[k] - w).abs() / scale
        n += int((d > TOL_G4).sum())
        total += w.numel()
        worst = max(worst, float(d.max()))
    return n, total, worst


def optimizer_card_phase(mx, dev):
    """G4 (phase 23): every registered rule takes G4_STEPS LeNet updates
    through ``Module`` and the ``device`` store on the card and on the CPU
    from the same weights and batches; each is held at TOL_G4 of each
    tensor's largest entry, the sign and threshold rules and the rules
    normalised by ``√v + ε`` (G4_THRESHOLD) by their count of flipped
    entries (at most G4_FLIPS of them, against a control of the CPU run at
    G4_CONTROL_LR times the rate, which must miss). SGD and NAG
    also with ``multi_precision`` on float16 weights through the store.
    Then each rule's update time on ResNet-50's parameters."""
    ctx = _ctx(mx, dev)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), IC_DIR))
    try:
        import importlib
        lenet = importlib.import_module("symbols.lenet_torch")
        resnet = importlib.import_module("symbols.resnet_torch")
    finally:
        sys.path.pop(0)
    sym = lenet.get_symbol(num_classes=10)
    rng = np.random.RandomState(SEED)
    arg_shapes, _, _ = sym.infer_shape(data=(G4_BATCH, 1, 28, 28),
                                       softmax_label=(G4_BATCH,))
    values = {n: (rng.randn(*s) * (0.1 if n.endswith("weight") else 0.01))
              .astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    batches = [(rng.rand(G4_BATCH, 1, 28, 28).astype(np.float32),
                rng.randint(0, 10, G4_BATCH).astype(np.float32))
               for _ in range(G4_STEPS)]
    registered = sorted(mx.optimizer._OPT_REGISTRY)
    if sorted({n for n, _ in G4_RULES}) != registered:
        raise AssertionError(f"route G4: the rules run are not the "
                             f"registry: {registered}")
    for name, params in G4_RULES:
        card = _lenet_run(mx, sym, ctx, name, params, values, batches)
        host = _lenet_run(mx, sym, mx.cpu(), name, params, values, batches)
        n, total, worst = _flips(card, host)
        line = (f"route G4: {name} {params}: card against CPU: largest "
                f"error {worst:.3e} of its tensor's largest, {n} of {total} "
                f"entries beyond {TOL_G4}")
        if name in G4_THRESHOLD:
            ctrl_params = dict(params)
            ctrl_params["learning_rate"] = params.get(
                "learning_rate", 0.01) * G4_CONTROL_LR
            ctrl = _lenet_run(mx, sym, mx.cpu(), name, ctrl_params, values,
                              batches)
            cn, _, _ = _flips(ctrl, host)
            print(f"{line}; control (rate x{G4_CONTROL_LR}) {cn} entries "
                  f"(allowed {G4_FLIPS * total:.0f})")
            if n > G4_FLIPS * total or cn <= G4_FLIPS * total:
                raise AssertionError(f"route G4: {name}: {n} flipped, "
                                     f"control {cn}")
        else:
            print(line)
            if n:
                raise AssertionError(f"route G4: {name} misses {TOL_G4}")

    # multi_precision: float16 weights, float32 masters, through the store
    grads = None
    for name in ("sgd", "nag"):
        outs = []
        for c in (ctx, mx.cpu()):
            opt = mx.optimizer.create(name, learning_rate=0.1, momentum=0.9,
                                      multi_precision=True,
                                      rescale_grad=1.0 / G4_BATCH)
            kv = mx.kvstore.create("device")
            kv.set_optimizer(opt)
            ws = {k: mx.nd.array(v, ctx=c, dtype="float16")
                  for k, v in values.items()}
            if grads is None:
                rs = np.random.RandomState(SEED + 1)
                grads = {k: rs.randn(*v.shape).astype(np.float16)
                         for k, v in values.items()}
            for i, k in enumerate(sorted(ws)):
                kv.init(i, ws[k])
            for _ in range(G4_STEPS):
                for i, k in enumerate(sorted(ws)):
                    kv.push(i, mx.nd.array(grads[k], ctx=c, dtype="float16"))
                for i, k in enumerate(sorted(ws)):
                    kv.pull(i, ws[k])
            masters = {k: kv._raw_updater.states[i][0].double().cpu()
                       for i, k in enumerate(sorted(ws))}
            outs.append(({k: w._data.double().cpu() for k, w in ws.items()},
                         masters, ws[sorted(ws)[0]]._data.dtype))
        n16, total, w16 = _flips(outs[0][0], outs[1][0])
        n32, _, w32 = _flips(outs[0][1], outs[1][1])
        print(f"route G4: {name} multi_precision on float16 weights: the "
              f"float32 masters, card against CPU, largest error {w32:.3e} "
              f"({n32} of {total} beyond {TOL_G4}); float16 weights equal "
              f"but {n16} (largest {w16:.3e}); weights {outs[0][2]}")
        if n32 or outs[0][2] != torch.float16:
            raise AssertionError(f"route G4: {name} multi_precision misses")

    # each rule's update time on ResNet-50's parameters (on the card)
    rn = resnet.get_symbol(num_classes=1000, num_layers=50,
                           image_shape="3,224,224", version=1)
    shapes, _, _ = rn.infer_shape(data=(32, 3, 224, 224),
                                  softmax_label=(32,))
    shapes = [s for n, s in zip(rn.list_arguments(), shapes)
              if n not in ("data", "softmax_label")]
    gen = torch.Generator(device=ctx.torch_device()).manual_seed(SEED)
    times = []
    for name, params in G4_RULES:
        updater = mx.optimizer.get_updater(mx.optimizer.create(
            name, rescale_grad=1.0 / 32, **params))
        ws = [mx.nd.NDArray(torch.randn(s, generator=gen,
                                        device=ctx.torch_device()) * 0.05)
              for s in shapes]
        gs = [mx.nd.NDArray(torch.randn(s, generator=gen,
                                        device=ctx.torch_device()))
              for s in shapes]

        def one_pass():
            for i, (w, g_) in enumerate(zip(ws, gs)):
                updater(i, g_, w)
        one_pass()                   # the states
        ms = _time_ms(one_pass, 3) if dev.type == "cuda" else float("nan")
        times.append(f"{name}{'-centered' if params.get('centered') else ''}"
                     f" {ms:.2f}")
        del ws, gs
    print(f"route G4: one update of ResNet-50 v1's {len(shapes)} parameter "
          f"tensors ({sum(int(np.prod(s)) for s in shapes)} floats), ms: "
          f"{', '.join(times)}; card {_card_line()}")


# ------------------------------------------------- slice 11: the op grid
# The cases of every op slice 11 adds (phase 24 on the card against the
# CPU; ``tests/test_torch_dense_ops.py`` against the JAX package): (case
# id, op name, numpy inputs, attrs, what to compare: "grad" for values and
# gradients, "value" for values only, "exact" for equal values).
TOL_GRID = 1e-6          # of the case's largest |value|, card against CPU
def grid_values(*shape, seed=0, lo=-2.0, hi=2.0):
    """Seeded uniform float32 values (the op grid's inputs)."""
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        "float32")


def with_values(a, *values):
    """``a`` with its first entries replaced by ``values`` (ties, zeros,
    bounds)."""
    a = a.copy()
    a.reshape(-1)[:len(values)] = values
    return a


# (case id, op name, numpy inputs, attrs, what to compare: "grad" for
# values and gradients, "value" for values only, "exact" for equal values)
GRID_POS = dict(lo=0.2, hi=3.0)
GRID_UNIT = dict(lo=-0.9, hi=0.9)


def _grid_unary():
    general = ["sign", "negative", "square", "exp", "expm1", "sin", "cos",
               "arctan", "sinh", "cosh", "tanh", "arcsinh", "degrees",
               "radians", "erf", "sigmoid", "softsign"]
    cases = [(n, n, [grid_values(3, 5)], {}, "grad") for n in general]
    cases += [(n, n, [grid_values(3, 5, **GRID_POS)], {}, "grad")
              for n in ("sqrt", "rsqrt", "log", "log2", "log10", "gammaln",
                        "digamma", "reciprocal", "cbrt", "rcbrt")]
    cases += [(n, n, [grid_values(3, 5, **GRID_UNIT)], {}, "grad")
              for n in ("arcsin", "arccos", "arctanh", "erfinv", "log1p")]
    cases += [
        ("tan", "tan", [grid_values(3, 5, lo=-1.2, hi=1.2)], {}, "grad"),
        ("arccosh", "arccosh", [grid_values(3, 5, lo=1.1, hi=4.0)], {}, "grad"),
        ("cbrt_negative", "cbrt", [grid_values(3, 5, lo=-3.0, hi=-0.2)], {}, "grad"),
        ("abs_at_zero", "abs", [with_values(grid_values(3, 5), 0.0, -0.0)], {}, "grad"),
        ("relu_at_zero", "relu", [with_values(grid_values(3, 5), 0.0)], {}, "grad"),
        # gamma is exp(lgamma): the sign is lost at negative non-integers
        ("gamma", "gamma", [with_values(grid_values(3, 5, lo=0.3, hi=4.0), -0.5, -1.5,
                                  -2.5)], {}, "grad"),
    ]
    halves = with_values(grid_values(3, 5), 0.5, 1.5, 2.5, -0.5, -2.5, 0.0, -1.7)
    cases += [(n, n, [halves], {}, "exact")
              for n in ("floor", "ceil", "round", "rint", "trunc", "fix",
                        "logical_not")]
    return cases


def _grid_elemwise():
    x = grid_values(3, 5, seed=1)
    y = with_values(grid_values(3, 5, seed=2), *x.reshape(-1)[:4])          # ties
    xi = np.round(grid_values(3, 5, seed=3))
    yi = np.round(grid_values(3, 5, seed=4))
    cases = [
        # exact bounds (XLA fuses 0.2·x + 0.5 into one rounding)
        ("hard_sigmoid_bounds", "hard_sigmoid",
         [with_values(grid_values(3, 5, lo=-4, hi=4), -2.0, 2.0, 0.0)],
         {"alpha": 0.25, "beta": 0.5}, "grad"),
        ("hard_sigmoid", "hard_sigmoid", [x], {}, "grad"),
        ("clip_ties", "clip", [with_values(x, -1.0, 1.0)],
         {"a_min": -1.0, "a_max": 1.0}, "grad"),
        ("clip_open_low", "clip", [x], {"a_max": 0.5}, "grad"),
        ("identity", "identity", [x], {}, "grad"),
        ("_copy", "_copy", [x], {}, "grad"),
        ("make_loss", "make_loss", [x], {}, "grad"),
        ("Cast_f16", "Cast", [x], {"dtype": "float16"}, "exact"),
        ("cast_i32", "cast", [x * 3], {"dtype": "int32"}, "exact"),
        ("amp_cast", "amp_cast", [x], {"dtype": "float16"}, "exact"),
        ("amp_multicast", "amp_multicast", [x, x.astype("float16")],
         {"num_outputs": 2}, "exact"),
        ("add_n", "add_n", [x, y, xi], {}, "grad"),
        ("ElementWiseSum", "ElementWiseSum", [x, y], {}, "grad"),
        ("_sum", "_sum", [x, y, y], {}, "grad"),
        ("_power", "_power", [grid_values(3, 5, **GRID_POS), y], {}, "grad"),
        ("pow", "pow", [grid_values(3, 5, **GRID_POS), y], {}, "grad"),
        ("_maximum_ties", "_maximum", [x, y], {}, "grad"),
        ("_minimum_ties", "_minimum", [x, y], {}, "grad"),
        ("_hypot", "_hypot", [x, y], {}, "grad"),
        ("_mod", "_mod", [x * 3, grid_values(3, 5, seed=5, lo=0.7, hi=1.9)], {},
         "grad"),
        ("mod_negative_divisor", "mod",
         [x * 3, -grid_values(3, 5, seed=5, lo=0.7, hi=1.9)], {}, "grad"),
    ]
    for name in ("elemwise_add", "_plus", "_add", "elemwise_sub", "_minus",
                 "_sub", "elemwise_mul", "_mul", "elemwise_div", "_div"):
        cases.append((name, name, [x, grid_values(3, 5, **GRID_POS)], {}, "grad"))
    for name in ("_equal", "_not_equal", "_greater", "_greater_equal",
                 "_lesser", "_lesser_equal", "_logical_and", "_logical_or",
                 "_logical_xor"):
        cases.append((name, name, [xi, yi], {}, "exact"))
    xs = with_values(x, 0.5, 0.5, -0.25)
    for name in ("_maximum_scalar", "_minimum_scalar", "_hypot_scalar",
                 "_plus_scalar", "_minus_scalar", "_rminus_scalar",
                 "_mul_scalar", "_div_scalar", "_rdiv_scalar"):
        cases.append((name, name, [xs], {"scalar": 0.5}, "grad"))
    for name in ("_equal_scalar", "_not_equal_scalar", "_greater_scalar",
                 "_greater_equal_scalar", "_lesser_scalar",
                 "_lesser_equal_scalar", "_logical_and_scalar",
                 "_logical_or_scalar", "_logical_xor_scalar"):
        cases.append((name, name, [with_values(xi, 0.0, 1.0)], {"scalar": 1.0},
                      "exact"))
    cases.append(("_logical_and_scalar_0", "_logical_and_scalar",
                  [with_values(xi, 0.0)], {"scalar": 0.0}, "exact"))
    return cases


def _grid_broadcast_reduce():
    a, b = grid_values(2, 3, 4), grid_values(1, 3, 1, seed=1)
    ai, bi = np.round(a), np.round(grid_values(2, 1, 4, seed=2))
    cases = [(n, n, [a, b], {}, "grad")
             for n in ("broadcast_plus", "broadcast_minus",
                       "broadcast_hypot")]
    cases += [(n, n, [np.round(a * 2) / 2, np.round(b * 2) / 2], {}, "grad")
              for n in ("broadcast_maximum", "broadcast_minimum")]
    cases += [(n, n, [ai, bi], {}, "exact")
              for n in ("broadcast_logical_and", "broadcast_logical_or",
                        "broadcast_logical_xor")]
    cases += [
        ("broadcast_like", "broadcast_like", [b, a], {}, "grad"),
        ("broadcast_like_axes", "broadcast_like", [grid_values(2, 1, 1), grid_values(5, 4, 3)],
         {"lhs_axes": (1, 2), "rhs_axes": (0, 2)}, "grad"),
        ("broadcast_axis", "broadcast_axis", [grid_values(2, 1, 4)],
         {"axis": 1, "size": 3}, "grad"),
        ("broadcast_axes", "broadcast_axes", [grid_values(1, 3, 1)],
         {"axis": (0, 2), "size": (2, 5)}, "grad"),
    ]
    tied = np.round(grid_values(2, 3, 4, seed=3))                  # many ties
    zeros = with_values(grid_values(2, 3, 4, seed=4), 0.0, 0.0)
    nans = with_values(grid_values(2, 3, 4, seed=5), np.nan, 0.0, np.nan)
    for name, x in (("prod", zeros), ("max", tied), ("min", tied),
                    ("nansum", nans), ("nanprod", nans)):
        for tag, attrs in (("all", {}), ("axis1", {"axis": 1}),
                           ("axes_keep", {"axis": (0, 2), "keepdims": True}),
                           ("exclude", {"axis": 1, "exclude": True}),
                           ("exclude_none", {"exclude": True}),
                           ("neg", {"axis": -1})):
            cases.append((f"{name}_{tag}", name, [x], attrs, "grad"))
    pos = grid_values(2, 3, 4, seed=6)
    for tag, attrs in (("all", {}), ("ord1", {"ord": 1}),
                       ("axis", {"axis": 1}),
                       ("axes_keep", {"axis": (1, 2), "keepdims": True}),
                       ("ord1_axis", {"ord": 1, "axis": -1}),
                       ("out_dtype", {"axis": 0, "out_dtype": "float16"})):
        cases.append((f"norm_{tag}", "norm", [pos], attrs,
                      "value" if "dtype" in tag else "grad"))
    for name in ("argmax", "argmin"):
        for tag, attrs in (("all", {}), ("axis1", {"axis": 1}),
                           ("keep", {"axis": 2, "keepdims": True})):
            cases.append((f"{name}_{tag}", name, [tied], attrs, "exact"))
    cases.append(("argmax_channel", "argmax_channel", [tied[0]], {},
                  "exact"))
    return cases


def _grid_nn():
    x = with_values(grid_values(2, 3, 4, 5), 0.0, -0.0)
    cases = [
        ("leaky", "LeakyReLU", [x], {"act_type": "leaky", "slope": 0.2},
         "grad"),
        ("prelu_channels", "LeakyReLU", [x, grid_values(3, seed=1, lo=0, hi=0.5)],
         {"act_type": "prelu"}, "grad"),
        ("prelu_one", "LeakyReLU", [x, np.array([0.3], "float32")],
         {"act_type": "prelu"}, "grad"),
        ("elu", "LeakyReLU", [x], {"act_type": "elu", "slope": 0.7}, "grad"),
        ("selu", "LeakyReLU", [x], {"act_type": "selu"}, "grad"),
        ("gelu", "LeakyReLU", [x], {"act_type": "gelu"}, "grad"),
        ("rrelu_inference", "LeakyReLU", [x],
         {"act_type": "rrelu", "is_train": False}, "grad"),
        ("instance_norm_4d", "InstanceNorm",
         [x * 3 + 1, grid_values(3, seed=2), grid_values(3, seed=3)], {}, "grad"),
        ("instance_norm_3d_eps", "InstanceNorm",
         [grid_values(2, 4, 7), grid_values(4, seed=2), grid_values(4, seed=3)], {"eps": 1e-5},
         "grad"),
        ("lrn_5", "LRN", [grid_values(2, 7, 3, 3)], {}, "grad"),
        ("lrn_3", "LRN", [grid_values(2, 4, 3, 3)],
         {"nsize": 3, "alpha": 0.1, "beta": 0.5, "knorm": 1.0}, "grad"),
        ("softmin", "softmin", [grid_values(3, 6)], {}, "grad"),
        ("softmin_axis_temp", "softmin", [grid_values(3, 6, 2)],
         {"axis": 1, "temperature": 2.0}, "grad"),
        ("softmax_activation", "SoftmaxActivation", [grid_values(3, 2, 4)], {},
         "grad"),
        ("softmax_activation_channel", "SoftmaxActivation",
         [grid_values(3, 4, 2, 2)], {"mode": "channel"}, "grad"),
        ("linear_regression", "LinearRegressionOutput",
         [grid_values(4, 1), grid_values(4, seed=1)], {"grad_scale": 0.5}, "grad"),
        ("logistic_regression", "LogisticRegressionOutput",
         [grid_values(4, 3), grid_values(4, 3, seed=1, lo=0, hi=1)], {}, "grad"),
        ("mae_regression", "MAERegressionOutput",
         [grid_values(4, 3), grid_values(4, 3, seed=1)], {"grad_scale": 2.0}, "grad"),
        ("svm_l2", "SVMOutput",
         [grid_values(4, 5), np.array([0, 3, 4, 1], "float32")],
         {"margin": 0.5, "regularization_coefficient": 0.7}, "grad"),
        ("svm_l1", "SVMOutput",
         [grid_values(4, 5), np.array([2, 3, 0, 1], "float32")],
         {"use_linear": True}, "grad"),
        ("upsampling_nearest", "UpSampling", [grid_values(2, 3, 4, 5)],
         {"scale": 2, "sample_type": "nearest"}, "grad"),
        ("upsampling_bilinear", "UpSampling", [grid_values(2, 3, 4, 5)],
         {"scale": 3, "sample_type": "bilinear"}, "grad"),
    ]
    return cases


def _grid_order_init():
    t = np.array([[3, 1, 3, 2, 0], [0, 5, 5, 1, 5], [2, 2, 2, 2, 2]],
                 "float32")
    v = with_values(grid_values(3, 5), *t.reshape(-1)[:5])
    cases = []
    for tag, attrs in (("", {}), ("_desc", {"is_ascend": False}),
                       ("_axis0", {"axis": 0}), ("_flat", {"axis": None})):
        cases.append((f"sort{tag}", "sort", [v], attrs, "grad"))
        cases.append((f"argsort{tag}", "argsort", [t], attrs, "exact"))
    cases += [
        ("argsort_int32", "argsort", [t], {"dtype": "int32"}, "exact"),
        ("topk_indices", "topk", [t], {"k": 3}, "exact"),
        ("topk_value", "topk", [t], {"k": 2, "ret_typ": "value"}, "exact"),
        ("topk_both_ascend", "topk", [t],
         {"k": 2, "ret_typ": "both", "is_ascend": True}, "exact"),
        ("topk_all", "topk", [t], {"k": 0, "ret_typ": "both"}, "exact"),
        ("topk_axis0", "topk", [t], {"axis": 0, "k": 2}, "exact"),
        ("topk_flat", "topk", [t], {"axis": None, "k": 4,
                                    "ret_typ": "both"}, "exact"),
        ("topk_mask_axis1", "topk", [t], {"axis": 1, "k": 2,
                                          "ret_typ": "mask"}, "exact"),
        ("topk_mask_1d", "topk", [t[1]], {"k": 2, "ret_typ": "mask"},
         "exact"),
        ("topk_int32", "topk", [t], {"k": 2, "dtype": "int32"}, "exact"),
        ("_full", "_full", [], {"shape": (2, 3), "value": 1.5}, "exact"),
        ("full_int", "full", [], {"shape": (4,), "value": 7,
                                  "dtype": "int32"}, "exact"),
        ("_arange_stop", "_arange", [], {"start": 5}, "exact"),
        ("_arange_float", "_arange", [],
         {"start": 0.1, "stop": 1.0, "step": 0.3}, "exact"),
        ("arange_repeat", "arange", [],
         {"start": 2, "stop": 8, "step": 2, "repeat": 3}, "exact"),
        ("_linspace", "_linspace", [], {"start": 0.0, "stop": 1.0,
                                        "num": 7}, "value"),
        ("linspace_open", "linspace", [],
         {"start": -1.0, "stop": 2.0, "num": 6, "endpoint": False}, "value"),
        ("_eye", "_eye", [], {"N": 3}, "exact"),
        ("eye_offset", "eye", [], {"N": 3, "M": 5, "k": 1}, "exact"),
        ("eye_below", "eye", [], {"N": 4, "M": 3, "k": -1,
                                  "dtype": "int32"}, "exact"),
    ]
    return cases


DENSE_OP_GROUPS = {"unary": _grid_unary, "elemwise": _grid_elemwise,
          "broadcast_reduce": _grid_broadcast_reduce, "nn": _grid_nn,
          "order_init": _grid_order_init}




def grid_cotangents(outs, seed):
    """Seeded head gradients for a case's outputs."""
    rs = np.random.RandomState(seed)
    return [rs.uniform(0.5, 1.5, o.shape).astype(np.float32) for o in outs]


def grid_grad_inputs(inputs, how):
    """Indices of the float inputs a case takes gradients for ("grad", and
    "exact_grad": outputs compared exactly, gradients by tolerance)."""
    if how not in ("grad", "exact_grad"):
        return []
    return [i for i, a in enumerate(inputs) if a.dtype == np.float32]


def run_grid_case(name, inputs, attrs, how, seed, device="cpu"):
    """One case through the port's registry op on ``device``: (outputs,
    gradients of the float inputs under ``grid_cotangents``), as numpy on
    the host (float16 outputs as float32; an input the op does not read
    gets None)."""
    from mxnet_tpu_torch.ops.registry import get_op
    dev = torch.device(device)
    ts = [torch.from_numpy(np.array(a)).to(dev) for a in inputs]
    gi = grid_grad_inputs(inputs, how)
    for i in gi:
        ts[i].requires_grad_()
    kw = dict(attrs)
    fn = get_op(name).fn
    if "device" in fn.__code__.co_varnames:
        kw["device"] = dev
    if "rng" in fn.__code__.co_varnames:
        kw["rng"] = torch.Generator(dev).manual_seed(SEED)
    out = fn(*ts, **kw)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    grads = []
    if gi:
        cts = grid_cotangents([o.detach().cpu().numpy() for o in outs], seed)
        torch.autograd.backward(outs, [torch.from_numpy(c).to(dev, o.dtype)
                                       for c, o in zip(cts, outs)])
        grads = [None if ts[i].grad is None else ts[i].grad.cpu().numpy()
                 for i in gi]
    return [(o.detach().float() if o.dtype == torch.float16 else
             o.detach()).cpu().numpy() for o in outs], grads


def grid_error(got, want) -> float:
    """max|got − want| / max|want| over the entries that are not NaN in
    ``want`` (NaN where the two disagree on which entries are NaN)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.array_equal(np.isnan(got),
                                                     np.isnan(want)):
        return float("nan")
    ok = ~np.isnan(want)
    if not ok.any():
        return 0.0
    scale = max(float(np.abs(want[ok]).max()), 1e-30)
    return float(np.abs(got[ok] - want[ok]).max()) / scale


def dense_op_grid(dev, tol=TOL_GRID):
    """Phase 24 (and ``tests/test_torch_gpu.py``): every case of
    ``DENSE_OP_GROUPS`` on the card against the same case on the CPU —
    discrete outputs equal, the rest and the gradients within ``tol`` of
    the case's largest entry; the CTC op at both blank conventions and
    with lengths; rrelu in training by its statistics. Returns the worst
    error and the number of cases; raises naming every failing case."""
    failed, worst, count = [], 0.0, 0
    for group, cases in DENSE_OP_GROUPS.items():
        for seed, (cid, name, inputs, attrs, how) in enumerate(cases()):
            count += 1
            want = run_grid_case(name, inputs, attrs, how, seed)
            got = run_grid_case(name, inputs, attrs, how, seed, dev)
            for g, w in zip(got[0], want[0]):
                if how == "exact":
                    if g.dtype != w.dtype or not np.array_equal(
                            g, w, equal_nan=True):
                        failed.append(f"{cid}: outputs differ")
                    continue
                err = grid_error(g, w)
                worst = max(worst, err) if err == err else worst
                if not err <= tol:
                    failed.append(f"{cid}: {err:.3e}")
            for g, w in zip(got[1], want[1]):
                g = np.zeros_like(w) if g is None and w is not None and \
                    not np.any(w) else g
                err = grid_error(g, w) if g is not None and w is not None \
                    else (0.0 if g is w else float("nan"))
                worst = max(worst, err) if err == err else worst
                if not err <= tol:
                    failed.append(f"{cid} (grad): {err:.3e}")
    x = -np.abs(grid_values(64, 1000, seed=9)) - 0.1
    slopes = run_grid_case("LeakyReLU", [x], {
        "act_type": "rrelu", "lower_bound": 0.1, "upper_bound": 0.4,
        "is_train": True}, "value", 0, dev)[0][0] / x
    if not (slopes.min() >= 0.1 - 1e-6 and slopes.max() <= 0.4 + 1e-6
            and abs(slopes.mean() - 0.25) < 0.01):
        failed.append(f"rrelu slopes {slopes.min()}..{slopes.max()}, "
                      f"mean {slopes.mean()}")
    if failed:
        raise AssertionError("op grid, card against CPU:\n"
                             + "\n".join(failed))
    return worst, count


def _layer_and_loss_grid(mx, dev, tol=TOL_GRID):
    """The six activation layers, ``InstanceNorm`` and every loss of
    ``gluon.loss`` (``CTCLoss`` eager and hybridized), eager on the card
    against the CPU from the same parameter values: outputs, the input's
    gradient and the parameters'."""
    from mxnet_tpu_torch import autograd, gluon
    nn, L = gluon.nn, gluon.loss
    x = np.concatenate([grid_values(2, 3, 4, 5),
                        np.zeros((1, 3, 4, 5), "float32")])
    layers = [("leaky_relu", lambda: nn.LeakyReLU(0.2)),
              ("prelu", lambda: nn.PReLU(alpha_initializer="ones")),
              ("elu", lambda: nn.ELU(0.7)), ("selu", nn.SELU),
              ("gelu", nn.GELU), ("swish", lambda: nn.Swish(1.5)),
              ("instance_norm", lambda: nn.InstanceNorm(in_channels=3))]
    pred, label = grid_values(4, 6), grid_values(4, 6, seed=1)
    binary = (grid_values(4, 6, seed=3) > 0).astype("float32")
    dist = np.exp(label) / np.exp(label).sum(-1, keepdims=True)
    ctc_x = grid_values(3, 7, 5, seed=8)
    ctc_label = np.array([[0, 1, 1], [2, -1, -1], [3, 3, 3]], "float32")
    losses = [
        ("l1", L.L1Loss, [pred, label]),
        ("sigmoid_bce", L.SigmoidBCELoss, [pred, binary]),
        ("kl_div", lambda: L.KLDivLoss(from_logits=False), [pred, dist]),
        ("huber", L.HuberLoss, [pred, label]),
        ("hinge", L.HingeLoss, [pred, binary * 2 - 1]),
        ("squared_hinge", L.SquaredHingeLoss, [pred, binary * 2 - 1]),
        ("logistic", L.LogisticLoss, [pred, binary * 2 - 1]),
        ("triplet", L.TripletLoss, [pred, label, grid_values(4, 6, seed=6)]),
        ("cosine_embedding", L.CosineEmbeddingLoss,
         [pred, label, np.array([1, -1, 1, -1], "float32")]),
        ("ctc", L.CTCLoss, [ctc_x, ctc_label]),
        ("ctc_hybridized", L.CTCLoss, [ctc_x, ctc_label]),
    ]

    def run(make, inputs, ctx, hybridize=False):
        block = make()
        block.initialize(ctx=ctx)
        if hybridize:
            block.hybridize()
        arrays = [mx.nd.array(a, ctx=ctx) for a in inputs]
        arrays[0].attach_grad()
        with autograd.record():
            out = block(*arrays)
        # a seeded head: under ones, InstanceNorm's input and gamma
        # gradients are 0 in exact arithmetic (rounding noise alone)
        head = grid_cotangents([out.asnumpy()], 0)[0]
        out.backward(mx.nd.array(head, ctx=ctx, dtype=out.dtype))
        params = sorted((k, p.grad.asnumpy()) for k, p in
                        block.collect_params().items()
                        if p.grad_req != "null")
        return [out.asnumpy(), arrays[0].grad.asnumpy()] + [
            g for _, g in params]

    failed, worst = [], 0.0
    cases = [(c, m, [x], False) for c, m in layers] + [
        (c, m, i, c.endswith("hybridized")) for c, m, i in losses]
    for cid, make, inputs, hyb in cases:
        want = run(make, inputs, mx.cpu(), hyb)
        got = run(make, inputs, _ctx(mx, dev), hyb)
        for g, w in zip(got, want):
            err = grid_error(g, w)
            worst = max(worst, err) if err == err else worst
            if not err <= tol:
                failed.append(f"{cid}: {err:.3e}")
    if failed:
        raise AssertionError("layers and losses, card against CPU:\n"
                             + "\n".join(failed))
    return worst, len(cases)


def op_grid_phase(mx, dev):
    """Phase 24: every op, layer and loss of slices 11 and 12 on the card
    against the CPU (no Hopper kernel may launch)."""
    t0 = time.perf_counter()
    ops_worst, n_ops = dense_op_grid(dev)
    layers_worst, n_layers = _layer_and_loss_grid(mx, dev)
    print(f"op grid: {n_ops} op cases and {n_layers} layers and losses on "
          f"the card against the CPU: discrete outputs equal, the rest "
          f"within {ops_worst:.2e} (ops) and {layers_worst:.2e} (layers, "
          f"losses) of the largest entry (tolerance {TOL_GRID}); "
          f"{time.perf_counter() - t0:.1f} s")
    library_grid_phase(mx, dev)


# --------------------------------------------- slice 11: route H, DCGAN
# DCGAN of Radford, Metz & Chintala (arXiv:1511.06434) at 64x64, as Apache
# MXNet's example/gluon/dcgan.py and the authors' dcgan.torch build it: the
# paper's batch, Adam lr 2e-4 and beta1 0.5; synthetic images (no dataset
# in the repo); nothing cut.
DCGAN = dict(ngf=64, ndf=64, nz=100, nc=3, image=64, batch=128, lr=2e-4,
             beta1=0.5)
DCGAN_TIMED = 10            # iterations timed, after two warm-up ones
# iteration 1 in float32 (TF32 off) against the same iteration in float64
# on the card: each loss relative (cuDNN's choice of f32 algorithm moves
# it by up to 1.25e-5), D's logits of the largest, every gradient by
# ||dg|| / ||g||: D's output layer tightly; the rest of the D step within
# 5e-3 (its first layers 0.7-1.2e-3 on an H100); the G step loosely. At
# initialisation D rejects G's images (errG ~5.9) and the G step's
# backward through D and the four BatchNorms is ill-conditioned: float32
# against float64 differs by up to 6.8e-3 per tensor on the CPU at batch
# 128 and 2.8e-2 with cuDNN's f32 algorithms, the TF32 control 6.6e-2.
TOL_GAN_LOSS = 3e-5
TOL_GAN_LOGITS = 1e-4
TOL_GAN_GRAD_TOP = 1e-4      # D's output convolution
TOL_GAN_GRAD_D = 5e-3
TOL_GAN_GRAD_G = 0.1
GAN_TOP = "disc_conv2d4_"


def build_dcgan64(nn, ngf=64, ndf=64, nz=100, nc=3):
    """(generator, discriminator) of the 64x64 DCGAN from ``nn`` (the
    port's ``gluon.nn`` or the JAX package's): G is ``Conv2DTranspose``
    nz→8·ngf (4, 1, 0), then →4·ngf→2·ngf→ngf (4, 2, 1), each with
    ``BatchNorm`` and ReLU, then →nc (4, 2, 1) and tanh; D is ``Conv2D``
    nc→ndf (4, 2, 1) with ``LeakyReLU(0.2)``, then →2·ndf→4·ndf→8·ndf
    (4, 2, 1), each with ``BatchNorm`` and ``LeakyReLU(0.2)``, then →1
    (4, 1, 0). No convolution has a bias. ``nz`` is read from the noise."""
    del nz
    gen = nn.HybridSequential(prefix="gen_")
    with gen.name_scope():
        for i, mult in enumerate((8, 4, 2, 1)):
            gen.add(nn.Conv2DTranspose(ngf * mult, 4, 1 if i == 0 else 2,
                                       0 if i == 0 else 1, use_bias=False))
            gen.add(nn.BatchNorm())
            gen.add(nn.Activation("relu"))
        gen.add(nn.Conv2DTranspose(nc, 4, 2, 1, use_bias=False))
        gen.add(nn.Activation("tanh"))
    disc = nn.HybridSequential(prefix="disc_")
    with disc.name_scope():
        disc.add(nn.Conv2D(ndf, 4, 2, 1, use_bias=False))
        disc.add(nn.LeakyReLU(0.2))
        for mult in (2, 4, 8):
            disc.add(nn.Conv2D(ndf * mult, 4, 2, 1, use_bias=False))
            disc.add(nn.BatchNorm())
            disc.add(nn.LeakyReLU(0.2))
        disc.add(nn.Conv2D(1, 4, 1, 0, use_bias=False))
    return gen, disc


def dcgan_d_step(pkg, net_g, net_d, tr_d, loss_fn, data, noise, real, fake):
    """The D half of ``example/gluon/dcgan.py``'s iteration in ``pkg`` (the
    port or the JAX package): errD on real and fake images, backward, one
    trainer step. Returns (errD, D's logits of the real batch)."""
    with pkg.autograd.record():
        out_real = net_d(data).reshape((-1,))
        err_real = loss_fn(out_real, real)
        out_fake = net_d(net_g(noise).detach()).reshape((-1,))
        err_d = err_real + loss_fn(out_fake, fake)
    err_d.backward()
    tr_d.step(data.shape[0])
    return err_d, out_real


def dcgan_g_step(pkg, net_g, net_d, tr_g, loss_fn, noise, real):
    """The G half: errG of D's verdict on G's images, backward, a step."""
    with pkg.autograd.record():
        err_g = loss_fn(net_d(net_g(noise)).reshape((-1,)), real)
    err_g.backward()
    tr_g.step(noise.shape[0])
    return err_g


def dcgan_setup(mx, ctx, weights=None, dtype="float32"):
    """The nets at ``DCGAN``'s widths on ``ctx`` (``Normal(0.02)`` from the
    port's seed, or ``weights``, G's and D's by name), cast to ``dtype``,
    with their Adam trainers and the loss."""
    from mxnet_tpu_torch import gluon, interop
    c = DCGAN
    net_g, net_d = build_dcgan64(gluon.nn, c["ngf"], c["ndf"], c["nz"],
                                 c["nc"])
    mx.random.seed(SEED)
    for net in (net_g, net_d):
        net.initialize(mx.init.Normal(0.02), ctx=ctx)
    with mx.autograd.pause():
        net_d(net_g(mx.nd.zeros((2, c["nz"], 1, 1), ctx=ctx)))
    if weights is not None:
        for net, w in zip((net_g, net_d), weights):
            interop.load_block_params(net, w)
    for net in (net_g, net_d):
        for p in net.collect_params().values():
            if dtype != "float32":
                p.cast(dtype)
    opt = {"learning_rate": c["lr"], "beta1": c["beta1"]}
    trainers = [gluon.Trainer(n.collect_params(), "adam", dict(opt))
                for n in (net_g, net_d)]
    return net_g, net_d, trainers, gluon.loss.SigmoidBinaryCrossEntropyLoss()


def dcgan_batch(mx, ctx, step, dtype="float32"):
    """(images in [−1, 1], noise) of one iteration, seeded by ``step``:
    drawn by the CPU's generator (the card's draws other values from a
    seed) and copied to ``ctx``."""
    c = DCGAN
    gen = torch.Generator().manual_seed(SEED + step)
    dev, dt = ctx.torch_device(), mx.nd.torch_dtype(dtype)
    data = torch.rand(c["batch"], c["nc"], c["image"], c["image"],
                      generator=gen).mul_(2).sub_(1)
    noise = torch.randn(c["batch"], c["nz"], 1, 1, generator=gen)
    return (mx.nd.NDArray(data.to(dev, dt)),
            mx.nd.NDArray(noise.to(dev, dt)))


def _gan_grads(net):
    return {k: p.grad._data.detach().double().clone()
            for k, p in net.collect_params().items()
            if p.grad_req != "null"}


def _gan_iteration_one(mx, ctx, weights, dtype):
    """Iteration 1 from ``weights`` in ``dtype``: (errD, errG, D's logits,
    D's gradients after the D step, G's after the G step)."""
    net_g, net_d, (tr_g, tr_d), loss_fn = dcgan_setup(mx, ctx, weights,
                                                      dtype)
    data, noise = dcgan_batch(mx, ctx, 0, dtype)
    b = DCGAN["batch"]
    real = mx.nd.ones((b,), ctx=ctx, dtype=dtype)
    fake = mx.nd.zeros((b,), ctx=ctx, dtype=dtype)
    err_d, logits = dcgan_d_step(mx, net_g, net_d, tr_d, loss_fn, data,
                                 noise, real, fake)
    g_d = _gan_grads(net_d)
    err_g = dcgan_g_step(mx, net_g, net_d, tr_g, loss_fn, noise, real)
    return (float(err_d.mean().asscalar()), float(err_g.mean().asscalar()),
            logits._data.detach().double(), g_d, _gan_grads(net_g))


def _gan_tensor_errors(run, ref):
    """{(half, name): (||dg|| / ||g||, ||g||)} of every gradient of
    ``run`` against ``ref`` (D's after the D step, G's after the G
    step)."""
    return {(half, n): (_norm_rel(g, ref[k][n]), ref[k][n].norm().item())
            for k, half in ((3, "D"), (4, "G")) for n, g in run[k].items()}


def _gan_errors(run, ref):
    """(loss, logits, D's output layer, the rest of the D step, the G
    step) errors of ``run`` against ``ref``, each the worst."""
    loss = max(abs(run[i] - ref[i]) / abs(ref[i]) for i in (0, 1))
    logits = ((run[2] - ref[2]).abs().max() / ref[2].abs().max()).item()
    per = _gan_tensor_errors(run, ref)

    def worst(keep):
        return max(e for k, (e, _) in per.items() if keep(k))
    return (loss, logits, worst(lambda k: k[1].startswith(GAN_TOP)),
            worst(lambda k: k[0] == "D" and not k[1].startswith(GAN_TOP)),
            worst(lambda k: k[0] == "G"))


def dcgan_phase(mx, hk, dev, profile=False):
    """Route H (phase 25): the 64x64 DCGAN trained through gluon on the
    card. Iteration 1 (the D step on real and fake, then the G step, two
    Adam trainers) against the same iteration in float64 on the card —
    both losses, D's logits, every gradient — with a TF32 control that
    must miss; then ``DCGAN_TIMED`` timed iterations (ms, images/s, peak
    memory, host dispatch beside the device time, for the iteration and
    each half), the losses finite, a ``torch.profiler`` breakdown (busy
    share). No Hopper kernel may launch."""
    from mxnet_tpu_torch import interop
    c, ctx = DCGAN, _ctx(mx, dev)
    net_g, net_d, _, _ = dcgan_setup(mx, ctx)
    n_g = sum(p.data().size for p in net_g.collect_params().values()
              if p.grad_req != "null")
    n_d = sum(p.data().size for p in net_d.collect_params().values()
              if p.grad_req != "null")
    weights = [interop.block_params_to_numpy(n) for n in (net_g, net_d)]
    del net_g, net_d
    print(f"dcgan: G {n_g:,} and D {n_d:,} trainable parameters at ngf = "
          f"ndf = {c['ngf']}, nz {c['nz']}, 64x64x{c['nc']}, batch "
          f"{c['batch']}")
    hk.reset_launch_counts()
    run = _gan_iteration_one(mx, ctx, weights, "float32")
    ref = _gan_iteration_one(mx, ctx, weights, "float64")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = _gan_iteration_one(mx, ctx, weights, "float32")
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    errs, ctl = _gan_errors(run, ref), _gan_errors(control, ref)
    tols = (TOL_GAN_LOSS, TOL_GAN_LOGITS, TOL_GAN_GRAD_TOP, TOL_GAN_GRAD_D,
            TOL_GAN_GRAD_G)
    print(f"dcgan: iteration 1 against float64 (loss, D's logits, "
          f"||dg||/||g|| of D's output layer, of the rest of the D step, of "
          f"the G step): {', '.join(f'{e:.2e}' for e in errs)} (tolerances "
          f"{tols}); TF32 control {', '.join(f'{e:.2e}' for e in ctl)}; "
          f"errD {run[0]:.6f} errG {run[1]:.6f}")
    per = _gan_tensor_errors(run, ref)
    per_ctl = _gan_tensor_errors(control, ref)
    for half in ("D", "G"):      # the four worst tensors of each step
        worst = sorted((kv for kv in per.items() if kv[0][0] == half),
                       key=lambda kv: -kv[1][0])[:4]
        for key, (e, norm) in worst:
            print(f"dcgan: {half} step {key[1]}: ||dg||/||g|| {e:.2e} "
                  f"(TF32 {per_ctl[key][0]:.2e}), ||g64|| {norm:.3e}")
    if not all(e <= t for e, t in zip(errs, tols)):
        raise AssertionError("dcgan: iteration 1 is not within its "
                             "tolerances of the float64 iteration")
    if all(e <= t for e, t in zip(ctl, tols)):
        raise AssertionError("dcgan: the TF32 control met every tolerance")
    del run, ref, control
    _free()

    net_g, net_d, (tr_g, tr_d), loss_fn = dcgan_setup(mx, ctx, weights)
    real = mx.nd.ones((c["batch"],), ctx=ctx)
    fake = mx.nd.zeros((c["batch"],), ctx=ctx)
    batches = [dcgan_batch(mx, ctx, i) for i in range(DCGAN_TIMED + 3)]
    losses, halves = [], {"D": [], "G": []}

    def d_half(i):
        return dcgan_d_step(mx, net_g, net_d, tr_d, loss_fn, batches[i][0],
                            batches[i][1], real, fake)[0]

    def g_half(i):
        return dcgan_g_step(mx, net_g, net_d, tr_g, loss_fn, batches[i][1],
                            real)

    torch.cuda.reset_peak_memory_stats()
    for i in range(DCGAN_TIMED + 2):
        out = {}
        for name, half in (("D", d_half), ("G", g_half)):
            def step(half=half, name=name):
                out[name] = half(i)
            if i >= 2:
                halves[name].append(_timed_step(step))
            else:
                step()
        losses.append((out["D"].mean(), out["G"].mean()))
    values = [(float(d.asscalar()), float(g.asscalar())) for d, g in losses]
    if not np.isfinite(values).all():
        raise AssertionError(f"dcgan: a loss is not finite: {values}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    line = []
    for name in ("D", "G"):
        host = 1e3 * float(np.median([h for h, _, _ in halves[name]]))
        devms = float(np.median([d for _, d, _ in halves[name]]))
        wall = 1e3 * float(np.median([w for _, _, w in halves[name]]))
        line.append(f"{name} half {wall:.2f} ms ({devms:.2f} on the card, "
                    f"host dispatch {host:.2f})")
    it_wall = 1e3 * float(np.median([a[2] + b[2] for a, b in zip(
        halves["D"], halves["G"])]))
    it_dev = float(np.median([a[1] + b[1] for a, b in zip(
        halves["D"], halves["G"])]))
    it_host = 1e3 * float(np.median([a[0] + b[0] for a, b in zip(
        halves["D"], halves["G"])]))
    print(f"dcgan: {DCGAN_TIMED} timed iterations: an iteration "
          f"{it_wall:.2f} ms ({it_dev:.2f} ms on the card, host dispatch "
          f"{it_host:.2f} ms), {1e3 * c['batch'] / it_wall:.1f} images/s; "
          f"{'; '.join(line)}; peak memory {peak:.2f} GB; errD "
          f"{values[0][0]:.4f} -> {values[-1][0]:.4f}, errG "
          f"{values[0][1]:.4f} -> {values[-1][1]:.4f}; card {_card_line()}")
    profile_breakdown("dcgan iteration", lambda: (d_half(DCGAN_TIMED + 2),
                                                  g_half(DCGAN_TIMED + 2)))
    if any(hk.launch_counts.values()):
        raise AssertionError(f"route H launched a Hopper kernel: "
                             f"{dict(hk.launch_counts)}")


# ------------------------------------------------- slice 11: route I, CTC
# a speech batch: 32 utterances of 400 frames, 28 graphemes and the blank
# (last), label lengths 40-120 (one row needs more frames than it has)
CTC_CARD = dict(batch=32, frames=400, classes=29, min_label=40,
                max_label=120)
TOL_CTC_LOSS = 1e-6          # relative, card float32 against float64
TOL_CTC_GRAD = 1e-5          # of the logits' gradient's largest entry
OCR_BAR = 0.65               # tests/test_examples.py's thresholds
SPEECH_BAR = 0.35


def ctc_batch(seed=SEED):
    """(logits (N, T, C), labels (N, Lmax) padded with −1, the label
    lengths, the frame lengths): row 0 repeats one grapheme 120 times,
    which needs 239 frames, and is given half of its 400."""
    c = CTC_CARD
    rs = np.random.RandomState(seed)
    lens = rs.randint(c["min_label"], c["max_label"] + 1, c["batch"])
    labels = np.full((c["batch"], c["max_label"]), -1, "float32")
    for i, n in enumerate(lens):
        labels[i, :n] = rs.randint(0, c["classes"] - 1, n)
    labels[0, :c["max_label"]] = 3
    lens[0] = c["max_label"]
    logits = rs.randn(c["batch"], c["frames"], c["classes"]).astype(
        "float32")
    frames = np.full(c["batch"], c["frames"], "float32")
    frames[0] = c["frames"] // 2
    return logits, labels, lens, frames


def ctc_phase(mx, hk, dev):
    """Route I (phase 26): ``gluon.loss.CTCLoss`` at a speech batch on the
    card in float32 against float64 on the card (loss, the logits'
    gradient), timed forward and backward beside ``F.ctc_loss`` (the
    library's call, not on the path); then the ``lstm_ocr`` and
    ``speech_ctc`` twins trained on the card at their own widths against
    the JAX recipes' test thresholds. No Hopper kernel may launch."""
    from mxnet_tpu_torch import autograd, gluon
    ctx = _ctx(mx, dev)
    logits, labels, lens, frames = ctc_batch()
    c = CTC_CARD
    hk.reset_launch_counts()
    loss_fn = gluon.loss.CTCLoss()

    def run(dtype):
        x = mx.nd.array(logits, ctx=ctx, dtype=dtype)
        x.attach_grad()
        with autograd.record():
            loss = loss_fn(x, mx.nd.array(labels, ctx=ctx),
                           mx.nd.array(frames, ctx=ctx))
        loss.backward()
        return loss._data.detach(), x.grad._data.detach().double()

    (l32, g32), (l64, g64) = run("float32"), run("float64")
    loss_err = ((l32 - l64).abs() / l64.abs()).max().item()
    grad_err = ((g32 - g64).abs().max() / g64.abs().max()).item()
    print(f"ctc: CTCLoss at ({c['batch']}, {c['frames']}, {c['classes']}), "
          f"labels {int(lens.min())}-{int(lens.max())}, row 0 given "
          f"{int(frames[0])} frames for {2 * int(lens[0]) - 1} needed: "
          f"float32 against "
          f"float64 on the card: loss {loss_err:.2e} (tolerance "
          f"{TOL_CTC_LOSS}), gradient {grad_err:.2e} of its largest "
          f"(tolerance {TOL_CTC_GRAD}); the impossible row's loss "
          f"{l32[0].item():.6e} (finite, optax's log_epsilon)")
    if not (loss_err <= TOL_CTC_LOSS and grad_err <= TOL_CTC_GRAD):
        raise AssertionError("ctc: float32 is not within its tolerances of "
                             "float64")
    if not (torch.isfinite(l32).all() and l32[0].item() > 1e5 - 1e4):
        raise AssertionError(f"ctc: the impossible row is not finite and "
                             f"≈1e5: {l32[0].item()}")
    x = mx.nd.array(logits, ctx=ctx)
    x.attach_grad()
    y, lengths = mx.nd.array(labels, ctx=ctx), mx.nd.array(frames, ctx=ctx)

    def port():
        with autograd.record():
            loss = loss_fn(x, y, lengths)
        loss.backward()

    lx = torch.tensor(logits, device=dev).transpose(0, 1).contiguous() \
        .requires_grad_()
    targets = torch.tensor(np.where(labels < 0, 0, labels), device=dev,
                           dtype=torch.long)
    in_lens = torch.tensor(frames, dtype=torch.long, device=dev)
    tgt_lens = torch.tensor(lens, dtype=torch.long, device=dev)

    def library():
        out = torch.nn.functional.ctc_loss(
            torch.log_softmax(lx, -1), targets, in_lens, tgt_lens,
            blank=c["classes"] - 1, reduction="none", zero_infinity=True)
        out.sum().backward()

    port_ms = _time_ms(port, 5)
    library_ms = _time_ms(library, 5)
    host, dev_ms, _ = _timed_step(port)
    print(f"ctc: forward and backward {port_ms:.2f} ms (host dispatch "
          f"{1e3 * host:.2f} ms, {dev_ms:.2f} ms between events); "
          f"F.ctc_loss (cuDNN/native, not on the path) {library_ms:.2f} ms; "
          f"card {_card_line()}")
    ocr = _load_example("example/ctc/lstm_ocr_torch.py", "lstm_ocr_torch")
    t0 = time.perf_counter()
    first, last, acc = ocr.train(epochs=3, steps_per_epoch=20,
                                 verbose=False, ctx=ctx)
    ocr_s = time.perf_counter() - t0
    speech = _load_example("example/speech_recognition/speech_ctc_torch.py",
                           "speech_ctc_torch")
    t0 = time.perf_counter()
    per0, per1 = speech.train(epochs=16, verbose=False, ctx=ctx)
    speech_s = time.perf_counter() - t0
    print(f"ctc: lstm_ocr twin on the card, 3 epochs of 20 steps: loss "
          f"{first:.3f} -> {last:.3f} (bar {OCR_BAR}x the first), exact "
          f"match {acc:.2f}, {ocr_s:.1f} s; speech_ctc twin, 16 epochs: "
          f"phone error rate {per0:.3f} -> {per1:.3f} (bar {SPEECH_BAR}), "
          f"{speech_s:.1f} s")
    if not (last < OCR_BAR * first and per1 < SPEECH_BAR):
        raise AssertionError("ctc: a twin missed the JAX recipe's "
                             "threshold")
    if any(hk.launch_counts.values()):
        raise AssertionError(f"route I launched a Hopper kernel: "
                             f"{dict(hk.launch_counts)}")
    return port_ms, library_ms




# ------------------------------------------ slice 12: the op library grid
# The cases of every deterministic op slice 12 adds (phase 24 on the card
# against the CPU; ``tests/test_torch_op_library.py`` against the JAX
# package), in the op grid's form: (case id, op name, numpy inputs, attrs,
# what to compare). "signs" compares the outputs of ``gelqf``/``syevd``
# after ``canonical_signs`` (a factor's rows are unique up to sign).
TOL_LINALG = 1e-5        # of the case's largest |value|, linalg


def spd(n, batch=(), seed=0):
    """A well-conditioned symmetric positive-definite M·Mᵀ + n·I."""
    m = grid_values(*batch, n, n, seed=seed, lo=-1, hi=1).astype("float64")
    a = m @ np.swapaxes(m, -1, -2) + n * np.eye(n)
    return a.astype("float32")


def _grid_matrix_index():
    x = grid_values(4, 5, 6)
    idx = np.array([-3, 0, 7, 2.7, -0.5], "float32")
    nd_idx = np.array([[0, 2, -1, 7], [1, -9, 3, 0]], "float32")
    sc_idx = np.array([[0, 1, 5, 2], [1, 3, 0, -1]], "float32")
    return [
        ("batch_dot", "batch_dot", [grid_values(2, 3, 4),
                                    grid_values(2, 4, 5, seed=1)], {}, "grad"),
        ("batch_dot_ta_tb", "batch_dot",
         [grid_values(2, 4, 3), grid_values(2, 5, 4, seed=1)],
         {"transpose_a": True, "transpose_b": True}, "grad"),
        ("slice", "slice", [x], {"begin": (1, 0), "end": (3, 4)}, "grad"),
        ("slice_open_negative_step", "slice", [x],
         {"begin": (None, 4), "end": (None, 0), "step": (1, -2)}, "grad"),
        ("crop", "crop", [x], {"begin": (0, 1, 2), "end": (2, 3, 5),
                               "step": (1, 1, 2)}, "grad"),
        ("tile", "tile", [grid_values(2, 3)], {"reps": (2, 1, 3)}, "grad"),
        ("tile_short", "tile", [grid_values(2, 3, 2)], {"reps": (2,)},
         "grad"),
        ("repeat_axis", "repeat", [grid_values(2, 3)],
         {"repeats": 2, "axis": 1}, "grad"),
        ("repeat_flat", "repeat", [grid_values(2, 3)], {"repeats": 3},
         "grad"),
        ("diag_1d", "diag", [grid_values(4)], {"k": 1}, "grad"),
        ("diag_2d", "diag", [grid_values(4, 5)], {"k": -1}, "grad"),
        ("diag_3d", "diag", [x], {"k": 1, "axis1": 1, "axis2": 2}, "grad"),
        ("shape_array", "shape_array", [x], {}, "exact"),
        ("size_array", "size_array", [x], {}, "exact"),
        ("take_clip", "take", [grid_values(5, 3), idx], {}, "grad"),
        ("take_raise", "take", [grid_values(5, 3), idx], {"mode": "raise"},
         "grad"),
        ("take_wrap_axis1", "take", [grid_values(3, 5), idx],
         {"axis": 1, "mode": "wrap"}, "grad"),
        ("batch_take", "batch_take",
         [grid_values(3, 4), np.array([1, 5, -1], "float32")], {}, "grad"),
        ("one_hot", "one_hot", [np.array([0, 2, 5, -1, 1.7], "float32")],
         {"depth": 4, "on_value": 2.0, "off_value": -1.0}, "exact"),
        ("gather_nd", "gather_nd", [grid_values(3, 4), nd_idx], {}, "grad"),
        ("gather_nd_rows", "gather_nd",
         [grid_values(3, 4, 2), nd_idx[:1]], {}, "grad"),
        ("scatter_nd", "scatter_nd", [grid_values(4), sc_idx],
         {"shape": (3, 4)}, "grad"),
        ("scatter_nd_rows", "scatter_nd",
         [grid_values(3, 2), np.array([[2, 0, 9]], "float32")],
         {"shape": (4, 2)}, "grad"),
        ("_scatter_set_nd", "_scatter_set_nd",
         [grid_values(3, 4), grid_values(4, seed=1), sc_idx],
         {"shape": (3, 4)}, "grad"),
        ("unravel_index", "unravel_index",
         [np.array([0, 5, 11, 13, -1, -14], "float32")],
         {"shape": (3, 4)}, "exact"),
        ("ravel_multi_index", "_ravel_multi_index",
         [np.array([[0, 2, 5, -1], [1, -1, 3, 2]], "float32")],
         {"shape": (3, 4)}, "exact"),
    ]


def _grid_spatial():
    # no grid point within float32 rounding of the image's border (the JAX
    # package computes the grid in float64: ROADMAP C)
    theta = np.array([[0.9, 0.1, 0.07, -0.2, 1.1, 0.13],
                      [1.2, -0.3, -0.11, 0.2, 0.8, 0.03]], "float32")
    data = grid_values(2, 3, 5, 6)
    grid = grid_values(2, 2, 4, 7, seed=1, lo=-1.2, hi=1.2)
    return [
        ("grid_affine", "GridGenerator", [theta],
         {"transform_type": "affine", "target_shape": (3, 4)}, "grad"),
        ("grid_warp", "GridGenerator", [grid],
         {"transform_type": "warp"}, "grad"),
        ("bilinear_sampler", "BilinearSampler", [data, grid], {}, "grad"),
        ("spatial_transformer", "SpatialTransformer", [data, theta],
         {"target_shape": (4, 5)}, "grad"),
    ]


def _grid_tail():
    img = np.random.RandomState(4).randint(0, 256, (5, 6, 3)).astype("uint8")
    return [
        ("_grad_add", "_grad_add", [grid_values(3, 4),
                                    grid_values(3, 4, seed=1)], {}, "grad"),
        ("_square_sum", "_square_sum", [grid_values(3, 4)], {}, "grad"),
        ("_square_sum_axis", "_square_sum", [grid_values(3, 4, 2)],
         {"axis": 1, "keepdims": True}, "grad"),
        ("_square_sum_axes", "_square_sum", [grid_values(3, 4, 2)],
         {"axis": (0, 2)}, "grad"),
        ("_scatter_elemwise_div", "_scatter_elemwise_div",
         [grid_values(3, 4), grid_values(3, 4, seed=1, **GRID_POS)], {},
         "grad"),
        ("_scatter_plus_scalar", "_scatter_plus_scalar", [grid_values(3, 4)],
         {"scalar": 1.5}, "grad"),
        ("_scatter_minus_scalar", "_scatter_minus_scalar",
         [grid_values(3, 4)], {"scalar": 0.5}, "grad"),
        ("div_sqrt_dim", "_contrib_div_sqrt_dim", [grid_values(2, 3, 8)], {},
         "grad"),
        ("image_to_tensor", "_image_to_tensor", [img], {}, "value"),
        ("image_to_tensor_batch", "image_to_tensor",
         [np.stack([img, img[::-1]])], {}, "value"),
        ("image_normalize", "_image_normalize", [grid_values(3, 4, 5)],
         {"mean": (0.5, 0.4, 0.3), "std": (0.2, 0.3, 0.4)}, "grad"),
        ("image_normalize_scalar", "image_normalize",
         [grid_values(2, 3, 4, 5)], {"mean": 0.5, "std": 2.0}, "grad"),
    ]


def _grid_linalg():
    a, b = grid_values(2, 3, 4), grid_values(2, 4, 5, seed=1)
    s = spd(4, (2,))
    low = np.tril(grid_values(2, 4, 4, seed=2, lo=-0.5, hi=0.5)) \
        + 2 * np.eye(4, dtype="float32")
    rhs = grid_values(2, 4, 3, seed=3)
    sq = grid_values(2, 4, 4, seed=5) + 3 * np.eye(4, dtype="float32")
    return [
        ("gemm", "_linalg_gemm", [a, b, grid_values(2, 3, 5, seed=2)],
         {"alpha": 0.5, "beta": 2.0}, "grad"),
        ("gemm_t", "linalg_gemm",
         [np.swapaxes(a, 1, 2).copy(), np.swapaxes(b, 1, 2).copy(),
          grid_values(2, 3, 5, seed=2)],
         {"transpose_a": True, "transpose_b": True}, "grad"),
        ("gemm2", "_linalg_gemm2", [a, b], {"alpha": 1.5}, "grad"),
        ("potrf", "_linalg_potrf", [s], {}, "value"),
        ("potrf_upper", "linalg_potrf", [s], {"lower": False}, "value"),
        ("potri", "_linalg_potri", [low], {}, "grad"),
        ("potri_upper", "linalg_potri",
         [np.swapaxes(low, 1, 2).copy()], {"lower": False}, "grad"),
        ("trsm", "_linalg_trsm", [low, rhs], {"alpha": 2.0}, "grad"),
        ("trsm_t", "linalg_trsm", [low, rhs], {"transpose": True}, "grad"),
        ("trsm_right_upper", "linalg_trsm",
         [np.swapaxes(low, 1, 2).copy(), np.swapaxes(rhs, 1, 2).copy()],
         {"rightside": True, "lower": False}, "grad"),
        ("trmm", "_linalg_trmm", [low, rhs], {"alpha": 0.5}, "grad"),
        ("trmm_t_right", "linalg_trmm",
         [low, np.swapaxes(rhs, 1, 2).copy()],
         {"transpose": True, "rightside": True}, "grad"),
        ("trmm_upper", "linalg_trmm", [sq, rhs], {"lower": False}, "grad"),
        ("syrk", "_linalg_syrk", [a], {"alpha": 2.0}, "grad"),
        ("syrk_t", "linalg_syrk", [a], {"transpose": True}, "grad"),
        ("sumlogdiag", "_linalg_sumlogdiag", [s], {}, "grad"),
        ("extractdiag", "_linalg_extractdiag", [sq], {"offset": 1}, "grad"),
        ("makediag", "_linalg_makediag", [grid_values(2, 3)], {}, "grad"),
        ("makediag_below", "linalg_makediag", [grid_values(2, 3)],
         {"offset": -1}, "grad"),
        ("extracttrian", "_linalg_extracttrian", [sq], {}, "grad"),
        ("extracttrian_below", "linalg_extracttrian", [sq],
         {"offset": -1}, "grad"),
        ("extracttrian_upper", "linalg_extracttrian", [sq],
         {"offset": 1, "lower": False}, "grad"),
        ("maketrian", "_linalg_maketrian", [grid_values(2, 10)], {}, "grad"),
        ("maketrian_below", "linalg_maketrian", [grid_values(2, 6)],
         {"offset": -1}, "grad"),
        ("maketrian_upper", "linalg_maketrian", [grid_values(2, 6)],
         {"offset": 1, "lower": False}, "grad"),
        ("inverse", "_linalg_inverse", [sq], {}, "grad"),
        ("det", "_linalg_det", [sq], {}, "grad"),
        ("slogdet", "_linalg_slogdet", [sq - 6 * np.eye(4, dtype="float32")],
         {}, "value"),
        ("gelqf", "_linalg_gelqf", [grid_values(2, 3, 5)], {}, "signs"),
        ("syevd", "_linalg_syevd", [s], {}, "signs"),
    ]


def _grid_parity():
    w, g = grid_values(3, 4), grid_values(3, 4, seed=1)
    pos = grid_values(3, 4, seed=2, **GRID_POS)
    st = grid_values(3, 4, seed=3, lo=0.1, hi=0.5)
    clip = {"clip_gradient": 1.5, "wd": 0.01, "rescale_grad": 0.5}
    scores = with_values(grid_values(2, 4, 3, seed=7, lo=0, hi=1), 0.9,
                         0.9)
    adj = np.array([[0, 3, 0], [1, 0, 2], [0, 4, 0]], "float32")
    return [
        ("sgd_update", "sgd_update", [w, g], dict(lr=0.1, **clip), "value"),
        ("sgd_mom_update", "sgd_mom_update", [w, g, st],
         dict(lr=0.1, momentum=0.9, **clip), "value"),
        ("mp_sgd_update", "mp_sgd_update", [w.astype("float16"), g, w],
         {"lr": 0.1, "wd": 0.01}, "value"),
        ("mp_sgd_mom_update", "mp_sgd_mom_update",
         [w.astype("float16"), g, st, w], {"lr": 0.1, "momentum": 0.9},
         "value"),
        ("adam_update", "adam_update", [w, g, st, pos],
         dict(lr=0.01, **clip), "value"),
        ("ftrl_update", "ftrl_update", [w, g, st, pos],
         {"lr": 0.1, "lamda1": 0.2, "wd": 0.01, "clip_gradient": 1.0},
         "value"),
        ("ftml_update", "ftml_update", [w, g, pos, pos * 0.5, st],
         {"lr": 0.1, "t": 3, "wd": 0.01, "clip_grad": 1.0}, "value"),
        ("rmsprop_update", "rmsprop_update", [w, g, pos],
         dict(lr=0.01, clip_weights=0.5, **clip), "value"),
        ("rmspropalex_update", "rmspropalex_update",
         [w, g, pos, st * 0.1, st], dict(lr=0.01, **clip), "value"),
        ("signsgd_update", "signsgd_update", [w, g], dict(lr=0.1, **clip),
         "value"),
        ("signum_update", "signum_update", [w, g, st],
         dict(lr=0.1, momentum=0.9, wd_lh=0.01, **clip), "value"),
        ("adamw_update", "_contrib_adamw_update",
         [w, g, st, pos, np.array([0.5], "float32")],
         {"lr": 0.01, "wd": 0.1, "eta": 0.7, "clip_gradient": 1.0}, "value"),
        ("group_adagrad_update", "group_adagrad_update",
         [w, g, grid_values(3, 1, seed=4, **GRID_POS)], {"lr": 0.1},
         "value"),
        ("group_adagrad_1d", "_contrib_group_adagrad_update",
         [w[0], g[0], pos[0]], {"lr": 0.1, "clip_gradient": 0.5}, "value"),
        ("multi_sum_sq", "multi_sum_sq", [w, g[:2], pos[0]],
         {"num_arrays": 3}, "value"),
        ("crop_hw", "Crop", [grid_values(2, 3, 6, 7)],
         {"offset": (1, 2), "h_w": (3, 4)}, "grad"),
        ("crop_like_center", "Crop",
         [grid_values(2, 3, 6, 7), grid_values(2, 3, 4, 3, seed=1)],
         {"center_crop": True, "num_args": 2}, "grad"),
        ("kl_sparse_reg", "IdentityAttachKLSparseReg", [grid_values(4, 5)],
         {"sparseness_target": 0.2, "penalty": 0.01}, "grad"),
        ("histogram", "_histogram", [grid_values(50, seed=5)],
         {"bin_cnt": 7}, "exact_first"),
        ("histogram_range", "histogram", [grid_values(50, seed=5)],
         {"bin_cnt": 5, "range": (-1.0, 1.5)}, "exact_first"),
        ("khatri_rao", "khatri_rao", [grid_values(2, 3),
                                      grid_values(4, 3, seed=1)], {}, "grad"),
        ("_slice_assign", "_slice_assign",
         [grid_values(4, 5), grid_values(2, 2, seed=1)],
         {"begin": (1, 0), "end": (3, 4), "step": (1, 2)}, "grad"),
        ("_slice_assign_scalar", "_slice_assign_scalar", [grid_values(4, 5)],
         {"scalar": 2.5, "begin": (0, 1), "end": (4, 3)}, "grad"),
        ("_identity_with_attr_like_rhs", "_identity_with_attr_like_rhs",
         [grid_values(3, 4), grid_values(3, 4, seed=1)], {}, "grad"),
        ("_zeros_without_dtype", "_zeros_without_dtype", [],
         {"shape": (2, 3)}, "exact"),
        ("_rnn_param_concat", "_rnn_param_concat",
         [grid_values(3, 4), grid_values(5, seed=1)], {}, "grad"),
        ("_rnn_param_concat_dim1", "_rnn_param_concat",
         [grid_values(3, 4), grid_values(3, 2, seed=1)], {"dim": 1}, "grad"),
        ("_CrossDeviceCopy", "_CrossDeviceCopy", [grid_values(3, 4)], {},
         "value"),
        ("cast_storage", "cast_storage", [grid_values(3, 4)],
         {"stype": "row_sparse"}, "grad"),
        ("sparse_retain", "_sparse_retain",
         [grid_values(5, 3), np.array([0, 3], "float32")], {}, "value"),
        ("quadratic", "_contrib_quadratic", [grid_values(3, 4)],
         {"a": 0.5, "b": -1.0, "c": 2.0}, "grad"),
        ("index_copy", "index_copy",
         [grid_values(5, 3), np.array([4, 0, 7], "float32"),
          grid_values(3, 3, seed=1)], {}, "value"),
        ("edge_id", "_contrib_edge_id",
         [adj, np.array([0, 1, 2, 2], "float32"),
          np.array([1, 1, 1, 0], "float32")], {}, "exact"),
        ("getnnz", "getnnz", [adj], {}, "exact"),
        ("getnnz_axis", "_contrib_getnnz", [adj], {"axis": 0}, "exact"),
        ("bipartite_matching", "bipartite_matching", [scores[0]],
         {"threshold": 0.1}, "exact"),
        ("bipartite_matching_batch_ascend", "_contrib_bipartite_matching",
         [scores], {"is_ascend": True, "threshold": 0.8, "topk": 2},
         "exact"),
    ]


LIBRARY_OP_GROUPS = {"matrix_index": _grid_matrix_index,
                     "spatial": _grid_spatial, "tail": _grid_tail,
                     "linalg": _grid_linalg, "parity": _grid_parity}


def canonical_signs(name, outs):
    """``gelqf``'s (L, Q) with each column of L (row of Q) flipped so that
    L's diagonal is not negative, and ``syevd``'s (U, w) with each row of
    U flipped so that its largest |entry| is positive: a factor is unique
    up to those signs, which the solvers choose."""
    outs = [np.asarray(o, np.float64) for o in outs]
    if name.endswith("gelqf"):
        L, Q = outs
        sign = np.where(np.diagonal(L, axis1=-2, axis2=-1) < 0, -1.0, 1.0)
        return [L * sign[..., None, :], Q * sign[..., :, None]]
    U, w = outs
    big = np.take_along_axis(U, np.abs(U).argmax(-1)[..., None], -1)
    return [U * np.where(big < 0, -1.0, 1.0), w]


def library_case_errors(cid, name, how, got, want, tol):
    """(failures, worst error) of one case's (outputs, gradients) ``got``
    against ``want``: "exact" outputs (and the first of "exact_first")
    equal in value and dtype, the rest within ``tol`` of the largest
    |entry| (``grid_error``); gradients likewise, an input the op does not
    read counting as a zero gradient."""
    failed, worst = [], 0.0
    g_outs, w_outs = got[0], want[0]
    if how == "signs":
        g_outs, w_outs = (canonical_signs(name, o) for o in (g_outs, w_outs))
    if len(g_outs) != len(w_outs):
        return [f"{cid}: {len(g_outs)} outputs, want {len(w_outs)}"], worst
    for i, (g, w) in enumerate(zip(g_outs, w_outs)):
        g, w = np.asarray(g), np.asarray(w)
        if how in ("exact", "exact_grad") or (how == "exact_first"
                                              and i == 0):
            if g.dtype != w.dtype or g.shape != w.shape or \
                    not np.array_equal(g, w, equal_nan=True):
                failed.append(f"{cid}: output {i} differs ({g.dtype} "
                              f"{g.shape} against {w.dtype} {w.shape})")
            continue
        err = grid_error(g, w)
        worst = max(worst, err) if err == err else worst
        if not err <= tol:
            failed.append(f"{cid}: output {i} {err:.3e}")
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        if g is None and w is not None and not np.any(w):
            g = np.zeros_like(w)
        err = grid_error(g, w) if g is not None and w is not None \
            else (0.0 if g is w else float("nan"))
        worst = max(worst, err) if err == err else worst
        if not err <= tol:
            failed.append(f"{cid} (grad {i}): {err:.3e}")
    return failed, worst


def library_tol(group):
    return TOL_LINALG if group == "linalg" else TOL_GRID


# The random ops: (case id, op name, numpy inputs, attrs), each drawing
# ``n`` samples of every parameter row (``random_cases(n)``);
# ``random_draw_sets`` splits a case's outputs into sets of iid draws.
def random_cases(n):
    half = n // 2
    two = lambda *v: np.array(v, "float32")  # noqa: E731
    like = np.zeros((n,), "float32")
    return [
        ("uniform", "_random_uniform", [],
         {"low": -1.0, "high": 3.0, "shape": (n,)}),
        ("normal", "random_normal", [],
         {"loc": 1.0, "scale": 2.0, "shape": (n,)}),
        ("gamma", "_random_gamma", [],
         {"alpha": 2.5, "beta": 0.5, "shape": (n,)}),
        ("gamma_small_alpha", "random_gamma", [],
         {"alpha": 0.5, "beta": 2.0, "shape": (n,)}),
        ("exponential", "_random_exponential", [],
         {"lam": 2.0, "shape": (n,)}),
        ("poisson", "_random_poisson", [], {"lam": 3.5, "shape": (n,)}),
        ("poisson_large", "random_poisson", [], {"lam": 40.0,
                                                 "shape": (n,)}),
        ("negative_binomial", "_random_negative_binomial", [],
         {"k": 3, "p": 0.4, "shape": (n,)}),
        ("generalized_negative_binomial",
         "_random_generalized_negative_binomial", [],
         {"mu": 2.0, "alpha": 0.5, "shape": (n,)}),
        ("randint", "_random_randint", [],
         {"low": -3, "high": 7, "shape": (n,)}),
        ("sample_uniform", "_sample_uniform",
         [two(0.0, -2.0), two(1.0, 5.0)], {"shape": (half,)}),
        ("sample_normal", "sample_normal", [two(0.0, 3.0), two(1.0, 0.5)],
         {"shape": (half,)}),
        ("sample_gamma", "_sample_gamma", [two(0.7, 4.0), two(1.0, 0.5)],
         {"shape": (half,)}),
        ("sample_exponential", "_sample_exponential", [two(0.5, 3.0)],
         {"shape": (half,)}),
        ("sample_poisson", "_sample_poisson", [two(1.5, 20.0)],
         {"shape": (half,)}),
        ("sample_negative_binomial", "_sample_negative_binomial",
         [two(2.0, 5.0), two(0.3, 0.7)], {"shape": (half,)}),
        ("sample_generalized_negative_binomial",
         "_sample_generalized_negative_binomial",
         [two(1.0, 4.0), two(0.3, 1.5)], {"shape": (half,)}),
        ("uniform_like", "_random_uniform_like", [like],
         {"low": 2.0, "high": 3.0}),
        ("normal_like", "_random_normal_like", [like],
         {"loc": -1.0, "scale": 0.5}),
        ("gamma_like", "_random_gamma_like", [like],
         {"alpha": 3.0, "beta": 2.0}),
        ("exponential_like", "_random_exponential_like", [like],
         {"lam": 0.5}),
        ("poisson_like", "_random_poisson_like", [like], {"lam": 6.0}),
        ("negative_binomial_like", "_random_negative_binomial_like", [like],
         {"k": 2, "p": 0.5}),
        ("generalized_negative_binomial_like",
         "_random_generalized_negative_binomial_like", [like],
         {"mu": 3.0, "alpha": 0.25}),
        ("multinomial", "_sample_multinomial",
         [np.array([[0.1, 0.2, 0.3, 0.4], [0.5, 0.0, 0.25, 0.25]],
                   "float32")], {"shape": (half,), "get_prob": True}),
        ("shuffle", "_shuffle",
         [np.arange(3 * 1000, dtype="float32").reshape(1000, 3)], {}),
        ("unique_zipfian", "_sample_unique_zipfian", [],
         {"range_max": 1000, "shape": (max(n // 50, 1), 50)}),
    ]


def random_draw_sets(cid, inputs, outs):
    """{label: 1-D float64 iid draws} of one random case's outputs (the
    per-category indicators of a multinomial, each row's ids and tries of
    the Zipfian sampler); None for ``shuffle``, which is checked as a
    permutation."""
    outs = [np.asarray(o, np.float64) for o in outs]
    if cid == "shuffle":
        return None
    if cid == "multinomial":
        samp = outs[0]
        return {f"row{r} category {k}": (samp[r] == k).astype(np.float64)
                for r in range(samp.shape[0]) for k in range(4)}
    if cid == "unique_zipfian":
        return {"ids": outs[0].reshape(-1), "tries": outs[1].reshape(-1)}
    rows = outs[0].reshape(-1, outs[0].shape[-1])
    return {f"row{r}": rows[r] for r in range(rows.shape[0])}


def stats_z(a, b):
    """(|Δmean|, |Δvariance|) of two iid samples in standard errors of the
    difference (the variance's from each sample's fourth moment)."""
    def moments(x):
        m, v = x.mean(), x.var()
        m4 = ((x - m) ** 4).mean()
        return m, v, v / x.size, max(m4 - v * v, 0.0) / x.size
    ma, va, sea, sva = moments(a)
    mb, vb, seb, svb = moments(b)
    zm = abs(ma - mb) / max(np.sqrt(sea + seb), 1e-300)
    zv = abs(va - vb) / max(np.sqrt(sva + svb), 1e-300)
    return zm, zv


def random_case_failures(cid, inputs, got, want, z=6.0):
    """Failures of one random case's draws ``got`` against ``want`` (each
    the op's outputs): every set of draws within ``z`` standard errors in
    mean and variance, ``shuffle`` a permutation of its input's rows,
    the multinomial's log-probabilities those of its draws, the Zipfian
    ids distinct in each row; and the worst z."""
    failed, worst = [], 0.0
    if cid == "shuffle":
        rows, src = np.asarray(got[0]), inputs[0]
        if not np.array_equal(np.sort(rows[:, 0]), src[:, 0]) or \
                not np.array_equal(rows[:, 1:] - rows[:, :1],
                                   src[:, 1:] - src[:, :1]) or \
                np.array_equal(rows, src):
            failed.append("shuffle: not a permutation of the rows")
        return failed, worst
    if cid == "multinomial":
        samp, logp = np.asarray(got[0]), np.asarray(got[1])
        probs = inputs[0] / inputs[0].sum(-1, keepdims=True)
        want_logp = np.log(np.maximum(np.take_along_axis(
            probs, samp.astype(int), -1), 1e-30))
        if np.abs(logp - want_logp).max() > 1e-5:
            failed.append("multinomial: log-probabilities")
    if cid == "unique_zipfian":
        ids = np.asarray(got[0])
        if any(len(set(r)) != len(r) for r in ids) or ids.min() < 0 or \
                ids.max() >= 1000:
            failed.append("unique_zipfian: ids not distinct in range")
    sets_got = random_draw_sets(cid, inputs, got)
    sets_want = random_draw_sets(cid, inputs, want)
    for label, draws in sets_got.items():
        zm, zv = stats_z(draws, sets_want[label])
        worst = max(worst, zm, zv)
        if not (zm <= z and zv <= z):
            failed.append(f"{cid} {label}: mean {zm:.1f} and variance "
                          f"{zv:.1f} standard errors apart")
    return failed, worst


def run_random_case(name, inputs, attrs, gen, device):
    """One random case through the port's registry op on ``device``,
    drawing from the generator ``gen``: its outputs as numpy."""
    from mxnet_tpu_torch.ops.registry import get_op
    fn = get_op(name).fn
    kw = dict(attrs, rng=gen)
    if "device" in fn.__code__.co_varnames:
        kw["device"] = device
    out = fn(*[torch.from_numpy(np.array(a)).to(device) for a in inputs],
             **kw)
    return [o.cpu().numpy() for o in (out if isinstance(out, tuple)
                                       else (out,))]


LIBRARY_DRAWS = 10 ** 6      # draws of every parameter row on the card


def library_op_grid(dev, draws=LIBRARY_DRAWS):
    """Phase 24 (and ``tests/test_torch_gpu.py``): every deterministic case
    of ``LIBRARY_OP_GROUPS`` on the card against the same case on the CPU
    (discrete outputs equal, linalg within ``TOL_LINALG``, the rest within
    ``TOL_GRID`` of the case's largest entry, the factors of gelqf and
    syevd up to their rows' signs); ``boolean_mask``; every random case at
    ``draws`` draws a row on the card against the CPU's by mean and
    variance (``random_case_failures``), and each again from the same seed
    on the card, bitwise equal. Returns (worst error, worst z, number of
    cases); raises naming every failing case."""
    failed, worst, count = [], 0.0, 0
    for group, cases in LIBRARY_OP_GROUPS.items():
        for seed, (cid, name, inputs, attrs, how) in enumerate(cases()):
            count += 1
            want = run_grid_case(name, inputs, attrs, how, seed)
            got = run_grid_case(name, inputs, attrs, how, seed, dev)
            f, w = library_case_errors(cid, name, how, got, want,
                                       library_tol(group))
            failed += f
            worst = max(worst, w)
    data = grid_values(5, 3)
    mask = np.array([1, 0, 0, 2, 1], "float32")
    want = run_grid_case("boolean_mask", [data, mask], {}, "grad", 0)
    got = run_grid_case("boolean_mask", [data, mask], {}, "grad", 0, dev)
    failed += library_case_errors("boolean_mask", "boolean_mask", "grad",
                                  got, want, TOL_GRID)[0]
    worst_z = 0.0
    cpu = torch.device("cpu")
    for cid, name, inputs, attrs in random_cases(draws):
        count += 1
        want = run_random_case(name, inputs, attrs,
                               torch.Generator(cpu).manual_seed(SEED), cpu)
        got = run_random_case(name, inputs, attrs,
                              torch.Generator(dev).manual_seed(SEED), dev)
        again = run_random_case(name, inputs, attrs,
                                torch.Generator(dev).manual_seed(SEED), dev)
        if not all(np.array_equal(a, b) for a, b in zip(got, again)):
            failed.append(f"{cid}: a seeded repeat on the card differs")
        f, z = random_case_failures(cid, inputs, got, want)
        failed += f
        worst_z = max(worst_z, z)
    if failed:
        raise AssertionError("slice 12 op grid, card against CPU:\n"
                             + "\n".join(failed))
    return worst, worst_z, count


def library_grid_phase(mx, dev):
    """Phase 24's second half: every op slice 12 adds on the card against
    the CPU, and the generator reaching a random op at inference: a bound
    ``Dropout(mode="always")`` drops about half its entries at
    ``is_train=False`` on the card."""
    t0 = time.perf_counter()
    worst, worst_z, count = library_op_grid(dev)
    ctx = _ctx(mx, dev)
    exe = mx.sym.Dropout(mx.sym.Variable("data"), p=0.5, mode="always") \
        .simple_bind(ctx, data=(1000, 1000))
    exe.arg_dict["data"][:] = 1.0
    out = exe.forward(is_train=False)[0].asnumpy()
    zeros = float((out == 0).mean())
    if abs(zeros - 0.5) > 0.02 or not np.all((out == 0) | (out == 2.0)):
        raise AssertionError(f"Dropout(mode='always') at inference on the "
                             f"card: zero share {zeros}")
    print(f"slice 12 op grid: {count} cases on the card against the CPU: "
          f"discrete outputs equal, the rest within {worst:.2e} of the "
          f"largest entry (tolerances {TOL_GRID}, linalg {TOL_LINALG}); "
          f"random ops at {LIBRARY_DRAWS:,} draws a row within "
          f"{worst_z:.2f} standard errors of the CPU's (bound 6), seeded "
          f"repeats bitwise equal; Dropout(mode='always') at inference "
          f"zeroes {zeros:.4f} of 10^6 entries; "
          f"{time.perf_counter() - t0:.1f} s")


# ----------------------------------------- slice 12: route J, CapsNet
# Sabour, Frosst & Hinton, "Dynamic Routing Between Capsules"
# (arXiv:1710.09829), at the paper's widths: Conv1 256 9x9 ReLU,
# PrimaryCaps 32 types of 8-D capsules (9x9, stride 2: 6x6x32 = 1,152),
# DigitCaps 10 x 16-D after 3 routing iterations, the margin loss and the
# 512-1024-784 reconstruction decoder weighted 0.0005; Adam lr 1e-3, batch
# 100, float32. Nothing is cut but the data (MNIST is not in the repo: the
# synthetic idx files of ``mnist_files``) and the paper's 2-pixel shift
# augmentation, which the JAX recipe does not have either.
CAPSNET = dict(channels=256, kernel=9, stride=1, primary=32, pdim=8,
               primary_kernel=9, primary_stride=2, capsules=1152,
               classes=10, ddim=16, iters=3, decoder=(512, 1024, 784),
               recon_weight=0.0005, batch=100, lr=1e-3)
CAPSNET_PARAMS = 8215568
CAPSNET_TIMED = 10           # iterations timed, after two warm-up ones
# the gates, from the first run on the card (H100): margin 2.2e-7,
# reconstruction 4.6e-9, lengths 1.8e-6, gradients up to 1.5e-6; the TF32
# control read 4.3e-4 (lengths) and 1.3e-2 (decoder_dense0's gradient)
TOL_CAPS_LOSS = 2e-6         # margin and reconstruction losses, relative
TOL_CAPS_LENGTHS = 1e-5      # capsule lengths, of their largest
TOL_CAPS_GRAD = 1e-5         # ||dg|| / ||g|| of every gradient


def build_capsnet(mx, ctx, weights=None, dtype="float32"):
    """Route J's model on ``ctx``: the capsnet twin's ``CapsNet`` at
    ``CAPSNET``'s widths and the reconstruction decoder (Xavier from the
    port's seed, or ``weights`` by name), cast to ``dtype``; with the twin
    module and one Adam trainer over both."""
    from mxnet_tpu_torch import gluon, interop
    c = CAPSNET
    twin = _load_example("example/capsnet/capsnet_torch.py",
                         "capsnet_torch")
    net = twin.CapsNet(
        channels=c["channels"], kernel=c["kernel"], stride=c["stride"],
        primary=c["primary"], pdim=c["pdim"],
        primary_kernel=c["primary_kernel"],
        primary_stride=c["primary_stride"], capsules=c["capsules"],
        classes=c["classes"], ddim=c["ddim"], prefix="capsnet_")
    decoder = gluon.nn.HybridSequential(prefix="decoder_")
    with decoder.name_scope():
        for units in c["decoder"][:-1]:
            decoder.add(gluon.nn.Dense(units, activation="relu"))
        decoder.add(gluon.nn.Dense(c["decoder"][-1], activation="sigmoid"))
    mx.random.seed(SEED)
    for block in (net, decoder):
        block.initialize(mx.init.Xavier(), ctx=ctx)
    with mx.autograd.pause():
        net(mx.nd.zeros((2, 1, 28, 28), ctx=ctx))
        decoder(mx.nd.zeros((2, c["classes"] * c["ddim"]), ctx=ctx))
    if weights is not None:
        for block, w in zip((net, decoder), weights):
            interop.load_block_params(block, w)
    params = {**net.collect_params(), **decoder.collect_params()}
    if dtype != "float32":
        for p in params.values():
            p.cast(dtype)
    trainer = gluon.Trainer(params, "adam", {"learning_rate": c["lr"]})
    return twin, net, decoder, trainer


def capsnet_losses(mx, twin, net, decoder, x, y):
    """(total, margin, reconstruction, capsule lengths) of a batch: the
    twin's ``route`` and ``margin_loss``, and the decoder's sum of squared
    errors over the image, fed the class capsules masked by
    ``one_hot(label)``, averaged over the batch."""
    import torch.profiler as tp
    c = CAPSNET
    with tp.record_function("capsnet.u_hat"):
        u_hat = net(x)
    with tp.record_function("capsnet.route"):
        v = twin.route(u_hat, c["iters"])
    with tp.record_function("capsnet.losses"):
        margin = twin.margin_loss(v, y)
        mask = mx.nd.one_hot(y, c["classes"], dtype=v.dtype)
        masked = (v * mx.nd.expand_dims(mask, axis=2)).reshape(
            (0, -1))
        recon = decoder(masked)
        err = mx.nd.sum(mx.nd.square(recon - x.reshape((0, -1))), axis=1)
        recon_loss = mx.nd.mean(err)
        total = margin + c["recon_weight"] * recon_loss
        lengths = mx.nd.sqrt(mx.nd.sum(mx.nd.square(v), axis=2))
    return total, margin, recon_loss, lengths


def capsnet_step(mx, twin, net, decoder, trainer, x, y):
    with mx.autograd.record():
        out = capsnet_losses(mx, twin, net, decoder, x, y)
    out[0].backward()
    trainer.step(1)
    return out


def _caps_grads(net, decoder):
    return {k: p.grad._data.detach().double().clone()
            for block in (net, decoder)
            for k, p in block.collect_params().items()
            if p.grad_req != "null"}


def _capsnet_iteration_one(mx, ctx, weights, batch, dtype):
    """Iteration 1 from ``weights`` in ``dtype``: (margin, reconstruction,
    capsule lengths, {name: gradient})."""
    twin, net, decoder, trainer = build_capsnet(mx, ctx, weights, dtype)
    x, y = (a.astype(dtype) for a in batch)
    _, margin, recon, lengths = capsnet_step(mx, twin, net, decoder,
                                             trainer, x, y)
    return (float(margin.asscalar()), float(recon.asscalar()),
            lengths._data.detach().double(), _caps_grads(net, decoder))


def _caps_errors(run, ref):
    """(margin, reconstruction, lengths, worst gradient) errors of ``run``
    against ``ref`` and {name: ||dg|| / ||g||}."""
    per = {n: _norm_rel(g, ref[3][n]) for n, g in run[3].items()}
    return ((abs(run[0] - ref[0]) / abs(ref[0]),
             abs(run[1] - ref[1]) / abs(ref[1]),
             ((run[2] - ref[2]).abs().max() / ref[2].abs().max()).item(),
             max(per.values())), per)


class OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched under it (each launches at least one
    kernel on the card)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


def capsnet_phase(mx, hk, dev, workdir, profile=False):
    """Route J (phase 27): CapsNet at the paper's widths trained through
    ``MNISTIter``, gluon, ``autograd.record()`` and Adam on the card.
    Iteration 1 against the same iteration in float64 on the card — the
    margin and reconstruction losses, the capsule lengths, every gradient
    — with a TF32 control that must miss; then ``CAPSNET_TIMED`` timed
    iterations (wall ms, host dispatch, device ms, images/s, peak memory),
    the ops dispatched by one iteration, the losses finite, and under
    ``profile`` a ``torch.profiler`` breakdown. No Hopper kernel may
    launch."""
    from mxnet_tpu_torch import interop
    c, ctx = CAPSNET, _ctx(mx, dev)
    root = os.path.join(workdir, "mnist_caps")
    n_train = c["batch"] * (CAPSNET_TIMED + 4)
    t0 = time.perf_counter()
    mnist_files(root, n_train, c["batch"])
    with ctx:
        it = mx.io.MNISTIter(
            image=os.path.join(root, "train-images-idx3-ubyte"),
            label=os.path.join(root, "train-labels-idx1-ubyte"),
            batch_size=c["batch"], shuffle=False)
        batches = [(b.data[0].as_in_context(ctx),
                    b.label[0].as_in_context(ctx)) for b in it]
    print(f"capsnet: {n_train} synthetic 28x28 idx images through "
          f"MNISTIter in {time.perf_counter() - t0:.2f} s (set-up)")
    twin, net, decoder, _ = build_capsnet(mx, ctx)
    n = sum(p.data().size for b in (net, decoder)
            for p in b.collect_params().values())
    weights = [interop.block_params_to_numpy(b) for b in (net, decoder)]
    del net, decoder
    if n != CAPSNET_PARAMS:
        raise AssertionError(f"capsnet: {n:,} parameters, the paper's "
                             f"widths give {CAPSNET_PARAMS:,}")
    k, cd = c["capsules"], c["classes"] * c["ddim"]
    print(f"capsnet: {n:,} parameters (conv {c['channels']} "
          f"{c['kernel']}x{c['kernel']}, primary caps {c['primary']}x"
          f"{c['pdim']}-D = {k:,} capsules, u_hat batch_dot ({k}, B, "
          f"{c['pdim']}) x ({k}, {c['pdim']}, {cd}), {c['iters']} routing "
          f"iterations, digit caps {c['classes']}x{c['ddim']}-D, decoder "
          f"{cd}-{'-'.join(str(u) for u in c['decoder'])}), batch "
          f"{c['batch']}")
    hk.reset_launch_counts()
    run = _capsnet_iteration_one(mx, ctx, weights, batches[0], "float32")
    ref = _capsnet_iteration_one(mx, ctx, weights, batches[0], "float64")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = _capsnet_iteration_one(mx, ctx, weights, batches[0],
                                         "float32")
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    (errs, per), (ctl, per_ctl) = _caps_errors(run, ref), \
        _caps_errors(control, ref)
    tols = (TOL_CAPS_LOSS, TOL_CAPS_LOSS, TOL_CAPS_LENGTHS, TOL_CAPS_GRAD)
    print(f"capsnet: iteration 1 against float64 (margin loss, "
          f"reconstruction loss, capsule lengths, worst ||dg||/||g||): "
          f"{', '.join(f'{e:.2e}' for e in errs)} (tolerances {tols}); "
          f"TF32 control {', '.join(f'{e:.2e}' for e in ctl)}; margin "
          f"{run[0]:.6f} reconstruction {run[1]:.4f}")
    for name, e in sorted(per.items(), key=lambda kv: -kv[1]):
        print(f"capsnet: gradient {name}: ||dg||/||g|| {e:.2e} (TF32 "
              f"{per_ctl[name]:.2e})")
    if not all(e <= t for e, t in zip(errs, tols)):
        raise AssertionError("capsnet: iteration 1 is not within its "
                             "tolerances of the float64 iteration")
    if all(e <= t for e, t in zip(ctl, tols)):
        raise AssertionError("capsnet: the TF32 control met every "
                             "tolerance")
    del run, ref, control
    _free()

    twin, net, decoder, trainer = build_capsnet(mx, ctx, weights)
    losses, steps = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(CAPSNET_TIMED + 2):
        x, y = batches[i]
        out = {}

        def step(x=x, y=y):
            out["v"] = capsnet_step(mx, twin, net, decoder, trainer, x, y)
        if i >= 2:
            steps.append(_timed_step(step))
        else:
            step()
        losses.append(out["v"][:3])
    values = [[float(t.asscalar()) for t in l] for l in losses]
    if not np.isfinite(values).all():
        raise AssertionError(f"capsnet: a loss is not finite: {values}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    host = 1e3 * float(np.median([h for h, _, _ in steps]))
    devms = float(np.median([d for _, d, _ in steps]))
    wall = 1e3 * float(np.median([w for _, _, w in steps]))
    x, y = batches[CAPSNET_TIMED + 2]
    with OpCount() as ops:
        capsnet_step(mx, twin, net, decoder, trainer, x, y)
    print(f"capsnet: {CAPSNET_TIMED} timed iterations: an iteration "
          f"{wall:.2f} ms ({devms:.2f} ms on the card, host dispatch "
          f"{host:.2f} ms), {1e3 * c['batch'] / wall:.1f} images/s; peak "
          f"memory {peak:.2f} GB; {ops.count} aten ops dispatched by one "
          f"iteration; loss {values[0][0]:.4f} -> {values[-1][0]:.4f} "
          f"(margin {values[0][1]:.4f} -> {values[-1][1]:.4f}); card "
          f"{_card_line()}")
    if profile:
        x, y = batches[CAPSNET_TIMED + 3]
        profile_breakdown(
            "capsnet iteration",
            lambda: capsnet_step(mx, twin, net, decoder, trainer, x, y),
            ranges=("capsnet.u_hat", "capsnet.route", "capsnet.losses"))
    if any(hk.launch_counts.values()):
        raise AssertionError(f"route J launched a Hopper kernel: "
                             f"{dict(hk.launch_counts)}")


# ------------------------------------------------- slice 13: routes K and L
# route K: the reference's example/sparse/linear_classification on avazu's
# widths (1,000,001 feature columns, 0-based; batch 8192), a stand-in file
# of ROUTE_K["batches"] seeded batches with one nonzero a categorical field
ROUTE_K = dict(columns=1_000_001, batch=8192, fields=15, batches=16,
               lr=1.0, init_std=0.01, zipf=1.3, bias0=-1.6)
ROUTE_K_TIMED = 12           # steps timed, after the checked one
# step 1 against float64: a popular feature's gradient row sums up to
# 8192 float32 terms in the atomics' order, ~sqrt(8192)·eps ≈ 5e-6 of it;
# the first run on the card (H100) read 1.2e-6 for both the rows and the
# update (lr 1), and the unmerged control 5.7e-4
TOL_K_LOSS = 1e-6            # step 1's loss, relative, float32 vs float64
TOL_K_GRAD = 1e-5            # its gradient rows, of their largest entry
TOL_K_WEIGHT = 1e-5          # the touched rows after it, of their largest
REFMLP = os.path.join("tests", "fixtures", "refmlp")
TOL_REFMLP = 1e-5            # the pinned logits of the reference checkpoint
RN_REF_REQUESTS = 8


def avazu_like_libsvm(path, seed=SEED):
    """Write ``ROUTE_K``'s synthetic LibSVM file (0-based columns): each
    row has one feature a field, drawn Zipf-skewed inside the field's block
    of columns (a few ids carry most rows, as in avazu), value 1, and a
    click label from a seeded logistic model (about a fifth positive).
    Returns (rows, nonzeros)."""
    c = ROUTE_K
    rng = np.random.RandomState(seed)
    n = c["batch"] * c["batches"]
    width = c["columns"] // c["fields"]
    starts = np.arange(c["fields"]) * width
    sizes = np.full(c["fields"], width)
    sizes[-1] = c["columns"] - starts[-1]
    ranks = (rng.zipf(c["zipf"], (n, c["fields"])) - 1) % sizes
    cols = starts + ranks
    w_true = rng.randn(c["columns"]).astype(np.float32) * 0.5
    z = w_true[cols].sum(1) + c["bias0"]
    labels = (rng.rand(n) < 1 / (1 + np.exp(-z))).astype(np.int64)
    with open(path, "w") as f:
        for y, row in zip(labels, cols):
            f.write(f"{y} " + " ".join(f"{k}:1" for k in row) + "\n")
    return n, n * c["fields"]


def logreg_step(mx, sp, x, y, w, b, updater):
    """One step of the reference recipe: ``sigmoid(sp.dot(x, w) + b)``, the
    gradient ``sp.dot(x, err, transpose_a=True)`` restricted to the batch's
    feature ids as a ``RowSparseNDArray``, and the lazy SGD ``Updater``
    (weight: index 0, bias: index 1). Returns (loss, gradient, ids)."""
    import torch.profiler as tp
    n = x.shape[0]
    with tp.record_function("logreg.forward"):
        z = sp.dot(x, w) + b
        p = mx.nd.sigmoid(z)
        zt, yt = z._data[:, 0], y._data.to(z._data.dtype)
        loss = (torch.nn.functional.softplus(zt) - yt * zt).mean()
        err = (p - y.reshape((-1, 1)).astype(p.dtype)) / float(n)
    with tp.record_function("logreg.backward"):
        full = sp.dot(x, err, transpose_a=True)
        ids = torch.unique(x.indices._data).long()
        grad = sp.RowSparseNDArray(full._data[ids], ids, w.shape)
    with tp.record_function("logreg.update"):
        updater(0, grad, w)
        updater(1, err.sum().reshape((1,)), b)
    return loss, grad, ids


def _logreg_model(mx, ctx, dtype):
    """(w, b, updater) from the seed, in ``dtype``: w ~ N(0, init_std²),
    b = 0, plain SGD (the lazy path)."""
    c = ROUTE_K
    gen = torch.Generator().manual_seed(SEED)
    w0 = torch.randn(c["columns"], 1, generator=gen) * c["init_std"]
    w = mx.nd.array(w0, ctx=ctx, dtype=dtype)
    b = mx.nd.zeros((1,), ctx=ctx, dtype=dtype)
    opt = mx.optimizer.SGD(learning_rate=c["lr"], rescale_grad=1.0)
    return w, b, mx.optimizer.get_updater(opt)


def _as_float64(sp, x):
    return sp.CSRNDArray(x.data._data.double(), x.indices._data,
                         x.indptr._data, x.shape)


def sparse_logreg_phase(mx, hk, dev, workdir, profile=False):
    """Route K (phase 28): sparse logistic regression at avazu's widths on
    the card. The synthetic file goes through ``LibSVMIter`` onto the card
    as ``CSRNDArray`` batches; each step is ``logreg_step`` (nothing is
    densified but the (1,000,001, 1) gradient of ``transpose_a``). Step 1's
    loss, gradient rows and updated rows against the same step in float64
    on the card; the rows outside each batch bitwise unchanged by every
    update; ``row_sparse_pull`` of a batch's rows from a ``local`` store;
    the unmerged per-entry gradient through the updater within the
    tolerance, and written without merging (a control) beyond it; the
    dot's repeats; then timed steps with the iterator's share apart. No
    Hopper kernel may launch."""
    import tempfile
    from mxnet_tpu_torch.ndarray import sparse as sp
    c, ctx = ROUTE_K, _ctx(mx, dev)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        path = os.path.join(tmp, "avazu_like.libsvm")
        t0 = time.perf_counter()
        rows, nnz = avazu_like_libsvm(path)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(c["columns"],),
                              batch_size=c["batch"], indexing_mode=0,
                              ctx=ctx)
        t_parse = time.perf_counter() - t0
        size = os.path.getsize(path)
    print(f"route K: {rows:,} rows x {c['columns']:,} columns, {nnz:,} "
          f"nonzeros ({size / 1e6:.1f} MB of LibSVM text) written in "
          f"{t_write:.2f} s, parsed by LibSVMIter in {t_parse:.2f} s "
          f"(set-up); batch {c['batch']}, lr {c['lr']}")
    batches, iter_ms = [], []
    for _ in range(c["batches"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = it.next()
        torch.cuda.synchronize()
        iter_ms.append((time.perf_counter() - t0) * 1e3)
        batches.append(batch)
    x, y = batches[0].data[0], batches[0].label[0]
    if not (x.stype == "csr" and x.context == ctx and x.nnz ==
            c["batch"] * c["fields"] and x.shape == (c["batch"],
                                                     c["columns"])):
        raise AssertionError(f"route K: batch {x.stype} {x.shape} nnz "
                             f"{x.nnz} on {x.context}")

    # step 1 against float64, with its checks
    hk.reset_launch_counts()
    w, b, updater = _logreg_model(mx, ctx, "float32")
    w0 = w._data.clone()
    loss, grad, ids = logreg_step(mx, sp, x, y, w, b, updater)
    w64, b64, upd64 = _logreg_model(mx, ctx, "float64")
    loss64, grad64, _ = logreg_step(mx, sp, _as_float64(sp, x), y, w64,
                                    b64, upd64)
    e_loss = abs(loss.item() - loss64.item()) / abs(loss64.item())
    g64 = grad64.data._data
    e_grad = ((grad.data._data.double() - g64).abs().max()
              / g64.abs().max()).item()
    rows64 = w64._data[ids]
    e_w = ((w._data[ids].double() - rows64).abs().max()
           / rows64.abs().max()).item()
    outside = torch.ones(c["columns"], dtype=torch.bool, device=dev)
    outside[ids] = False
    untouched = torch.equal(w._data[outside], w0[outside])
    # the per-entry gradient (one row an entry, duplicates unmerged):
    # through the updater, which merges first, and written without merging
    # (b is 0 at step 1)
    rid, cols = x._row_ids(), x.indices._data.long()
    err = (torch.sigmoid(x.dot(mx.nd.NDArray(w0))._data)
           - y._data.view(-1, 1)) / c["batch"]
    contrib = x.data._data.view(-1, 1) * err[rid]
    w_merge = mx.nd.array(w0, ctx=ctx)
    mx.optimizer.get_updater(mx.optimizer.SGD(learning_rate=c["lr"]))(
        0, sp.RowSparseNDArray(contrib, cols, w0.shape), w_merge)
    e_merge = ((w_merge._data[ids].double() - rows64).abs().max()
               / rows64.abs().max()).item()
    w_ctl = w0.clone().index_copy_(0, cols, w0[cols] - c["lr"] * contrib)
    e_ctl = ((w_ctl[ids].double() - rows64).abs().max()
             / rows64.abs().max()).item()
    dups = cols.numel() - ids.numel()
    print(f"route K: step 1 against float64 on the card: loss "
          f"{loss.item():.6f} rel {e_loss:.2e} (tol {TOL_K_LOSS}); "
          f"gradient rows ({ids.numel():,} of {cols.numel():,} entries, "
          f"{dups:,} repeats) {e_grad:.2e} (tol {TOL_K_GRAD}); updated rows "
          f"{e_w:.2e} (tol {TOL_K_WEIGHT}); rows outside the batch "
          f"unchanged bitwise: {untouched}; the unmerged per-entry gradient "
          f"through the updater {e_merge:.2e}; control, written without "
          f"merging: {e_ctl:.2e} (must miss {TOL_K_WEIGHT})")
    if not (e_loss <= TOL_K_LOSS and e_grad <= TOL_K_GRAD
            and e_w <= TOL_K_WEIGHT and e_merge <= TOL_K_WEIGHT
            and untouched):
        raise AssertionError("route K: step 1 is not within its tolerances "
                             "of the float64 step")
    if e_ctl <= TOL_K_WEIGHT:
        raise AssertionError("route K: the unmerged control met the "
                             "tolerance")
    del w64, b64, upd64, grad64, w_merge, w_ctl

    # row_sparse_pull of the batch's rows from a local store
    kv = mx.kv.create("local")
    kv.init(0, w)
    pulled = mx.nd.zeros(w.shape, ctx=ctx)
    kv.row_sparse_pull(0, out=pulled, row_ids=mx.nd.array(ids, ctx=ctx))
    pull_ok = torch.equal(pulled._data[ids], w._data[ids]) and \
        not pulled._data[outside].any().item()
    print(f"route K: row_sparse_pull of {ids.numel():,} rows: the rows "
          f"equal and every other row zero: {pull_ok}")
    if not pull_ok:
        raise AssertionError("route K: row_sparse_pull")
    del kv, pulled

    # the dot's repeats (cuSPARSE forward; gather + atomic index_add_)
    fwd = [x.dot(w)._data for _ in range(2)]
    bwd = [x.dot(mx.nd.array(err, ctx=ctx), transpose_a=True)._data
           for _ in range(2)]
    print(f"route K: dot repeats bitwise: csr·w {torch.equal(*fwd)}, "
          f"csrᵀ·err {torch.equal(*bwd)}")
    ms_fwd = _time_ms(lambda: x.dot(w), 20)
    ms_bwd = _time_ms(lambda: x.dot(mx.nd.array(err, ctx=ctx),
                                    transpose_a=True), 20)
    print(f"route K: csr·w ({c['batch']}x{c['columns']:,}, nnz {x.nnz:,}) "
          f"{ms_fwd:.4f} ms, csrᵀ·err {ms_bwd:.4f} ms; card {_card_line()}")
    del fwd, bwd

    # the timed steps (batches 2.. reread: the iterator's share apart)
    losses, steps, untouched_all = [loss.item()], [], True
    torch.cuda.reset_peak_memory_stats()
    for k in range(1, 1 + ROUTE_K_TIMED):
        xb, yb = batches[k % len(batches)].data[0], \
            batches[k % len(batches)].label[0]
        before = w._data.clone()
        out = {}

        def step(xb=xb, yb=yb):
            out["v"] = logreg_step(mx, sp, xb, yb, w, b, updater)
        steps.append(_timed_step(step))
        keep = torch.ones(c["columns"], dtype=torch.bool, device=dev)
        keep[out["v"][2]] = False
        untouched_all &= torch.equal(w._data[keep], before[keep])
        losses.append(out["v"][0].item())
    peak = torch.cuda.max_memory_allocated() / 1e9
    host = 1e3 * float(np.median([h for h, _, _ in steps]))
    devms = float(np.median([d for _, d, _ in steps]))
    wall = 1e3 * float(np.median([s for _, _, s in steps]))
    it_ms = float(np.median(iter_ms[1:]))
    print(f"route K: {ROUTE_K_TIMED} timed steps: a step {wall:.3f} ms "
          f"({devms:.3f} ms between its events on the card, host dispatch "
          f"{host:.3f} ms) plus the iterator's batch {it_ms:.3f} ms (next() "
          f"with its copy to the card; first {iter_ms[0]:.3f} ms); "
          f"{1e3 * c['batch'] / (wall + it_ms):,.0f} rows/s end to end, "
          f"{1e3 * c['batch'] / wall:,.0f} rows/s the step alone; peak "
          f"memory {peak:.3f} GB; loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"rows outside every batch unchanged bitwise: {untouched_all}; "
          f"card {_card_line()}")
    if not (untouched_all and np.isfinite(losses).all()):
        raise AssertionError("route K: an update wrote rows outside its "
                             "batch, or a loss is not finite")
    if profile:
        xb, yb = batches[-1].data[0], batches[-1].label[0]
        profile_breakdown(
            "route K step",
            lambda: logreg_step(mx, sp, xb, yb, w, b, updater),
            ranges=("logreg.forward", "logreg.backward", "logreg.update"))
    if any(hk.launch_counts.values()):
        raise AssertionError(f"route K launched a Hopper kernel: "
                             f"{dict(hk.launch_counts)}")


def reference_formats_phase(mx, hk, dev, workdir):
    """Route L (phase 29): the committed reference checkpoint ``refmlp``
    (its graph JSON and NDARRAY_V2 params) through ``model.load_checkpoint``
    and ``Module`` and through ``FeedForward.load(...).predict`` on the
    card, against its pinned logits; then ResNet-50 v1 (route C's net, f32)
    written with ``save_reference_params`` and served through
    ``ModelServer`` from those bytes, bitwise against the same weights
    served from ``MXTPU001`` bytes. No Hopper kernel may launch."""
    from mxnet_tpu_torch import interop
    from mxnet_tpu_torch.serving import ModelConfig, ModelServer
    ctx = _ctx(mx, dev)
    hk.reset_launch_counts()
    root = os.path.dirname(os.path.abspath(__file__))
    prefix = os.path.join(root, REFMLP)
    x = np.load(os.path.join(root, REFMLP + "_input.npy"))
    want = np.load(os.path.join(root, REFMLP + "_output.npy"))
    sym, arg, aux = mx.model.load_checkpoint(prefix, 0)
    mod = mx.mod.Module(sym, data_names=["data"], label_names=None,
                        context=ctx)
    mod.bind(data_shapes=[("data", x.shape)], for_training=False)
    mod.set_params(arg, aux)
    mod.forward(mx.io.DataBatch(data=[mx.nd.array(x, ctx=ctx)]),
                is_train=False)
    out = mod.get_outputs()[0]
    ff = mx.model.FeedForward.load(prefix, 0, ctx=ctx).predict(x)
    e_mod = float(np.abs(out.asnumpy() - want).max())
    e_ff = float(np.abs(ff - want).max())
    print(f"route L: refmlp (reference graph JSON + NDARRAY_V2 params) on "
          f"{out.context}: Module logits max|d| {e_mod:.2e}, "
          f"FeedForward.predict {e_ff:.2e} against the pinned logits (tol "
          f"{TOL_REFMLP})")
    if not (e_mod <= TOL_REFMLP and e_ff <= TOL_REFMLP
            and out.context == ctx):
        raise AssertionError("route L: the reference checkpoint's logits")

    net = seeded_resnet(mx)
    xs, _ = resnet_batch(RN_REF_REQUESTS)
    net.hybridize()
    net(mx.nd.array(xs[:1]))
    os.makedirs(workdir, exist_ok=True)
    sym_file, own_file = net.export(os.path.join(workdir, "resnet50_ref"))
    del net
    _free()
    with open(sym_file) as f:
        sym_json = f.read()
    params = mx.nd.load(own_file, ctx=mx.cpu())
    ref_file = os.path.join(workdir, "resnet50_ref-reference.params")
    writers = {"reference": lambda: interop.save_reference_params(
                   ref_file, params),
               "MXTPU001": lambda: mx.nd.save(own_file, params)}
    files = {"reference": ref_file, "MXTPU001": own_file}
    # each format written, then read onto the card, twice, in turns (the
    # first pass pays the allocations and the page cache's first touch)
    writes, loads, blobs = {}, {}, {}
    for name in ("reference", "MXTPU001") * 2:
        t0 = time.perf_counter()
        writers[name]()
        writes[name] = (time.perf_counter() - t0) * 1e3
        with open(files[name], "rb") as f:
            blobs[name] = f.read()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = mx.nd.load_frombuffer(blobs[name], ctx=ctx)
        torch.cuda.synchronize()
        loads[name] = (time.perf_counter() - t0) * 1e3
        if sorted(loaded) != sorted(params):
            raise AssertionError(f"route L: {name} keys")
        del loaded
    back = interop.load_reference_params(ref_file)
    same = sorted(back) == sorted(params) and all(
        torch.equal(back[k]._data, v._data) for k, v in params.items())
    served = {}
    for name, blob in blobs.items():
        server = ModelServer([ModelConfig(
            "resnet50", sym_json, blob,
            feature_shape=(RESNET_IMAGE, RESNET_IMAGE, 3),
            buckets=RN_SERVE_BUCKETS, deadline_ms=0,
            dev_type=2 if dev.type == "cuda" else 1)])
        server.start()
        try:
            served[name] = np.stack([server.submit("resnet50", xs[i])
                                     .result(timeout=300)
                                     for i in range(RN_REF_REQUESTS)])
        finally:
            server.close()
        _free()
    bitwise = np.array_equal(served["reference"], served["MXTPU001"])
    print(f"route L: ResNet-50 v1 ({len(params)} arrays), the second of "
          f"two passes in turns: reference .params "
          f"{len(blobs['reference']):,} bytes written in "
          f"{writes['reference']:.1f} ms, loaded onto the card in "
          f"{loads['reference']:.1f} ms; MXTPU001 "
          f"{len(blobs['MXTPU001']):,} bytes written in "
          f"{writes['MXTPU001']:.1f} ms, loaded in "
          f"{loads['MXTPU001']:.1f} ms (writes warm in the page cache); "
          f"read back bitwise: {same}; "
          f"{RN_REF_REQUESTS} requests served from each: logits bitwise "
          f"equal: {bitwise}; card {_card_line()}")
    if not (same and bitwise and np.isfinite(served["reference"]).all()):
        raise AssertionError("route L: the reference-format ResNet-50 "
                             "differs from the MXTPU001 one")
    if any(hk.launch_counts.values()):
        raise AssertionError(f"route L launched a Hopper kernel: "
                             f"{dict(hk.launch_counts)}")


# ------------------------------------------ slice 14: the contrib op grid
# The contrib ops (``ops/contrib_ops.py``, the PSROI poolings of
# ``ops/parity_ops.py``) at small shapes: ``tests/test_torch_contrib_ops.py``
# holds the port to the JAX package on them, and ``tests/test_torch_gpu.py``
# the card to the CPU. "exact_grad": outputs equal, gradients within the
# tolerance (ROIPooling's maxima are selected, not computed).
TOL_CONTRIB_CARD = 1e-5      # of the case's largest |value|, card vs CPU


def roi_boxes(n, batch, height, width, scale=1.0, seed=0):
    """Seeded ROIs ``[batch, x1, y1, x2, y2]`` in the coordinates of an
    image ``1/scale`` times a height x width map, a few reaching past its
    edges and one wholly outside it."""
    rs = np.random.RandomState(seed)
    x1 = rs.uniform(-0.15, 0.8, n) * width
    y1 = rs.uniform(-0.15, 0.8, n) * height
    x2 = x1 + rs.uniform(0.05, 0.7, n) * width
    y2 = y1 + rs.uniform(0.05, 0.7, n) * height
    rois = np.stack([rs.randint(0, batch, n), x1, y1, x2, y2], 1) / \
        np.array([1, scale, scale, scale, scale])
    rois[-1, 1:] = np.array([width + 3, height + 2, width + 9, height + 7]) \
        / scale
    return rois.astype(np.float32)


def rpn_maps(batch, anchors, height, width, seed=0):
    """Seeded RPN outputs for ``Proposal``: scores (N, 2A, H, W) with a tied
    row, deltas (N, 4A, H, W)."""
    rs = np.random.RandomState(seed)
    cls = rs.uniform(0, 1, (batch, 2 * anchors, height, width))
    cls[:, anchors:, 1] = 0.5
    deltas = rs.randn(batch, 4 * anchors, height, width) * 0.3
    return cls.astype(np.float32), deltas.astype(np.float32)


def _grid_roi():
    data = grid_values(2, 3, 8, 10, seed=1)
    rois = roi_boxes(6, 2, 8, 10, seed=2)
    ps_data = grid_values(2, 2 * 9, 8, 10, seed=3)
    trans = grid_values(6, 4, 3, 3, seed=4)
    return [
        ("roi_pool", "ROIPooling", [data, rois],
         {"pooled_size": (3, 2), "spatial_scale": 1.0}, "exact_grad"),
        ("roi_pool_scaled_ties", "ROIPooling",
         [np.round(data), roi_boxes(6, 2, 8, 10, scale=0.5, seed=2)],
         {"pooled_size": (2, 2), "spatial_scale": 0.5}, "exact_grad"),
        ("roi_pool_all_tied", "ROIPooling",
         [np.zeros((1, 2, 4, 4), np.float32),
          np.array([[0, 0, 0, 3, 3]], np.float32)],
         {"pooled_size": (3, 3), "spatial_scale": 1.0}, "exact_grad"),
        ("roi_align", "_contrib_ROIAlign", [data, rois],
         {"pooled_size": (3, 2), "spatial_scale": 1.0, "sample_ratio": 2},
         "grad"),
        ("roi_align_adaptive_aligned", "ROIAlign",
         [data, roi_boxes(6, 2, 8, 10, scale=0.5, seed=2)],
         {"pooled_size": (2, 2), "spatial_scale": 0.5, "sample_ratio": -1,
          "aligned": True}, "grad"),
        ("psroi", "_contrib_PSROIPooling", [ps_data, rois],
         {"spatial_scale": 1.0, "output_dim": 2, "pooled_size": 3},
         "grad"),
        ("deformable_psroi", "DeformablePSROIPooling",
         [ps_data, rois, trans],
         {"spatial_scale": 1.0, "output_dim": 2, "pooled_size": 3,
          "group_size": 3, "trans_std": 0.1, "sample_per_part": 3},
         "grad"),
        ("deformable_psroi_no_trans", "_contrib_DeformablePSROIPooling",
         [ps_data, rois],
         {"spatial_scale": 1.0, "output_dim": 2, "pooled_size": 3,
          "no_trans": True}, "grad"),
    ]


def _grid_proposal():
    cls, deltas = rpn_maps(2, 9, 5, 7)
    info = np.array([[80, 112, 1.0], [70, 100, 1.5]], np.float32)
    common = {"scales": (2, 4, 8), "ratios": (0.5, 1, 2),
              "feature_stride": 16}
    loose = dict(common, rpn_pre_nms_top_n=200, rpn_post_nms_top_n=40,
                 threshold=0.7, rpn_min_size=16, output_score=True)
    # rpn_min_size 30 grows boxes and ties their scores at -1; 60 slots
    # for 50 boxes pads and fills the last slot from the suppressed ones
    tied = dict(common, scales=(1, 2, 4), rpn_pre_nms_top_n=50,
                rpn_post_nms_top_n=60, threshold=0.5, rpn_min_size=30,
                output_score=True)
    return [
        ("multi_proposal", "_contrib_MultiProposal", [cls, deltas, info],
         loose, "value"),
        ("multi_proposal_tied_padded", "MultiProposal",
         [cls, deltas, info], tied, "value"),
        ("proposal", "_contrib_Proposal", [cls, deltas, info], loose,
         "value"),
        ("proposal_tied_padded", "Proposal", [cls, deltas, info],
         dict(tied, output_score=False), "value"),
    ]


def _grid_contrib_other():
    data = grid_values(2, 3, 8, 10, seed=1)
    a, b = grid_values(2, 3, 9, 11, seed=5), grid_values(2, 3, 9, 11, seed=6)
    x = grid_values(3, 8, seed=7)
    return [
        ("deformable_conv", "_contrib_DeformableConvolution",
         [data, grid_values(2, 18, 8, 10, seed=8) * 0.75,
          grid_values(4, 3, 3, 3, seed=9), grid_values(4, seed=10)],
         {"kernel": (3, 3), "pad": (1, 1), "num_filter": 4}, "grad"),
        ("deformable_conv_groups", "DeformableConvolution",
         [grid_values(1, 4, 6, 6, seed=11),
          with_values(np.zeros((1, 16, 3, 3), np.float32), 0.5, -1.25),
          grid_values(4, 2, 2, 2, seed=12)],
         {"kernel": (2, 2), "stride": (2, 2), "num_filter": 4,
          "num_group": 2, "num_deformable_group": 2, "no_bias": True},
         "grad"),
        ("correlation_multiply", "Correlation", [a, b],
         {"kernel_size": 1, "max_displacement": 4, "stride2": 2,
          "pad_size": 4}, "grad"),
        ("correlation_absdiff", "Correlation", [a, b],
         {"kernel_size": 3, "max_displacement": 2, "stride1": 2,
          "pad_size": 1, "is_multiply": False}, "grad"),
        ("fft", "_contrib_fft", [x], {}, "grad"),
        ("ifft", "ifft", [grid_values(3, 16, seed=13)], {}, "grad"),
        ("count_sketch", "_contrib_count_sketch",
         [x, np.array([0, -1, 5, 2, 2, 9, -9, 1], np.float32),
          np.array([1, -1, 1, 1, -1, 1, -1, -1], np.float32)],
         {"out_dim": 5}, "grad"),
        ("adaptive_avg_pool", "_contrib_AdaptiveAvgPooling2D", [a],
         {"output_size": (4, 3)}, "grad"),
        ("adaptive_avg_pool_int", "AdaptiveAvgPooling2D", [a],
         {"output_size": 2}, "grad"),
        ("bilinear_resize", "_contrib_BilinearResize2D", [a],
         {"height": 13, "width": 5}, "grad"),
        ("bilinear_resize_scale", "BilinearResize2D", [a],
         {"scale_height": 2.0, "scale_width": 0.5}, "grad"),
    ]


CONTRIB_OP_GROUPS = {"roi": _grid_roi, "proposal": _grid_proposal,
                     "other": _grid_contrib_other}


def contrib_op_grid(dev, tol=TOL_CONTRIB_CARD):
    """Every case of ``CONTRIB_OP_GROUPS`` on the card against the same
    case on the CPU (``library_case_errors``). Returns (worst error, case
    count); raises naming every failing case."""
    failed, worst, count = [], 0.0, 0
    for group, cases in CONTRIB_OP_GROUPS.items():
        for seed, (cid, name, inputs, attrs, how) in enumerate(cases()):
            count += 1
            want = run_grid_case(name, inputs, attrs, how, seed)
            got = run_grid_case(name, inputs, attrs, how, seed, dev)
            f, w = library_case_errors(cid, name, how, got, want, tol)
            failed += f
            worst = max(worst, w)
    if failed:
        raise AssertionError("contrib op grid, card against CPU:\n"
                             + "\n".join(failed))
    return worst, count


# --------------------------- slice 14: route N, the contrib op grid at
# the shapes of the models that use each op (batch 1 where the model runs
# the op per image), card against CPU within TOL_ROUTE_N of the largest
# entry in float32 with TF32 off; the forward's ms on the card
TOL_ROUTE_N = 1e-5
ROUTE_N_TIMED = 5


def route_n_cases():
    """(case id, op, numpy inputs, attrs, what to compare, the model)."""
    rs = np.random.RandomState(SEED)

    def normal(*shape, std=1.0):
        return (rs.randn(*shape) * std).astype(np.float32)

    rfcn = normal(1, 21 * 49, 38, 63)
    rfcn_rois = roi_boxes(300, 1, 38, 63, scale=1 / 16, seed=3)
    sketch = normal(196, 512)
    return [
        ("roi_align_mask_rcnn", "_contrib_ROIAlign",
         [normal(1, 256, 50, 84), roi_boxes(512, 1, 50, 84, scale=1 / 16,
                                             seed=1)],
         {"pooled_size": (14, 14), "spatial_scale": 1 / 16,
          "sample_ratio": 2}, "grad",
         "Mask R-CNN's mask head (He et al. 2017): 512 ROIs, 14x14, "
         "sample_ratio 2, a 256-channel 800x1333 map at 1/16"),
        ("psroi_rfcn", "_contrib_PSROIPooling", [rfcn, rfcn_rois],
         {"spatial_scale": 1 / 16, "output_dim": 21, "pooled_size": 7,
          "group_size": 7}, "grad",
         "R-FCN (Dai et al. 2016): 300 ROIs, 21 classes, 7x7 groups over "
         "1,029 channels at 1/16 of 600x1000"),
        ("deformable_psroi_rfcn", "_contrib_DeformablePSROIPooling",
         [rfcn, rfcn_rois, normal(300, 2, 7, 7)],
         {"spatial_scale": 1 / 16, "output_dim": 21, "pooled_size": 7,
          "group_size": 7, "part_size": 7, "sample_per_part": 4,
          "trans_std": 0.1}, "grad",
         "Deformable R-FCN (Dai et al. 2017): the same, trans_std 0.1, "
         "sample_per_part 4"),
        ("deformable_conv_res5", "_contrib_DeformableConvolution",
         [normal(1, 512, 37, 62), normal(1, 18, 37, 62, std=2.0),
          normal(512, 512, 3, 3, std=0.02), normal(512, std=0.1)],
         {"kernel": (3, 3), "pad": (1, 1), "num_filter": 512}, "grad",
         "Deformable ConvNets (Dai et al. 2017): res5's 3x3, 512->512, "
         "on a 37x62 map"),
        ("correlation_flownetc", "Correlation",
         [normal(1, 256, 48, 64), normal(1, 256, 48, 64)],
         {"kernel_size": 1, "max_displacement": 20, "stride1": 1,
          "stride2": 2, "pad_size": 20}, "grad",
         "FlowNetC (Dosovitskiy et al. 2015): k 1, max displacement 20, "
         "stride2 2, pad 20, 256 channels at 48x64 (441 displacements)"),
        ("count_sketch_cbp", "_contrib_count_sketch",
         [sketch, rs.randint(0, 8192, 512).astype(np.float32),
          (rs.randint(0, 2, 512) * 2 - 1).astype(np.float32)],
         {"out_dim": 8192}, "grad",
         "compact bilinear pooling (Gao et al. 2016): 512 -> 8,192 at "
         "14x14 positions"),
        ("fft_cbp", "_contrib_fft", [normal(196, 8192)], {}, "grad",
         "compact bilinear pooling's FFT of the 8,192-d sketches"),
        ("ifft_cbp", "_contrib_ifft", [normal(196, 16384)], {}, "grad",
         "its inverse FFT"),
        ("adaptive_pool_psp", "_contrib_AdaptiveAvgPooling2D",
         [normal(1, 2048, 60, 60)], {"output_size": 6}, "grad",
         "PSPNet (Zhao et al. 2017): bin 6 over 2,048 channels at 60x60"),
        ("bilinear_resize_psp", "_contrib_BilinearResize2D",
         [normal(1, 512, 6, 6)], {"height": 60, "width": 60}, "grad",
         "PSPNet: a bin's 512 channels back to 60x60"),
    ] + [(f"adaptive_pool_psp_bin{b}", "AdaptiveAvgPooling2D",
          [normal(1, 2048, 60, 60)], {"output_size": b}, "grad",
          f"PSPNet: bin {b}") for b in (1, 2, 3)]


# ConvLSTM of Shi et al. 2015 on Moving MNIST: 64x64 frames as 16x16
# patches of 16, 64 hidden channels, 5x5 kernels, ten steps
CONVLSTM = dict(batch=8, channels=16, size=16, hidden=64, kernel=5,
                steps=10)


def _convlstm_run(mx, ctx, values, x):
    """Ten steps of ``Conv2DLSTMCell.unroll`` under ``autograd.record()``
    with the given weights: (outputs, final states, weight gradients)."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.contrib.rnn import Conv2DLSTMCell
    c = CONVLSTM
    cell = Conv2DLSTMCell((c["channels"], c["size"], c["size"]), c["hidden"],
                          c["kernel"], c["kernel"], i2h_pad=c["kernel"] // 2,
                          prefix="convlstm_")
    cell.initialize(ctx=ctx)
    params = cell.collect_params()
    for name, p in params.items():
        p.set_data(mx.nd.array(values[name], ctx=ctx))
    data = mx.nd.array(x, ctx=ctx)
    with autograd.record():
        out, states = cell.unroll(c["steps"], data, layout="NTC",
                                  merge_outputs=True)
        loss = (out * out).sum() + states[1].sum()
    loss.backward()
    return ([out.asnumpy()] + [s.asnumpy() for s in states],
            {n: p.grad.asnumpy() for n, p in params.items()})


def convlstm_case(mx, dev):
    """One ``Conv2DLSTMCell`` unroll (forward and weight gradients) on the
    card against the CPU: (worst error, card ms of the unroll with its
    backward)."""
    c = CONVLSTM
    rs = np.random.RandomState(SEED)
    g, k, h = 4 * c["hidden"], c["kernel"], c["hidden"]
    values = {
        "convlstm_i2h_weight": rs.randn(g, c["channels"], k, k) * 0.05,
        "convlstm_h2h_weight": rs.randn(g, h, k, k) * 0.02,
        "convlstm_i2h_bias": rs.randn(g) * 0.1,
        "convlstm_h2h_bias": rs.randn(g) * 0.1}
    values = {n: v.astype(np.float32) for n, v in values.items()}
    x = rs.randn(c["batch"], c["steps"], c["channels"], c["size"],
                 c["size"]).astype(np.float32)
    want = _convlstm_run(mx, mx.cpu(), values, x)
    got = _convlstm_run(mx, _ctx(mx, dev), values, x)
    errs = [grid_error(a, b) for a, b in zip(got[0], want[0])]
    errs += [grid_error(got[1][n], w) for n, w in want[1].items()]
    ms = _time_ms(lambda: _convlstm_run(mx, _ctx(mx, dev), values, x), 3)
    return max(errs), ms


def route_n_phase(mx, hk, dev):
    """Route N (phase 31): every case of ``route_n_cases`` and one
    ``Conv2DLSTMCell`` unroll on the card against the CPU (discrete
    outputs equal, the rest and the gradients within ``TOL_ROUTE_N`` of
    the largest entry), each forward timed on the card. No Hopper kernel
    may launch."""
    from mxnet_tpu_torch.ops.registry import get_op
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    failed, rows = [], []
    for seed, (cid, name, inputs, attrs, how, model) in enumerate(
            route_n_cases()):
        want = run_grid_case(name, inputs, attrs, how, seed)
        got = run_grid_case(name, inputs, attrs, how, seed, dev)
        f, worst = library_case_errors(cid, name, how, got, want,
                                       TOL_ROUTE_N)
        failed += f
        ts = [torch.from_numpy(a).to(dev) for a in inputs]
        fn = get_op(name).fn
        ms = _time_ms(lambda: fn(*ts, **attrs), ROUTE_N_TIMED)
        rows.append(f"  {cid}: {worst:.2e}, forward {ms:.3f} ms ({model})")
        del want, got, ts
    worst, ms = convlstm_case(mx, dev)
    if not worst <= TOL_ROUTE_N:
        failed.append(f"conv2d_lstm_unroll: {worst:.3e}")
    c = CONVLSTM
    rows.append(f"  conv2d_lstm_unroll: {worst:.2e}, {c['steps']} steps "
                f"with the backward {ms:.3f} ms (ConvLSTM, Shi et al. 2015: "
                f"batch {c['batch']}, {c['channels']}x{c['size']}x"
                f"{c['size']} in, {c['hidden']} hidden, {c['kernel']}x"
                f"{c['kernel']})")
    print(f"route N: the contrib ops at their models' shapes on the card "
          f"against the CPU (tolerance {TOL_ROUTE_N} of the largest entry; "
          f"ms on the card {_card_line()}); "
          f"{time.perf_counter() - t0:.1f} s:\n" + "\n".join(rows))
    if failed:
        raise AssertionError("route N, card against CPU:\n"
                             + "\n".join(failed))
    if any(hk.launch_counts.values()):
        raise AssertionError(f"route N launched a Hopper kernel: "
                             f"{dict(hk.launch_counts)}")


# ---------------------------- slice 14: route M, Faster R-CNN with VGG16
# Ren, He, Girshick & Sun, "Faster R-CNN" (arXiv:1506.01497) as the
# reference example/rcnn trains it end to end with py-faster-rcnn's
# defaults (faster_rcnn_end2end.yml): one 600x1000 image a step, the VGG16
# body to conv5_3 (the zoo's vgg16 features, 37x62 at stride 16), a 3x3
# RPN conv of 512 with 18 scores and 36 deltas over 9 anchors a place
# (scales 8, 16, 32; ratios 0.5, 1, 2: 20,646 anchors), 256 RPN samples
# (at most half foreground at IoU 0.7, background below 0.3), MultiProposal
# 12,000 -> 2,000 at NMS 0.7 and min size 16, 128 ROIs (at most 25 %
# foreground at IoU 0.5, background below 0.5) from the proposals and the
# ground truth, ROIPooling 7x7 at 1/16, fc6 25088->4096, fc7 4096->4096, 21
# class scores and 84 deltas (targets over stds 0.1, 0.1, 0.2, 0.2), SGD
# lr 1e-3, momentum 0.9, wd 5e-4, float32. Cut: random weights from the
# seed (no ImageNet VGG16), seeded synthetic images with 1-5 drawn boxes
# of VOC's 20 classes (VOC is not in the repo), and no dropout after fc6
# and fc7 (so that step 1 can be repeated in float64).
RCNN = dict(image=(600, 1000), classes=21, stride=16, scales=(8, 16, 32),
            ratios=(0.5, 1, 2), rpn_pre=12000, rpn_post=2000, rpn_nms=0.7,
            rpn_min=16, rpn_batch=256, rpn_fg=0.5, rpn_pos=0.7, rpn_neg=0.3,
            rois=128, fg_fraction=0.25, fg_iou=0.5, pooled=7, lr=1e-3,
            momentum=0.9, wd=5e-4, test_pre=6000, test_post=300,
            test_nms=0.3, test_thresh=0.05, images=4)
RCNN_BODY = 30               # the zoo vgg16's features up to conv5_3's ReLU
RCNN_STDS = (0.1, 0.1, 0.2, 0.2)
RCNN_TIMED = 10              # steps timed, after the checked one
# step 1 against float64, bounds set before the first run: the loss sums
# log-probabilities of float32 logits each of whose products is a dot of
# up to 25,088 terms (~sqrt(K)·eps ≈ 1e-5 of it, relative, through 15
# layers), so 1e-5 relative; the heads' and the RPN's gradients are sums
# over 128 ROIs or 2,294 places of such products: 1e-4 by ||dg||/||g||;
# the body's gradients pass ReLUs and ROIPooling's maxima whose float32
# and float64 choices differ near ties (route F's body measured 1e-2):
# 2e-2 by ||dg||/||g||
TOL_RCNN_LOSS = 1e-5
TOL_RCNN_GRAD_HEAD = 1e-4
TOL_RCNN_GRAD = 2e-2
TOL_RCNN_PROPOSAL = 1e-5     # MultiProposal's boxes, card against CPU


def rcnn_images(mx, ctx, n=None, seed=SEED):
    """``n`` seeded synthetic 600x1000 images (noise, with 1-5 boxes of
    random colours drawn on it) as NDArrays (1, 3, H, W), and their
    ground truth (G, 5) rows ``[x1, y1, x2, y2, class]`` on ``ctx``."""
    rs = np.random.RandomState(seed)
    h, w = RCNN["image"]
    out = []
    for _ in range(n or RCNN["images"]):
        img = rs.uniform(-0.3, 0.3, (1, 3, h, w)).astype(np.float32)
        gt = []
        for _ in range(rs.randint(1, 6)):
            bw, bh = rs.randint(w // 20, w * 12 // 25), \
                rs.randint(h // 12, h * 3 // 5)
            x1, y1 = rs.randint(0, w - bw), rs.randint(0, h - bh)
            img[0, :, y1:y1 + bh, x1:x1 + bw] += rs.uniform(
                -1, 1, (3, 1, 1)).astype(np.float32)
            gt.append([x1, y1, x1 + bw - 1, y1 + bh - 1,
                       rs.randint(1, RCNN["classes"])])
        out.append((mx.nd.array(img, ctx=ctx),
                    mx.nd.array(np.array(gt, np.float32), ctx=ctx)))
    return out


def build_faster_rcnn(mx):
    """The net: ``features(x)`` gives (conv5_3, RPN scores, RPN deltas),
    ``head(pooled)`` (class scores, deltas)."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo import vision
    a = len(RCNN["scales"]) * len(RCNN["ratios"])

    class FasterRCNN(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                vgg = vision.vgg16()
                self.body = nn.HybridSequential()
                for i in range(RCNN_BODY):
                    self.body.add(vgg.features[i])
                self.rpn_conv = nn.Conv2D(512, 3, padding=1,
                                          activation="relu")
                self.rpn_cls = nn.Conv2D(2 * a, 1)
                self.rpn_reg = nn.Conv2D(4 * a, 1)
                self.fc6 = nn.Dense(4096, activation="relu")
                self.fc7 = nn.Dense(4096, activation="relu")
                self.cls_score = nn.Dense(
                    RCNN["classes"], weight_initializer=mx.init.Normal(0.01))
                self.bbox_pred = nn.Dense(
                    4 * RCNN["classes"],
                    weight_initializer=mx.init.Normal(0.001))

        def features(self, x):
            f = self.body(x)
            r = self.rpn_conv(f)
            return f, self.rpn_cls(r), self.rpn_reg(r)

        def head(self, pooled):
            h = self.fc7(self.fc6(pooled))
            return self.cls_score(h), self.bbox_pred(h)

    return FasterRCNN(prefix="rcnn_")


def rcnn_net(mx, ctx, weights=None, dtype="float32"):
    """The net on ``ctx``: seeded (Xavier with a Gaussian of fan-in scale
    2 for the body, py-faster-rcnn's N(0, 0.01) and N(0, 0.001) for the
    heads), or ``weights`` (name -> tensor), in ``dtype``."""
    mx.random.seed(SEED)
    net = build_faster_rcnn(mx)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=ctx)
    h, w = RCNN["image"]
    net.features(mx.nd.zeros((1, 3, h, w), ctx=ctx))
    net.head(mx.nd.zeros((1, 512, RCNN["pooled"], RCNN["pooled"]), ctx=ctx))
    params = net.collect_params()
    for name, p in params.items():
        if dtype != "float32":
            p.cast(dtype)
        if weights is not None:
            p.set_data(mx.nd.NDArray(weights[name]))
    return net


def rcnn_anchors(mx, ctx, h, w):
    """The anchors of an h x w map at the route's stride, (h·w·A, 4) in
    the order of MultiProposal and the RPN's outputs."""
    from mxnet_tpu_torch.ops.contrib_ops import _make_anchors
    base = _make_anchors(RCNN["stride"], RCNN["scales"],
                         RCNN["ratios"]).numpy()
    sx, sy = np.meshgrid(np.arange(w) * RCNN["stride"],
                         np.arange(h) * RCNN["stride"])
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], 1)
    return mx.nd.array((base[None] + shifts[:, None]).reshape(-1, 4),
                       ctx=ctx)


def rcnn_iou(mx, a, b):
    """(n, m) IoU of inclusive-pixel boxes a (n, 4) and b (m, 4)."""
    ax1, ay1, ax2, ay2 = mx.nd.split(a, 4, axis=1)
    bx1, by1, bx2, by2 = mx.nd.split(mx.nd.transpose(b), 4, axis=0)
    iw = mx.nd.relu(mx.nd.broadcast_minimum(ax2, bx2)
                    - mx.nd.broadcast_maximum(ax1, bx1) + 1)
    ih = mx.nd.relu(mx.nd.broadcast_minimum(ay2, by2)
                    - mx.nd.broadcast_maximum(ay1, by1) + 1)
    inter = iw * ih
    area = mx.nd.broadcast_add((ax2 - ax1 + 1) * (ay2 - ay1 + 1),
                               (bx2 - bx1 + 1) * (by2 - by1 + 1))
    return inter / (area - inter)


def rcnn_deltas(mx, src, gt):
    """The (dx, dy, dw, dh) of boxes gt (n, 4) against src (n, 4)."""
    sx1, sy1, sx2, sy2 = mx.nd.split(src, 4, axis=1)
    gx1, gy1, gx2, gy2 = mx.nd.split(gt, 4, axis=1)
    sw, sh = sx2 - sx1 + 1, sy2 - sy1 + 1
    gw, gh = gx2 - gx1 + 1, gy2 - gy1 + 1
    return mx.nd.concat(((gx1 + 0.5 * (gw - 1)) - (sx1 + 0.5 * (sw - 1)))
                        / sw,
                        ((gy1 + 0.5 * (gh - 1)) - (sy1 + 0.5 * (sh - 1)))
                        / sh,
                        mx.nd.log(gw / sw), mx.nd.log(gh / sh), dim=1)


def _rank_desc(mx, key):
    """Each entry's position in a descending sort of key (n, 1)."""
    order = mx.nd.argsort(-key.reshape((-1,)))
    return mx.nd.argsort(order).reshape((-1, 1))


def rcnn_sample(mx, anchors, rois, gt, im_h, im_w, ctx):
    """py-faster-rcnn's AnchorTargetLayer and ProposalTargetLayer as
    ``mx.nd`` ops on ``ctx`` (no host loop over anchors or ROIs), random
    choices from the context's seeded generator. Returns the RPN's labels
    (K, 1) (1 foreground, 0 background, -1 ignored), its box targets
    (K, 4) and foreground mask (K, 1); the heads' ROIs (128, 5), labels
    (128,), class-specific targets and their mask (128, 84)."""
    c = RCNN
    boxes = gt[:, :4]
    # the RPN's 256 anchors
    ax1, ay1, ax2, ay2 = mx.nd.split(anchors, 4, axis=1)
    inside = (ax1 >= 0) * (ay1 >= 0) * (ax2 < im_w) * (ay2 < im_h)
    iou = mx.nd.broadcast_mul(rcnn_iou(mx, anchors, boxes), inside)
    best = iou.max(axis=1, keepdims=True)
    best_gt = iou.argmax(axis=1)
    top = mx.nd.broadcast_equal(iou, iou.max(axis=0, keepdims=True)) * \
        (iou > 0)
    fg = mx.nd.maximum(top.max(axis=1, keepdims=True),
                       best >= c["rpn_pos"]) * inside
    bg = (best < c["rpn_neg"]) * inside * (1 - fg)
    keys = mx.nd.random_uniform(shape=best.shape, ctx=ctx)
    n_fg = int(c["rpn_batch"] * c["rpn_fg"])
    fg = fg * (_rank_desc(mx, mx.nd.where(fg, keys, keys - 2)) < n_fg)
    room = c["rpn_batch"] - fg.sum()
    bg = bg * mx.nd.broadcast_lesser(
        _rank_desc(mx, mx.nd.where(bg, keys, keys - 2)), room.reshape((1, 1)))
    rpn_label = fg - (1 - fg - bg)
    rpn_target = rcnn_deltas(mx, anchors, mx.nd.take(boxes, best_gt))
    # the heads' 128 ROIs from the proposals and the ground truth
    cand = mx.nd.concat(rois, boxes, dim=0)
    iou = rcnn_iou(mx, cand, boxes)
    best = iou.max(axis=1, keepdims=True)
    best_gt = iou.argmax(axis=1)
    is_fg = best >= c["fg_iou"]
    keys = mx.nd.random_uniform(shape=best.shape, ctx=ctx)
    fg_keep = is_fg * (_rank_desc(mx, mx.nd.where(is_fg, keys, keys - 2))
                       < int(c["rois"] * c["fg_fraction"]))
    # kept foreground first, then background, then the surplus foreground
    prio = (fg_keep * 2 + (1 - is_fg) + keys).reshape((-1,))
    sel = mx.nd.topk(prio, k=c["rois"], ret_typ="indices")
    head_rois = mx.nd.take(cand, sel)
    fg_sel = mx.nd.take(fg_keep, sel).reshape((-1,))
    gt_sel = mx.nd.take(best_gt, sel)
    label = mx.nd.take(gt[:, 4], gt_sel) * fg_sel
    target = rcnn_deltas(mx, head_rois, mx.nd.take(boxes, gt_sel)) / \
        mx.nd.array(RCNN_STDS, ctx=ctx).reshape((1, 4))
    mask = mx.nd.repeat(mx.nd.one_hot(label, c["classes"])
                        * fg_sel.reshape((-1, 1)), repeats=4, axis=1)
    head_rois = mx.nd.concat(mx.nd.zeros((c["rois"], 1), ctx=ctx),
                             head_rois, dim=1)
    return dict(rpn_label=rpn_label, rpn_target=rpn_target, rpn_fg=fg,
                rois=head_rois, label=label,
                target=mx.nd.tile(target, reps=(1, c["classes"])) * mask,
                mask=mask)


def _rpn_prob(mx, rpn_cls):
    """The RPN's scores as MultiProposal takes them: a softmax over each
    anchor's (background, foreground) pair, (1, 2A, H, W)."""
    n, a2, h, w = rpn_cls.shape
    return mx.nd.softmax(rpn_cls.reshape((n, 2, a2 // 2 * h, w)),
                         axis=1).reshape((n, a2, h, w))


def rcnn_proposals(mx, rpn_cls, rpn_reg, im_info, pre, post):
    return mx.nd.contrib.MultiProposal(
        _rpn_prob(mx, rpn_cls), rpn_reg, im_info, rpn_pre_nms_top_n=pre,
        rpn_post_nms_top_n=post, threshold=RCNN["rpn_nms"],
        rpn_min_size=RCNN["rpn_min"], scales=RCNN["scales"],
        ratios=RCNN["ratios"], feature_stride=RCNN["stride"])


def rcnn_losses(mx, net, feat, rpn_cls, rpn_reg, s):
    """The four losses of a step over the samples ``s``: the RPN's
    softmax and smooth-L1 (sigma 3) over its sampled anchors, the heads'
    softmax over the 128 ROIs and smooth-L1 (sigma 1) over the foreground
    ROIs' class-specific deltas."""
    a = rpn_cls.shape[1] // 2
    pairs = rpn_cls.reshape((2, a, -1)).transpose((2, 1, 0)).reshape((-1, 2))
    label = s["rpn_label"].reshape((-1,))
    valid = label >= 0
    nll = -mx.nd.pick(mx.nd.log_softmax(pairs, axis=1),
                      mx.nd.maximum(label, 0), axis=1)
    count = valid.sum()
    rpn_cls_loss = (nll * valid).sum() / count
    deltas = rpn_reg.reshape((a, 4, -1)).transpose((2, 0, 1)) \
        .reshape((-1, 4))
    rpn_box_loss = (mx.nd.smooth_l1(deltas - s["rpn_target"], scalar=3.0)
                    * s["rpn_fg"]).sum() / count
    pooled = mx.nd.ROIPooling(feat, s["rois"],
                              pooled_size=(RCNN["pooled"], RCNN["pooled"]),
                              spatial_scale=1.0 / RCNN["stride"])
    score, bbox = net.head(pooled)
    cls_loss = -mx.nd.pick(mx.nd.log_softmax(score, axis=1), s["label"],
                           axis=1).mean()
    box_loss = (mx.nd.smooth_l1(bbox - s["target"], scalar=1.0)
                * s["mask"]).sum() / RCNN["rois"]
    return rpn_cls_loss + rpn_box_loss + cls_loss + box_loss, \
        (rpn_cls_loss, rpn_box_loss, cls_loss, box_loss)


def rcnn_step(mx, net, trainer, x, gt, anchors, ctx, samples=None):
    """One training step (``trainer`` None: forward and backward only):
    the body and the RPN, MultiProposal, the sampling (or ``samples``, as
    data), ROIPooling, the heads and the losses under
    ``autograd.record()``. Returns (loss, the step's proposals and
    samples)."""
    import torch.profiler as tp
    from mxnet_tpu_torch import autograd
    h, w = x.shape[2], x.shape[3]
    im_info = mx.nd.array([[h, w, 1.0]], ctx=ctx)
    with autograd.record():
        with tp.record_function("rcnn.body_rpn"):
            feat, rpn_cls, rpn_reg = net.features(x)
        if samples is None:
            with autograd.pause(), tp.record_function("rcnn.proposal"):
                rois = rcnn_proposals(mx, rpn_cls, rpn_reg, im_info,
                                      RCNN["rpn_pre"], RCNN["rpn_post"])
            with autograd.pause(), tp.record_function("rcnn.sample"):
                samples = rcnn_sample(mx, anchors, rois[:, 1:], gt, h, w,
                                      ctx)
                samples["proposals"] = rois
        with tp.record_function("rcnn.heads_loss"):
            loss, _ = rcnn_losses(mx, net, feat, rpn_cls, rpn_reg, samples)
    with tp.record_function("rcnn.backward"):
        loss.backward()
    if trainer is not None:
        with tp.record_function("rcnn.update"):
            trainer.step(1)
    return loss, samples


def rcnn_detect(mx, net, x):
    """The test-time forward (py-faster-rcnn's test setting): 6,000 ->
    300 proposals, ROIPooling, the heads, the class-specific boxes decoded
    and clipped, per-class ``box_nms`` at 0.3. Returns (1, 6000, 6) rows
    ``[class - 1, score, x1, y1, x2, y2]``, a suppressed row all -1."""
    c = RCNN
    h, w = x.shape[2], x.shape[3]
    ctx = x.context
    im_info = mx.nd.array([[h, w, 1.0]], ctx=ctx)
    feat, rpn_cls, rpn_reg = net.features(x)
    rois = rcnn_proposals(mx, rpn_cls, rpn_reg, im_info, c["test_pre"],
                          c["test_post"])
    pooled = mx.nd.ROIPooling(feat, rois, pooled_size=(c["pooled"],) * 2,
                              spatial_scale=1.0 / c["stride"])
    score, bbox = net.head(pooled)
    prob = mx.nd.softmax(score, axis=1)
    n, k = rois.shape[0], c["classes"]
    d = bbox.reshape((n, k, 4)) * mx.nd.array(RCNN_STDS, ctx=ctx) \
        .reshape((1, 1, 4))
    x1, y1, x2, y2 = mx.nd.split(rois[:, 1:], 4, axis=1)
    bw, bh = x2 - x1 + 1, y2 - y1 + 1
    cx, cy = x1 + 0.5 * (bw - 1), y1 + 0.5 * (bh - 1)
    dx, dy, dw, dh = mx.nd.split(d, 4, axis=2)
    pcx = dx.reshape((n, k)) * bw + cx
    pcy = dy.reshape((n, k)) * bh + cy
    pw = mx.nd.exp(dw.reshape((n, k))) * bw
    ph = mx.nd.exp(dh.reshape((n, k))) * bh
    boxes = mx.nd.stack(
        mx.nd.clip(pcx - 0.5 * (pw - 1), 0, w - 1),
        mx.nd.clip(pcy - 0.5 * (ph - 1), 0, h - 1),
        mx.nd.clip(pcx + 0.5 * (pw - 1), 0, w - 1),
        mx.nd.clip(pcy + 0.5 * (ph - 1), 0, h - 1), axis=2)
    cls_id = mx.nd.broadcast_mul(mx.nd.ones((n, 1), ctx=ctx),
                                 mx.nd.arange(k, ctx=ctx).reshape((1, k)))
    rows = mx.nd.concat(cls_id.reshape((n, k, 1)) - 1,
                        prob.reshape((n, k, 1)), boxes, dim=2)[:, 1:]
    return mx.nd.contrib.box_nms(rows.reshape((1, -1, 6)),
                                 overlap_thresh=c["test_nms"],
                                 valid_thresh=0.0, coord_start=2,
                                 score_index=1, id_index=0)


def _rcnn_grads(net):
    return {n: p.grad._data.detach().clone()
            for n, p in net.collect_params().items()
            if p.grad_req != "null"}


def faster_rcnn_phase(mx, hk, dev, profile=False):
    """Route M (phase 30): Faster R-CNN with VGG16 at 600x1000 trained on
    the card (``RCNN``). Step 1: MultiProposal on the card keeps the CPU's
    anchors for the same inputs (boxes within ``TOL_RCNN_PROPOSAL``; a
    control at NMS 0.69 must keep others), ROIPooling's forward bitwise the
    CPU's on the step's conv5_3 and ROIs (a control at 1.01x the scale must
    differ), and the step against the same step in float64 on the card fed
    the step's proposals and samples (loss, the heads' and the body's
    gradients). Then timed steps, MultiProposal's and ROIPooling's times,
    and the test-time detection forward. No Hopper kernel may launch."""
    from mxnet_tpu_torch.ops import contrib_ops as co
    c = RCNN
    ctx = _ctx(mx, dev)
    hk.reset_launch_counts()
    t_phase = time.perf_counter()
    images = rcnn_images(mx, ctx)
    h, w = c["image"]
    net = rcnn_net(mx, ctx)
    n_params = sum(p.data()._data.numel()
                   for p in net.collect_params().values())
    w0 = {n: p.data()._data.detach().clone()
          for n, p in net.collect_params().items()}
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": c["lr"], "momentum": c["momentum"], "wd": c["wd"]})
    fh, fw = (h // 16, w // 16)
    anchors = rcnn_anchors(mx, ctx, fh, fw)
    x, gt = images[0]
    loss, samples = rcnn_step(mx, net, None, x, gt, anchors, ctx)
    g32 = _rcnn_grads(net)
    trainer.step(1)
    n_fg = int(samples["rpn_fg"].sum().asscalar())
    n_rpn = int((samples["rpn_label"] >= 0).sum().asscalar())
    n_head_fg = int((samples["label"] > 0).sum().asscalar())
    print(f"route M: Faster R-CNN, VGG16 body to conv5_3, {n_params:,} "
          f"parameters, one {h}x{w} image a step ({gt.shape[0]} boxes), "
          f"conv5_3 {fh}x{fw}, {anchors.shape[0]:,} anchors; step 1 loss "
          f"{loss.asscalar():.6f}; RPN samples {n_rpn} ({n_fg} foreground), "
          f"head ROIs {c['rois']} ({n_head_fg} foreground)")

    # MultiProposal and ROIPooling on the card against the CPU
    feat, rpn_cls, rpn_reg = net.features(x)
    prob = _rpn_prob(mx, rpn_cls)._data
    info = torch.tensor([[h, w, 1.0]], device=dev)
    args = dict(anchors=co._make_anchors(c["stride"], c["scales"],
                                         c["ratios"]),
                feature_stride=c["stride"], pre_nms=c["rpn_pre"],
                post_nms=c["rpn_post"], min_size=float(c["rpn_min"]))
    card = co._proposals(prob, rpn_reg._data, info, threshold=c["rpn_nms"],
                         **args)
    host = co._proposals(prob.cpu(), rpn_reg._data.cpu(), info.cpu(),
                         threshold=c["rpn_nms"], **args)
    ctrl = co._proposals(prob, rpn_reg._data, info, threshold=0.69, **args)
    same_idx = torch.equal(card[2].cpu(), host[2])
    e_box = grid_error(card[0].cpu().numpy(), host[0].numpy())
    ctrl_same = torch.equal(ctrl[2].cpu(), host[2])
    ms_prop = _time_ms(lambda: rcnn_proposals(
        mx, rpn_cls, rpn_reg, mx.nd.NDArray(info), c["rpn_pre"],
        c["rpn_post"]), 5)
    rois = samples["rois"]
    pool = dict(pooled_size=(c["pooled"], c["pooled"]),
                spatial_scale=1.0 / c["stride"])
    p_card = co._roi_pooling(feat._data, rois._data, **pool)
    p_host = co._roi_pooling(feat._data.cpu(), rois._data.cpu(), **pool)
    p_ctrl = co._roi_pooling(feat._data, rois._data, pooled_size=pool[
        "pooled_size"], spatial_scale=1.01 / c["stride"])
    pool_bitwise = torch.equal(p_card.cpu(), p_host)
    ctrl_bitwise = torch.equal(p_ctrl.cpu(), p_host)
    leaf = feat._data.detach().requires_grad_()
    out = co._roi_pooling(leaf, rois._data, **pool)
    g_out = torch.ones_like(out)
    ms_pool = _time_ms(lambda: co._roi_pooling(feat._data, rois._data,
                                               **pool), 10)
    ms_pool_b = _time_ms(lambda: torch.autograd.grad(
        out, leaf, g_out, retain_graph=True), 10)
    print(f"route M: MultiProposal ({c['rpn_pre']:,} -> {c['rpn_post']:,} "
          f"at NMS {c['rpn_nms']}) on the card keeps the CPU's anchors: "
          f"{same_idx}, boxes within {e_box:.2e} (tol {TOL_RCNN_PROPOSAL}); "
          f"NMS fixed point in {card[3]} batched steps; control at NMS "
          f"0.69 keeps the same: {ctrl_same} (must not); {ms_prop:.3f} ms. "
          f"ROIPooling ({c['rois']} ROIs, 512x{fh}x{fw}, 7x7) bitwise the "
          f"CPU's: {pool_bitwise}; control at 1.01x the scale bitwise: "
          f"{ctrl_bitwise} (must not); forward {ms_pool:.3f} ms, backward "
          f"{ms_pool_b:.3f} ms; card {_card_line()}")
    if not (same_idx and e_box <= TOL_RCNN_PROPOSAL and pool_bitwise):
        raise AssertionError("route M: MultiProposal or ROIPooling on the "
                             "card differs from the CPU")
    if ctrl_same or ctrl_bitwise:
        raise AssertionError("route M: a control met its check")
    del feat, rpn_cls, rpn_reg, prob, card, host, ctrl, p_card, p_host, \
        p_ctrl, leaf, out, g_out

    # step 1 against float64 on the card, fed the step's samples
    net64 = rcnn_net(mx, ctx, weights=w0, dtype="float64")
    s64 = {k: v.astype("float64") for k, v in samples.items()}
    loss64, _ = rcnn_step(mx, net64, None, x.astype("float64"),
                          gt.astype("float64"), anchors.astype("float64"),
                          ctx, samples=s64)
    g64 = _rcnn_grads(net64)
    e_loss = abs(loss.asscalar() - loss64.asscalar()) / abs(
        loss64.asscalar())
    heads = set()
    for block in (net.rpn_conv, net.rpn_cls, net.rpn_reg, net.fc6, net.fc7,
                  net.cls_score, net.bbox_pred):
        heads |= set(block.collect_params().keys())
    worst_head, worst_body = 0.0, 0.0
    for name, g in g64.items():
        err = ((g32[name].double() - g).norm()
               / g.norm().clamp_min(1e-300)).item()
        if name in heads:
            worst_head = max(worst_head, err)
        else:
            worst_body = max(worst_body, err)
    print(f"route M: step 1 against float64 on the card: loss rel "
          f"{e_loss:.2e} "
          f"(tol {TOL_RCNN_LOSS}); the RPN's and heads' gradients "
          f"{worst_head:.2e} (tol {TOL_RCNN_GRAD_HEAD}); the body's "
          f"{worst_body:.2e} (tol {TOL_RCNN_GRAD}), by ||dg||/||g||")
    if not (e_loss <= TOL_RCNN_LOSS and worst_head <= TOL_RCNN_GRAD_HEAD
            and worst_body <= TOL_RCNN_GRAD):
        raise AssertionError("route M: step 1 is not within its float64 "
                             "gates")
    del net64, s64, g64, g32
    _free()

    # timed steps
    losses, steps = [loss.asscalar()], []
    torch.cuda.reset_peak_memory_stats()
    for k in range(1, 1 + RCNN_TIMED):
        xb, gb = images[k % len(images)]
        out = {}

        def step(xb=xb, gb=gb):
            out["loss"] = rcnn_step(mx, net, trainer, xb, gb, anchors,
                                    ctx)[0]
        steps.append(_timed_step(step))
        losses.append(out["loss"].asscalar())
    peak = torch.cuda.max_memory_allocated() / 1e9
    host = 1e3 * float(np.median([s[0] for s in steps]))
    devms = float(np.median([s[1] for s in steps]))
    wall = 1e3 * float(np.median([s[2] for s in steps]))
    print(f"route M: {RCNN_TIMED} timed steps: {wall:.2f} ms a step "
          f"({devms:.2f} ms between its events on the card, host dispatch "
          f"{host:.2f} ms), {1e3 / wall:.2f} images/s; peak memory "
          f"{peak:.2f} GB; loss {losses[0]:.5f} -> {losses[-1]:.5f}; card "
          f"{_card_line()}")
    if not np.isfinite(losses).all():
        raise AssertionError("route M: a loss is not finite")
    if profile:
        xb, gb = images[0]
        profile_breakdown(
            "route M step",
            lambda: rcnn_step(mx, net, trainer, xb, gb, anchors, ctx),
            ranges=("rcnn.body_rpn", "rcnn.proposal", "rcnn.sample",
                    "rcnn.heads_loss", "rcnn.backward", "rcnn.update"))

    # the test-time detection forward
    from mxnet_tpu_torch import autograd
    with autograd.predict_mode():
        dets = rcnn_detect(mx, net, images[0][0])
        ms_det = _time_ms(lambda: rcnn_detect(mx, net, images[0][0]), 3)
    d = dets.asnumpy()[0]
    kept = d[:, 0] >= 0
    shown = int((d[kept, 1] >= c["test_thresh"]).sum())
    print(f"route M: detection ({c['test_pre']:,} -> {c['test_post']} "
          f"proposals, per-class box_nms at {c['test_nms']}): "
          f"{ms_det:.2f} ms an image; {int(kept.sum())} of {d.shape[0]} "
          f"rows kept, {shown} scoring at least {c['test_thresh']}; "
          f"{time.perf_counter() - t_phase:.1f} s for the phase")
    if not (d.shape == (c["test_post"] * (c["classes"] - 1), 6)
            and np.isfinite(d).all() and kept.any()):
        raise AssertionError(f"route M: detections {d.shape}")
    if any(hk.launch_counts.values()):
        raise AssertionError(f"route M launched a Hopper kernel: "
                             f"{dict(hk.launch_counts)}")



# ----------------------------------- slice 15: graph passes, int8 (route O)
class PassAudit:
    """Every graph-pass pipeline run while the smoke drives the routes
    (``PassManager.run``: ``Module``'s bind, the fused trainer's capture,
    the buckets and stages built on them) is recorded and run again on the
    same graph on the host; a route whose rewrite counts differ from the
    recount, or whose pipeline logged a fallback (a pass skipped, or the
    unrewritten graph bound), fails at :meth:`report`, which also prints
    each Module's and trainer's ``passes_provenance()``."""

    def __init__(self):
        import logging
        from mxnet_tpu_torch import passes
        self.records, self.owners, self.fallbacks = [], [], []
        self._manager = passes.PassManager
        self._saved = [(passes.PassManager, "run", passes.PassManager.run)]
        audit, run0 = self, passes.PassManager.run

        def run(mgr, sym, *args, **kwargs):
            res = run0(mgr, sym, *args, **kwargs)
            audit.records.append((mgr, sym, args, kwargs, dict(res.counts)))
            return res

        passes.PassManager.run = run
        for cls in (mx.mod.Module, mx.parallel.DataParallelTrainer):
            self._saved.append((cls, "_run_passes", cls._run_passes))

            def owned(obj, *a, _orig=cls._run_passes, **k):
                out = _orig(obj, *a, **k)
                # the provenance, not the object: a module holds its
                # weights, which the next phase needs the memory of
                audit.owners.append((type(obj).__name__, json.dumps(
                    obj.passes_provenance(), sort_keys=True)))
                return out

            cls._run_passes = owned

        class Fallbacks(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if "graph pass" in msg or "graph-pass pipeline" in msg:
                    audit.fallbacks.append(msg)

        self._handler = Fallbacks(logging.WARNING)
        self._loggers = [logging.getLogger("mxnet_tpu_torch"),
                         logging.getLogger()]
        for lg in self._loggers:
            lg.addHandler(self._handler)

    def close(self):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)
        for lg in self._loggers:
            lg.removeHandler(self._handler)

    def report(self, route: str) -> None:
        """Print the provenance of every Module and trainer bound since
        the last report, and check each pipeline run against a recount on
        the host."""
        run0 = self._saved[0][2]
        for mgr, sym, args, kwargs, counts in self.records:
            fresh = self._manager(list(mgr.passes), mgr.input_layout,
                                  mgr.rehome_params)
            recount = dict(run0(fresh, sym, *args, **kwargs).counts)
            if recount != counts:
                raise AssertionError(f"{route}: the pass counts {counts} "
                                     f"differ from the host's recount "
                                     f"{recount}")
        seen = {}
        for key in self.owners:
            seen[key] = seen.get(key, 0) + 1
        for (kind, prov), n in seen.items():
            print(f"passes: {route}: {kind} x{n}: passes_provenance() = "
                  f"{prov}")
        print(f"passes: {route}: {len(self.records)} pipeline run(s), each "
              f"equal to its recount on the host")
        if self.fallbacks:
            raise AssertionError(f"{route}: the graph-pass pipeline fell "
                                 f"back: {self.fallbacks}")
        self.records, self.owners = [], []


def quant_op_cases():
    """The int8 ops over a grid (case id, op, numpy inputs, attrs): the
    codecs on ordinary, degenerate (zero-width) and all-negative ranges,
    requantize with and without a calibrated range, the quantized fully
    connected and convolution ops (with and without bias, grouped, dilated,
    strided, 1-D, channel-last, K and N that ``torch._int_mm`` needs padded),
    pooling (max, avg, global), flatten and concat of unequal ranges.
    Shared by ``tests/test_torch_quant.py`` (against the JAX package) and
    ``tests/test_torch_gpu.py`` (the card against the CPU)."""
    rs = np.random.RandomState(15)

    def f32(*s, lo=-2.0, hi=2.0):
        return rs.uniform(lo, hi, s).astype(np.float32)

    def i8(*s):
        return rs.randint(-127, 128, s).astype(np.int8)

    def sc(v):
        return np.float32(v)

    def acc(*s):
        return rs.randint(-2 ** 30, 2 ** 30, s).astype(np.int32)

    cases = []
    x = f32(4, 7, 5)
    for cid, lo, hi in (("ordinary", -1.5, 2.5), ("degenerate", 0.0, 0.0),
                        ("negative", -3.0, -0.5), ("clipped", -0.5, 0.25)):
        data = -np.abs(x) if cid == "negative" else x
        cases.append((f"quantize/{cid}", "_contrib_quantize",
                      [data, sc(lo), sc(hi)], {}))
    q = i8(6, 9)
    cases += [("dequantize/ordinary", "_contrib_dequantize",
               [q, sc(-0.7), sc(1.3)], {}),
              ("dequantize/degenerate", "_contrib_dequantize",
               [q, sc(0.0), sc(0.0)], {})]
    a = acc(5, 8)
    cases += [("requantize/runtime", "_contrib_requantize",
               [a, sc(-3.5), sc(3.5)], {}),
              ("requantize/calibrated", "_contrib_requantize",
               [a, sc(-3.5), sc(3.5)],
               {"min_calib_range": -0.9, "max_calib_range": 1.2}),
              ("requantize/degenerate", "_contrib_requantize",
               [np.zeros((3, 4), np.int32), sc(0.0), sc(0.0)], {})]

    def product(cid, op, data, weight, bias, attrs, ranges=None):
        r = ranges or (-1.2, 1.7, -0.4, 0.3, -0.05, 0.08)
        cases.append((cid, op, [data, weight, bias] + [sc(v) for v in r],
                      attrs))

    fc = "_contrib_quantized_fully_connected"
    product("fc/bias", fc, i8(19, 13), i8(11, 13), i8(11),
            {"num_hidden": 11})
    product("fc/no_bias", fc, i8(3, 2, 4), i8(6, 8), i8(6),
            {"num_hidden": 6, "no_bias": True})
    product("fc/flatten_false", fc, i8(2, 5, 16), i8(8, 16), i8(8),
            {"num_hidden": 8, "flatten": False})
    product("fc/degenerate", fc, i8(17, 8), i8(8, 8), i8(8),
            {"num_hidden": 8}, (0.0, 0.0, -0.4, 0.3, -0.05, 0.08))
    conv = "_contrib_quantized_conv"
    product("conv/3x3", conv, i8(2, 3, 9, 9), i8(5, 3, 3, 3), i8(5),
            {"kernel": (3, 3), "pad": (1, 1), "num_filter": 5})
    product("conv/stride_no_bias", conv, i8(2, 4, 10, 11), i8(8, 4, 3, 3),
            i8(8), {"kernel": (3, 3), "stride": (2, 2), "num_filter": 8,
                    "no_bias": True})
    product("conv/grouped_dilated", conv, i8(2, 6, 12, 12), i8(9, 2, 3, 3),
            i8(9), {"kernel": (3, 3), "pad": (2, 2), "dilate": (2, 2),
                    "num_group": 3, "num_filter": 9})
    product("conv/depthwise", conv, i8(1, 8, 7, 7), i8(8, 1, 3, 3), i8(8),
            {"kernel": (3, 3), "pad": (1, 1), "num_group": 8,
             "num_filter": 8})
    product("conv/1x1_strided", conv, i8(3, 16, 8, 8), i8(24, 16, 1, 1),
            i8(24), {"kernel": (1, 1), "stride": (2, 2), "num_filter": 24})
    product("conv/rect_1d", conv, i8(2, 5, 13), i8(7, 5, 4), i8(7),
            {"kernel": (4,), "stride": (2,), "pad": (1,), "num_filter": 7,
             "layout": "NCW"})
    product("conv/nhwc", conv, i8(2, 8, 8, 3), i8(6, 3, 3, 3), i8(6),
            {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6,
             "layout": "NHWC"})
    # a 3x3 window over 512 channels: sums of 4,608 products of up to
    # 127², past float32's exact integers
    big = np.full((1, 512, 3, 3), 127, np.int8)
    bigw = np.full((2, 512, 3, 3), 127, np.int8)
    bigw[1] = -127
    product("conv/float32_inexact", conv, big, bigw, i8(2),
            {"kernel": (3, 3), "num_filter": 2})
    pool = "_contrib_quantized_pooling"
    p = i8(2, 3, 9, 9)
    for cid, attrs in (("max", {"kernel": (3, 3), "stride": (2, 2)}),
                       ("avg", {"kernel": (3, 3), "stride": (2, 2),
                                "pool_type": "avg", "pad": (1, 1)}),
                       ("global", {"kernel": (1, 1), "global_pool": True,
                                   "pool_type": "avg"})):
        cases.append((f"pooling/{cid}", pool, [p, sc(-1.0), sc(2.0)],
                      attrs))
    cases.append(("flatten", "_contrib_quantized_flatten",
                  [i8(2, 3, 4, 5), sc(-1.0), sc(1.5)], {}))
    cases.append(("concat/unequal", "_contrib_quantized_concat",
                  [i8(2, 3, 4), i8(2, 5, 4), i8(2, 2, 4), sc(-0.5), sc(1.0),
                   sc(-3.0), sc(2.0), sc(-0.1), sc(0.2)],
                  {"dim": 1, "num_args": 3}))
    return cases


def run_quant_case(op, inputs, attrs, device="cpu"):
    """One case of :func:`quant_op_cases` through the port's op on
    ``device``: its outputs as numpy."""
    from mxnet_tpu_torch.ops.registry import get_op
    ts = [torch.as_tensor(np.asarray(v)).to(device) for v in inputs]
    out = get_op(op).fn(*ts, **attrs)
    out = out if isinstance(out, tuple) else (out,)
    return [o.detach().cpu().numpy() for o in out]


# Route O: ResNet-50 v1 quantized as MXNet 1.5's
# example/quantization/imagenet_gen_qsym.py quantizes it (naive
# calibration over 10 batches of 32, the first convolution and the
# classifier left in float: 52 int8 convolutions), on random weights from
# the seed and synthetic images (no ImageNet, no pretrained weights here).
# TOL_INT8_LOGITS: the card's int8 logits against the CPU's plain path on
# the same images, of the largest |logit|. The int8 codes are equal when
# every float before them is (the int32 products are exact on both), but
# the float layers between the islands (the float stem, BatchNorm, the
# residual adds) round differently on the card (cuDNN) and the CPU, and an
# activation within one rounding of a quantization step's edge takes the
# next code: each such flip moves the logits by about one step of its
# layer's scale. The card's Module also runs the default pipeline, whose
# space-to-depth stem rounds otherwise. The first H100 run read 6.3e-3
# (the gate started at 1e-2 and was set to 8e-3 from it); the control
# (every calibrated range doubled: every code halved) read 1.19e-2 and
# must miss.
INT8 = dict(batch=32, batches=10, image=224, classes=1000, check=2,
            requests_b1=8, timed=10)
INT8_CONVS = 52
TOL_INT8_LOGITS = 8e-3


def int8_batches(n_batches, batch, image, seed=SEED):
    """Synthetic images uniform(-1, 1), NCHW float32, from the seed."""
    rng = np.random.RandomState(seed + 15)
    return [rng.uniform(-1, 1, (batch, 3, image, image)).astype(np.float32)
            for _ in range(n_batches)]


def _graph_signature(sym):
    """(name, op, attrs, inputs by name and index) of every node."""
    return [(n.name, n.op, sorted((n.attrs or {}).items()),
             [(s.name, i) for s, i in n.inputs]) for n in sym.topo_nodes()]


def _module_logits(mx, sym, params, aux, x, ctx, passes=None):
    """``x`` through ``mx.mod.Module(sym)`` on ``ctx`` for inference: the
    logits as a tensor."""
    mod = mx.mod.Module(sym, data_names=["data"], label_names=None,
                        context=ctx, passes=passes)
    mod.bind(data_shapes=[("data", tuple(x.shape))], for_training=False)
    mod.set_params(params, aux)
    mod.forward(mx.io.DataBatch(data=[mx.nd.array(x, ctx=ctx)]),
                is_train=False)
    return mod.get_outputs()[0]._data


def _int8_conv_times(mx, qsym, qarg, batch, image, dev):
    """Each int8 convolution of ``qsym`` at ``batch`` timed on the card:
    the quantized op (im2col + ``torch._int_mm`` + bias) on int8 inputs
    of its shape, against cuDNN's float32 convolution at the same shape
    (TF32 off). Returns [(name, shape, int8 ms, f32 ms)]."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.registry import get_op
    shapes = {}
    internals = qsym.get_internals()
    names = [n.name for n in qsym.topo_nodes()
             if n.op == "_contrib_quantized_conv"]
    arg_shapes, out_shapes, _ = internals.infer_shape(
        data=(batch, 3, image, image))
    by_out = dict(zip(internals.list_outputs(), out_shapes))
    node = {n.name: n for n in qsym.topo_nodes()}
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    fn = get_op("_contrib_quantized_conv").fn
    for name in names:
        n = node[name]
        src, idx = n.inputs[0]
        key = (f"{src.name}_output" if src.num_outputs == 1
               else f"{src.name}_output{idx}")
        ds = by_out[key]
        w = qarg[n.inputs[1][0].name]._data.to(dev)
        b = qarg[n.inputs[2][0].name]._data.to(dev)
        x = torch.randint(-127, 128, ds, generator=g, device=dev,
                          dtype=torch.int8)
        r = [torch.tensor(v, device=dev) for v in
             (-1.0, 1.0, -0.5, 0.5, -0.1, 0.1)]
        attrs = dict(n.attrs)
        int8_ms = _time_ms(lambda: fn(x, w, b, *r, **attrs), reps=5)
        xf, wf = x.float(), w.float()
        stride = tuple(attrs.get("stride") or (1, 1))
        pad = tuple(attrs.get("pad") or (0, 0))
        f32_ms = _time_ms(lambda: F.conv2d(xf, wf, None, stride, pad),
                          reps=5)
        shapes[name] = (tuple(ds), tuple(w.shape))
        rows.append((name, shapes[name], int8_ms, f32_ms))
        del x, xf, wf
    return rows


def int8_phase(mx, hk, dev, workdir):
    """Route O (phase 32): ResNet-50 v1 (``vision.resnet50_v1``, 1,000
    classes, NCHW, Xavier from the seed, moving statistics at their
    initial values) calibrated on the card (``quant.collect``, naive, 10
    batches of 32 synthetic 224² images), quantized by the pass route
    (``quant.quantize_symbol``) and held against the direct route
    (``contrib.quantization.quantize_graph`` excluding the same two
    layers: the same graph, extra parameters and outputs); scored at batch
    32 through ``mx.mod.Module`` on the card; each int8 convolution's
    int32 output bitwise the CPU's given the CPU's inputs, and the logits
    against the CPU's plain path within TOL_INT8_LOGITS with a control
    (every range doubled) that must miss; then the float model served
    through ``ModelServer`` with ``tier="int8"`` (quantized at state build
    from runtime ranges) bitwise a ``Module`` forward of the same
    quantized graph, beside the float tier; each int8 convolution timed
    against cuDNN's float32 one at its shape. No Hopper kernel may
    launch."""
    from mxnet_tpu_torch import quant
    from mxnet_tpu_torch.contrib import quantization as cq
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops.registry import get_op
    from mxnet_tpu_torch.serving import ModelConfig, ModelServer
    cfg = INT8
    ctx, cpu = _ctx(mx, dev), mx.cpu()
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    hk.reset_launch_counts()
    B, S = cfg["batch"], cfg["image"]

    mx.random.seed(SEED)
    with ctx:
        net = vision.resnet50_v1(classes=cfg["classes"])
        net.initialize(mx.init.Xavier())
        batches = int8_batches(cfg["batches"], B, S)
        net(mx.nd.array(batches[0][:1], ctx=ctx))
    sym, arg, aux = cq._trace_gluon(net)
    n_params = sum(int(np.prod(v.shape)) for v in arg.values())
    del net
    _free()
    convs = [n.name for n in sym.topo_nodes() if n.op == "Convolution"]
    fcs = [n.name for n in sym.topo_nodes() if n.op == "FullyConnected"]
    calib = [mx.nd.array(b, ctx=ctx) for b in batches]

    # calibration and quantization, the pass route
    sync()
    t0 = time.perf_counter()
    table = quant.collect(sym, arg, aux, calib, mode="naive",
                          num_calib_examples=B * cfg["batches"], ctx=ctx,
                          model="resnet50_v1")
    sync()
    t_calib = time.perf_counter() - t0
    t0 = time.perf_counter()
    qsym, extra, res = quant.quantize_symbol(sym, arg, table=table,
                                             model="resnet50_v1")
    sync()
    t_quant = time.perf_counter() - t0
    qarg = dict(arg)
    qarg.update(extra)
    n_q = sum(1 for n in qsym.topo_nodes()
              if n.op == "_contrib_quantized_conv")
    n_fc = sum(1 for n in qsym.topo_nodes()
               if n.op == "_contrib_quantized_fully_connected")
    print(f"route O: ResNet-50 v1, {n_params:,} parameters; calibrated "
          f"(naive) over {table.num_examples} images in {len(table)} "
          f"ranges in {t_calib:.2f} s on {ctx}; quantized by the pass "
          f"route in {t_quant:.2f} s: {n_q} int8 convolutions, {n_fc} int8 "
          f"fully connected; left in float: {convs[0]}, {fcs[-1]}; "
          f"rewrites {res.counts}")
    if n_q != INT8_CONVS or n_fc != 0 or len(table) != len(convs) + 1:
        raise AssertionError("route O: the quantized graph does not have "
                             "the reference's 52 int8 convolutions")
    # the direct route, excluding the same two layers
    dsym, dextra = cq.quantize_graph(sym, arg,
                                     excluded_sym_names=[convs[0], fcs[-1]],
                                     calib_ranges=table.ranges)
    same_graph = _graph_signature(dsym) == _graph_signature(qsym)
    same_params = sorted(dextra) == sorted(extra) and all(
        torch.equal(dextra[k]._data, extra[k]._data)
        and dextra[k]._data.dtype == extra[k]._data.dtype for k in extra)
    xs = batches[0][:cfg["check"]]
    dq = dict(arg)
    dq.update(dextra)
    same_out = torch.equal(
        _module_logits(mx, dsym, dq, aux, xs, ctx, passes=False),
        _module_logits(mx, qsym, qarg, aux, xs, ctx, passes=False))
    print(f"route O: the direct route (contrib.quantization.quantize_graph"
          f", the same two layers excluded): graph equal {same_graph}, "
          f"extra parameters bitwise {same_params} ({len(dextra)}), "
          f"outputs bitwise {same_out}")
    if not (same_graph and same_params and same_out):
        raise AssertionError("route O: the pass route and the direct route "
                             "differ")
    del dsym, dextra, dq

    # scoring through Module on the card
    mod = mx.mod.Module(qsym, data_names=["data"], label_names=None,
                        context=ctx)
    mod.bind(data_shapes=[("data", (B, 3, S, S))], for_training=False)
    mod.set_params(qarg, aux)
    score_batch = mx.io.DataBatch(data=[mx.nd.array(batches[0], ctx=ctx)])

    def score():
        mod.forward(score_batch, is_train=False)
        return mod.get_outputs()[0]._data

    logits = score()
    sync()
    score_ms = _time_ms(score, reps=cfg["timed"]) if on_card else 0.0
    fmod = mx.mod.Module(sym, data_names=["data"], label_names=None,
                         context=ctx)
    fmod.bind(data_shapes=[("data", (B, 3, S, S))], for_training=False)
    fmod.set_params(arg, aux)

    def fscore():
        fmod.forward(score_batch, is_train=False)
        return fmod.get_outputs()[0]._data

    flogits = fscore()
    sync()
    fscore_ms = _time_ms(fscore, reps=cfg["timed"]) if on_card else 0.0
    del fmod
    agree = float((logits.argmax(1) == flogits.argmax(1)).float().mean())
    rel = float((logits - flogits).norm() / flogits.norm())
    print(f"route O: scored {B} images through Module: int8 "
          f"{score_ms:.2f} ms a batch ({1e3 * B / max(score_ms, 1e-9):.1f} "
          f"images/s), the float graph {fscore_ms:.2f} ms "
          f"({1e3 * B / max(fscore_ms, 1e-9):.1f} images/s); int8 against "
          f"float: top-1 agreement {agree:.3f}, ||d logits|| / ||logits|| "
          f"{rel:.3e} (a finding: random weights); card {_card_line()}")
    if not torch.isfinite(logits).all() or tuple(logits.shape) != \
            (B, cfg["classes"]):
        raise AssertionError("route O: the int8 logits")

    # the card against the CPU's plain path on the first images: every
    # int8 convolution's int32 output bitwise, given the CPU's inputs
    internals = qsym.get_internals()
    cpu_args = {k: v.as_in_context(cpu) for k, v in qarg.items()
                if k in set(internals.list_arguments())}
    cpu_args["data"] = mx.nd.array(xs, ctx=cpu)
    cpu_aux = {k: v.as_in_context(cpu) for k, v in aux.items()}
    t0 = time.perf_counter()
    outs = internals.bind(cpu, cpu_args, grad_req="null",
                          aux_states=cpu_aux).forward()
    t_cpu = time.perf_counter() - t0
    index = {}
    k = 0
    for n in qsym.topo_nodes():
        for i in range(n.num_outputs):
            index[(id(n), i)] = k
            k += 1
    fn = get_op("_contrib_quantized_conv").fn
    equal = 0
    for n in qsym.topo_nodes():
        if n.op != "_contrib_quantized_conv":
            continue
        ins = [outs[index[(id(s), i)]]._data.to(dev) for s, i in n.inputs]
        got = fn(*ins, **n.attrs)[0]
        want = outs[index[(id(n), 0)]]._data
        if got.dtype != torch.int32 or not torch.equal(got.cpu(), want):
            raise AssertionError(f"route O: {n.name}'s int32 output on the "
                                 f"card differs from the CPU's")
        equal += 1
    cpu_logits = outs[index[(id(qsym._outputs[0][0]),
                             qsym._outputs[0][1])]]._data
    del outs
    # requantize takes its range from the batch (the table calibrates the
    # quantize inputs, as imagenet_gen_qsym.py's naive mode does), so the
    # logits depend on the batch: the card scores the CPU's images as one
    # batch, through Module and its default pipeline
    card = _module_logits(mx, qsym, qarg, aux, xs, ctx)
    err = float((card.cpu() - cpu_logits).abs().max()
                / cpu_logits.abs().max())
    ctl_table = quant.CalibTable({k: (2 * lo, 2 * hi) for k, (lo, hi)
                                  in table.ranges.items()}, mode="naive")
    csym, cextra, _ = quant.quantize_symbol(sym, arg, table=ctl_table)
    cq_arg = dict(arg)
    cq_arg.update(cextra)
    ctl = _module_logits(mx, csym, cq_arg, aux, xs, ctx)
    ctl_err = float((ctl.cpu() - cpu_logits).abs().max()
                    / cpu_logits.abs().max())
    print(f"route O: against the CPU's plain path ({len(xs)} images, "
          f"{t_cpu:.1f} s there): {equal} int8 convolutions' int32 outputs "
          f"bitwise on the card given the CPU's inputs; the card's logits "
          f"(Module, the same {len(xs)} images) max|d| / max|cpu| "
          f"{err:.3e} (tol {TOL_INT8_LOGITS}); the control with every "
          f"range doubled {ctl_err:.3e} (must miss)")
    if equal != INT8_CONVS or not err <= TOL_INT8_LOGITS \
            or not ctl_err > TOL_INT8_LOGITS:
        raise AssertionError("route O: the card's int8 logits against the "
                             "CPU's, or the control")
    del csym, cextra, cq_arg, ctl, mod
    _free()

    # serving: the float model in its int8 tier, beside the float tier
    params = {f"arg:{k}": v for k, v in arg.items()}
    params.update({f"aux:{k}": v for k, v in aux.items()})
    os.makedirs(workdir, exist_ok=True)
    pfile = os.path.join(workdir, "resnet50_int8_tier.params")
    mx.nd.save(pfile, params)
    with open(pfile, "rb") as f:
        pbytes = f.read()
    xb = batches[1]
    served, timing = {}, {}
    for tier in ("f32", "int8"):
        def server_for(buckets, wait_ms):
            return ModelServer([ModelConfig(
                "resnet50", sym.tojson(), pbytes, feature_shape=(3, S, S),
                buckets=buckets, deadline_ms=0, max_wait_ms=wait_ms,
                tier=tier, dev_type=2 if on_card else 1)])

        # batch 1: one request at a time, no assembly window
        t0 = time.perf_counter()
        server = server_for((1,), 0.0).start(warm=True)
        setup = time.perf_counter() - t0
        try:
            lat1 = []
            for i in range(cfg["requests_b1"]):
                t0 = time.perf_counter()
                server.predict("resnet50", xb[i], timeout=300)
                lat1.append(time.perf_counter() - t0)
            st1 = server.stats("resnet50")
        finally:
            server.close()
        # batch B: B requests at once, gathered into one dispatch
        server = server_for((B,), 200.0).start(warm=True)
        try:
            t0 = time.perf_counter()
            pending = [server.submit("resnet50", xb[i]) for i in range(B)]
            got = np.stack([p.result(timeout=300) for p in pending])
            lat_b = time.perf_counter() - t0
            stats = server.stats("resnet50")
            qcfg = server._models["resnet50"].cfg
        finally:
            server.close()
        served[tier] = (got, qcfg)
        timing[tier] = (setup, 1e3 * float(np.median(lat1[1:])),
                        1e3 * lat_b, B / lat_b)
        print(f"route O: served the {tier} tier: set-up (quantization "
              f"included) {setup:.2f} s; batch 1 {timing[tier][1]:.2f} ms "
              f"(median of {cfg['requests_b1'] - 1} after the first); {B} "
              f"requests in {stats['batches']} dispatch(es) "
              f"{timing[tier][2]:.1f} ms, {timing[tier][3]:.1f} images/s; "
              f"counts {st1['counts']} and {stats['counts']}, deadline "
              f"violations {st1['deadline_violations']} and "
              f"{stats['deadline_violations']}, tier {stats['tier']}")
        ok = all(st["tier"] == tier and st["counts"]["ok"] == n
                 and st["deadline_violations"] == 0
                 for st, n in ((st1, cfg["requests_b1"]), (stats, B)))
        if not ok or stats["batches"] != 1:
            raise AssertionError(f"route O: the {tier} tier's stats")
        _free()
    got, qcfg = served["int8"]
    from mxnet_tpu_torch.native.predict_bridge import _load_param_bytes
    tsym = mx.sym.load_json(qcfg.symbol_json)
    targ, taux = _load_param_bytes(qcfg.param_bytes, ctx)
    # the served graph itself (passes=False: the default pipeline would
    # rewrite the float stem into its space-to-depth form, which rounds
    # otherwise)
    want = _module_logits(mx, tsym, targ, taux, xb, ctx,
                          passes=False).cpu().numpy()
    bitwise = np.array_equal(got, want)
    n_tier = sum(1 for n in tsym.topo_nodes()
                 if n.op == "_contrib_quantized_conv")
    f_agree = float((got.argmax(1) == served["f32"][0].argmax(1)).mean())
    print(f"route O: the int8 tier's graph ({n_tier} int8 convolutions, "
          f"runtime ranges) served bitwise a Module forward of it on the "
          f"card: {bitwise}; its top-1 agreement with the f32 tier "
          f"{f_agree:.3f}")
    if not bitwise or n_tier != INT8_CONVS:
        raise AssertionError("route O: the served int8 outputs differ from "
                             "Module's")
    del targ, taux
    _free()
    os.remove(pfile)

    if on_card:
        rows = _int8_conv_times(mx, qsym, qarg, B, S, dev)
        tot8 = sum(r[2] for r in rows)
        tot32 = sum(r[3] for r in rows)
        print(f"route O: the {len(rows)} int8 convolutions at batch {B}: "
              f"{tot8:.2f} ms in all against cuDNN's float32 at the same "
              f"shapes {tot32:.2f} ms (TF32 off); card {_card_line()}")
        for name, (ds, ws), t8, t32 in sorted(rows, key=lambda r: -r[2])[:8]:
            print(f"route O: conv {name}: data {ds}, weight {ws}: int8 "
                  f"{t8:.3f} ms, float32 {t32:.3f} ms")
    if any(hk.launch_counts.values()):
        raise AssertionError(f"route O launched a Hopper kernel: "
                             f"{dict(hk.launch_counts)}")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one served dispatch, one training "
                         "step, one custom-head step, one Module step, one "
                         "fused step, one bf16 fused step, one route F "
                         "step, one route J iteration, one route K step "
                         "and one route M step (torch.profiler)")
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

    # every graph-pass pipeline the routes run is recorded, printed and
    # recounted on the host at each report below
    audit = PassAudit()
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
        checkpointed = route_p_phase(mx, hk, dev, prefix, workdir)
        _free()
        bucketed = bucketing_phase(mx, hk, dev, prefix, module_loss)
        _free()
        sequenced = sequential_phase(mx, hk, dev, prefix, module_loss,
                                     module_w1)
        del module_w1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    audit.report("the LM's routes (serving, Module, fused, mixed, "
                 "bucketing, sequential)")
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
    audit.report("routes A, B, C and the zoo")
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
    audit.report("the transformer twin and routes D and E")
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
    audit.report("route F")
    if any(hk.launch_counts.values()):
        raise AssertionError(f"route F launched a Hopper kernel: "
                             f"{dict(hk.launch_counts)}")
    _free()
    # route G, the image-classification recipe: no TPU kernel on its path
    # (XLA lowered the JAX package's convolutions, BatchNorm and update
    # rules; cuDNN and plain torch run the port's)
    hk.reset_launch_counts()
    try:
        _, g1_wall_ms = recipe_resnet_phase(mx, dev, args.profile)
        _free()
        recipe_records_phase(mx, dev, workdir, g1_wall_ms)
        _free()
        recipe_mnist_phase(mx, dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    _free()
    optimizer_card_phase(mx, dev)
    audit.report("route G")
    if any(hk.launch_counts.values()):
        raise AssertionError(f"route G launched a Hopper kernel: "
                             f"{dict(hk.launch_counts)}")
    _free()
    # slice 11: the dense ops, gluon's activations and losses, route H
    # (DCGAN) and route I (CTC): no TPU kernel on their paths (XLA lowered
    # the JAX package's; plain torch and cuDNN run the port's)
    hk.reset_launch_counts()
    op_grid_phase(mx, dev)
    if any(hk.launch_counts.values()):
        raise AssertionError(f"the op grid launched a Hopper kernel: "
                             f"{dict(hk.launch_counts)}")
    _free()
    dcgan_phase(mx, hk, dev, args.profile)
    _free()
    ctc_phase(mx, hk, dev)
    audit.report("the op grid and routes H and I")
    _free()
    # slice 12: route J (CapsNet): no TPU kernel on its path (XLA lowered
    # the JAX package's convolutions, batch_dot and routing; cuDNN, cuBLAS
    # and plain torch run the port's)
    hk.reset_launch_counts()
    try:
        capsnet_phase(mx, hk, dev, workdir, args.profile)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    _free()
    # slice 13: route K (sparse logistic regression) and route L (the
    # reference's formats): no TPU kernel on their paths (XLA lowered the
    # JAX package's BCOO products and scatters; cuSPARSE and plain torch
    # run the port's); each phase fails if one of B1-B4 launches
    try:
        os.makedirs(workdir, exist_ok=True)
        sparse_logreg_phase(mx, hk, dev, workdir, args.profile)
        _free()
        reference_formats_phase(mx, hk, dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    audit.report("routes J, K and L")
    _free()
    # slice 14: route M (Faster R-CNN) and route N (the contrib op grid):
    # no TPU kernel on their paths (XLA lowered the JAX package's ROI ops,
    # proposals and convolutions; cuDNN, cuBLAS and plain torch run the
    # port's); each phase fails if one of B1-B4 launches
    faster_rcnn_phase(mx, hk, dev, args.profile)
    _free()
    route_n_phase(mx, hk, dev)
    audit.report("routes M and N")
    _free()
    # slice 15: route O (int8 ResNet-50): no TPU kernel on its path (XLA
    # lowered the JAX package's int8 products; cuBLASLt's int8 product
    # and plain torch run the port's); the phase fails if one of B1-B4
    # launches
    try:
        int8_phase(mx, hk, dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    audit.report("route O")
    audit.close()
    for rec in records:
        name = rec["name"]
        rec["launches"] = sum(path.get(name, 0) for path in
                              (served, trained, extended, moduled, fused,
                               mixed, checkpointed, bucketed, sequenced,
                               recipe))
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
