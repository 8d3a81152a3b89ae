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
   dims, masks, ragged lengths and offsets, the fused cross-entropy on
   ragged and full-vocabulary shapes — with controls (the plain versions
   in TF32, or on TF32-rounded logits) that must miss each float32
   tolerance; then time each kernel, its plain version and the library's
   call at the shapes the main paths give it.
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
   must miss; the launch counts against the steps. ``--profile`` adds a
   ``torch.profiler`` breakdown of one more step (and of one serving
   dispatch).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
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

# the model: OPT-6.7B widths, depth cut to 4 of 32 (one layer is a whole
# period of the pattern)
OPT_6_7B = dict(vocab=50272, units=4096, heads=32, ffn=16384, max_len=2048,
                layers=4)
SERVE_BUCKETS = (1, 2, 4)
SERVE_REQUESTS = 8
TRAIN_BATCH = 4       # sequences of the full 2048-token context
TRAIN_STEPS = 3
TRAIN_LR = 1e-4
SEED = 0

# card peaks for the roofline bound (NVIDIA H100 SXM data sheet, dense)
PEAK_F32_FLOPS = 67e12          # float32 on the CUDA cores
PEAK_BYTES_S = 3.35e12          # HBM3

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


def build_lm_symbol(sym, vocab, units, layers, heads, ffn):
    """The causal TransformerLM graph exactly as the JAX package's gluon
    ``export()`` writes it (Embedding, sinusoidal positions, pre-norm blocks
    with fused-QKV flash attention and a ReLU FFN, final LayerNorm, untied
    head), built with ``sym`` — either package's ``mx.sym``. Inputs: ``data``
    (B, T) token ids; argument ``pos_table`` (max_len, units)."""
    d = units // heads
    x = sym.Embedding(sym.Variable("data"), input_dim=vocab,
                      output_dim=units, name="embed")
    tab = sym.slice_like(sym.expand_dims(sym.Variable("pos_table"), axis=0),
                         x, axes=(1,))
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


def plain_forward(w, tokens, vocab, units, layers, heads, attend=None):
    """The same LM as one plain float32 PyTorch function: no registry, no
    executor, no kernel. ``w`` maps argument names to tensors; ``tokens``
    (B, T) int64; ``attend(q, k, v)`` on (B, H, T, D) is causal attention,
    by default a dense masked softmax."""
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


def roofline_ms(flops: float, nbytes: float):
    """(least time in ms on this card for the work, what bounds it): f32
    operations on the CUDA cores, bytes at the HBM rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


@contextlib.contextmanager
def tf32_matmuls():
    """Let float32 matmuls run in TF32 inside the block (controls only)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


# --------------------------------------------------------------- kernels
def kernel_phase(hk, dev):
    """Flash-attention forward vs its plain version; returns the record of
    the serving shape (f32, causal, (4, 32, 2048, 128))."""
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
        grid.append((dtype, (4, 32, 2048, 2048, 128), True, 0, 0))
    worst = {}
    main = None
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
        if dtype == torch.float32 and (B, H, Tq, D) == (4, 32, 2048, 128):
            main = dict(q=q, k=k, v=v, err=err)
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

    q, k, v = main["q"], main["k"], main["v"]
    BH, T, D = 4 * 32, 2048, 128
    ms = _time_ms(lambda: hk.flash_attention(q, k, v, True), reps=5)
    plain_ms = _time_ms(lambda: hk.flash_attention_reference(q, k, v, True),
                        reps=5)
    lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True), reps=5)
    flops = attention_flops(BH, T, T, D, causal=True)
    nbytes = 4.0 * (4 * BH * T * D + BH * T)   # q, k, v, out, lse (f32)
    bound_ms, bound_by = roofline_ms(flops, nbytes)
    print(f"flash_attention_fwd f32 causal (4, 32, 2048, 128): kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention {lib_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({flops:.3e} FLOP, {nbytes:.3e} B); worst "
          f"errors {worst}")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:63",
            "max_abs_err": main["err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def _max_rel(got, ref) -> float:
    return ((got.float() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


def backward_kernel_phase(hk, dev):
    """The flash-attention backward kernels vs their plain version; returns
    the records of the dK/dV and dQ kernels at the training shape (f32,
    causal, (4, 32, 2048, 128))."""
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
    grid.append((torch.float32, (4, 32, 2048, 2048, 128), True, 0, 0))
    main = None
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
            main = dict(q=q, k=k, v=v, out=out, lse=lse, g=g, sc=sc,
                        err_dq=(got[0] - ref[0]).abs().max().item(),
                        err_dkdv=max((got[1] - ref[1]).abs().max().item(),
                                     (got[2] - ref[2]).abs().max().item()))
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

    q, k, v, out, lse, g, sc = (main[n] for n in
                                ("q", "k", "v", "out", "lse", "g", "sc"))
    BH, T, D = q.shape
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
    bounds = {"dkdv": roofline_ms(8.0 * D * pairs, 6 * tile + 8.0 * BH * T),
              "dq": roofline_ms(6.0 * D * pairs, 5 * tile + 8.0 * BH * T)}
    joint_ms, _ = roofline_ms(10.0 * D * pairs, 7 * tile + 8.0 * BH * T)
    print(f"flash_attention_bwd f32 causal (4, 32, 2048, 128): dK/dV kernel "
          f"{times['dkdv']:.3f} ms (bound {bounds['dkdv'][0]:.3f}), dQ "
          f"kernel {times['dq']:.3f} ms (bound {bounds['dq'][0]:.3f}), whole "
          f"backward {whole_ms:.3f} ms (bound of the function {joint_ms:.3f} "
          f"ms at 10*D FLOP a pair), plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention backward {lib_ms:.3f} ms")
    del o4, q4, k4, v4
    records = []
    for which, err in (("dkdv", main["err_dkdv"]), ("dq", main["err_dq"])):
        records.append({
            "name": f"flash_attention_bwd_{which}", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:220",
            "max_abs_err": err, "ms": times[which], "plain_ms": plain_ms,
            "bound_ms": bounds[which][0], "bound_by": bounds[which][1],
            "library_ms": lib_ms})
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
            lib_ms = _time_ms(lambda: torch.logsumexp(x, dim=1), reps=20)
            # logits read once, labels read, lse and loss written; about
            # 4 operations an element (max, subtract, exp, add)
            bound_ms, bound_by = roofline_ms(4.0 * n * c,
                                             4.0 * n * c + 16.0 * n)
            print(f"softmax_cross_entropy_fwd f32 ({n}, {c}): kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms, torch.logsumexp "
                  f"{lib_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
            rec = {"name": "softmax_cross_entropy_fwd", "route": "cuda",
                   "source": "mxnet_tpu_torch/csrc/softmax_cross_entropy.cu",
                   "replaces": "mxnet_tpu/ops/pallas_kernels.py:325",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": lib_ms}
        del x, labels, loss, lse, ref_loss, ref_lse
    return rec


# --------------------------------------------------------------- serving
def _kernel_class(key: str) -> str:
    low = key.lower()
    if "fa_fwd_kernel" in key:
        return "flash_attention_fwd"
    if "fa_bwd_" in key:
        return "flash_attention_bwd (dK/dV, dQ)"
    if "ce_fwd_kernel" in key:
        return "softmax_cross_entropy_fwd"
    if "memcpy" in low:
        return "memcpy"
    if "gemm" in low or "cutlass" in low:
        return "matmul (cuBLAS)"
    return "other kernels"


def profile_breakdown(what: str, run) -> None:
    """Run ``run()`` once under ``torch.profiler``: device time by kernel
    class and by kernel, and the device events' share of the wall window
    (one stream, so their sum is the busy time)."""
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
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
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
def _plain_weights(net):
    """{``plain_forward`` name: (parameter, its tensor as a new leaf that
    shares the storage)} of the port's TransformerLM."""
    body = net.body
    params = {"embed_weight": net.embed.weight, "pos_table": net.pos.table,
              "lnf_gamma": body.final_ln.gamma, "lnf_beta": body.final_ln.beta,
              "head_weight": net.head.weight}
    for i, cell in enumerate(body.layers):
        p = f"layer{i}_"
        for name, blk in (("ln1", cell.ln1), ("ln2", cell.ln2)):
            params[p + name + "_gamma"] = blk.gamma
            params[p + name + "_beta"] = blk.beta
        for name, blk in (("qkv", cell.attn.qkv), ("proj", cell.attn.proj),
                          ("fc1", cell.ffn.fc1), ("fc2", cell.ffn.fc2)):
            params[p + name + "_weight"] = blk.weight
            params[p + name + "_bias"] = blk.bias
    return {n: (p, p.data()._data.detach().requires_grad_(p.grad_req != "null"))
            for n, p in params.items()}


def _plain_step_grads(hk, weights, tokens, labels, names):
    """Loss and gradients of the plain float32 LM: ``plain_forward`` with
    the attention kernels' plain version (recomputed in the backward, so
    the (T, T) scores of one layer live at a time) and the cross-entropy
    kernel's plain version, under torch autograd."""
    import torch
    from torch.utils.checkpoint import checkpoint
    cfg = OPT_6_7B

    def attend(q, k, v):
        return checkpoint(lambda q, k, v: hk.flash_attention_reference(
            q, k, v, causal=True)[0], q, k, v, use_reentrant=False)

    w = {n: t for n, (_, t) in weights.items()}
    logits = plain_forward(w, tokens, cfg["vocab"], cfg["units"],
                           cfg["layers"], cfg["heads"], attend=attend)
    loss = hk.softmax_cross_entropy_reference(
        logits.reshape(-1, cfg["vocab"]), labels.reshape(-1))[0].sum()
    grads = torch.autograd.grad(loss, [w[n] for n in names])
    return loss.detach(), dict(zip(names, grads))


def _norm_rel(got, ref) -> float:
    return ((got.float() - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def training_gate(hk, net, x, y, loss):
    """Step 1's loss and gradients against the plain float32 reference on
    the same weights; the reference in TF32 and in bf16 must miss."""
    import torch
    weights = _plain_weights(net)
    names = [n for n, (p, _) in weights.items() if p.grad_req != "null"]
    last = f"layer{OPT_6_7B['layers'] - 1}_fc2_"
    top = [n for n in names if n.startswith(("head_", "lnf_", last))]
    port = {n: weights[n][0].grad._data for n in names}
    tokens, labels = x._data.long(), y._data.long()
    ref_loss, ref = _plain_step_grads(hk, weights, tokens, labels, names)
    loss_err = abs(loss - ref_loss.item()) / abs(ref_loss.item())

    def worst(grads):
        """(worst norm error over all tensors, over the top ones)."""
        errs = {n: _norm_rel(grads[n], ref[n]) for n in names}
        return max(errs.values()), max(errs[n] for n in top), errs

    w_all, w_top, errs = worst(port)
    max_err = max(_max_rel(port[n], ref[n]) for n in names)
    with tf32_matmuls():
        ctl = _plain_step_grads(hk, weights, tokens, labels, names)[1]
    c_tf32 = worst(ctl)[:2]
    del ctl
    with torch.autocast("cuda", dtype=torch.bfloat16):
        ctl = _plain_step_grads(hk, weights, tokens, labels, names)[1]
    c_bf16 = worst(ctl)[:2]
    del ctl
    print(f"training: step-1 loss {loss:.6f}, plain {ref_loss.item():.6f} "
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
        raise AssertionError("step-1 loss or gradients disagree with the "
                             "plain float32 reference")
    for ctl_all, ctl_top in (c_tf32, c_bf16):
        if not (ctl_all > TOL_TRAIN_GRAD and ctl_top > TOL_TRAIN_GRAD_TOP):
            raise AssertionError("a TF32 or bf16 control passes a gradient "
                                 "tolerance: it is too loose")


def training_phase(mx, hk, dev, profile=False):
    """Train the 4-layer OPT-6.7B-width TransformerLM three Adam steps
    through gluon on the card; returns {kernel name: launches in the
    three steps}."""
    import torch
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.contrib import transformer as tfm
    cfg = OPT_6_7B
    V, T, B = cfg["vocab"], cfg["max_len"], TRAIN_BATCH
    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(SEED)
    net = tfm.TransformerLM(vocab_size=V, units=cfg["units"],
                            num_layers=cfg["layers"], num_heads=cfg["heads"],
                            hidden_size=cfg["ffn"], max_len=T)
    net.initialize(mx.init.Normal(0.02))
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": TRAIN_LR})
    rng = np.random.RandomState(SEED)
    x = mx.nd.array(rng.randint(0, V, (B, T)).astype(np.float32))
    y = mx.nd.array(rng.randint(0, V, (B, T)).astype(np.float32))

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
    per_step = {"flash_attention_fwd": cfg["layers"],
                "flash_attention_bwd_dkdv": cfg["layers"],
                "flash_attention_bwd_dq": cfg["layers"],
                "softmax_cross_entropy_fwd": 1}
    want = {n: c * TRAIN_STEPS for n, c in per_step.items()}
    if launches != want:
        raise AssertionError(f"training launched {launches}, expected "
                             f"{want} ({TRAIN_STEPS} steps)")
    if profile:
        def one_step():
            forward_backward()
            trainer.step(B * T)
        profile_breakdown(f"one training step of {B} x {T} tokens",
                          one_step)
    return launches


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one served dispatch and one training "
                         "step (torch.profiler)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on the GPU", file=sys.stderr)
        return 2
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

    records = [kernel_phase(hk, dev)]
    records += backward_kernel_phase(hk, dev)
    records.append(ce_phase(hk, dev))
    torch.cuda.empty_cache()
    workdir = os.path.join(os.path.dirname(os.path.abspath(mx.__file__)),
                           "_build", "smoke_lm")
    try:
        served = serving_phase(mx, hk, dev, workdir, args.profile)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    trained = training_phase(mx, hk, dev, args.profile)
    for rec in records:
        name = rec["name"]
        rec["launches"] = served[name] + trained[name]
        if rec["launches"] == 0:
            raise AssertionError(f"{name} never launched on the main paths")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
