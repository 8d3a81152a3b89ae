#!/usr/bin/env python3
"""Drive the PyTorch port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. set-up: refuse to run without CUDA; print the card's name and power
   limit and the TF32 flags (TF32 stays off: float32 products run in full
   float32); build every Hopper kernel from ``mxnet_tpu_torch/csrc``.
2. kernels: hold each kernel against its plain PyTorch version on the card
   over a grid of dtypes, head dims, masks, ragged lengths and offsets,
   then time it, the plain version and the library's call at the serving
   shape.
3. serving: the repo's causal TransformerLM graph at the published widths
   of OPT-6.7B (``facebook/opt-6.7b`` config.json: hidden 4096, 32 heads of
   128, FFN 16384, vocab 50272, context 2048), cut to 4 of its 32 layers,
   with seeded random weights, written with ``nd.save`` and served through
   ``model_config_from_files`` and ``ModelServer`` on the card. Every
   response's logits are held against a plain PyTorch float32 forward of
   the same model, and the kernels' launch counts against the dispatches.

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


def plain_forward(w, tokens, vocab, units, layers, heads):
    """The same LM as one plain float32 PyTorch function: no registry, no
    executor, no kernel. ``w`` maps argument names to tensors; ``tokens``
    (B, T) int64."""
    import torch
    import torch.nn.functional as F
    B, T = tokens.shape
    d = units // heads
    x = w["embed_weight"][tokens.clamp(0, vocab - 1)] + w["pos_table"][:T]
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()

    def ln(x, name):
        return F.layer_norm(x, (units,), w[name + "_gamma"],
                            w[name + "_beta"], eps=1e-5)

    for i in range(layers):
        p = f"layer{i}_"
        qkv = F.linear(ln(x, p + "ln1"), w[p + "qkv_weight"],
                       w[p + "qkv_bias"])
        q, k, v = qkv.reshape(B, T, 3, heads, d).permute(2, 0, 3, 1, 4)
        s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        att = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        a = torch.matmul(att, v).transpose(1, 2).reshape(B, T, units)
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


def attention_flops(BH, Tq, Tk, D, causal, q_offset=0, k_offset=0):
    """Multiply-adds (x2) that attention needs on these inputs: q.k^T and
    p.v over the keys each row sees, none for masked keys."""
    if not causal:
        return 4.0 * BH * Tq * Tk * D
    rows = np.arange(Tq, dtype=np.int64) + q_offset - k_offset + 1
    return 4.0 * BH * D * float(np.clip(rows, 0, Tk).sum())


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
    bound_ms = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S) * 1e3
    print(f"flash_attention_fwd f32 causal (4, 32, 2048, 128): kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention {lib_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({flops:.3e} FLOP, {nbytes:.3e} B); worst "
          f"errors {worst}")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "mxnet_tpu/ops/pallas_kernels.py:63",
            "max_abs_err": main["err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if flops / PEAK_F32_FLOPS
            >= nbytes / PEAK_BYTES_S else "bytes",
            "library_ms": lib_ms}


# --------------------------------------------------------------- serving
def profile_dispatch(server, reqs):
    """One more bucket-4 dispatch under ``torch.profiler``: device time by
    kernel class and by kernel, and the device events' share of the wall
    window (one stream, so their sum is the busy time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in [server.submit("lm", r) for r in reqs]:
            f.result(timeout=120.0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        print("profile: torch.profiler recorded no device time")
        return
    classes = {}
    for us, _, key in rows:
        low = key.lower()
        cls = ("flash_attention_fwd" if "fa_fwd_kernel" in key
               else "memcpy" if "memcpy" in low
               else "matmul (cuBLAS)" if ("gemm" in low or "cutlass" in low)
               else "other kernels")
        classes[cls] = classes.get(cls, 0.0) + us
    busy = sum(r[0] for r in rows)
    print(f"profile: one dispatch of {len(reqs)} x {len(reqs[0])} tokens, "
          f"wall {wall_us / 1e3:.1f} ms, device events {busy / 1e3:.1f} ms "
          f"(busy share {busy / wall_us:.3f}); card {_card_line()}")
    for cls, us in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"profile: class {cls}: {us / 1e3:.2f} ms "
              f"({us / busy:.3f} of device time)")
    for us, count, key in sorted(rows, reverse=True)[:10]:
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
            profile_dispatch(server, reqs[:max(SERVE_BUCKETS)])
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


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one served dispatch (torch.profiler)")
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
    lib = hk.build()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")

    record = kernel_phase(hk, dev)
    torch.cuda.empty_cache()
    workdir = os.path.join(os.path.dirname(os.path.abspath(mx.__file__)),
                           "_build", "smoke_lm")
    try:
        launches = serving_phase(mx, hk, dev, workdir, args.profile)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    record["launches"] = launches["flash_attention_fwd"]
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: record[k] for k in keys}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
