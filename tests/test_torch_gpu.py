"""PyTorch port, on the card: what the Hopper kernel wrappers refuse, and
that the flash kernels carry gradients under autograd. Their agreement with
the plain versions, over dtypes, head dims, masks, ragged lengths and
offsets, is checked by ``chip_smoke.py``'s kernel phases; here too at the
edges of their tiles, with a bitwise repeat of each and a look at their
SASS for tensor-core instructions (``HMMA``). Also ``mx.rtc``
on the card: the user kernels of ``chip_smoke.py`` through ``extern "C"``
and template exports, what a launch refuses, a launch from a second
thread, one above 48 KB of dynamic shared memory, and the CustomOp loss
head against its plain version at OPT's vocabulary. And one step of the
symbolic route (``mx.mod.Module``) and of the fused one
(``parallel.DataParallelTrainer`` over a ``SymbolBlock``) of a small LM,
with their launch counts, against the CPU run; the fused step in bf16
under each remat mode (launches, bitwise across modes, no further from
the CPU's f32 step than 1.5× the CPU's bf16 step), B2's label cases and
the float16 refusal. The conv nets: a ResNet-18 v1 in NHWC through the
fused trainer in bf16 (every convolution on bf16 ``channels_last``
inputs, no layout copy), the NHWC net against the NCHW net, and the
"full" pooling convention against the CPU. The recurrent family: the
``RNN`` op (each mode, bidirectional, its gradients) and one step of a
small word LM through gluon (the recipe twin's ``train_step``) on the
card against the CPU, no Hopper kernel launched. The detection family:
the multibox ops and ``box_nms`` on the card against the CPU (discrete
outputs equal), a ``Module`` step of the small SSD twin on records read
by ``ImageDetRecordIter`` straight onto the card, and ``DataLoader``'s
page-locked batches. Marked ``gpu``; it skips without CUDA. This file imports no JAX, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""
import importlib.util
import os
import shutil
import subprocess
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import hopper_kernels as hk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA for sm_90a")
    # the plain versions' float32 matmuls must run in full float32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    return torch.device("cuda", 0)


def test_flash_attention_kernel_refuses(cuda):
    x = torch.zeros(1, 1, 8, 48, device=cuda)
    with pytest.raises(MXNetError, match="supported"):
        hk.flash_attention(x, x, x)
    h = torch.zeros(1, 1, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        hk.flash_attention(h, h, h)
    g = torch.zeros(1, 1, 8, 64, device=cuda)
    with pytest.raises(MXNetError, match="one dtype"):
        hk.flash_attention(g, g.bfloat16(), g)
    with pytest.raises(MXNetError, match="different devices"):
        hk.flash_attention(g, g.cpu(), g)


def test_flash_attention_backward_runs_the_kernels(cuda):
    """Under autograd the forward saves (q, k, v, out, lse) and the
    backward launches the dK/dV and dQ kernels once each."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    q, k, v = (torch.randn(1, 2, 70, 64, generator=gen, device=cuda)
               .requires_grad_() for _ in range(3))
    hk.reset_launch_counts()
    out = hk.flash_attention(q, k, v, causal=True)
    out.square().sum().backward()
    assert hk.launch_counts["flash_attention_fwd"] == 1
    assert hk.launch_counts["flash_attention_bwd_dkdv"] == 1
    assert hk.launch_counts["flash_attention_bwd_dq"] == 1
    ref = hk.flash_attention_bwd_reference(
        *(t.detach().reshape(2, 70, 64) for t in (q, k, v, out)),
        hk.flash_attention_with_lse(q, k, v, True)[1].reshape(2, 70),
        2 * out.detach().reshape(2, 70, 64), 64 ** -0.5, True)
    for t, r in zip((q, k, v), ref):
        err = (t.grad.reshape(2, 70, 64) - r).abs().max().item()
        assert err <= 1e-5 * r.abs().max().item()


def test_flash_attention_backward_kernel_refuses(cuda):
    q = torch.zeros(2, 8, 64, device=cuda)
    lse = torch.zeros(2, 8, device=cuda)
    h = q.half()
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        hk._fa_bwd_dispatch(h, h, h, h, lse, h, 0.125, True, 0, 0)
    with pytest.raises(MXNetError, match="one dtype"):
        hk._fa_bwd_dispatch(q, q, q, q, lse, q.bfloat16(), 0.125, True, 0, 0)
    d = torch.zeros(2, 8, 80, device=cuda)
    with pytest.raises(MXNetError, match="supported"):
        hk._fa_bwd_dispatch(d, d, d, d, lse, d, 0.125, True, 0, 0)
    with pytest.raises(MXNetError, match="different devices"):
        hk._fa_bwd_dispatch(q, q.cpu(), q, q, lse, q, 0.125, True, 0, 0)


# (Tq, Tk, causal, q_offset, k_offset) at the edges of the tensor-core
# kernels' tiles, as in chip_smoke.attention_edge_cases: lengths that are
# multiples of no tile, a whole 128-row query tile with no visible key,
# and a later query block with Tq < Tk
TILE_EDGES = [(200, 300, True, 0, 150), (150, 333, True, 100, 0),
              (150, 333, False, 0, 0)]


def _qkvg(cuda, dtype, D, Tq, Tk, seed, bh=2):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    return [torch.randn(bh, t, D, generator=gen, device=cuda).to(dtype)
            for t in (Tq, Tk, Tk, Tq)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", hk.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("Tq,Tk,causal,q_offset,k_offset", TILE_EDGES)
def test_flash_kernels_match_plain_at_tile_edges(cuda, cs, dtype, D, Tq, Tk,
                                                 causal, q_offset, k_offset):
    """B1 and B3 against their plain versions, with chip_smoke.py's
    tolerances; rows that see no key get out 0, lse -1e30 and dq 0."""
    q, k, v, g = _qkvg(cuda, dtype, D, Tq, Tk, D + Tq + q_offset)
    sc = D ** -0.5
    hk.reset_launch_counts()
    out, lse = hk._fa_fwd_dispatch(q, k, v, sc, causal, q_offset, k_offset)
    grads = hk._fa_bwd_dispatch(q, k, v, out, lse, g, sc, causal, q_offset,
                                k_offset)
    assert hk.launch_counts == {"flash_attention_fwd": 1,
                                "flash_attention_bwd_dkdv": 1,
                                "flash_attention_bwd_dq": 1,
                                "softmax_cross_entropy_fwd": 0}
    ref, ref_lse = hk.flash_attention_reference(
        q.float(), k.float(), v.float(), causal, sc, q_offset, k_offset)
    ref_grads = hk.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), out.float(), lse, g.float(), sc,
        causal, q_offset, k_offset)
    f32 = dtype == torch.float32
    tol_out = cs.TOL_OUT_F32 if f32 else cs.TOL_OUT_BF16
    tol_grad = cs.TOL_GRAD_F32 if f32 else cs.TOL_GRAD_BF16
    assert (out.float() - ref).abs().max().item() <= tol_out
    assert (lse - ref_lse).abs().max().item() <= cs.TOL_LSE
    for got, want in zip(grads, ref_grads):
        assert bool(torch.isfinite(got).all())
        err = (got.float() - want).abs().max() / want.abs().max()
        assert err.item() <= tol_grad
    if causal and k_offset > q_offset:
        blind = k_offset - q_offset
        assert bool((out[:, :blind] == 0).all())
        assert bool((lse[:, :blind] == -1e30).all())
        assert bool((grads[0][:, :blind] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_repeat_bitwise(cuda, dtype):
    """No atomics: the same inputs launched twice give bitwise-equal out
    and lse (B1) and dq, dk, dv (B3)."""
    q, k, v, g = _qkvg(cuda, dtype, 128, 1000, 1000, 3, bh=8)
    sc = 128 ** -0.5
    fwd = [hk._fa_fwd_dispatch(q, k, v, sc, True, 0, 0) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*fwd))
    out, lse = fwd[0]
    bwd = [hk._fa_bwd_dispatch(q, k, v, out, lse, g, sc, True, 0, 0)
           for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*bwd))


def test_flash_kernels_take_unaligned_tensors(cuda):
    """Contiguous views whose data starts off a 16-byte boundary are staged
    with plain loads instead of cp.async: the same bits as aligned copies
    give."""
    T, D, n = 77, 64, 2 * 77 * 64
    base = torch.randn(4 * n + 1, device=cuda)
    q, k, v, g = (base[1 + i * n:1 + (i + 1) * n].view(2, T, D)
                  for i in range(4))
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    sc = D ** -0.5
    out, lse = hk._fa_fwd_dispatch(q, k, v, sc, True, 0, 0)
    ref = hk._fa_fwd_dispatch(q.clone(), k.clone(), v.clone(), sc, True, 0,
                              0)
    assert torch.equal(out, ref[0]) and torch.equal(lse, ref[1])
    grads = hk._fa_bwd_dispatch(q, k, v, out, lse, g, sc, True, 0, 0)
    ref_grads = hk._fa_bwd_dispatch(q.clone(), k.clone(), v.clone(), out,
                                    lse, g.clone(), sc, True, 0, 0)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads))


@pytest.mark.parametrize("name", ["flash_attention_fwd",
                                  "flash_attention_bwd"])
def test_flash_kernels_run_on_tensor_cores(cuda, name):
    """Every kernel function of the flash libraries issues tensor-core
    MMAs: TF32 (the split product) and bf16."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin",
                                                     "cuobjdump")
    if not os.path.exists(tool):
        pytest.skip("cuobjdump not found: it reads the built SASS")
    sass = subprocess.run([tool, "-sass", str(hk.build()[name])],
                          capture_output=True, text=True, check=True).stdout
    functions = sass.split("Function : ")[1:]
    per_dim = 2 if name.endswith("fwd") else 4     # (kernels) x 2 dtypes
    assert len(functions) == per_dim * len(hk.SUPPORTED_HEAD_DIMS)
    for fn in functions:
        kind = "TF32" if "kernelIfLi" in fn.split("\n", 1)[0] else "BF16"
        assert f"F32.{kind}" in fn and "HMMA" in fn


def test_softmax_cross_entropy_kernel_refuses(cuda):
    labels = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        hk.softmax_cross_entropy(torch.zeros(4, 9, device=cuda,
                                             dtype=torch.float16), labels)
    with pytest.raises(MXNetError, match="different devices"):
        hk._ce_kernel(torch.zeros(4, 9, device=cuda), labels.cpu())
    x = torch.randn(4, 9, device=cuda, requires_grad=True)
    hk.reset_launch_counts()
    loss = hk.softmax_cross_entropy(x, torch.tensor([0, 8, 3, 9],
                                                    device=cuda))
    assert hk.launch_counts["softmax_cross_entropy_fwd"] == 1
    assert torch.isnan(loss[3]) and torch.isfinite(loss[:3]).all()
    loss[:3].sum().backward()
    assert torch.isfinite(x.grad).all()


@pytest.fixture(scope="module")
def cs():
    """``chip_smoke.py``, which holds the user kernels and the head."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_gpu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("template", [False, True])
def test_rtc_axpy_exports(cuda, cs, template):
    x = torch.arange(1000, dtype=torch.float32, device=cuda)
    y = torch.ones_like(x)
    k = cs.KERNELS.axpy_t if template else cs.KERNELS.axpy_c
    before = k.launches
    cs.KERNELS.axpy(x, y, 2.0, template)
    assert k.launches == before + 1
    assert torch.equal(y, 2.0 * x + 1.0)


def test_rtc_launch_refuses(cuda, cs):
    k = cs.KERNELS.axpy_c
    x = torch.zeros(8, device=cuda)
    with pytest.raises(MXNetError, match="takes torch.float32"):
        k.launch([x.double(), x, 2.0, 8], mx.gpu(0), (1,), (32,))
    with pytest.raises(MXNetError, match="lies on cpu"):
        k.launch([x.cpu(), x, 2.0, 8], mx.gpu(0), (1,), (32,))
    with pytest.raises(MXNetError, match="contiguous"):
        k.launch([torch.zeros(16, device=cuda)[::2], x, 2.0, 8], mx.gpu(0),
                 (1,), (32,))
    with pytest.raises(MXNetError, match="takes a scalar"):
        k.launch([x, x, x, 8], mx.gpu(0), (1,), (32,))
    with pytest.raises(MXNetError, match="3 arguments"):
        k.launch([x, x, 2.0], mx.gpu(0), (1,), (32,))
    with pytest.raises(MXNetError, match="GPU context"):
        k.launch([x, x, 2.0, 8], mx.cpu(), (1,), (32,))
    mod = mx.rtc.CudaModule("__global__ void broken( { }",
                            exports=("broken",))
    with pytest.raises(MXNetError, match="failed to compile"):
        mod.get_kernel("broken", "").launch([], mx.gpu(0), (1,), (1,))


def test_rtc_launch_from_another_thread(cuda, cs):
    """A thread that has not touched CUDA yet launches (the driver's
    context is made current for it)."""
    x = torch.arange(64, dtype=torch.float32, device=cuda)
    y = torch.zeros_like(x)
    errors = []

    def run():
        try:
            cs.KERNELS.axpy(x, y, 3.0, template=True)
            torch.cuda.synchronize(cuda)
        except Exception as e:   # surfaced by the assert below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    assert torch.equal(y, 3.0 * x)


def test_rtc_large_dynamic_shared_memory(cuda, cs):
    """A 50272-wide softmax row kept in shared memory: 201 KB, above the
    48 KB a launch gets without the attribute."""
    x = 2.0 * torch.randn(3, 50272, device=cuda)
    p = torch.empty_like(x)
    cs.KERNELS.softmax_fwd(x, p)
    ref = cs.softmax_plain(x)
    assert 4 * 50272 > 48 * 1024
    assert (p - ref).abs().max().item() <= 1e-5 * ref.max().item()


@pytest.mark.parametrize("n", [7, 8192])
def test_custom_head_matches_plain(cuda, cs, n):
    """``mx.nd.Custom`` with the rtc head: forward probabilities and the
    logits' gradient against the plain versions, one launch of each
    kernel."""
    C = 50272
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)
    x = 2.0 * torch.randn(n, C, generator=gen, device=cuda)
    lab = torch.randint(0, C, (n,), generator=gen, device=cuda).float()
    data, label = mx.nd.NDArray(x.clone()), mx.nd.NDArray(lab)
    data.attach_grad()
    cs.KERNELS.reset_launch_counts()
    with autograd.record():
        probs = mx.nd.Custom(data, label, op_type="rtc_softmax_ce")
    probs.backward()
    counts = cs.KERNELS.launch_counts()
    assert counts["rtc_softmax_fwd"] == 1
    assert counts["rtc_softmax_ce_bwd"] == 1
    ref_p = cs.softmax_plain(x)
    ref_g = cs.softmax_ce_bwd_plain(ref_p, lab, 1.0 / n)
    p, g = probs._data, data.grad._data
    assert (p - ref_p).abs().max().item() <= 1e-5 * ref_p.max().item()
    assert (g - ref_g).abs().max().item() <= 1e-5 * ref_g.abs().max().item()


# ------------------------------------------- the symbolic and fused routes
# A small LM whose heads fit the kernels (head dim 32): 2 layers, 128
# units, 4 heads, FFN 256, vocab 97, 2 x 64 tokens. One step of each route
# on the card and on the CPU (the kernels' plain versions) from the same
# checkpoint; the card's gradients (or weight steps) against the CPU's by
# ||d|| / ||cpu|| per tensor with chip_smoke.py's gates (all tensors, and
# the ones above the last ReLU).
SMALL = dict(vocab=97, units=128, layers=2, heads=4, ffn=256, T=64, B=2)


@pytest.fixture(scope="module")
def small_lm(cs, tmp_path_factory):
    c = SMALL
    graph = cs.build_lm_symbol(mx.sym, c["vocab"], c["units"], c["layers"],
                               c["heads"], c["ffn"], max_len=c["T"])
    arg, _, _ = graph.infer_shape(data=(c["B"], c["T"]))
    rng = np.random.RandomState(0)
    params = {n: (rng.randn(*s) * 0.05).astype("float32")
              for n, s in zip(graph.list_arguments(), arg) if n != "data"}
    params["pos_table"] = cs.sinusoid_table(c["T"], c["units"])
    prefix = str(tmp_path_factory.mktemp("small_lm") / "lm")
    with mx.cpu():
        mx.model.save_checkpoint(prefix, 0, graph,
                                 {n: mx.nd.array(v) for n, v in
                                  params.items()}, {})
    shape = (c["B"], c["T"])
    return {"prefix": prefix,
            "x": rng.randint(0, c["vocab"], shape).astype("float32"),
            "y": rng.randint(0, c["vocab"], shape).astype("float32")}


def _route_gate(cs, card, cpu):
    """Per tensor ||card - cpu|| / ||cpu|| within chip_smoke.py's gates."""
    last = f"layer{SMALL['layers'] - 1}_fc2_"
    for n, ref in cpu.items():
        err = np.linalg.norm(card[n] - ref) / max(np.linalg.norm(ref), 1e-30)
        top = n.startswith(("head_", "lnf_", last))
        assert err <= (cs.TOL_TRAIN_GRAD_TOP if top else cs.TOL_TRAIN_GRAD), \
            f"{n}: {err:.3e}"


def _module_step(cs, files, ctx):
    lm, arg, aux = mx.model.load_checkpoint(files["prefix"], 0)
    it = mx.io.NDArrayIter({"data": files["x"]}, {"label": files["y"]},
                           batch_size=SMALL["B"])
    mod = mx.mod.Module(cs.lm_loss_head(mx.sym, lm, SMALL["vocab"]),
                        data_names=("data",), label_names=("label",),
                        context=ctx, fixed_param_names=["pos_table"])
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1})
    hk.reset_launch_counts()
    mod.forward_backward(it.next())
    counts = dict(hk.launch_counts)
    ex = mod._exec_group.execs[0]
    return (counts, mod.get_outputs()[0].asscalar(),
            {n: g.asnumpy() for n, g in ex.grad_dict.items()})


def test_module_step_on_card_matches_cpu(cuda, cs, small_lm):
    """A Module step of the LM with the MakeLoss(softmax_cross_entropy)
    head launches B1 and B3's kernels once a layer and B2 once, and its
    loss and gradients match the CPU run."""
    counts, loss, grads = _module_step(cs, small_lm, mx.gpu(0))
    L = SMALL["layers"]
    assert counts == {"flash_attention_fwd": L, "flash_attention_bwd_dkdv": L,
                      "flash_attention_bwd_dq": L,
                      "softmax_cross_entropy_fwd": 1}
    cpu_counts, cpu_loss, cpu_grads = _module_step(cs, small_lm, mx.cpu())
    assert not any(cpu_counts.values())
    assert abs(loss - cpu_loss) <= cs.TOL_TRAIN_LOSS * abs(cpu_loss)
    assert len(grads) == len(cpu_grads) == 4 + 12 * L
    _route_gate(cs, grads, cpu_grads)


def _fused_step(files, ctx):
    from mxnet_tpu_torch import gluon, parallel
    prefix = files["prefix"]
    with ctx:
        block = gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                          prefix + "-0000.params")
        block.collect_params()["pos_table"].grad_req = "null"
        w0 = {n: p.data().asnumpy() for n, p in
              block.collect_params().items()}
        trainer = parallel.DataParallelTrainer(
            block, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9})
        hk.reset_launch_counts()
        loss = trainer.step(mx.nd.array(files["x"]),
                            mx.nd.array(files["y"]))
        counts = dict(hk.launch_counts)
        assert trainer._mesh.devices[0] == ctx
    return counts, loss.asscalar(), {
        n: w0[n] - t.detach().cpu().numpy()
        for n, t in trainer._params.items()}


def test_fused_step_on_card_matches_cpu(cuda, cs, small_lm):
    """A DataParallelTrainer step over the SymbolBlock of the same files
    (mesh=None: the current context) launches B1 and B3's kernels once a
    layer and B2 never, and its loss and weight steps match the CPU run."""
    counts, loss, steps = _fused_step(small_lm, mx.gpu(0))
    L = SMALL["layers"]
    assert counts == {"flash_attention_fwd": L, "flash_attention_bwd_dkdv": L,
                      "flash_attention_bwd_dq": L,
                      "softmax_cross_entropy_fwd": 0}
    cpu_counts, cpu_loss, cpu_steps = _fused_step(small_lm, mx.cpu())
    assert not any(cpu_counts.values())
    assert abs(loss - cpu_loss) <= cs.TOL_TRAIN_LOSS * abs(cpu_loss)
    assert len(steps) == len(cpu_steps) == 4 + 12 * L
    _route_gate(cs, steps, cpu_steps)


def _mixed_step(cs, files, ctx, remat, dtype="bfloat16"):
    """One step of ``DataParallelTrainer(compute_dtype=dtype, remat=...)``
    over the SymbolBlock with the table as an input and int32 ids: the
    launches, the loss and each weight's step ``w0 − w1``."""
    from mxnet_tpu_torch import gluon, parallel
    prefix = files["prefix"]
    with ctx:
        block = gluon.SymbolBlock.imports(prefix + "-symbol.json",
                                          ["data", "pos_table"],
                                          prefix + "-0000.params")
        w0 = {n: p.data().asnumpy() for n, p in
              block.collect_params().items()}
        trainer = parallel.DataParallelTrainer(
            block, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9}, compute_dtype=dtype,
            remat=remat)
        hk.reset_launch_counts()
        loss = trainer.step(files["x"].astype(np.int32),
                            cs.sinusoid_table(SMALL["T"], SMALL["units"]),
                            files["y"])
        counts = dict(hk.launch_counts)
    return counts, loss.asscalar(), {
        n: w0[n] - t.detach().cpu().numpy()
        for n, t in trainer._params.items()}


def _worst(steps, ref):
    return max(np.linalg.norm(steps[n] - ref[n])
               / max(np.linalg.norm(ref[n]), 1e-30) for n in ref)


def test_bf16_steps_with_remat_on_card(cuda, cs, small_lm):
    """The bf16 step on the card, under each remat mode: B1 once a layer
    (twice under remat: the recompute), B3 once, every launch on bf16
    inputs; the remat modes give the
    step without remat bitwise; and the card's bf16 step is no further
    from the float32 step on the CPU than 1.5× the CPU's own bf16 step
    (the plain versions under the same cast rule)."""
    L = SMALL["layers"]
    runs = {}
    for remat in (None, "dots", "full"):
        counts, loss, steps = _mixed_step(cs, small_lm, mx.gpu(0), remat)
        assert counts == {
            "flash_attention_fwd": L * (1 if remat is None else 2),
            "flash_attention_bwd_dkdv": L, "flash_attention_bwd_dq": L,
            "softmax_cross_entropy_fwd": 0}, (remat, counts)
        assert {dt for (_, dt) in hk.launch_dtypes} == {"bfloat16"}, \
            hk.launch_dtypes
        runs[remat] = (loss, steps)
    for remat in ("dots", "full"):
        assert runs[remat][0] == runs[None][0]
        for n, s in runs[None][1].items():
            np.testing.assert_array_equal(runs[remat][1][n], s, err_msg=n)
    _, cpu_f32_loss, cpu_f32 = _mixed_step(cs, small_lm, mx.cpu(), None,
                                           dtype=None)
    cpu_bf16 = _mixed_step(cs, small_lm, mx.cpu(), None)[2]
    card = _worst(runs[None][1], cpu_f32)
    ctl = _worst(cpu_bf16, cpu_f32)
    assert card <= 1.5 * ctl, (card, ctl)
    assert abs(runs[None][0] - cpu_f32_loss) <= 2e-2 * abs(cpu_f32_loss)


def test_softmax_cross_entropy_label_cases_on_card(cuda):
    """B2 with negative labels (class C + label), out-of-range ones (NaN)
    and one label for every row, against its plain version."""
    x = torch.randn(6, 37, device=cuda) * 2
    for labels in ([-1, -37, 0, 36, 37, -38], [5]):
        lab = torch.tensor(labels, device=cuda)
        hk.reset_launch_counts()
        loss = hk.softmax_cross_entropy(x, lab)
        assert hk.launch_counts["softmax_cross_entropy_fwd"] == 1
        ref = hk.softmax_cross_entropy_reference(x, lab.expand(6))[0]
        assert torch.equal(loss.isnan(), ref.isnan())
        ok = ~ref.isnan()
        # lse and loss, absolute: chip_smoke.py's TOL_CE
        assert (loss[ok] - ref[ok]).abs().max().item() <= 2e-5


def test_float16_on_the_card_names_its_roadmap_item(cuda):
    from mxnet_tpu_torch import gluon, parallel
    net = gluon.nn.Dense(4, in_units=3)
    with pytest.raises(NotImplementedError, match="B5"):
        parallel.DataParallelTrainer(net, gluon.loss.L2Loss(), "sgd",
                                     compute_dtype="float16")


# ------------------------------------------------- the conv nets (slice 7)
def _resnet18(layout, prefix="r18_"):
    from mxnet_tpu_torch.gluon.model_zoo import vision
    mx.random.seed(0)
    net = vision.resnet18_v1(classes=10, layout=layout, prefix=prefix)
    net.initialize(mx.init.Xavier())
    return net


def _images(n=8, size=64, layout="NHWC"):
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    if layout == "NCHW":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    return x, rng.randint(0, 10, n).astype(np.float32)


def test_resnet18_nhwc_bf16_fused_steps_on_card(cuda, cs):
    """ResNet-18 v1 in NHWC through the fused trainer in bf16 on the card:
    finite losses, weights moved, and every convolution of a step, forward
    and backward, on bf16 ``channels_last`` inputs, with no copy that
    changes a tensor's memory format (``chip_smoke.ConvCensus``)."""
    from mxnet_tpu_torch import gluon, parallel
    x, y = _images()
    with mx.gpu(0):
        net = _resnet18("NHWC")
        trainer = parallel.DataParallelTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
            dict(cs.RESNET_OPT), compute_dtype="bfloat16")
        xs, ys = mx.nd.array(x), mx.nd.array(y)
        losses = [float(trainer.step(xs, ys).asscalar())]
        w1 = {n: t.detach().clone() for n, t in trainer._params.items()}
        census = cs.ConvCensus()
        with census:
            losses.append(float(trainer.step(xs, ys).asscalar()))
    assert np.isfinite(losses).all(), losses
    assert any(not torch.equal(t, w1[n]) for n, t in trainer._params.items())
    # 20 convolutions: the stem, two a block, three downsamples
    assert census.convs == {("forward", "bfloat16", "channels_last"): 20,
                            ("backward", "bfloat16", "channels_last"): 20}
    assert not census.relayouts, census.relayouts


def test_nhwc_net_equals_nchw_net_on_card(cuda, cs):
    """ResNet-18 v1 in NHWC with the NCHW net's weights transposed: one
    float32 gluon step on the card, logits, loss and every gradient within
    ``chip_smoke.py``'s route-B tolerances. cuDNN's TF32 is on by default
    (unlike matmul's), and TF32 rounding alone moves the loss by 6e-5:
    the test turns it off while it runs, as ``chip_smoke.py`` does."""
    x, y = _images(8, size=224, layout="NCHW")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        _nhwc_against_nchw(cs, x, y)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _nhwc_against_nchw(cs, x, y):
    from mxnet_tpu_torch import interop
    with mx.gpu(0):
        nchw = _resnet18("NCHW")
        nchw(mx.nd.array(x[:1]))
        w = {n: p.data()._data.detach()
             for n, p in nchw.collect_params().items()}
        nhwc = _resnet18("NHWC")
        interop.load_block_params(nhwc, {
            n: (t.permute(0, 2, 3, 1) if t.dim() == 4 else t)
            .contiguous().cpu().numpy() for n, t in w.items()})
        lc, gc, oc = cs._gluon_grads(mx, nchw, x, y)
        lh, gh, oh = cs._gluon_grads(
            mx, nhwc, np.ascontiguousarray(x.transpose(0, 2, 3, 1)), y)
    ref = {n: g.double() for n, g in gc.items()}
    errs, null = cs._rn_grads_rel(
        {n: cs._to_nchw(n, g) for n, g in gh.items()}, ref,
        cs._null_grads(ref))
    assert not null and len(errs) == len(gc)
    assert abs(lh - lc) <= cs.TOL_RN_LOSS * abs(lc)
    assert ((oh - oc).abs().max() / oc.abs().max()).item() \
        <= cs.TOL_RN_LOGITS
    for n, e in errs.items():
        tol = cs.TOL_RN_GRAD_TOP if "_dense" in n else cs.TOL_RN_GRAD
        assert e <= tol, (n, e)


@pytest.mark.parametrize("pool_type,cip", [("max", True), ("avg", True),
                                           ("avg", False), ("sum", True)])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_full_pooling_on_card_matches_cpu(cuda, pool_type, cip, layout):
    """The "full" convention with a window wholly in padding (size 5,
    kernel 2, stride 3, pad 1) on the card: the CPU's values, −inf and
    0/0 included, and the same input gradient."""
    from mxnet_tpu_torch.ops.registry import get_op
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 5, 5, generator=gen)
    if layout == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    kw = dict(kernel=(2, 2), stride=(3, 3), pad=(1, 1), pool_type=pool_type,
              pooling_convention="full", count_include_pad=cip,
              layout=layout)
    outs = []
    for dev in ("cpu", cuda):
        t = x.to(dev).clone().requires_grad_()
        out = get_op("Pooling").fn(t, **kw)
        out.masked_fill(~out.isfinite(), 0.0).sum().backward()
        outs.append((out.detach().cpu(), t.grad.cpu()))
    (cpu_out, cpu_grad), (out, grad) = outs
    assert out.shape == cpu_out.shape
    assert torch.equal(out.isfinite(), cpu_out.isfinite())
    assert torch.equal(out[~out.isfinite()].nan_to_num(),
                       cpu_out[~cpu_out.isfinite()].nan_to_num())
    ok = cpu_out.isfinite()
    assert torch.allclose(out[ok], cpu_out[ok], rtol=1e-6, atol=1e-6)
    assert torch.allclose(grad, cpu_grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_op_on_card_matches_cpu(cuda, mode):
    """The ``RNN`` op, 2 bidirectional layers, its outputs and gradients
    on the card against the CPU (float32, TF32 off): the same code on
    both devices, cuBLAS against the CPU's products."""
    from mxnet_tpu_torch.ops.registry import get_op
    from mxnet_tpu_torch.ops.rnn import rnn_packed_param_size
    gen = torch.Generator().manual_seed(0)
    T, B, I, H, L = 7, 3, 5, 16, 2
    n = rnn_packed_param_size(mode, L, True, I, H)
    ins = [torch.randn(T, B, I, generator=gen),
           torch.randn(n, generator=gen) * 0.2,
           torch.randn(2 * L, B, H, generator=gen)]
    if mode == "lstm":
        ins.append(torch.randn(2 * L, B, H, generator=gen))
    attrs = dict(state_size=H, num_layers=L, mode=mode, bidirectional=True,
                 state_outputs=True, is_train=False)
    runs = []
    hk.reset_launch_counts()
    for dev in (torch.device("cpu"), cuda):
        ts = [t.to(dev).requires_grad_() for t in ins]
        outs = get_op("RNN").fn(*ts, **attrs)
        grads = torch.autograd.grad([o.sum() for o in outs], ts)
        runs.append([t.detach().cpu() for t in list(outs) + list(grads)])
    assert not any(hk.launch_counts.values())
    for a, b in zip(*runs):
        torch.testing.assert_close(b, a, rtol=0,
                                   atol=1e-5 * float(a.abs().max()))


def test_word_lm_step_on_card_matches_cpu(cuda):
    """One step of the recipe twin's ``RNNModel`` (vocab 200, 32 x 32, 2
    layers, bptt 10, batch 4, dropout 0) through ``train_step`` on the
    card and on the CPU from the same weights: the loss and the weights
    after the clipped SGD update."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "example",
                        "gluon", "word_language_model", "train_torch.py")
    spec = importlib.util.spec_from_file_location("train_torch_gpu", path)
    wlm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wlm)
    corpus = wlm.synthetic_corpus(200, 4 * 21, seed=3)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    runs, weights = [], None
    for ctx in (mx.cpu(), mx.gpu(0)):
        net, trainer = wlm.build(200, "lstm", 32, 32, 2, 1.0, 0.0, ctx,
                                 weights)
        if weights is None:
            weights = {k: p.data().asnumpy() for k, p in
                       net._collect_params_with_prefix().items()}
        data, target = wlm.get_batch(wlm.batchify(corpus, 4, ctx), 0, 10)
        L, _ = wlm.train_step(net, trainer, loss_fn, data, target,
                              net.begin_state(batch_size=4, ctx=ctx), 0.05,
                              10, 4)
        runs.append((float(L.mean().asscalar()),
                     {k: p.data().asnumpy() for k, p in
                      net._collect_params_with_prefix().items()}))
    (cpu_loss, cpu_w), (loss, w) = runs
    assert abs(loss - cpu_loss) <= 1e-6 * abs(cpu_loss)
    for k in cpu_w:
        assert not np.array_equal(cpu_w[k], weights[k]), k
        np.testing.assert_allclose(w[k], cpu_w[k], rtol=0,
                                   atol=1e-6 * np.abs(cpu_w[k]).max())


# ------------------------------------------------------------ detection
def _det_case(dev, seed=0, n_side=8, batch=4):
    from mxnet_tpu_torch.ops.registry import get_op
    g = torch.Generator().manual_seed(seed)
    anchors = get_op("_contrib_MultiBoxPrior").fn(
        torch.zeros(1, 1, n_side, n_side), sizes=(0.2, 0.3),
        ratios=(1.0, 2.0, 0.5), clip=True)
    n = anchors.shape[1]
    label = torch.full((batch, 5, 5), -1.0)
    for b in range(batch):
        for k in range(1 + b % 4):
            xy = torch.rand(2, generator=g) * 0.6
            wh = torch.rand(2, generator=g) * 0.3 + 0.05
            label[b, k] = torch.cat([torch.tensor([float(k % 3)]), xy,
                                     xy + wh])
    cls_pred = torch.randn(batch, 4, n, generator=g)
    loc = torch.randn(batch, 4 * n, generator=g) * 0.3
    return get_op, anchors, label, cls_pred, loc


def test_detection_family_on_card_matches_cpu(cuda, tmp_path):
    """The detection slice on the card: the multibox ops, a step of the
    SSD twin through ``Module``, and page-locked ``DataLoader`` batches."""
    _check_multibox_ops_on_card(cuda)
    _check_ssd_twin_module_step_on_card(tmp_path)
    _check_dataloader_pins_host_batches()


def _check_multibox_ops_on_card(cuda):
    """Anchors, targets (with hard-negative mining), detections (nms_topk
    below the candidate count) and ``box_nms`` on the card against the
    same inputs on the CPU: discrete outputs equal, the rest within 1e-6
    of the largest entry."""
    get_op, anchors, label, cls_pred, loc = _det_case(cuda)
    on = [t.to(cuda) for t in (anchors, label, cls_pred, loc)]
    prior = get_op("_contrib_MultiBoxPrior").fn(
        torch.zeros(1, 1, 8, 8, device=cuda), sizes=(0.2, 0.3),
        ratios=(1.0, 2.0, 0.5), clip=True)
    assert (prior.cpu() - anchors).abs().max() <= 1e-6
    kw = dict(overlap_threshold=0.5, negative_mining_ratio=3.0,
              negative_mining_thresh=0.5)
    want = get_op("_contrib_MultiBoxTarget").fn(anchors, label, cls_pred,
                                                **kw)
    got = get_op("_contrib_MultiBoxTarget").fn(on[0], on[1], on[2], **kw)
    assert torch.equal(got[2].cpu(), want[2])
    assert torch.equal(got[1].cpu(), want[1])
    assert (got[0].cpu() - want[0]).abs().max() <= 1e-6 * want[0].abs().max()
    prob = torch.softmax(cls_pred, dim=1)
    kw = dict(nms_threshold=0.45, nms_topk=40, threshold=0.01)
    want = get_op("_contrib_MultiBoxDetection").fn(prob, loc, anchors, **kw)
    got = get_op("_contrib_MultiBoxDetection").fn(prob.to(cuda), on[3],
                                                  on[0], **kw).cpu()
    assert torch.equal(got[..., :2], want[..., :2])
    assert (got[..., 2:] - want[..., 2:]).abs().max() <= 1e-6
    assert (want[:, 40:, 0] == -1).all() and (want[:, :40, 0] >= 0).any()
    data = torch.cat([want[..., :2], want[..., 2:]], dim=-1)
    data[..., 0] = data[..., 0].abs()
    want = get_op("_contrib_box_nms").fn(data, overlap_thresh=0.3, topk=60)
    got = get_op("_contrib_box_nms").fn(data.to(cuda), overlap_thresh=0.3,
                                        topk=60).cpu()
    assert torch.equal(got, want)


def _check_ssd_twin_module_step_on_card(tmp_path):
    """One ``Module`` step of ``symbol_ssd_torch``'s graph on a batch that
    ``ImageDetRecordIter`` reads straight onto the card, against the same
    step on the CPU from the same weights: the targets equal, the losses
    and the updated weights within 1e-4 of their largest entry (cuDNN's
    convolutions sum in another order; cuDNN's TF32, on by default, is
    turned off for the step), or 1e-7: a conv bias ahead of a BatchNorm
    has no gradient in exact arithmetic, so its update is rounding noise
    (~1e-9) in both runs. No Hopper kernel is launched."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                    "example", "ssd"))
    import dataset_torch
    rec = dataset_torch.write_records(str(tmp_path / "t"), num_images=8,
                                      size=32)
    hk.reset_launch_counts()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        results = _ssd_steps(rec)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (cpu_out, cpu_w), (gpu_out, gpu_w) = results["cpu(0)"], results["gpu(0)"]
    np.testing.assert_array_equal(gpu_out[2], cpu_out[2])
    for a, b in zip(gpu_out[:2], cpu_out[:2]):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    for k in cpu_w:     # a conv bias ahead of a BatchNorm has no gradient
        assert np.abs(gpu_w[k] - cpu_w[k]).max() <= \
            max(1e-4 * np.abs(cpu_w[k]).max(), 1e-7), k
    assert not any(hk.launch_counts.values())


def _ssd_steps(rec):
    import symbol_ssd_torch
    results = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        it = mx.io.ImageDetRecordIter(rec, data_shape=(3, 32, 32),
                                      batch_size=8, max_objs=4,
                                      scale=1.0 / 255, ctx=ctx)
        batch = it.next()
        assert batch.data[0].context == ctx
        mod = mx.mod.Module(symbol_ssd_torch.build_ssd(3), context=ctx,
                            data_names=["data"], label_names=["label"])
        mod.bind(data_shapes=it.provide_data,
                 label_shapes=it.provide_label)
        mx.random.seed(0)
        mod.init_params(mx.init.Xavier() if ctx == mx.cpu() else None,
                        arg_params=results.get("w0"),
                        aux_params=results.get("aux0"))
        if ctx == mx.cpu():
            results["w0"], results["aux0"] = (
                {k: v.copy() for k, v in p.items()}
                for p in mod.get_params())
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.05, "momentum": 0.9})
        mod.forward_backward(batch)
        mod.update()
        results[str(ctx)] = ([o.asnumpy() for o in mod.get_outputs()],
                             {k: v.asnumpy()
                              for k, v in mod.get_params()[0].items()})
    return results


def _check_dataloader_pins_host_batches():
    gd = mx.gluon.data
    loader = gd.DataLoader(gd.ArrayDataset(np.ones((6, 3), "float32"),
                                           np.arange(6)), batch_size=4,
                           pin_memory=True, num_workers=2)
    for data, label in loader:
        assert data._data.is_pinned() and label._data.is_pinned()
        assert data.context == mx.cpu()
