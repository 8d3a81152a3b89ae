"""PyTorch port, on the card: what the Hopper kernel wrappers refuse, and
that the flash kernels carry gradients under autograd. Their agreement with
the plain versions, over dtypes, head dims, masks, ragged lengths and
offsets, is checked by ``chip_smoke.py``'s kernel phases. Also ``mx.rtc``
on the card: the user kernels of ``chip_smoke.py`` through ``extern "C"``
and template exports, what a launch refuses, a launch from a second
thread, one above 48 KB of dynamic shared memory, and the CustomOp loss
head against its plain version at OPT's vocabulary. Marked ``gpu``; it
skips without CUDA. This file imports no JAX, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""
import importlib.util
import os
import threading

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
