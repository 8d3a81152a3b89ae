"""PyTorch port, on the card: what the Hopper kernel wrappers refuse, and
that the flash kernels carry gradients under autograd. Their agreement with
the plain versions, over dtypes, head dims, masks, ragged lengths and
offsets, is checked by ``chip_smoke.py``'s kernel phases. Marked ``gpu``;
it skips without CUDA. This file imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""
import pytest
import torch

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
