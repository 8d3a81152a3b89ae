"""PyTorch port, on the card: what the Hopper kernel wrapper refuses.
Its agreement with the plain version, over dtypes, head dims, masks,
ragged lengths and offsets, is checked by ``chip_smoke.py``'s kernel
phase. Marked ``gpu``; it skips without CUDA. This file imports no JAX,
so it runs on a machine that has only PyTorch:

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
        pytest.skip("needs a CUDA card: the kernel is CUDA for sm_90a")
    # the plain version's float32 matmuls must run in full float32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    return torch.device("cuda", 0)


def test_flash_attention_kernel_refuses(cuda):
    x = torch.zeros(1, 1, 8, 48, device=cuda)
    with pytest.raises(MXNetError, match="supported"):
        hk.flash_attention(x, x, x)
    h = torch.zeros(1, 1, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        hk.flash_attention(h, h, h)
    y = torch.zeros(1, 1, 8, 64, device=cuda, requires_grad=True)
    with pytest.raises(MXNetError, match="training slice"):
        hk.flash_attention(y, y, y)
    with torch.no_grad():
        assert hk.flash_attention(y, y, y).shape == (1, 1, 8, 64)
