"""PyTorch port, kernel module: ``mxnet_tpu_torch.ops.hopper_kernels``.

On CPU tensors the flash-attention wrapper runs its plain version; here it
is held against the JAX package's flash attention on the same numpy inputs
— the real Pallas kernel ``_fa_kernel`` under the Pallas interpreter for
D = 128 (as tests/test_pallas.py runs it), the jnp path for D = 32 and 64,
which the Pallas gate (D % 128 == 0) excludes. Tolerance 2e-5, as in
test_pallas.py: both sides compute in float32, in another summation order.

The kernel itself (CUDA, sm_90a) runs only on the card: chip_smoke.py
holds it against the plain version there, and tests/test_torch_gpu.py
checks what it refuses.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.ops import hopper_kernels as hk

TOL = 2e-5

# (D, Tq, Tk, causal, q_offset, k_offset)
CASES = [
    (128, 16, 16, False, 0, 0),
    (128, 16, 16, True, 0, 0),
    (128, 24, 24, True, 0, 0),
    (128, 24, 16, True, 8, 0),       # a later q block: ring-attention step
    (128, 16, 24, True, 0, 8),       # rows 0..7 see no key: lse = -1e30
    (128, 24, 24, False, 3, 5),      # offsets ignored without the mask
    (32, 16, 16, True, 0, 0),
    (64, 24, 24, True, 0, 8),
    (64, 16, 24, False, 0, 0),
]


@pytest.fixture
def interp(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("D,Tq,Tk,causal,q_offset,k_offset", CASES)
def test_flash_attention_plain_matches_jax(interp, D, Tq, Tk, causal,
                                           q_offset, k_offset):
    rng = np.random.RandomState(D + Tq + Tk + q_offset + k_offset)
    q, k, v = (rng.randn(1, 2, t, D).astype("float32") for t in (Tq, Tk, Tk))
    assert pk.use_pallas()
    jout, jlse = pk.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_offset, k_offset=k_offset)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = hk.flash_attention_with_lse(tq, tk, tv, causal=causal,
                                           q_offset=q_offset,
                                           k_offset=k_offset)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=TOL,
                               atol=TOL)
    only_out = hk.flash_attention(tq, tk, tv, causal=causal,
                                  q_offset=q_offset, k_offset=k_offset)
    assert torch.equal(only_out, out)
    if causal and k_offset > q_offset:
        masked = lse[..., :k_offset - q_offset]
        assert torch.all(masked == -1e30)         # never -inf
        assert torch.all(out[..., :k_offset - q_offset, :] == 0)
    assert hk.launch_counts["flash_attention_fwd"] == 0   # CPU: no launch


def test_flash_attention_meta_shapes():
    q = torch.empty(2, 3, 5, 64, device="meta")
    k = torch.empty(2, 3, 7, 64, device="meta")
    out, lse = hk.flash_attention_with_lse(q, k, k)
    assert out.shape == (2, 3, 5, 64) and lse.shape == (2, 3, 5)
    assert out.device.type == lse.device.type == "meta"


@pytest.mark.parametrize("D,Tq,Tk,causal,q_offset,k_offset", CASES)
def test_smoke_bound_counts_only_visible_keys(D, Tq, Tk, causal, q_offset,
                                              k_offset):
    """chip_smoke.py's roofline bound counts 4*D FLOP per (query, key) pair
    the mask lets through, the work these inputs need."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    qpos = np.arange(Tq)[:, None] + q_offset
    kpos = np.arange(Tk)[None, :] + k_offset
    pairs = int((qpos >= kpos).sum()) if causal else Tq * Tk
    assert cs.attention_flops(3, Tq, Tk, D, causal, q_offset, k_offset) \
        == 4.0 * 3 * D * pairs
