"""PyTorch port, kernel module: ``mxnet_tpu_torch.ops.hopper_kernels``.

On CPU tensors each wrapper runs its plain version; here it is held
against the JAX package's function on the same numpy inputs:

* flash attention, forward: the real Pallas kernel ``_fa_kernel`` under
  the Pallas interpreter for D = 128 (as tests/test_pallas.py runs it),
  the jnp path for D = 32 and 64, which the Pallas gate (D % 128 == 0)
  excludes. Tolerance 2e-5, as in test_pallas.py: both sides compute in
  float32, in another summation order.
* flash attention, gradients (the port's ``torch.autograd.Function``
  over ``flash_attention_bwd_reference``) against ``jax.grad`` of
  ``pk.flash_attention`` (its custom VJP over ``flash_attention_bwd``),
  offsets and fully masked rows included: 1e-5 relative to the largest
  gradient (float32 sums over at most 24 keys and 128 dims).
* softmax cross-entropy, loss and gradient, against
  ``pk.softmax_cross_entropy``: the Pallas ``_ce_kernel`` in interpret
  mode at C = 128, its jnp branch at the ragged C = 37. 1e-5.

The kernels themselves (CUDA, sm_90a) run only on the card: chip_smoke.py
holds them against the plain versions there, and tests/test_torch_gpu.py
checks what they refuse.
"""
import importlib.util
import os

import jax
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


@pytest.mark.parametrize("D,Tq,Tk,causal,q_offset,k_offset", CASES)
def test_flash_attention_grads_match_jax(interp, D, Tq, Tk, causal,
                                         q_offset, k_offset):
    rng = np.random.RandomState(7 + D + Tq + Tk + q_offset + k_offset)
    q, k, v = (rng.randn(1, 2, t, D).astype("float32") for t in (Tq, Tk, Tk))
    w = rng.randn(1, 2, Tq, D).astype("float32")

    def jloss(q, k, v):
        out = pk.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                 k_offset=k_offset)
        return jnp.sum(out * w)

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = hk.flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset,
                             k_offset=k_offset)
    (out * torch.from_numpy(w)).sum().backward()
    for t, jg in zip((tq, tk, tv), jgrads):
        jg = np.asarray(jg)
        assert np.isfinite(t.grad.numpy()).all()
        np.testing.assert_allclose(t.grad.numpy(), jg, rtol=0,
                                   atol=1e-5 * np.abs(jg).max())
    if causal and k_offset > q_offset:    # rows that see no key: 0, not NaN
        assert torch.all(tq.grad[..., :k_offset - q_offset, :] == 0)
    assert all(hk.launch_counts[n] == 0 for n in hk.launch_counts)


def test_flash_attention_lse_takes_no_gradient():
    q = torch.randn(1, 1, 4, 32, requires_grad=True)
    out, lse = hk.flash_attention_with_lse(q, q, q)
    assert out.requires_grad and not lse.requires_grad


@pytest.mark.parametrize("N,C", [(16, 128), (24, 128), (16, 37), (7, 37)])
def test_softmax_cross_entropy_matches_jax(interp, N, C):
    rng = np.random.RandomState(N * C)
    x = (rng.randn(N, C) * 3).astype("float32")
    labels = rng.randint(0, C, size=N)
    g = rng.randn(N).astype("float32")
    @jax.jit
    def loss_and_grad(a, ct):
        loss, vjp = jax.vjp(
            lambda a: pk.softmax_cross_entropy(a, jnp.asarray(labels)), a)
        return loss, vjp(ct)[0]

    jloss, jgrad = loss_and_grad(jnp.asarray(x), jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    # float labels, as the op receives them, truncate like the int32 cast
    loss = hk.softmax_cross_entropy(tx, torch.from_numpy(labels + 0.25))
    loss.backward(torch.from_numpy(g))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-5)
    assert hk.launch_counts["softmax_cross_entropy_fwd"] == 0


def test_softmax_cross_entropy_reference_edges():
    """lse in float32 from bf16 logits; a label outside [0, C) gives a NaN
    loss and no one-hot entry in the gradient; meta tensors get shapes."""
    x = torch.randn(3, 5)
    labels = torch.tensor([0, 5, -1])
    loss, lse = hk.softmax_cross_entropy_reference(x.bfloat16(), labels)
    assert lse.dtype == loss.dtype == torch.float32
    assert torch.isfinite(loss[0]) and torch.isnan(loss[1:]).all()
    grad = hk.softmax_cross_entropy_grad(x, labels, torch.logsumexp(x, 1),
                                         torch.ones(3))
    np.testing.assert_allclose(grad[1:].sum(1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(grad[0].sum().item(), 0.0, atol=1e-6)
    m = hk.softmax_cross_entropy(torch.empty(4, 9, device="meta"),
                                 torch.empty(4, device="meta"))
    assert m.shape == (4,) and m.device.type == "meta"
