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
from test_torch_threads import one_torch_thread  # noqa: F401

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
    jout, jlse = jax.jit(lambda *a: pk.flash_attention_with_lse(
        *a, causal=causal, q_offset=q_offset, k_offset=k_offset))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
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


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


# the main path's shape: (4, 32, 2048, 128) f32 causal
MAIN = (128, 2048, 2048, True, 0, 0)


@pytest.mark.parametrize("D,Tq,Tk,causal,q_offset,k_offset", CASES + [MAIN])
def test_smoke_bound_counts_only_visible_keys(D, Tq, Tk, causal, q_offset,
                                              k_offset):
    """chip_smoke.py's roofline bound counts 4*D FLOP per (query, key) pair
    the mask lets through, the work these inputs need, and takes the least
    time over the routes that meet the f32 gates: three TF32 passes on the
    tensor cores beat one f32 pass on the CUDA cores (0.833 ms against
    2.052 ms at the main shape)."""
    cs = _chip_smoke()
    BH = 128 if (D, Tq, Tk, causal, q_offset, k_offset) == MAIN else 3
    qpos = np.arange(Tq)[:, None] + q_offset
    kpos = np.arange(Tk)[None, :] + k_offset
    pairs = int((qpos >= kpos).sum()) if causal else Tq * Tk
    flops = cs.attention_flops(BH, Tq, Tk, D, causal, q_offset, k_offset)
    assert flops == 4.0 * BH * D * pairs
    nbytes = 4.0 * (BH * (2 * Tq + 2 * Tk) * D + BH * Tq)
    ms, bound_by, route = cs.roofline_ms(flops, nbytes, "f32")
    t_ops = 3 * flops / 495e12
    assert ms == pytest.approx(max(t_ops, nbytes / 3.35e12) * 1e3)
    assert bound_by == ("operations" if t_ops >= nbytes / 3.35e12
                        else "bytes")
    assert route == ("3-pass TF32 tensor cores" if bound_by == "operations"
                     else "HBM")
    cuda_core_ms, _, cuda_core_route = cs.roofline_ms(flops, nbytes)
    assert cuda_core_route in ("f32 CUDA cores", "HBM")
    assert ms <= cuda_core_ms
    if BH == 128:
        assert (round(ms, 3), bound_by) == (0.833, "operations")
        assert round(cuda_core_ms, 3) == 2.052
        # bf16 bytes (half of these): bf16 products at 989 TFLOP/s bound it
        assert cs.roofline_ms(flops, nbytes / 2, "bf16")[1:] == (
            "operations", "bf16 tensor cores")
        assert round(cs.roofline_ms(flops, nbytes / 2, "bf16")[0], 3) \
            == 0.139


def _tf32(x):
    """float32 -> TF32, rounded to nearest with ties away from zero
    (``cvt.rna.tf32.f32``), on the bits."""
    bits = x.view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _mm_passes(terms):
    """A float32 matrix product built from TF32 parts: ``terms`` of
    ("hi"|"lo", "hi"|"lo") pairs, each pair's product taken exactly (TF32 x
    TF32 fits a float32 mantissa) and summed in float32, small terms first
    as the kernels issue them."""
    def mm(a, b):
        parts = {}
        for name, x in (("a", a), ("b", b)):
            hi = _tf32(x)
            parts[name] = {"hi": hi, "lo": _tf32(x - hi)}
        out = np.zeros((a.shape[0], b.shape[1]), np.float32)
        for ta, tb in terms:
            out += (parts["a"][ta].astype(np.float64)
                    @ parts["b"][tb].astype(np.float64)).astype(np.float32)
        return out
    return mm


def _attention(q, k, v, mm):
    """Causal attention of one head in float32 with the products by
    ``mm``: (out, lse), the sentinels of the plain version."""
    Tq, D = q.shape
    s = mm(q, k.T) * np.float32(D ** -0.5)
    s = np.where(np.tril(np.ones((Tq, k.shape[0]), bool)), s,
                 np.float32(-1e30))
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m).astype(np.float32)
    l = p.sum(-1, keepdims=True)
    return mm(p, v) / l, (m + np.log(l))[:, 0]


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_split_tf32_product_meets_f32_gates(D):
    """The kernels' float32 products, emulated: q.k^T and p.v each as the
    split-TF32 product (a_lo.b_hi + a_hi.b_lo + a_hi.b_hi) keep attention
    at (1, 2, 256, D) causal within chip_smoke.py's float32 gates of the
    plain float32 version; one TF32 pass lands at least 10x further off,
    and so does dropping the a_lo.b_hi term."""
    cs = _chip_smoke()
    rng = np.random.RandomState(D)
    q, k, v = (rng.randn(2, 256, D).astype(np.float32) for _ in range(3))
    ref_out, ref_lse = hk.flash_attention_reference(
        *(torch.from_numpy(t) for t in (q, k, v)), causal=True)
    ref_out, ref_lse = ref_out.numpy(), ref_lse.numpy()

    def err(terms):
        mm = _mm_passes(terms)
        worst_out = worst_lse = 0.0
        for h in range(2):
            out, lse = _attention(q[h], k[h], v[h], mm)
            worst_out = max(worst_out, float(np.abs(out - ref_out[h]).max()))
            worst_lse = max(worst_lse, float(np.abs(lse - ref_lse[h]).max()))
        return worst_out, worst_lse

    split = err([("lo", "hi"), ("hi", "lo"), ("hi", "hi")])
    one_pass = err([("hi", "hi")])
    no_lo_hi = err([("hi", "lo"), ("hi", "hi")])
    assert split[0] <= cs.TOL_OUT_F32 and split[1] <= cs.TOL_LSE
    assert one_pass[0] >= 10 * split[0] and one_pass[1] >= 10 * split[1]
    assert no_lo_hi[0] >= 10 * split[0] and no_lo_hi[1] >= 10 * split[1]
    assert one_pass[0] > cs.TOL_OUT_F32       # the TF32 control misses


def test_lib_path_digest_covers_headers(tmp_path, monkeypatch):
    """A library's name digests its source, the headers beside it and the
    flags: editing ``flash_mma.cuh`` renames (so rebuilds) the flash
    libraries; nothing runs nvcc."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in list(hk._SOURCES.values()) + sorted(
            next(iter(hk._SOURCES.values())).parent.glob("*.cuh")):
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(hk, "_SOURCES", {n: csrc / p.name
                                         for n, p in hk._SOURCES.items()})
    monkeypatch.setattr(hk, "_BUILD", tmp_path / "_build")
    before = {n: hk._lib_path(n) for n in hk._SOURCES}
    assert before == {n: hk._lib_path(n) for n in hk._SOURCES}   # stable
    header = csrc / "flash_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: hk._lib_path(n) for n in hk._SOURCES}
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        assert "flash_mma.cuh" in hk._SOURCES[name].read_text()
        assert after[name] != before[name]
        assert after[name].parent == tmp_path / "_build"


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
    """lse in float32 from bf16 logits; a label in [-C, 0) picks class
    C + label in the forward but has no one-hot entry in the gradient (as
    the JAX package's ``take_along_axis`` and ``one_hot``), a label at C
    or below -C gives a NaN loss; meta tensors get shapes."""
    x = torch.randn(4, 5)
    labels = torch.tensor([0, 5, -6, -1])
    loss, lse = hk.softmax_cross_entropy_reference(x.bfloat16(), labels)
    assert lse.dtype == loss.dtype == torch.float32
    assert torch.isfinite(loss[[0, 3]]).all()
    assert torch.isnan(loss[1:3]).all()
    np.testing.assert_allclose(loss[3].item(),
                               (lse[3] - x.bfloat16()[3, 4].float()).item())
    grad = hk.softmax_cross_entropy_grad(x, labels, torch.logsumexp(x, 1),
                                         torch.ones(4))
    np.testing.assert_allclose(grad[1:].sum(1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(grad[0].sum().item(), 0.0, atol=1e-6)
    m = hk.softmax_cross_entropy(torch.empty(4, 9, device="meta"),
                                 torch.empty(4, device="meta"))
    assert m.shape == (4,) and m.device.type == "meta"


@jax.jit
def _ce_loss_and_grad(x, labels):
    loss, vjp = jax.vjp(lambda a: pk.softmax_cross_entropy(a, labels), x)
    return loss, vjp(jnp.ones_like(loss))[0]


@pytest.mark.parametrize("labels", [[-1, 0], [3], [-5, 4], [5, -6]],
                         ids=["negative", "one-label", "wrap-all",
                              "out-of-range"])
def test_softmax_cross_entropy_labels_like_jax(labels):
    """Labels in [-C, 0) and a single label for every row, loss and
    gradient, against the JAX package's ``softmax_cross_entropy``; NaN
    where it gives NaN. The kernel's wrapper hands it one label a row."""
    x = np.random.RandomState(5).randn(2, 5).astype("float32") * 2
    lab = np.asarray(labels, "float32")
    jloss, jgrad = _ce_loss_and_grad(jnp.asarray(x), jnp.asarray(lab))
    tx = torch.from_numpy(x).requires_grad_()
    loss = hk.softmax_cross_entropy(tx, torch.from_numpy(lab))
    loss.backward(torch.ones(2))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-5)


def test_softmax_cross_entropy_labels_that_do_not_broadcast_raise():
    """Neither package takes 3 labels for 2 rows; the kernel's wrapper
    refuses a label count other than the rows'."""
    x = np.zeros((2, 5), "float32")
    lab = np.zeros(3, "float32")
    with pytest.raises(Exception):
        pk.softmax_cross_entropy(jnp.asarray(x), jnp.asarray(lab))
    with pytest.raises(hk.MXNetError, match="broadcast"):
        hk.softmax_cross_entropy(torch.from_numpy(x), torch.from_numpy(lab))
    with pytest.raises(hk.MXNetError, match="one label a row"):
        hk._ce_kernel(torch.zeros(2, 5), torch.zeros(1, dtype=torch.int64))
