"""PyTorch port, ``mxnet_tpu_torch.autograd`` and the ops of the loss head.

The port keeps no tape of its own: ops run under torch's grad mode while
``autograd.record()`` is on. These tests hold it to the JAX package's
semantics on the same numpy inputs: the record/pause/train flags, no graph
outside ``record()``, the ``grad_req`` rules (``write`` overwrites where
torch would accumulate, ``add`` adds, ``null`` takes nothing), ``grad``,
and the values and gradients of the ops the training step and the losses
use. Tolerance 1e-5: both sides float32, another summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu.ops.registry import get_op as jax_op
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.base import MXNetError
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _both(a):
    """The same numpy array as a JAX-package and a port (CPU) NDArray."""
    return jmx.nd.array(a), mx.nd.array(a, ctx=mx.cpu())


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_record_pause_train_flags(pkg):
    ag = jag if pkg == "jax" else autograd
    seen = [(ag.is_recording(), ag.is_training())]
    with ag.record():
        seen.append((ag.is_recording(), ag.is_training()))
        with ag.pause():
            seen.append((ag.is_recording(), ag.is_training()))
            with ag.train_mode():
                seen.append((ag.is_recording(), ag.is_training()))
        with ag.predict_mode():
            seen.append((ag.is_recording(), ag.is_training()))
    with ag.record(train_mode=False):
        seen.append((ag.is_recording(), ag.is_training()))
    seen.append((ag.is_recording(), ag.is_training()))
    assert seen == [(False, False), (True, True), (False, False),
                    (False, True), (True, False), (True, False),
                    (False, False)]


def test_no_graph_outside_record():
    x = mx.nd.array(np.ones((2, 3), "float32"), ctx=mx.cpu())
    x.attach_grad()
    assert not (x * 2)._data.requires_grad
    with autograd.record():
        assert (x * 2)._data.requires_grad
        with autograd.pause():
            assert not (x * 2)._data.requires_grad
    with pytest.raises(MXNetError, match="recorded graph"):
        (x * 2).backward()


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req_matches_jax(req):
    """Two backward passes without zeroing: ``write`` keeps the second
    gradient, ``add`` the sum, ``null`` none (its buffer stays zero; a
    second variable keeps the graph alive)."""
    a = np.arange(6, dtype="float32").reshape(2, 3) / 7
    out = {}
    for name, pkg, ag in (("jax", jmx, jag), ("port", mx, autograd)):
        i = 0 if name == "jax" else 1
        x, z = _both(a)[i], _both(a)[i]
        x.attach_grad(req)
        z.attach_grad()
        for scale in (2.0, 5.0):
            with ag.record():
                y = (x * x * scale + z).sum()
            y.backward()
        out[name] = x.grad.asnumpy()
    want = 2 * a * {"write": 5.0, "add": 7.0, "null": 0.0}[req]
    np.testing.assert_allclose(out["port"], want, rtol=TOL)
    np.testing.assert_allclose(out["port"], out["jax"], rtol=TOL)


def test_grad_leaves_buffers_and_matches_jax():
    a = np.linspace(-1, 1, 6, dtype="float32").reshape(2, 3)
    grads = []
    for pkg, ag in ((jmx, jag), (mx, autograd)):
        x = pkg.nd.array(a) if pkg is jmx else pkg.nd.array(a, ctx=mx.cpu())
        x.attach_grad()
        with ag.record():
            y = (x * x * x).sum()
        (g,) = ag.grad(y, [x])
        assert float(np.abs(x.grad.asnumpy()).max()) == 0.0
        grads.append(g.asnumpy())
    np.testing.assert_allclose(grads[1], 3 * a * a, rtol=TOL)
    np.testing.assert_allclose(grads[1], grads[0], rtol=TOL)


class _JaxOps:
    """``F`` for the JAX side: the JAX package's registered op functions
    on jnp arrays, so one jitted ``jax.vjp`` checks value and gradient."""

    def __getattr__(self, name):
        return jax_op(name).fn


def _jax_value_and_grad(fn, arrays):
    rest = [jnp.asarray(a) for a in arrays[1:]]

    def f(x):
        return fn(_JaxOps(), x, *rest)

    shape = jax.eval_shape(f, jnp.asarray(arrays[0])).shape
    w = np.linspace(0.5, 1.5, int(np.prod(shape)),
                    dtype="float32").reshape(shape)

    @jax.jit
    def run(x):
        y, vjp = jax.vjp(f, x)
        return y, vjp(jnp.asarray(w))[0]

    y, g = run(jnp.asarray(arrays[0]))
    return np.asarray(y), np.asarray(g)


def _port_value_and_grad(fn, arrays):
    xs = [mx.nd.array(a, ctx=mx.cpu()) for a in arrays]
    xs[0].attach_grad()
    with autograd.record():
        y = fn(mx.nd, *xs)
    w = np.linspace(0.5, 1.5, y.size, dtype="float32").reshape(y.shape)
    y.backward(mx.nd.array(w, ctx=mx.cpu()))
    return y.asnumpy(), xs[0].grad.asnumpy()


_RNG = np.random.RandomState(11)
_X = _RNG.randn(6, 10).astype("float32")
_Y = _RNG.randint(0, 10, 6).astype("float32")
_B = _RNG.randn(1, 10).astype("float32")

OPS = {
    "softmax_cross_entropy": (lambda F, x, y: F.softmax_cross_entropy(x, y),
                              (_X, _Y)),
    "log_softmax": (lambda F, x: F.log_softmax(x, axis=-1), (_X,)),
    "pick": (lambda F, x, y: F.pick(x, y, axis=-1, keepdims=True), (_X, _Y)),
    "mean_exclude": (lambda F, x: F.mean(x, axis=0, exclude=True), (_X,)),
    "sum_keepdims": (lambda F, x: F.sum(x, axis=1, keepdims=True), (_X,)),
    "reshape_like": (lambda F, x, y: F.reshape_like(x, y),
                     (_X, _X.reshape(3, 20))),
    "broadcast_mul": (lambda F, x, b: F.broadcast_mul(x, b), (_X, _B)),
    "square": (lambda F, x: F.square(x), (_X,)),
    "arithmetic": (lambda F, x, b: (-(x - b) * 3.0 + 2.0) / (x * x + 1.0)
                   - 1.0 / (x * x + 2.0), (_X, _B)),
    "dot": (lambda F, x, b: F.dot(x, b, transpose_b=True), (_X, _B)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_loss_head_ops_match_jax(name):
    fn, arrays = OPS[name]
    jv, jg = _jax_value_and_grad(fn, arrays)
    pv, pg = _port_value_and_grad(fn, arrays)
    assert pv.shape == jv.shape
    np.testing.assert_allclose(pv, jv, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pg, jg, rtol=TOL, atol=TOL)


def test_ndarray_sugar():
    x = mx.nd.array(np.arange(6, dtype="float32").reshape(2, 3),
                    ctx=mx.cpu())
    assert x.reshape((3, 2)).shape == (3, 2)
    assert x.mean().asscalar() == 2.5 and float(x.sum()) == 15.0
    assert x.astype("float64").dtype == np.float64
    c = x.copy()
    c._set_data(c._data + 1)
    assert x.asnumpy()[0, 0] == 0 and c.asnumpy()[0, 0] == 1
    assert mx.nd.ones((2,), ctx=mx.cpu()).asnumpy().tolist() == [1, 1]
    assert mx.nd.zeros(3, ctx=mx.cpu()).shape == (3,)
    with pytest.raises(MXNetError, match="not scalar"):
        x.asscalar()
