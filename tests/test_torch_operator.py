"""PyTorch port, ``mx.operator`` (CustomOp) and ``autograd.Function``
against the JAX package.

The same numpy inputs go through both packages' custom-op bridges with
the same numpy op bodies, so what is compared is the bridge: how outputs
and gradient buffers are allocated and written, ``need_top_grad``, two
outputs, ``grad_req="add"`` across two backwards, the graph-mode
``sym.Custom`` (forward only, in both), the errors, and user-defined
``autograd.Function``s. Tolerance 1e-6 relative: the bodies are the same
float32 numpy, the chain rule around them is float32 in both.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_torch_threads import one_torch_thread  # noqa: F401

PACKAGES = {"jax": jmx, "torch": mx}


def _ops(m):
    """The test ops, written once against either package ``m``."""

    class Sigmoid(m.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0],
                        m.nd.array(1.0 / (1.0 + np.exp(-x))))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            gy = out_grad[0].asnumpy()
            self.assign(in_grad[0], req[0], m.nd.array(gy * y * (1 - y)))

    class SigmoidProp(m.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Sigmoid()

    class SoftmaxCE(m.operator.CustomOp):
        """``example/numpy-ops/custom_softmax.py``'s head."""

        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        m.nd.array(e / e.sum(axis=1, keepdims=True)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            p = out_data[0].asnumpy()
            lab = in_data[1].asnumpy().astype("int64")
            g = p.copy()
            g[np.arange(len(lab)), lab] -= 1.0
            self.assign(in_grad[0], req[0], m.nd.array(g / len(lab)))
            self.assign(in_grad[1], req[1],
                        m.nd.array(np.zeros(lab.shape, "float32")))

    class SoftmaxCEProp(m.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return SoftmaxCE()

    class TwoOut(m.operator.CustomOp):
        """(2x, x²) and their gradient 2·g0 + 2x·g1."""

        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], m.nd.array(2.0 * x))
            self.assign(out_data[1], req[1], m.nd.array(x * x))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            x = in_data[0].asnumpy()
            g0, g1 = out_grad[0].asnumpy(), out_grad[1].asnumpy()
            self.assign(in_grad[0], req[0], m.nd.array(2 * g0 + 2 * x * g1))

    class TwoOutProp(m.operator.CustomOpProp):
        def list_outputs(self):
            return ["double", "square"]

        def create_operator(self, ctx, shapes, dtypes):
            return TwoOut()

    m.operator.register("tt_sigmoid")(SigmoidProp)
    m.operator.register("tt_softmax_ce")(SoftmaxCEProp)
    m.operator.register("tt_two_out")(TwoOutProp)


@pytest.fixture(scope="module", autouse=True)
def registered():
    for m in PACKAGES.values():
        _ops(m)


def _run(m, fn):
    """``fn(m)`` in the package's CPU context: numpy results."""
    if m is mx:
        with mx.cpu():
            return fn(m)
    return fn(m)


def _both(fn):
    return _run(jmx, fn), _run(mx, fn)


def _close(a, b, tol=1e-6):
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), rtol=tol,
                                   atol=tol * max(np.abs(x).max(), 1e-30))


X = np.array([0.0, 1.0, -2.0, 0.37], dtype="float32")


def test_custom_op_forward_and_grad():
    def fn(m):
        x = m.nd.array(X)
        x.attach_grad()
        with m.autograd.record():
            y = m.nd.Custom(x, op_type="tt_sigmoid")
        y.backward()
        return y.asnumpy(), x.grad.asnumpy()
    jax, port = _both(fn)
    _close(jax, port)
    s = 1.0 / (1.0 + np.exp(-X))
    _close((s, s * (1 - s)), port)


def test_custom_op_chained_grad():
    def fn(m):
        x = m.nd.array(X)
        x.attach_grad()
        with m.autograd.record():
            y = m.nd.Custom(2.0 * x, op_type="tt_sigmoid")
            z = (y * y).sum()
        z.backward()
        return z.asnumpy().reshape(1), x.grad.asnumpy()
    _close(*_both(fn))


def test_loss_head_without_top_grad():
    rng = np.random.RandomState(0)
    logits = rng.randn(6, 5).astype("float32")
    labels = np.array([0, 4, 2, 2, 1, 3], dtype="float32")

    def fn(m):
        x = m.nd.array(logits)
        x.attach_grad()
        with m.autograd.record():
            p = m.nd.Custom(x, m.nd.array(labels), op_type="tt_softmax_ce")
        p.backward()
        return p.asnumpy(), x.grad.asnumpy()
    jax, port = _both(fn)
    _close(jax, port)
    onehot = np.eye(5, dtype="float32")[labels.astype(int)]
    _close([(jax[0] - onehot) / 6], port[1:])


def test_two_outputs():
    def fn(m):
        x = m.nd.array(X)
        x.attach_grad()
        with m.autograd.record():
            a, b = m.nd.Custom(x, op_type="tt_two_out")
            z = (a * b).sum()
        z.backward()
        return a.asnumpy(), b.asnumpy(), x.grad.asnumpy()
    jax, port = _both(fn)
    _close(jax, port)
    _close((2 * X, X * X, 6 * X * X), port)


def test_grad_req_add_across_two_backwards():
    def fn(m):
        x = m.nd.array(X)
        x.attach_grad(grad_req="add")
        for scale in (1.0, 3.0):
            with m.autograd.record():
                y = m.nd.Custom(x, op_type="tt_sigmoid") * scale
            y.backward()
        return (x.grad.asnumpy(),)
    jax, port = _both(fn)
    _close(jax, port)
    s = 1.0 / (1.0 + np.exp(-X))
    _close((4 * s * (1 - s),), port)


def test_symbolic_custom_forward():
    def fn(m):
        s = m.sym.Custom(m.sym.Variable("data"), op_type="tt_sigmoid",
                         name="sig")
        ex = s.bind(m.cpu(), {"data": m.nd.array(X)})
        return (ex.forward()[0].asnumpy(),)
    jax, port = _both(fn)
    _close(jax, port)
    _close((1.0 / (1.0 + np.exp(-X)),), port)


def test_symbolic_custom_infers_shapes_without_running():
    """Shape inference answers from the prop; the user's forward (numpy
    on a shapeless tensor would fail) is not called."""
    s = mx.sym.Custom(mx.sym.Variable("data"), op_type="tt_two_out",
                      name="two")
    _, outs, _ = s.infer_shape(data=(3, 7))
    assert outs == [(3, 7), (3, 7)]
    assert s.list_outputs() == ["two_output0", "two_output1"]


@pytest.mark.parametrize("case", ["too_few_inputs", "unregistered"])
def test_errors(case):
    def fn(m):
        x = m.nd.array(X)
        if case == "too_few_inputs":
            m.nd.Custom(x, op_type="tt_softmax_ce")
        else:
            m.nd.Custom(x, op_type="tt_not_registered")
    for name, m in PACKAGES.items():
        with pytest.raises(m.MXNetError):
            _run(m, fn)


def _functions(m):
    class Sigmoid(m.autograd.Function):
        def forward(self, x):
            y = m.nd.sigmoid(x)
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    class MulAdd(m.autograd.Function):
        """(x·y, x + y) and their gradients."""

        def forward(self, x, y):
            self.save_for_backward(x, y)
            return x * y, x + y

        def backward(self, g_prod, g_sum):
            x, y = self.saved_tensors
            return g_prod * y + g_sum, g_prod * x + g_sum

    return Sigmoid, MulAdd


def test_autograd_function_single_output():
    rng = np.random.RandomState(1)
    xv = rng.randn(5).astype("float32")

    def fn(m):
        Sigmoid, _ = _functions(m)
        x = m.nd.array(xv)
        x.attach_grad()
        with m.autograd.record():
            y = Sigmoid()(x)
            loss = (y * y).sum()
        loss.backward()
        return y.asnumpy(), x.grad.asnumpy()
    jax, port = _both(fn)
    _close(jax, port)
    s = 1 / (1 + np.exp(-xv))
    _close((s, 2 * s * s * (1 - s)), port)


def test_autograd_function_two_outputs():
    rng = np.random.RandomState(2)
    xv, yv = rng.randn(2, 4).astype("float32")

    def fn(m):
        _, MulAdd = _functions(m)
        x, y = m.nd.array(xv), m.nd.array(yv)
        x.attach_grad()
        y.attach_grad()
        with m.autograd.record():
            prod, tot = MulAdd()(x, y)
            loss = (prod * 3.0 + tot * tot).sum()
        loss.backward()
        return prod.asnumpy(), tot.asnumpy(), x.grad.asnumpy(), \
            y.grad.asnumpy()
    jax, port = _both(fn)
    _close(jax, port)
    _close((xv * yv, xv + yv, 3 * yv + 2 * (xv + yv),
            3 * xv + 2 * (xv + yv)), port)
