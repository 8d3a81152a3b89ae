"""PyTorch port, ``mx.mod.BucketingModule`` and ``mx.mod.SequentialModule``
against the JAX package's.

A small sequence model (Embedding 40→16, FullyConnected 16 relu, a head
to the 40 classes, ``flatten=False``) under a
``MakeLoss(softmax_cross_entropy)`` head, batch 2, MXNet's Adam (lr 1e-2)
on both sides, from the same numpy values.

* Bucketing: buckets T = 8 (the default) and 4, steps on 8, 4 and 8. The
  buckets share one storage for each parameter and gradient (the JAX
  package shares its arrays by reference); a bucket bound after an update
  sees the updated weights.
* Sequential: the body up to its logits, then a loss module
  (``take_labels=True, auto_wiring=True``) whose input gradient is the
  body's head gradient; two steps, and the same steps through one Module
  over the whole graph (bitwise on the port's side). A ``PythonModule``
  stage in the chain trains as the same operation inside the graph.

Tolerance: losses and weights within 1e-5 of each tensor's largest entry
(float32, the same arithmetic in another summation order).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
V, U, B = 40, 16, 2
ADAM = {"learning_rate": 1e-2}


def _body(sym):
    x = sym.Embedding(sym.Variable("data"), input_dim=V, output_dim=U,
                      name="embed")
    h = sym.Activation(sym.FullyConnected(x, num_hidden=U, flatten=False,
                                          name="fc1"), act_type="relu")
    return sym.FullyConnected(h, num_hidden=V, flatten=False, name="head")


def _head(sym, logits):
    return sym.MakeLoss(sym.softmax_cross_entropy(
        sym.reshape(logits, shape=(-1, V)),
        sym.reshape(sym.Variable("label"), shape=(-1,))))


def _values():
    rng = np.random.RandomState(0)
    shapes = {"embed_weight": (V, U), "fc1_weight": (U, U), "fc1_bias": (U,),
              "head_weight": (V, U), "head_bias": (V,)}
    return {k: (rng.randn(*s) * 0.3).astype("float32")
            for k, s in shapes.items()}


def _batch(pkg, T, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, V, (B, T)).astype("float32")
    y = rng.randint(0, V, (B, T)).astype("float32")
    return pkg.io.DataBatch(
        [pkg.nd.array(x)], [pkg.nd.array(y)], bucket_key=T,
        provide_data=[pkg.io.DataDesc("data", (B, T))],
        provide_label=[pkg.io.DataDesc("label", (B, T))])


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{what}: {err:.3e} of max|want| {scale:.3e}"


def _bucketing_run(pkg):
    """Steps on T = 8, 4, 8; (losses, final weights, the 4-bucket's
    weights right after it was bound, the default bucket's at that time,
    the module)."""
    with pkg.cpu():
        mod = pkg.mod.BucketingModule(
            lambda T: (_head(pkg.sym, _body(pkg.sym)), ("data",),
                       ("label",)),
            default_bucket_key=8, context=pkg.cpu())
        first = _batch(pkg, 8, 1)
        mod.bind(first.provide_data, first.provide_label)
        mod.init_params(arg_params={k: pkg.nd.array(v)
                                    for k, v in _values().items()})
        mod.init_optimizer(optimizer="adam", optimizer_params=ADAM)
        losses, seen = [], None
        for i, T in enumerate((8, 4, 8)):
            batch = _batch(pkg, T, i + 1)
            if T == 4:
                mod.switch_bucket(4, batch.provide_data, batch.provide_label)
                seen = ({k: v.asnumpy() for k, v in
                         mod.get_params()[0].items()},
                        {k: v.asnumpy() for k, v in
                         mod._buckets[8].get_params()[0].items()})
            mod.forward_backward(batch)
            losses.append(float(mod.get_outputs()[0].asnumpy().sum()))
            mod.update()
        weights = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return losses, weights, seen, mod


def test_bucketing_module_matches_jax():
    jl, jw, _, _ = _bucketing_run(jmx)
    pl, pw, (w4, w8), _ = _bucketing_run(mx)
    _close(pl, jl, "losses")
    assert sorted(pw) == sorted(jw)
    for k in jw:
        _close(pw[k], jw[k], k)
    # the 4-bucket, bound after an update, holds the updated weights
    for k in w8:
        np.testing.assert_array_equal(w4[k], w8[k])
    assert not np.array_equal(w8["head_weight"], _values()["head_weight"])


def test_buckets_share_one_storage():
    """Every parameter and gradient of the 4-bucket is the default
    bucket's storage; the data arrays are the bucket's own."""
    _, _, _, mod = _bucketing_run(mx)
    big, small = (mod._buckets[T]._exec_group.execs[0] for T in (8, 4))
    for k in _values():
        assert big.arg_dict[k]._data.data_ptr() == \
            small.arg_dict[k]._data.data_ptr()
        assert big.grad_dict[k]._data.data_ptr() == \
            small.grad_dict[k]._data.data_ptr()
    assert small.arg_dict["data"].shape == (B, 4)
    assert big.arg_dict["data"].shape == (B, 8)


def test_shared_parameter_of_another_shape_raises():
    """A bucket whose graph gives a shared parameter another shape is
    refused: one shape for each shared parameter."""
    def gen(T):
        out = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=T,
                                    name="fc")
        return mx.sym.MakeLoss(mx.sym.sum(out)), ("data",), ()
    with mx.cpu():
        mod = mx.mod.BucketingModule(gen, default_bucket_key=4,
                                     context=mx.cpu())
        mod.bind([mx.io.DataDesc("data", (B, 3))])
        mod.init_params()
        with pytest.raises(mx.MXNetError, match="one shape"):
            mod.switch_bucket(5, [mx.io.DataDesc("data", (B, 3))])


def _sequential_run(pkg):
    with pkg.cpu():
        body = pkg.mod.Module(_body(pkg.sym), data_names=("data",),
                              label_names=(), context=pkg.cpu())
        head = pkg.mod.Module(_head(pkg.sym, pkg.sym.Variable("logits")),
                              data_names=("logits",), label_names=("label",),
                              context=pkg.cpu())
        seq = pkg.mod.SequentialModule()
        seq.add(body).add(head, take_labels=True, auto_wiring=True)
        first = _batch(pkg, 8, 1)
        seq.bind(first.provide_data, first.provide_label)
        seq.init_params(arg_params={k: pkg.nd.array(v)
                                    for k, v in _values().items()})
        seq.init_optimizer(optimizer="adam", optimizer_params=ADAM)
        losses = []
        for i in range(2):
            batch = _batch(pkg, 8, i + 1)
            seq.forward_backward(batch)
            losses.append(float(seq.get_outputs()[0].asnumpy().sum()))
            seq.update()
        return losses, {k: v.asnumpy()
                        for k, v in seq.get_params()[0].items()}


def _whole_module_run():
    with mx.cpu():
        mod = mx.mod.Module(_head(mx.sym, _body(mx.sym)), data_names=("data",),
                            label_names=("label",), context=mx.cpu())
        first = _batch(mx, 8, 1)
        mod.bind(first.provide_data, first.provide_label)
        mod.init_params(arg_params={k: mx.nd.array(v)
                                    for k, v in _values().items()})
        mod.init_optimizer(optimizer="adam", optimizer_params=ADAM)
        losses = []
        for i in range(2):
            mod.forward_backward(_batch(mx, 8, i + 1))
            losses.append(float(mod.get_outputs()[0].asnumpy().sum()))
            mod.update()
        return losses, {k: v.asnumpy()
                        for k, v in mod.get_params()[0].items()}


def test_sequential_module_matches_jax_and_one_module():
    jl, jw = _sequential_run(jmx)
    pl, pw = _sequential_run(mx)
    _close(pl, jl, "losses")
    assert sorted(pw) == sorted(jw)
    for k in jw:
        _close(pw[k], jw[k], k)
    ml, mw = _whole_module_run()
    assert pl == ml
    for k in mw:
        np.testing.assert_array_equal(pw[k], mw[k], err_msg=k)


class _Double(mx.mod.PythonModule):
    """A Python stage between the body and the head: twice its input,
    twice the gradient back."""

    def __init__(self):
        super().__init__(["x"], None, ["doubled"])

    def forward(self, data_batch, is_train=None):
        self._out = [data_batch.data[0] * 2]

    def get_outputs(self, merge_multi_context=True):
        return self._out

    def backward(self, out_grads=None):
        self._grad = [out_grads[0] * 2]

    def get_input_grads(self, merge_multi_context=True):
        return self._grad


def test_python_module_stage_in_a_sequence():
    """A ``PythonModule`` stage mirrors its input shapes and carries the
    gradient through: body → ×2 → head trains as body → head over logits
    that are doubled in the graph."""
    def seq_run(python_stage):
        with mx.cpu():
            body = _body(mx.sym)
            if not python_stage:
                body = body * 2
            seq = mx.mod.SequentialModule()
            seq.add(mx.mod.Module(body, data_names=("data",), label_names=(),
                                  context=mx.cpu()))
            if python_stage:
                seq.add(_Double(), auto_wiring=True)
            seq.add(mx.mod.Module(_head(mx.sym, mx.sym.Variable("logits")),
                                  data_names=("logits",),
                                  label_names=("label",), context=mx.cpu()),
                    take_labels=True, auto_wiring=True)
            first = _batch(mx, 8, 1)
            seq.bind(first.provide_data, first.provide_label)
            seq.init_params(arg_params={k: mx.nd.array(v)
                                        for k, v in _values().items()})
            seq.init_optimizer(optimizer="sgd",
                               optimizer_params={"learning_rate": 0.1})
            seq.forward_backward(first)
            seq.update()
            return (float(seq.get_outputs()[0].asnumpy().sum()),
                    {k: v.asnumpy() for k, v in seq.get_params()[0].items()})
    with_stage, in_graph = seq_run(True), seq_run(False)
    assert with_stage[0] == pytest.approx(in_graph[0], rel=1e-6)
    for k, w in in_graph[1].items():
        _close(with_stage[1][k], w, k)
