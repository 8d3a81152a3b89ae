"""PyTorch port, ``gluon.CachedOp`` and ``gluon.contrib`` (slice 14)
against the JAX package: a graph with its parameters through each
package's ``CachedOp`` (inference, training with the moving statistics'
update, ``train_mode=False`` under ``record()``, gradients of the
parameters and the data, the input-count error); ``contrib.nn``'s
``Concurrent``, ``HybridConcurrent``, ``Identity``, ``SparseEmbedding``
and ``SyncBatchNorm``; ``contrib.data.IntervalSampler``; ``contrib.rnn``'s
``VariationalDropoutCell``, ``LSTMPCell`` and the nine convolutional
cells; and ``contrib.estimator``'s ``Estimator.fit``/``evaluate`` with its
handlers over a few batches.

Each block is built in both packages with the same prefix and the JAX
block's weights are carried across (``interop.load_block_params``).
Tolerance: 1e-5 of the largest |value| (float32 on both sides, another
summation order); the samplers' indices and the handlers' decisions
equal. Dropout draws from torch's generator in the port, so the cells'
parity runs at rate 0 and the variational mask's reuse is checked on the
port alone.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import interop
from mxnet_tpu_torch.base import MXNetError
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{what}: {err:.3e} of max|want| {scale:.3e}"


def _grad(p):
    """A parameter's gradient as numpy (a method in the JAX package, a
    property in the port)."""
    g = p.grad
    return (g() if callable(g) else g).asnumpy()


def _run(pkg, block, inputs, seed=0):
    """``block`` on ``inputs`` under ``record()``; the backward of
    sum(out · seeded weights) over every output. Returns (outputs, the
    parameters' gradients, the inputs' gradients)."""
    xs = [pkg.nd.array(a) for a in inputs]
    for x in xs:
        x.attach_grad()
    with pkg.autograd.record():
        out = block(*xs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        flat = []
        for o in outs:
            flat += o if isinstance(o, (list, tuple)) else [o]
        rs = np.random.RandomState(seed)
        loss = sum((o * pkg.nd.array(rs.uniform(0.5, 1.5, o.shape)
                                     .astype("float32"))).sum()
                   for o in flat)
    loss.backward()
    return ([o.asnumpy() for o in flat],
            {n: _grad(p) for n, p in block.collect_params().items()
             if p.grad_req != "null"},
            [x.grad.asnumpy() for x in xs])


def _pair(make, inputs, what, init=True):
    """``make(pkg)`` in both packages, the JAX block's weights carried to
    the port's, both run by ``_run``; every output and gradient compared."""
    with jmx.cpu():
        jb = make(jmx)
        if init:
            jb.initialize(jmx.init.Xavier())
        jrun = _run(jmx, jb, inputs)
    with mx.cpu():
        pb = make(mx)
        if init:
            pb.initialize()
        interop.load_block_params(pb, {n: p.data().asnumpy() for n, p in
                                       jb.collect_params().items()})
        prun = _run(mx, pb, inputs)
    for i, (g, w) in enumerate(zip(prun[0], jrun[0])):
        _close(g, w, f"{what} output {i}")
    assert sorted(prun[1]) == sorted(jrun[1]), what
    for n, w in jrun[1].items():
        _close(prun[1][n], w, f"{what} d{n}")
    for i, (g, w) in enumerate(zip(prun[2], jrun[2])):
        _close(g, w, f"{what} dinput{i}")
    return jb, pb


def _graph(pkg):
    s = pkg.sym
    h = s.BatchNorm(s.Variable("data"), name="bn")
    h = s.Activation(s.FullyConnected(h, num_hidden=6, name="fc1"),
                     act_type="tanh")
    return s.FullyConnected(h, num_hidden=3, name="fc2")


def _cached_op(pkg, sym, values, aux):
    """``gluon.CachedOp`` over ``sym`` with a parameter a value (the moving
    statistics without gradient)."""
    params = {}
    for name, v in values.items():
        p = pkg.gluon.Parameter(name, shape=v.shape,
                                grad_req="null" if name in aux else "write")
        p.initialize(ctx=pkg.cpu())
        p.set_data(pkg.nd.array(v))
        params[name] = p
    return pkg.gluon.CachedOp(sym, params), params


def test_cached_op_and_contrib_layers_match_jax():
    """``CachedOp`` against the JAX ``CachedOp`` on the same graph and
    values: inference, training (outputs, every gradient, the moving
    statistics after it), ``record(train_mode=False)``, and the message
    for a wrong input count. Then ``HybridConcurrent`` (hybridized in both)
    and ``Concurrent`` over ``Dense`` and ``Identity`` branches,
    ``SparseEmbedding`` (its dense gradient holds only the rows a batch
    touched: ``row_sparse_array`` of it keeps those), ``SyncBatchNorm`` in
    training and inference, and ``IntervalSampler``'s indices."""
    rs = np.random.RandomState(0)
    x = rs.randn(4, 5).astype("float32")
    jsym, psym = _graph(jmx), _graph(mx)
    arg_shapes, _, aux_shapes = psym.infer_shape(data=x.shape)
    values = {n: rs.uniform(-1, 1, s).astype("float32")
              for n, s in zip(psym.list_arguments(), arg_shapes)
              if n != "data"}
    aux = {n: rs.uniform(0.5, 1.5, s).astype("float32")
           for n, s in zip(psym.list_auxiliary_states(), aux_shapes)}
    values.update(aux)
    runs = []
    for pkg, sym in ((jmx, jsym), (mx, psym)):
        with pkg.cpu():
            op, params = _cached_op(pkg, sym, values, aux)
            xa = pkg.nd.array(x)
            infer = op(xa).asnumpy()
            with pkg.autograd.record(train_mode=False):
                frozen = op(xa).asnumpy()
            xa.attach_grad()
            with pkg.autograd.record():
                out = op(xa)
                (out * out).sum().backward()
            grads = {n: _grad(p) for n, p in params.items()
                     if n not in aux}
            stats = {n: params[n].data().asnumpy() for n in aux}
            with pytest.raises(Exception) as err:
                op(xa, xa)
        runs.append((infer, frozen, out.asnumpy(), grads,
                     xa.grad.asnumpy(), stats, str(err.value)))
    (ji, jf, jo, jg, jx, js, je), (pi, pf, po, pg, px, ps, pe) = runs
    for g, w, what in ((pi, ji, "inference"), (pf, jf, "train_mode=False"),
                       (po, jo, "training"), (px, jx, "d data")):
        _close(g, w, what)
    for n, w in jg.items():
        _close(pg[n], w, f"d{n}")
    for n, w in js.items():
        _close(ps[n], w, n)
        assert not np.allclose(ps[n], aux[n]), n
    assert pe == je == "CachedOp expects 1 inputs (['data']), got 2"

    def concurrent(hybrid):
        def make(pkg):
            nn, cnn = pkg.gluon.nn, pkg.gluon.contrib.nn
            net = (cnn.HybridConcurrent if hybrid else cnn.Concurrent)(
                axis=1, prefix="cat_")
            with net.name_scope():
                net.add(nn.Dense(3, in_units=5), nn.Dense(2, in_units=5),
                        cnn.Identity())
            if hybrid:
                net.hybridize()
            return net
        return make

    for hybrid in (True, False):
        _pair(concurrent(hybrid), [x], f"concurrent hybrid={hybrid}")

    ids = np.array([[1, 3], [3, 7]], np.float32)
    _, emb = _pair(lambda pkg: pkg.gluon.contrib.nn.SparseEmbedding(
        10, 4, prefix="semb_"), [ids], "SparseEmbedding")
    rows = mx.nd.sparse.row_sparse_array(emb.weight.grad)
    assert rows.indices.asnumpy().tolist() == [1, 3, 7]

    # inference on fresh blocks: after a training forward the JAX eager
    # BatchNorm keeps its running statistics (ROADMAP C)
    img = rs.randn(4, 3, 2, 2).astype("float32")
    outs, stats = [], rs.uniform(0.5, 1.5, (4, 3)).astype("float32")
    for pkg in (jmx, mx):
        with pkg.cpu():
            sbn = pkg.gluon.contrib.nn.SyncBatchNorm(
                in_channels=3, num_devices=2, prefix="sbn_")
            sbn.initialize()
            for p, v in zip(sbn.collect_params().values(), stats):
                p.set_data(pkg.nd.array(v))
            outs.append(sbn(pkg.nd.array(img)).asnumpy())
    _close(outs[1], outs[0], "SyncBatchNorm inference")
    _pair(lambda pkg: pkg.gluon.contrib.nn.SyncBatchNorm(
        in_channels=3, num_devices=2, prefix="sbn_"), [img],
        "SyncBatchNorm training")

    for args in ((10, 3), (10, 3, False), (7, 7), (5, 1, False)):
        want = jmx.gluon.contrib.data.IntervalSampler(*args)
        got = mx.gluon.contrib.data.IntervalSampler(*args)
        assert list(got) == list(want) and len(got) == len(want), args


def _cell(pkg, kind, dims):
    rnn = pkg.gluon.contrib.rnn
    shape = (2,) + (5, 4, 3)[:dims]
    return getattr(rnn, f"Conv{dims}D{kind}Cell")(
        shape, 3, 3, 3, i2h_pad=1, prefix=f"c{dims}{kind.lower()}_")


class _Unroll:
    """A cell unrolled ``length`` steps as a block of its inputs (NTC;
    the outputs merged, then the final states)."""

    def __init__(self, cell, length):
        self.cell, self.length = cell, length

    def __call__(self, x):
        out, states = self.cell.unroll(self.length, x, layout="NTC",
                                       merge_outputs=True)
        return [out] + list(states)

    def __getattr__(self, name):
        return getattr(self.cell, name)


def test_contrib_cells_and_estimator_match_jax(tmp_path):
    """``LSTMPCell`` and ``VariationalDropoutCell`` (around an ``LSTMCell``
    at rate 0) unrolled three steps, and each of the nine
    ``Conv{1,2,3}D{RNN,LSTM,GRU}Cell`` unrolled two, against the JAX cells
    (outputs, final states, every gradient); the variational masks drawn
    once a sequence (port). Then ``Estimator.fit`` over two batches for
    two epochs with validation, ``CheckpointHandler`` and
    ``EarlyStoppingHandler`` against the JAX estimator (weights, the
    metrics, the files written, the stop), and ``evaluate``."""
    rs = np.random.RandomState(1)
    seq = rs.randn(2, 3, 4).astype("float32")
    _pair(lambda pkg: _Unroll(pkg.gluon.contrib.rnn.LSTMPCell(
        6, 3, input_size=4, prefix="lstmp_"), 3), [seq], "LSTMPCell")
    _pair(lambda pkg: _Unroll(pkg.gluon.contrib.rnn.VariationalDropoutCell(
        pkg.gluon.rnn.LSTMCell(5, input_size=4, prefix="vd_")), 3), [seq],
        "VariationalDropoutCell")
    for dims in (1, 2, 3):
        frames = rs.randn(*((2, 2, 2) + (5, 4, 3)[:dims])).astype("float32")
        for kind in ("RNN", "LSTM", "GRU"):
            _pair(lambda pkg: _Unroll(_cell(pkg, kind, dims), 2), [frames],
                  f"Conv{dims}D{kind}Cell")

    vd = mx.gluon.contrib.rnn.VariationalDropoutCell(
        mx.gluon.rnn.LSTMCell(5, input_size=4), drop_inputs=0.5,
        drop_outputs=0.5)
    vd.initialize(ctx=mx.cpu())
    with mx.autograd.record():
        vd.unroll(3, mx.nd.array(seq, ctx=mx.cpu()), layout="NTC")
        masks = (vd._input_mask, vd._output_mask)
        vd(mx.nd.array(seq[:, 0], ctx=mx.cpu()),
           vd.begin_state(2, ctx=mx.cpu()))
    assert vd._input_mask is masks[0] and vd._output_mask is masks[1]
    assert set(np.unique(masks[0].asnumpy())) <= {0.0, 2.0}

    data = rs.randn(8, 4).astype("float32")
    label = np.array([0, 1, 2, 1, 0, 2, 2, 1], np.float32)
    runs = []
    for pkg in (jmx, mx):
        with pkg.cpu():
            runs.append(_estimator_run(pkg, data, label, tmp_path, runs))
    (jw, ja, jv, je, jf, jev, _), (pw, pa, pv, pe, pf, pev, _) = runs
    for n, w in jw.items():
        _close(pw[n], w, n)
    assert (pa, pv, pe, pf, pev) == (ja, jv, je, jf, jev)
    with pytest.raises(MXNetError, match="needs a trainer"):
        mx.gluon.contrib.estimator.Estimator(None, None).fit([])


def _estimator_run(pkg, data, label, tmp_path, runs):
    """``Estimator.fit`` (three epochs of two batches, validation,
    checkpoints, early stopping at patience 1 on the training accuracy)
    from the JAX run's first weights (``runs[0][-1]``), then ``evaluate``.
    Returns (weights, the training and validation metrics, the last epoch,
    the files written, the evaluation, the first weights)."""
    est_mod = pkg.gluon.contrib.estimator
    net = pkg.gluon.nn.Dense(3, in_units=4, prefix="est_")
    net.initialize()
    if runs:
        interop.load_block_params(net, runs[0][-1])
    w0 = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    batches = [(pkg.nd.array(data[i:i + 4]), pkg.nd.array(label[i:i + 4]))
               for i in (0, 4)]
    acc = pkg.metric.Accuracy()
    est = est_mod.Estimator(
        net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(), train_metrics=[acc],
        trainer=pkg.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.5}))
    out = str(tmp_path / pkg.__name__)
    stop = est_mod.EarlyStoppingHandler(acc, patience=1, mode="max")
    est.fit(batches, val_data=batches[:1], epochs=3, event_handlers=[
        est_mod.CheckpointHandler(out, model_prefix="m"), stop])
    return ({n: p.data().asnumpy() for n, p in net.collect_params().items()},
            acc.get(), est.val_metrics[0].get(), est.epoch,
            sorted(os.listdir(out)),
            est.evaluate(batches, [pkg.metric.Accuracy()]), w0)
