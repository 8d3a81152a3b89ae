"""PyTorch port, ``mx.io``'s iterators with their state protocol, the
device feed, and the metrics and callbacks ``fit`` reads, against the JAX
package.

Both packages read the same files (CSV, MNIST idx plain and gzip) and
arrays; their batches must be equal, and a state taken mid-epoch and set
on a fresh iterator must give the same remaining batches in both. The
feed runs here on the CPU (its thread, queue and state logic; the card's
streams and page-locked buffers run in ``chip_smoke.py``). Shuffles draw
their seeds from each package's host stream, seeded alike for each case.
Metrics: within 1e-6 of the JAX value.
"""
import gzip
import logging
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_torch_threads import one_torch_thread  # noqa: F401
from torch_shared import jax_host_seed


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def _np(batch):
    return ([d.asnumpy() for d in batch.data],
            [l.asnumpy() for l in batch.label or []], batch.pad)


def _drain(it, n=None):
    out = []
    for k, b in enumerate(it):
        if n is not None and k == n:
            break
        out.append(_np(b))
    return out


def _same(a, b, what):
    assert len(a) == len(b), f"{what}: {len(a)} against {len(b)} batches"
    for k, (x, y) in enumerate(zip(a, b)):
        for u, v in zip(x[0] + x[1], y[0] + y[1]):
            np.testing.assert_array_equal(u, v, f"{what}: batch {k}")
        assert x[2] == y[2], f"{what}: batch {k} pad"


def _write_idx(prefix, images, labels, suffix=""):
    """``prefix-images`` and ``prefix-labels`` (gzip with ``.gz``)."""
    opener = gzip.open if suffix == ".gz" else open
    with opener(f"{prefix}-images{suffix}", "wb") as f:
        f.write(struct.pack(">IIII", 2051, *images.shape))
        f.write(images.tobytes())
    with opener(f"{prefix}-labels{suffix}", "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)))
        f.write(labels.tobytes())


def _seeded(seed):
    """Both packages' host streams seeded with ``seed``."""
    mx.random.seed(seed)
    return jax_host_seed(seed)


def _iterators(tmp_path):
    """(case, factory(pkg)) for every iterator."""
    rs = np.random.RandomState(3)
    x = rs.randn(23, 2, 3).astype("float32")
    y = rs.randint(0, 5, 23).astype("float32")
    csv_d, csv_l = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(csv_d, x.reshape(23, -1), delimiter=",")
    np.savetxt(csv_l, y, delimiter=",")
    images = rs.randint(0, 256, (37, 28, 28)).astype("uint8")
    labels = rs.randint(0, 10, 37).astype("uint8")
    prefix = str(tmp_path / "mnist")
    for suffix in ("", ".gz"):
        _write_idx(prefix, images, labels, suffix)

    def mnist(pkg, suffix="", **kw):
        return pkg.io.MNISTIter(image=f"{prefix}-images{suffix}",
                                label=f"{prefix}-labels{suffix}",
                                batch_size=8, **kw)

    svm1, svm0, svm_labels = _libsvm_files(tmp_path, rs)

    return [
        ("ndarray-pad-shuffle", lambda pkg: pkg.io.NDArrayIter(
            x, y, 5, shuffle=True)),
        ("ndarray-discard", lambda pkg: pkg.io.NDArrayIter(
            x, y, 5, last_batch_handle="discard")),
        ("resize", lambda pkg: pkg.io.ResizeIter(
            pkg.io.NDArrayIter(x, y, 5), 9)),
        ("prefetching", lambda pkg: pkg.io.PrefetchingIter(
            [pkg.io.NDArrayIter(x, y, 5, shuffle=True)])),
        ("csv", lambda pkg: pkg.io.CSVIter(
            data_csv=csv_d, data_shape=(2, 3), label_csv=csv_l,
            batch_size=6)),
        ("mnist", lambda pkg: mnist(pkg)),
        ("mnist-gz-flat-seed", lambda pkg: mnist(
            pkg, ".gz", flat=True, seed=12345)),
        ("mnist-no-shuffle", lambda pkg: mnist(pkg, shuffle=False)),
        ("libsvm-auto-1based-pad", lambda pkg: pkg.io.LibSVMIter(
            data_libsvm=svm1, data_shape=(6,), batch_size=4)),
        ("libsvm-0based-short", lambda pkg: pkg.io.LibSVMIter(
            data_libsvm=svm0, data_shape=(2, 3), batch_size=4,
            round_batch=False, indexing_mode=0)),
        ("libsvm-label-file", lambda pkg: pkg.io.LibSVMIter(
            data_libsvm=svm0, data_shape=(6,), label_libsvm=svm_labels,
            label_shape=(2,), batch_size=3, indexing_mode=0)),
    ]


def _libsvm_line(rs, label, ncol, base):
    cols = np.sort(rs.choice(ncol, rs.randint(0, 4), replace=False))
    return f"{label} " + " ".join(f"{c + base}:{rs.randn():.6g}"
                                  for c in cols)


def _libsvm_files(tmp_path, rs):
    """A 1-based file that uses column ncol (11 rows, "auto" reads it
    1-based), a 0-based one with a blank line (10 rows) and a label file
    of two values a row."""
    paths = [str(tmp_path / n) for n in ("one.svm", "zero.svm", "lab.txt")]
    lines = [_libsvm_line(rs, k % 2, 6, 1) for k in range(10)] + ["1 6:2.5"]
    with open(paths[0], "w") as f:
        f.write("\n".join(lines) + "\n")
    lines = [_libsvm_line(rs, k % 3, 6, 0) for k in range(10)]
    with open(paths[1], "w") as f:
        f.write("\n".join(lines[:4] + [""] + lines[4:]) + "\n")
    with open(paths[2], "w") as f:
        f.write("\n".join(f"{k} {-k}" for k in range(10)) + "\n")
    return paths


def _csr_parts(batch):
    d = batch.data[0]
    return (d.stype, d.shape, d.data.asnumpy(), d.indices.asnumpy(),
            d.indptr.asnumpy(), batch.label[0].asnumpy(), batch.pad)


def _libsvm_behaviours(tmp_path):
    """CSR structure and dtypes against the JAX package's batches; the JAX
    package's quirks the port keeps: the last batch padded with its own
    first row, and "auto" reading a 1-based file that never uses column
    ncol as 0-based; out-of-range indices raise in every mode."""
    rs = np.random.RandomState(8)
    svm1, svm0, _ = _libsvm_files(tmp_path, rs)
    for kw in ({"data_libsvm": svm1, "data_shape": (6,), "batch_size": 4},
               {"data_libsvm": svm0, "data_shape": (6,), "batch_size": 3,
                "indexing_mode": 0}):
        for b, jb in zip(mx.io.LibSVMIter(**kw), jmx.io.LibSVMIter(**kw)):
            got, want = _csr_parts(b), _csr_parts(jb)
            assert got[:2] == want[:2] and got[-1] == want[-1]
            for g, w in zip(got[2:-1], want[2:-1]):
                assert g.dtype == w.dtype and np.array_equal(g, w)
    last = list(mx.io.LibSVMIter(data_libsvm=svm1, data_shape=(6,),
                                 batch_size=4))[-1]
    dense = last.data[0].asnumpy()
    assert last.pad == 1 and np.array_equal(dense[3], dense[0])
    assert last.data[0].context == mx.cpu()
    # a 1-based file whose largest index is below ncol reads 0-based
    path = str(tmp_path / "ambiguous.svm")
    with open(path, "w") as f:
        f.write("1 1:1.0 3:2.0\n0 2:3.0\n")
    for pkg in (mx, jmx):
        b = next(iter(pkg.io.LibSVMIter(data_libsvm=path, data_shape=(5,),
                                        batch_size=2)))
        assert b.data[0].indices.asnumpy().tolist() == [1, 3, 2], pkg
        b = next(iter(pkg.io.LibSVMIter(data_libsvm=path, data_shape=(5,),
                                        batch_size=2, indexing_mode=1)))
        assert b.data[0].indices.asnumpy().tolist() == [0, 2, 1], pkg
        for mode, shape in ((0, (3,)), (1, (2,)), ("auto", (2,))):
            with pytest.raises(Exception, match="out of range"):
                pkg.io.LibSVMIter(data_libsvm=path, data_shape=shape,
                                  indexing_mode=mode)


def test_iterators_state_and_metrics_match_jax(tmp_path, caplog):
    """Every iterator's batches, over two epochs, and a state taken after
    two batches and set on a fresh iterator; ``MNISTIter(seed=)`` draws
    no differently; ``LibSVMIter``'s CSR batches and its quirks; the
    metrics and callbacks ``fit`` reads."""
    with mx.cpu():
        for case, make in _iterators(tmp_path):
            got = {}
            for pkg in (jmx, mx):
                with _seeded(5):
                    it = make(pkg)
                    epochs = _drain(it)
                    it.reset()
                    epochs += _drain(it, 2)
                    assert pkg.io.has_state(it), case
                    state = it.state()
                    rest = _drain(it)
                    it.close()
                with _seeded(9):
                    fresh = make(pkg)
                    fresh.set_state(state)
                    resumed = _drain(fresh)
                    fresh.close()
                _same(resumed, rest, f"{case} resumed ({pkg.__name__})")
                got[pkg] = (epochs, rest, state)
            _same(got[mx][0], got[jmx][0], case)
            _same(got[mx][1], got[jmx][1], case)
            assert got[mx][2] == got[jmx][2], case
        # the seed MNISTIter accepts changes nothing
        with _seeded(5):
            a = _drain(_iterators(tmp_path)[6][1](mx))
        with _seeded(5):
            it = mx.io.MNISTIter(
                image=str(tmp_path / "mnist-images.gz"),
                label=str(tmp_path / "mnist-labels.gz"), batch_size=8,
                flat=True, seed=1)
            _same(_drain(it), a, "MNISTIter(seed=)")
        _libsvm_behaviours(tmp_path)

    rs = np.random.RandomState(4)
    probs = rs.dirichlet(np.ones(3), 16).astype("float32")
    binary = rs.dirichlet(np.ones(2), 16).astype("float32")
    labels3 = rs.randint(0, 3, 16).astype("float32")
    labels2 = rs.randint(0, 2, 16).astype("float32")
    reg = rs.randn(16, 1).astype("float32")
    reg_l = (reg[:, 0] + 0.3 * rs.randn(16)).astype("float32")
    cases = [("f1", {}, labels2, binary), ("mcc", {}, labels2, binary),
             ("mae", {}, reg_l, reg), ("rmse", {}, reg_l, reg),
             ("mse", {}, reg_l, reg), ("nll_loss", {}, labels3, probs),
             ("negativeloglikelihood", {}, labels3, probs),
             ("pearsoncorrelation", {}, reg_l, reg),
             ("top_k_acc", {"top_k": 2}, labels3, probs),
             ("ce", {}, labels3, probs), ("acc", {}, labels3, probs)]
    for name, kw, label, pred in cases:
        values = []
        for pkg in (jmx, mx):
            m = pkg.metric.create(name, **kw)
            for half in (slice(0, 8), slice(8, 16)):
                m.update([pkg.nd.array(label[half])],
                         [pkg.nd.array(pred[half])])
            values.append(m.get())
        assert values[1][0] == values[0][0], name
        np.testing.assert_allclose(values[1][1], values[0][1], rtol=1e-6,
                                   err_msg=name)
    for pkg in (jmx, mx):
        @pkg.metric.np_metric(name="absdiff")
        def absdiff(label, pred):
            return float(np.abs(label - pred.ravel()).sum()), label.size
        absdiff.update([pkg.nd.array(reg_l)], [pkg.nd.array(reg)])
        values.append(absdiff.get())
    assert values[-1] == pytest.approx(values[-2], rel=1e-6)

    lines = []
    for pkg in (jmx, mx):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            m = pkg.metric.create("acc")
            m.update([pkg.nd.array(labels3)], [pkg.nd.array(probs)])
            param = pkg.module.base_module.BatchEndParam(
                epoch=2, nbatch=3, eval_metric=m, locals=None)
            pkg.callback.ProgressBar(total=8, length=20)(param)
            pkg.callback.LogValidationMetricsCallback()(param)
        lines.append([r.getMessage() for r in caplog.records])
    assert lines[1] == lines[0] and len(lines[0]) == 2, lines


class _Failing(mx.io.DataIter):
    """Two batches, then an error; ``reset`` rewinds."""

    def __init__(self, pkg):
        super().__init__(2)
        self.pkg, self.n = pkg, 0
        self.provide_data = [pkg.io.DataDesc("data", (2, 3))]
        self.provide_label = [pkg.io.DataDesc("softmax_label", (2,))]

    def reset(self):
        self.n = 0

    def next(self):
        self.n += 1
        if self.n > 2:
            raise ValueError("broken record")
        return self.pkg.io.DataBatch(
            [self.pkg.nd.array(np.full((2, 3), self.n, "float32"))],
            [self.pkg.nd.array(np.full(2, self.n, "float32"))])


def test_device_feed_matches_jax():
    """``DeviceFeedIter`` and ``prefetch_to_device`` against the JAX feed:
    the batches in order, the wire cast and rescale of data (not labels),
    the state credited for staged batches, a resume, the error raised on
    every ``next()`` until ``reset()``; sharding waits."""
    rs = np.random.RandomState(6)
    x = (rs.rand(21, 3) * 300).astype("float32")
    y = rs.randint(0, 4, 21).astype("float32")
    with mx.cpu():
        for kw in ({"depth": 1}, {"depth": 3},
                   {"depth": 2, "wire_dtype": "uint8", "scale": 1 / 255.,
                    "shift": -0.5}):
            runs = []
            for pkg in (jmx, mx):
                with _seeded(2):
                    feed = pkg.io.DeviceFeedIter(
                        pkg.io.NDArrayIter(x, y, 4, shuffle=True), **kw)
                    first = _drain(feed, 2)
                    import time
                    time.sleep(0.2)       # let the producer stage ahead
                    state = feed.state()
                    rest = _drain(feed)
                    feed.set_state(state)
                    again = _drain(feed)
                    feed.reset()
                    epoch2 = _drain(feed)
                    feed.close()
                _same(again, rest, f"{kw} resumed ({pkg.__name__})")
                runs.append((first + rest, state, epoch2))
            (jb, js, je), (pb, ps, pe) = runs
            assert len(pb) == len(jb) and len(pe) == len(je) and ps == js, kw
            # the rescale may round its multiply-add apart: 1 ulp
            for k, (u, v) in enumerate(zip(pb + pe, jb + je)):
                np.testing.assert_allclose(u[0][0], v[0][0], rtol=1e-6,
                                           atol=1e-7,
                                           err_msg=f"{kw} batch {k}")
                np.testing.assert_array_equal(u[1][0], v[1][0])
            if "wire_dtype" in kw:      # the labels travel untouched
                assert float(pb[0][1][0].max()) > 1.0

        errors = []
        for pkg in (jmx, mx):
            feed = pkg.io.DeviceFeedIter(_Failing(pkg))
            got = [float(b.data[0].asnumpy()[0, 0]) for b in
                   (feed.next(), feed.next())]
            msgs = []
            for _ in range(2):
                with pytest.raises(ValueError) as e:
                    feed.next()
                msgs.append(str(e.value))
            feed.reset()
            got.append(float(feed.next().data[0].asnumpy()[0, 0]))
            feed.close()
            errors.append((got, msgs))
        assert errors[1] == errors[0] == ([1.0, 2.0, 1.0],
                                          ["broken record"] * 2), errors
        # fit closes its feed when a batch raises
        s = mx.sym
        net = s.SoftmaxOutput(s.FullyConnected(s.Variable("data"),
                                               num_hidden=2, name="fc"),
                              s.Variable("softmax_label"), name="softmax")
        feed = mx.io.DeviceFeedIter(_Failing(mx))
        with pytest.raises(ValueError, match="broken record"):
            mx.mod.Module(net).fit(feed, num_epoch=1)
        assert feed._closed and not feed._thread

        # a stress of the hand-over: switches every microsecond, depth 1,
        # many one-row batches; the order and the count must hold
        import sys
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            rows = np.arange(400, dtype="float32")[:, None]
            feed = mx.io.DeviceFeedIter(mx.io.NDArrayIter(rows, rows[:, 0], 1),
                                        depth=1)
            got = [float(b.data[0].asnumpy()[0, 0]) for b in feed]
            feed.close()
        finally:
            sys.setswitchinterval(interval)
        assert got == list(rows[:, 0]), "the feed lost or reordered a batch"

        items = [(x[:2], {"y": y[:2]}), (x[2:4], {"y": y[2:4]})]
        staged = [list(mx.io.prefetch_to_device(items, depth=1)),
                  list(jmx.io.prefetch_to_device(items, depth=1))]
        for (pa, pd), (ja, jd) in zip(*staged):
            np.testing.assert_array_equal(pa.asnumpy(), np.asarray(ja))
            np.testing.assert_array_equal(pd["y"].asnumpy(),
                                          np.asarray(jd["y"]))
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            mx.io.DeviceFeedIter(mx.io.NDArrayIter(x, y, 4), sharding="dp")
