"""PyTorch port, MXNet's optimizers, the one-process ``kvstore`` and
``Module`` over it, against the JAX package.

Every rule takes three updates of the same numpy weights and gradients in
both packages (through each package's ``Updater``), with
``multi_precision`` on float16 weights, ``lr_mult``/``wd_mult`` by name,
``clip_gradient`` and a states file written after the second update and
read into a fresh updater. The sign and threshold rules (``Signum``,
``Ftrl``'s ``|z| > λ1``, ``LBSGD``'s ratio) run on gradients of one sign
and at least 0.5 in size, so that no entry sits within rounding of a
threshold. The store is held to the JAX store's flush order and copy
semantics, and ``Module`` over it to the JAX ``Module``. Tolerance:
weights and states within 1e-5 of the tensor's largest entry (float16
weights: equal after rounding both float32 masters to float16, 1e-3).
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
SHAPES = [(4, 3), (5,)]
NAMES = ["fc_weight", "fc_bias"]

RULES = [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True}),
    ("adam", {"learning_rate": 0.01, "clip_gradient": 0.8}),
    ("adagrad", {"learning_rate": 0.1, "wd": 0.01}),
    ("adadelta", {"rho": 0.9, "wd": 0.01}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True,
                 "clip_weights": 0.9}),
    ("ftrl", {"learning_rate": 0.1, "lamda1": 0.01, "wd": 0.01}),
    ("signum", {"learning_rate": 0.01, "wd": 0.01, "wd_lh": 0.001}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.0}),
    ("ftml", {"learning_rate": 0.01, "wd": 0.01}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("dcasgd", {"learning_rate": 0.1}),
    ("adamax", {"learning_rate": 0.01, "wd": 0.01}),
    ("nadam", {"learning_rate": 0.01, "wd": 0.01}),
    ("lbsgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("test", {"learning_rate": 0.1}),
]


def _values(seed, dtype="float32"):
    """Weights, and three steps of gradients of one sign per entry and at
    least 0.5 in size."""
    rs = np.random.RandomState(seed)
    weights = [rs.uniform(-1, 1, s).astype(dtype) for s in SHAPES]
    signs = [np.where(rs.rand(*s) < 0.5, -1.0, 1.0) for s in SHAPES]
    grads = [[(sg * rs.uniform(0.5, 1.5, s)).astype(dtype)
              for sg, s in zip(signs, SHAPES)] for _ in range(3)]
    return weights, grads


def _flat(state):
    """A state's arrays, in order, as numpy (None dropped)."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _flat(s)]
    if isinstance(state, torch.Tensor):
        return [state.detach().cpu().numpy()]
    return [np.asarray(state.asnumpy() if hasattr(state, "asnumpy")
                       else state)]


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, "float64"), np.asarray(want, "float64")
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3e} of max|want| {scale:.3e}"


def _run(pkg, name, params, weights, grads, order=(0, 1), states_at=None,
         mults=False):
    """Three updates through ``pkg``'s Updater; with ``states_at`` the
    states go through a states file after that many updates."""
    kwargs = dict(params)
    kwargs["param_idx2name"] = dict(enumerate(NAMES))
    opt = pkg.optimizer.create(name, **kwargs)
    if mults:
        opt.set_lr_mult({"fc_bias": 2.0})
        opt.set_wd_mult({"fc_weight": 0.5})
    updater = pkg.optimizer.get_updater(opt)
    dtype = str(weights[0].dtype)
    ws = [pkg.nd.array(w, dtype=dtype) for w in weights]
    for step, gs in enumerate(grads):
        if step == states_at:
            blob = updater.get_states(dump_optimizer=True)
            updater = pkg.optimizer.get_updater(opt)
            updater.set_states(blob)
        for i in order:
            updater(i, pkg.nd.array(gs[i], dtype=dtype), ws[i])
    return ([w.asnumpy() for w in ws],
            [_flat(updater.states[i]) for i in range(len(ws))])


def _compare(case, jax_out, port_out, tol=TOL):
    for i, (jw, pw) in enumerate(zip(jax_out[0], port_out[0])):
        _close(pw, jw, f"{case}: weight {i}", tol)
    for i, (js, ps) in enumerate(zip(jax_out[1], port_out[1])):
        assert len(js) == len(ps), f"{case}: state {i} arity"
        for k, (j, p) in enumerate(zip(js, ps)):
            _close(p, j, f"{case}: state {i}.{k}", tol)


def test_rules_match_jax():
    """Every rule, with its options, the multipliers, the states file and
    multi_precision, against the JAX rule; then the JAX-side behaviours the
    port copies."""
    assert sorted(mx.optimizer._OPT_REGISTRY) == sorted(
        jmx.optimizer._OPT_REGISTRY)
    with mx.cpu():
        for k, (name, params) in enumerate(RULES):
            case = f"{name}{params}"
            mp = params.get("multi_precision", False)
            weights, grads = _values(k, "float16" if mp else "float32")
            tol = 1e-3 if mp else TOL
            for kw in ({}, {"states_at": 2}, {"mults": True}):
                _compare(f"{case} {kw}", _run(jmx, name, params, weights,
                                              grads, **kw),
                         _run(mx, name, params, weights, grads, **kw), tol)
            if mp:      # the float32 master is the state's first array
                jout = _run(jmx, name, params, weights, grads)
                pout = _run(mx, name, params, weights, grads)
                for i in range(2):
                    assert pout[1][i][0].dtype == np.float32, case
                    _close(pout[1][i][0], jout[1][i][0], f"{case} master",
                           TOL)

        weights, grads = _values(0)
        # AdaDelta reads no learning rate
        for pkg in (jmx, mx):
            a = _run(pkg, "adadelta", {"learning_rate": 0.5}, weights, grads)
            b = _run(pkg, "adadelta", {"learning_rate": 1e-4}, weights, grads)
            np.testing.assert_array_equal(a[0][0], b[0][0])
        # Nadam's m_schedule is shared: the update order changes the result
        for pkg in (jmx, mx):
            a = _run(pkg, "nadam", {}, weights, grads, order=(0, 1))
            b = _run(pkg, "nadam", {}, weights, grads, order=(1, 0))
            assert not np.allclose(a[0][1], b[0][1], rtol=0, atol=1e-9), pkg
        _compare("nadam (1, 0)",
                 _run(jmx, "nadam", {}, weights, grads, order=(1, 0)),
                 _run(mx, "nadam", {}, weights, grads, order=(1, 0)))
        # LBSGD: the warm-up arguments are dropped, and under a schedule
        # the LARS ratio is not applied (it is plain SGD)
        for pkg in (jmx, mx):
            sched = lambda: pkg.lr_scheduler.FactorScheduler(step=2,  # noqa
                                                             factor=0.5)
            base = _run(pkg, "lbsgd", {"learning_rate": 0.1}, weights, grads)
            warm = _run(pkg, "lbsgd", {"learning_rate": 0.1,
                                       "warmup_strategy": "power2",
                                       "warmup_epochs": 50,
                                       "batch_scale": 8}, weights, grads)
            np.testing.assert_array_equal(base[0][0], warm[0][0])
            lars = _run(pkg, "lbsgd", {"learning_rate": 0.1,
                                       "lr_scheduler": sched()},
                        weights, grads)
            sgd = _run(pkg, "sgd", {"learning_rate": 0.1,
                                    "lr_scheduler": sched()}, weights, grads)
            np.testing.assert_array_equal(lars[0][0], sgd[0][0])
            assert not np.allclose(base[0][0], sgd[0][0])
        # Adamax's ε is a fixed 1e-8: a zero gradient moves nothing
        zero = [[np.zeros(s, "float32") for s in SHAPES]] * 3
        for pkg in (jmx, mx):
            out = _run(pkg, "adamax", {}, weights, zero)
            np.testing.assert_array_equal(out[0][0], weights[0])


def _mlp(pkg):
    s = pkg.sym
    data = s.Variable("data")
    h = s.Activation(s.FullyConnected(data, num_hidden=8, name="fc1"),
                     act_type="tanh")
    out = s.FullyConnected(h, num_hidden=3, name="fc2")
    return s.SoftmaxOutput(out, s.Variable("softmax_label"), name="softmax")


def _mlp_values():
    rs = np.random.RandomState(7)
    return {"fc1_weight": rs.randn(8, 5).astype("float32") * 0.5,
            "fc1_bias": rs.randn(8).astype("float32") * 0.1,
            "fc2_weight": rs.randn(3, 8).astype("float32") * 0.5,
            "fc2_bias": rs.randn(3).astype("float32") * 0.1}


def _batches():
    rs = np.random.RandomState(8)
    return [(rs.randn(4, 5).astype("float32"),
             rs.randint(0, 3, 4).astype("float32")) for _ in range(3)]


def _module_run(pkg, optimizer, params, kvstore="local", values=None,
                hook=None, ctx=None):
    """Three updates of the MLP through ``pkg``'s Module; ``hook(mod, k)``
    runs before update k."""
    kw = {"context": ctx} if ctx is not None else {}
    mod = pkg.mod.Module(_mlp(pkg), **kw)
    mod.bind(data_shapes=[("data", (4, 5))],
             label_shapes=[("softmax_label", (4,))])
    vals = values or _mlp_values()
    mod.init_params(arg_params={k: pkg.nd.array(v) for k, v in vals.items()})
    mod.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                       optimizer_params=dict(params))
    for k, (x, y) in enumerate(_batches()):
        batch = pkg.io.DataBatch([pkg.nd.array(x)], [pkg.nd.array(y)])
        mod.forward(batch, is_train=True)
        mod.backward()
        if hook is not None:
            hook(mod, k)
        mod.update()
    arg, _ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in arg.items()}


def test_store_and_module_match_jax(tmp_path, monkeypatch):
    """The store's flush order, buckets and copies; ``Module`` over the
    store (Nadam, whose shared schedule sees the update order; a
    ``set_params`` after ``init_optimizer``, which the next pull
    overwrites) against the JAX Module; the states file through the store;
    and what waits."""
    # flush order: keys by first push priority, same-key pushes in order
    pushes = [(3, 0), (1, 5), (3, -2), (0, 5), (2, 1), (1, 9), (4, -1)]
    orders = []
    for pkg in (jmx, mx):
        seen = []
        with mx.cpu():
            kv = pkg.kvstore.create("device")
            for k in range(5):
                kv.init(k, pkg.nd.array(np.zeros(2, "float32")))
            kv.set_updater(lambda k, g, w, seen=seen: seen.append(
                (k, float(g.asnumpy()[0]))))
            for n, (k, prio) in enumerate(pushes):
                kv.push(k, pkg.nd.array(np.full(2, n, "float32")),
                        priority=prio)
            kv.barrier()
        orders.append((seen, kv.comm_stats["bucket_reduces"]))
    assert orders[1] == orders[0], orders

    # copies: init copies, pull copies, the store is not the weight
    with mx.cpu():
        kv = mx.kvstore.create("local")
        src = mx.nd.array(np.ones(3, "float32"))
        kv.init("w", src)
        src[:] = 5.0
        out = mx.nd.array(np.zeros(3, "float32"))
        kv.pull("w", out)
        np.testing.assert_array_equal(out.asnumpy(), np.ones(3))
        out[:] = 7.0
        kv.pull("w", out)
        np.testing.assert_array_equal(out.asnumpy(), np.ones(3))
        assert kv.comm_stats["pull_copies"] == 2

    # Module over the store against the JAX Module, every weight
    for case in ("nadam", "sgd-momentum", "set_params"):
        opt, params = (("nadam", {"learning_rate": 0.01, "wd": 0.01})
                       if case == "nadam" else
                       ("sgd", {"learning_rate": 0.5, "momentum": 0.9}))
        hook = None
        if case == "set_params":
            def hook(mod, k, pkg=None):
                if k == 1:
                    arg, aux = mod.get_params()
                    mod.set_params({n: a * 0.0 for n, a in arg.items()}, aux)
        _, jw = _module_run(jmx, opt, params, hook=hook,
                            ctx=jmx.cpu())
        with mx.cpu():
            _, pw = _module_run(mx, opt, params, hook=hook)
            _, direct = _module_run(mx, opt, params, kvstore=None, hook=hook)
        for n in jw:
            _close(pw[n], jw[n], f"{case}: {n}")
        if case == "set_params":   # the pull overwrote the zeros
            assert not np.allclose(pw["fc1_weight"], direct["fc1_weight"])
        else:                      # the store is the direct update, bitwise
            for n in pw:
                np.testing.assert_array_equal(pw[n], direct[n], case)

    # the optimizer's states through the store: a run resumed from the
    # parameters and the states after update 2 takes the uninterrupted
    # run's update 3; the JAX Module writes its own, empty, updater under
    # a store
    fname = str(tmp_path / "port.states")
    saved = {}

    def save(mod, k):
        if k == 2:
            saved.update(mod.get_params()[0])
            mod.save_optimizer_states(fname)
    with mx.cpu():
        _, full = _module_run(mx, "adam", {"learning_rate": 0.01}, hook=save)
        mod = mx.mod.Module(_mlp(mx))
        mod.bind(data_shapes=[("data", (4, 5))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(arg_params=saved)
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": 0.01})
        mod.load_optimizer_states(fname)
        x, y = _batches()[2]
        mod.forward(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)]),
                    is_train=True)
        mod.backward()
        mod.update()
        for n, v in mod.get_params()[0].items():
            np.testing.assert_array_equal(v.asnumpy(), full[n], n)
    with open(fname, "rb") as f:
        states, _ = pickle.load(f)
    assert sorted(states) == [0, 1, 2, 3]
    jmod, _ = _module_run(jmx, "adam", {"learning_rate": 0.01},
                          ctx=jmx.cpu())
    jprefix = str(tmp_path / "jax")
    jmod.save_checkpoint(jprefix, 1, save_optimizer_states=True)
    with open(jprefix + "-0001.states", "rb") as f:
        assert pickle.loads(f.read()) == {}

    # pinned JAX-side behaviour, copied: a string key's optimizer state is
    # indexed by ``hash(key) % 2**30``, and Python salts string hashes per
    # process, so a states file saved under string keys does not meet its
    # keys in the next process
    for pkg in (jmx, mx):
        with mx.cpu():
            kv = pkg.kvstore.create("local")
            kv.init("w", pkg.nd.array(np.ones(3, "float32")))
            kv.set_optimizer(pkg.optimizer.create("sgd", momentum=0.9,
                                                  learning_rate=0.1))
            kv.push("w", pkg.nd.array(np.ones(3, "float32")))
            kv.pull("w", pkg.nd.array(np.zeros(3, "float32")))
        states = kv._raw_updater.states
        assert list(states) == [hash("w") % (1 << 30)], (pkg, list(states))
    salted = {subprocess.run(
        [sys.executable, "-c", "print(hash('w') % (1 << 30))"],
        env=dict(os.environ, PYTHONHASHSEED=seed), capture_output=True,
        text=True, check=True).stdout for seed in ("1", "2")}
    assert len(salted) == 2

    # what waits
    for call in (lambda: mx.kvstore.create("dist_sync"),
                 lambda: mx.kvstore.create("local").set_gradient_compression(
                     {"type": "2bit"})):
        with pytest.raises(NotImplementedError, match="ROADMAP A"):
            call()
    # row_sparse_pull (slice 13) needs its row ids, as in the JAX package
    with pytest.raises(mx.MXNetError, match="row_ids"):
        mx.kvstore.create("local").row_sparse_pull(0, row_ids=None)
