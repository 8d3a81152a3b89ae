"""PyTorch port, the rest of the op library (slice 12) against the JAX
registry ops: every op that ``mxnet_tpu/ops/{index,matrix,random_ops,
tail_ops,linalg}.py`` registers, ``parity_ops.py`` but its PSROI poolings
and quantized ops, and the spatial transformer of ``ops/nn.py``; the
generator reaching every random op; ``mx.nd``'s remaining functions,
``mx.nd.contrib``/``mx.sym.contrib``, ``mx.engine``, ``mx.registry``,
``mx.util`` and ``mx.test_utils``.

The case tables are ``chip_smoke.LIBRARY_OP_GROUPS`` (the card's op grid
runs the same cases) and ``chip_smoke.random_cases``. The JAX side of each
group is one ``jax.jit`` of every case's forward and ``jax.vjp`` (with a
seeded cotangent), computed once a session; each group is one item that
names the failing case. Tolerance: discrete outputs equal in value and
dtype; float values and gradients within 1e-6 of the case's largest
|value| (``TOL_GRID``), linalg within 1e-5 (``TOL_LINALG``, well-
conditioned inputs: SPD as M·Mᵀ + n·I), the factors of ``gelqf`` and
``syevd`` up to the sign of each row. Random streams cannot match bit for
bit: each random op's draws (10^5 a parameter row) are held to the JAX
package's by mean and variance within 6 standard errors, the multinomial
by its frequencies, ``shuffle`` by being a permutation; seeded repeats are
bitwise equal.
"""
import importlib.util
import io
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops.registry import get_op as jax_op
from mxnet_tpu_torch.ops.registry import get_op as port_op
from test_torch_threads import one_torch_thread  # noqa: F401
from torch_shared import jax_grid, once

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
DRAWS = 10 ** 5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_library", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _chip_smoke()


# ---------------------------------------------------------- the JAX side
def _jax_group(group):
    return jax_grid(cs.LIBRARY_OP_GROUPS[group](), cs.grid_grad_inputs,
                    cs.grid_cotangents)


def _jax_random():
    """Every random case's JAX draws (one program; the Zipfian sampler, a
    host op, eagerly)."""
    cases = cs.random_cases(DRAWS)
    key = jax.random.PRNGKey(17)

    def run(all_inputs):
        out = []
        for i, ((cid, name, _, attrs), inputs) in enumerate(
                zip(cases, all_inputs)):
            if cid == "unique_zipfian":
                out.append(())
                continue
            o = jax_op(name).fn(*inputs, rng=jax.random.fold_in(key, i),
                                **attrs)
            out.append(tuple(o) if isinstance(o, tuple) else (o,))
        return out

    inputs = [[jnp.asarray(a) for a in c[2]] for c in cases]
    with jmx.cpu():
        outs = jax.jit(run)(inputs)
        for i, (cid, name, _, attrs) in enumerate(cases):
            if cid == "unique_zipfian":
                outs[i] = jax_op(name).fn(rng=jax.random.fold_in(key, i),
                                          **attrs)
    return [[np.asarray(o) for o in case] for case in outs]


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    return once(tmp_path_factory, "op-library-jax",
                lambda: {g: _jax_group(g) for g in cs.LIBRARY_OP_GROUPS})


def _check_group(group, jax_refs):
    failed = []
    for seed, (case, want) in enumerate(zip(cs.LIBRARY_OP_GROUPS[group](),
                                            jax_refs[group])):
        cid, name, inputs, attrs, how = case
        got = cs.run_grid_case(name, inputs, attrs, how, seed)
        failed += cs.library_case_errors(cid, name, how, got, want,
                                         cs.library_tol(group))[0]
    assert not failed, "\n".join(failed)


# ------------------------------------------------------------------ tests
def test_matrix_and_index_ops_match_jax(jax_refs):
    """``batch_dot``, ``slice``/``crop`` (open ends, a negative step),
    ``tile``, ``repeat``, ``diag``, ``shape_array``/``size_array`` (int64,
    as the JAX package's 64-bit mode returns), and the index ops at the
    JAX package's out-of-range rules: ``take`` clamps (``raise`` too) or
    wraps, ``batch_take`` and ``gather_nd`` count a negative index from
    the end and clamp, ``one_hot`` gives ``off_value`` rows outside
    ``[0, depth)``, the scatters drop an update outside the target;
    ``unravel_index``/``ravel_multi_index``; ``boolean_mask`` (a
    data-dependent shape: eager only, in both packages)."""
    _check_group("matrix_index", jax_refs)
    data = cs.grid_values(5, 3)
    mask = np.array([1, 0, 0, 2, 1], "float32")
    want = jax_op("boolean_mask").fn(jnp.asarray(data), jnp.asarray(mask))
    for name in ("boolean_mask", "_contrib_boolean_mask"):
        got = port_op(name).fn(torch.from_numpy(data),
                               torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # torch raises where the JAX package clamps; an integer one_hot is
    # float64 in both (the JAX package's 64-bit promotion)
    with pytest.raises(IndexError):
        torch.arange(5)[torch.tensor([7])]
    np.testing.assert_array_equal(np.asarray(jnp.arange(5)[(
        jnp.asarray([7, -9]),)]), [4, 0])
    hot = port_op("one_hot").fn(torch.tensor([1.0, 9.0]), depth=3,
                                dtype="int32")
    want = jax_op("one_hot").fn(jnp.asarray([1.0, 9.0]), depth=3,
                                dtype="int32")
    assert hot.dtype == torch.float64 and want.dtype == jnp.float64
    np.testing.assert_array_equal(hot.numpy(), np.asarray(want))


def test_spatial_transformer_matches_jax(jax_refs):
    """``GridGenerator`` (affine, and warp passing its grid through),
    ``BilinearSampler`` (a sample outside the image is zero as a whole,
    each corner index clamped; ``F.grid_sample`` pads each corner with
    zeros instead) and ``SpatialTransformer``, forward and gradients."""
    _check_group("spatial", jax_refs)
    import torch.nn.functional as F
    theta = torch.tensor([[1.1, 0.0, 0.3, 0.0, 1.1, 0.0]])
    grid = port_op("GridGenerator").fn(theta, target_shape=(3, 4))
    ref = F.affine_grid(theta.reshape(1, 2, 3), (1, 1, 3, 4),
                        align_corners=True)
    np.testing.assert_allclose(grid.permute(0, 2, 3, 1).numpy(),
                               ref.numpy(), atol=1e-6)
    # the JAX package's grid is float64 (64-bit mode); the port's keeps
    # the data's dtype (ROADMAP C)
    jgrid = jax_op("GridGenerator").fn(jnp.asarray(theta.numpy()),
                                       target_shape=(3, 4))
    assert jgrid.dtype == jnp.float64 and grid.dtype == torch.float32


def test_tail_and_linalg_ops_match_jax(jax_refs):
    """``_grad_add``, ``_square_sum``, the ``_scatter_*`` arithmetic,
    ``_contrib_div_sqrt_dim``, the image ops; every linalg op, with its
    gradient where it has one in both packages (``gelqf`` returns
    ``(L, Q)`` and ``syevd`` ``(U, w)``, eigenvectors as rows, as the JAX
    package returns them)."""
    _check_group("tail", jax_refs)
    _check_group("linalg", jax_refs)
    a = torch.from_numpy(cs.grid_values(2, 3, 5))
    L, Q = port_op("_linalg_gelqf").fn(a)
    np.testing.assert_allclose((L @ Q).numpy(), a.numpy(), atol=1e-5)
    s = torch.from_numpy(cs.spd(4, (2,)))
    U, w = port_op("_linalg_syevd").fn(s)
    np.testing.assert_allclose(
        (U.transpose(1, 2) @ torch.diag_embed(w) @ U).numpy(), s.numpy(),
        rtol=1e-5, atol=1e-4)


def test_parity_ops_match_jax_and_the_optimizer(jax_refs):
    """The thirteen ``*_update`` ops (and their aliases) and
    ``multi_sum_sq``, the legacy ``Crop`` and
    ``IdentityAttachKLSparseReg``, ``histogram`` (int64 counts), the graph
    utilities and the contrib tail (``bipartite_matching`` with ties)
    against the JAX ops; and each update op against the port's optimizer
    rule of the same name on the same state, which follows MXNet's rule
    too."""
    _check_group("parity", jax_refs)
    from mxnet_tpu_torch import optimizer as opt
    w, g = cs.grid_values(3, 4), cs.grid_values(3, 4, seed=1)
    st = cs.grid_values(3, 4, seed=3, lo=0.1, hi=0.5)
    pos = cs.grid_values(3, 4, seed=2, **cs.GRID_POS)
    common = dict(wd=0.01, rescale_grad=0.5, clip_gradient=1.5)
    # Adam's first step: the rule folds the bias correction into the rate
    adam_lr = 0.01 * (1 - 0.999) ** 0.5 / (1 - 0.9)
    rules = [
        ("sgd_update", opt.SGD(learning_rate=0.1, **common), [],
         {"lr": 0.1}),
        ("sgd_mom_update", opt.SGD(learning_rate=0.1, momentum=0.9,
                                   **common), [st],
         {"lr": 0.1, "momentum": 0.9}),
        ("adam_update", opt.Adam(learning_rate=0.01, **common), [st, pos],
         {"lr": adam_lr}),
        ("rmsprop_update", opt.RMSProp(learning_rate=0.01, **common), [pos],
         {"lr": 0.01, "gamma1": 0.9}),
        ("rmspropalex_update", opt.RMSProp(learning_rate=0.01, centered=True,
                                           **common), [pos, st * 0.1, st],
         {"lr": 0.01, "gamma1": 0.9, "gamma2": 0.9}),
        ("ftrl_update", opt.Ftrl(learning_rate=0.1, lamda1=0.2, **common),
         [st, pos], {"lr": 0.1, "lamda1": 0.2}),
        ("signum_update", opt.Signum(learning_rate=0.1, momentum=0.9,
                                     wd_lh=0.01, **common), [st],
         {"lr": 0.1, "momentum": 0.9, "wd_lh": 0.01}),
    ]
    failed = []
    for name, rule, states, attrs in rules:
        weight = mx.nd.array(w, ctx=mx.cpu())
        state = rule.create_state(0, weight)
        held = state if isinstance(state, tuple) else (state,)
        for t, v in zip(held, states):
            t.copy_(torch.from_numpy(v))
        rule.update(0, weight, mx.nd.array(g, ctx=mx.cpu()), state)
        out = port_op(name).fn(*[torch.from_numpy(a) for a in
                                 [w, g] + states], **attrs, **common)
        out = out if isinstance(out, tuple) else (out,)
        mine = [weight._data] + list(held if states else ())
        for i, (a, b) in enumerate(zip(out, mine)):
            err = cs.grid_error(a.numpy(), b.numpy())
            if not err <= cs.TOL_GRID:
                failed.append(f"{name} output {i}: {err:.3e}")
    assert not failed, "\n".join(failed)


@pytest.fixture(scope="module")
def jax_draws(tmp_path_factory):
    return once(tmp_path_factory, "op-library-jax-draws", _jax_random)


def test_random_ops_match_jax_by_their_statistics(jax_draws):
    """Every ``_random_*``, ``_sample_*`` and ``*_like`` op, the
    multinomial (with ``get_prob``), ``shuffle`` and the unique Zipfian
    sampler at 10^5 draws a parameter row, against the JAX package's
    draws (``chip_smoke.random_case_failures``); each repeated from its
    seed, bitwise equal; and ``mx.random.seed`` restarting the stream of
    ``mx.nd.random_normal``."""
    failed = []
    cpu = torch.device("cpu")
    for (cid, name, inputs, attrs), want in zip(cs.random_cases(DRAWS),
                                                 jax_draws):
        got = cs.run_random_case(name, inputs, attrs,
                                 torch.Generator().manual_seed(3), cpu)
        again = cs.run_random_case(name, inputs, attrs,
                                   torch.Generator().manual_seed(3), cpu)
        if not all(np.array_equal(a, b) for a, b in zip(got, again)):
            failed.append(f"{cid}: a seeded repeat differs")
        if [a.dtype for a in got] != [a.dtype for a in want]:
            failed.append(f"{cid}: dtypes {[a.dtype for a in got]} against "
                          f"{[a.dtype for a in want]}")
        failed += cs.random_case_failures(cid, inputs, got, want)[0]
    assert not failed, "\n".join(failed)
    draws = []
    for _ in range(2):
        mx.random.seed(11)
        draws.append(mx.nd.random_normal(shape=(50,), ctx=mx.cpu())
                     .asnumpy())
    np.testing.assert_array_equal(*draws)


def test_the_generator_reaches_every_random_op():
    """A bound ``Dropout(p=0.5, mode="always")`` at ``is_train=False``
    drops half its entries and doubles the rest in both packages (the JAX
    executor gives every random op a key; the port gave none at
    inference); a random op without array inputs in a graph at inference
    draws from ``mx.random``'s generator of the graph's device, and
    imperatively from its ``ctx``'s."""
    n = (1000, 100)
    x = np.full(n, 1.5, "float32")
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, mx.cpu())):
        sym = pkg.sym.Dropout(pkg.sym.Variable("data"), p=0.5,
                              mode="always")
        exe = sym.simple_bind(ctx, data=n)
        out = exe.forward(is_train=False, data=pkg.nd.array(x, ctx=ctx))
        out = out[0].asnumpy()
        zeros = float((out == 0).mean())
        assert abs(zeros - 0.5) <= 0.02, (pkg.__name__, zeros)
        np.testing.assert_array_equal(out[out != 0], 2 * x[out != 0])
        # the training-mode Dropout stays the identity at inference
        exe = pkg.sym.Dropout(pkg.sym.Variable("data"), p=0.5).simple_bind(
            ctx, data=n)
        np.testing.assert_array_equal(exe.forward(
            is_train=False, data=pkg.nd.array(x, ctx=ctx))[0].asnumpy(), x)

    data = mx.sym.Variable("data")
    sym = data + mx.sym.random_normal(shape=(1000,))
    exe = sym.simple_bind(mx.cpu(), data=(1000,))
    mx.random.seed(5)
    out = exe.forward(is_train=False,
                      data=mx.nd.zeros((1000,), ctx=mx.cpu()))[0].asnumpy()
    want = torch.empty(1000).normal_(generator=torch.Generator()
                                     .manual_seed(5))
    np.testing.assert_array_equal(out, want.numpy())
    mx.random.seed(5)
    got = mx.nd.random_uniform(shape=(100,), ctx=mx.cpu()).asnumpy()
    want = torch.empty(100).uniform_(generator=torch.Generator()
                                     .manual_seed(5))
    np.testing.assert_array_equal(got, want.numpy())


def _png(rs):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rs.randint(0, 256, (6, 5, 3)).astype("uint8")).save(
        buf, format="PNG")
    return buf.getvalue()


def test_nd_functions_contrib_engine_and_small_modules(tmp_path):
    """``mx.nd``'s ``waitall``, ``one_hot``, ``onehot_encode``,
    ``imdecode``, ``concatenate``, ``moveaxis`` and the DLPack pair;
    ``mx.nd.contrib``/``mx.sym.contrib``; ``mx.engine`` (the native engine
    where ``g++`` exists, so that a broken build cannot hide behind the
    serial one; ordering, versions, deferred errors at ``wait_var``,
    ``wait_all_host`` and ``waitall``, naive mode, bulk); ``mx.registry``,
    ``mx.util`` and ``mx.test_utils``, each as the JAX package's."""
    rs = np.random.RandomState(0)
    idx = np.array([1, 0, 3, 7, -1], "float32")
    a = rs.uniform(-1, 1, (2, 3, 4)).astype("float32")
    png = _png(rs)
    pairs = []
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, mx.cpu())):
        nd = pkg.nd
        with ctx:
            x = nd.array(a)
            out = nd.zeros((5, 4))
            got = [nd.one_hot(nd.array(idx), 4, on_value=3.0),
                   nd.onehot_encode(nd.array(idx), out), out,
                   nd.imdecode(png), nd.concatenate([x, x], axis=1),
                   nd.moveaxis(x, 0, 2),
                   nd.from_dlpack(torch.from_numpy(a.copy())),
                   nd.contrib.div_sqrt_dim(x),
                   nd.contrib.boolean_mask(x, nd.array([1, 0]))]
            got.append(nd.array(np.from_dlpack(nd.to_dlpack_for_read(x))))
            w = nd.to_dlpack_for_write(x)
            np.asarray(w)[...] = 0
            got.append(x)
            nd.waitall()
        pairs.append([np.asarray(g.asnumpy()) for g in got])
        assert pkg.sym.contrib.div_sqrt_dim is getattr(
            pkg.sym, "_contrib_div_sqrt_dim")
        assert "div_sqrt_dim" in dir(nd.contrib)
    for i, (j, p) in enumerate(zip(*pairs)):
        assert j.shape == p.shape, i
        np.testing.assert_allclose(p, j, rtol=1e-6, err_msg=str(i))

    import mxnet_tpu_torch.native as native
    if shutil.which("g++"):
        assert isinstance(mx.engine.host_engine(), native.NativeEngine)
    results = []
    for engine in (jmx.engine, mx.engine):
        seen = []
        v = engine.new_var()
        for k in range(5):
            engine.push(lambda k=k: seen.append(k), mutable_vars=[v])
        engine.push(lambda: 1 / 0, const_vars=[v])
        with pytest.raises(RuntimeError, match="ZeroDivisionError"):
            engine.wait_var(v)
        engine.push(lambda: [][1], mutable_vars=[v])
        with pytest.raises(RuntimeError, match="IndexError"):
            engine.wait_all_host()
        engine.push(lambda: {}["k"], mutable_vars=[v])
        err = jmx.base.MXNetError if engine is jmx.engine else mx.MXNetError
        with pytest.raises(err, match="KeyError"):
            engine.wait_all()
        results.append((seen, engine.var_version(v)))
        engine.free_var(v)
        with engine.naive_mode():
            assert engine.is_naive()
        assert engine.set_bulk_size(4) == 0 and engine.set_bulk_size(0) == 4
    assert results[0] == results[1] == (list(range(5)), 7)
    with mx.engine.naive_mode(), mx.cpu():
        assert float(mx.nd.ones((2,)).sum().asscalar()) == 2.0

    outs = []
    for pkg in (jmx, mx):
        class Base:
            pass

        class Thing(Base):
            def __init__(self, size=1):
                self.size = size

        reg = pkg.registry
        register = reg.get_register_func(Base, "thing")
        create = reg.get_create_func(Base, "thing")
        reg.get_alias_func(Base, "thing")("gadget")(Thing)
        register(Thing)
        made = [create("thing", size=2).size, create("GADGET").size,
                create('["thing", {"size": 3}]').size,
                create({"thing": "thing", "size": 4}).size]
        with pytest.raises(Exception, match="not registered"):
            create("nothing")
        util = pkg.util
        with util.np_shape(True):
            made.append(util.is_np_shape())
        made.append(util.is_np_shape())
        util.makedirs(str(tmp_path / pkg.__name__ / "d"))
        util.setenv("MXTPU_PORT_TEST", 5)
        made += [os.path.isdir(tmp_path / pkg.__name__ / "d"),
                 util.getenv("MXTPU_PORT_TEST")]
        tu = pkg.test_utils
        made += [tu.almost_equal([1.0, 2.0], [1.0, 2.0 + 1e-7]),
                 tu.same([1, 2], [1, 2])]
        tu.assert_almost_equal(pkg.nd.array(a, ctx=pkg.cpu()), a)
        tu.check_numeric_gradient(lambda t: t * t + 2 * t,
                                  [rs.uniform(-1, 1, (3,)).astype("float32")],
                                  **({"ctx": mx.cpu()} if pkg is mx else {}))
        outs.append(made)
    assert outs[0] == outs[1], outs
    assert mx.util.get_gpu_count() == torch.cuda.device_count()
    # the reference-format files (slice 13): written by the port, read by
    # both packages
    fname = str(tmp_path / "x.params")
    mx.util.save_reference_params(fname, {"arg:a": mx.nd.array(
        a, ctx=mx.cpu())})
    for back in (mx.util.load_reference_params(fname),
                 jmx.util.load_reference_params(fname)):
        np.testing.assert_array_equal(back["arg:a"].asnumpy(), a)
    sym = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                name="fc")
    res = mx.test_utils.check_consistency(sym, [
        {"ctx": mx.cpu(), "data": (2, 4),
         "type_dict": {"__default__": "float32"}},
        {"ctx": mx.cpu(), "data": (2, 4),
         "type_dict": {"__default__": "float64"}}])
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=1e-5, atol=1e-6)
