"""PyTorch port, the dense op library of slice 11 against the JAX registry
ops: every op that ``mxnet_tpu/ops/{elemwise,broadcast_reduce,ctc,order,
init_ops}.py`` registers, and ``LeakyReLU``, ``InstanceNorm``, ``LRN``,
``softmin``, ``SoftmaxActivation``, the regression outputs, ``SVMOutput``
and ``UpSampling`` of ``ops/nn.py``, forward and gradient, on the same
numpy inputs (ties, zeros, bounds and NaNs where an op treats them
specially).

The JAX side of each group is one ``jax.jit`` of every case's forward and
``jax.vjp`` (with a seeded cotangent), computed once a session. Each group
is one item that names the failing case. Tolerance: discrete outputs
(comparisons, rounding, indices, sorts) equal; float32 values and
gradients within 2e-6 of the case's largest |value| (torch's and XLA's
transcendental functions differ in the last bits); CTC within 1e-6
relative (float64 recursions, the log-softmax in float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops.registry import _REGISTRY as JAX_REGISTRY
from mxnet_tpu.ops.registry import get_op as jax_op
from mxnet_tpu_torch.ops.registry import _REGISTRY as PORT_REGISTRY
from mxnet_tpu_torch.ops.registry import get_op as port_op
from test_torch_threads import one_torch_thread  # noqa: F401
from torch_shared import once

TOL = 2e-6
TOL_CTC = 1e-6


def _r(*shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        "float32")


def _with(a, *values):
    """``a`` with its first entries replaced by ``values`` (ties, zeros,
    bounds)."""
    a = a.copy()
    a.reshape(-1)[:len(values)] = values
    return a


# ------------------------------------------------------------------ cases
# (case id, op name, numpy inputs, attrs, what to compare: "grad" for
# values and gradients, "value" for values only, "exact" for equal values)
POS = dict(lo=0.2, hi=3.0)
UNIT = dict(lo=-0.9, hi=0.9)


def _unary_cases():
    general = ["sign", "negative", "square", "exp", "expm1", "sin", "cos",
               "arctan", "sinh", "cosh", "tanh", "arcsinh", "degrees",
               "radians", "erf", "sigmoid", "softsign"]
    cases = [(n, n, [_r(3, 5)], {}, "grad") for n in general]
    cases += [(n, n, [_r(3, 5, **POS)], {}, "grad")
              for n in ("sqrt", "rsqrt", "log", "log2", "log10", "gammaln",
                        "digamma", "reciprocal", "cbrt", "rcbrt")]
    cases += [(n, n, [_r(3, 5, **UNIT)], {}, "grad")
              for n in ("arcsin", "arccos", "arctanh", "erfinv", "log1p")]
    cases += [
        ("tan", "tan", [_r(3, 5, lo=-1.2, hi=1.2)], {}, "grad"),
        ("arccosh", "arccosh", [_r(3, 5, lo=1.1, hi=4.0)], {}, "grad"),
        ("cbrt_negative", "cbrt", [_r(3, 5, lo=-3.0, hi=-0.2)], {}, "grad"),
        ("abs_at_zero", "abs", [_with(_r(3, 5), 0.0, -0.0)], {}, "grad"),
        ("relu_at_zero", "relu", [_with(_r(3, 5), 0.0)], {}, "grad"),
        # gamma is exp(lgamma): the sign is lost at negative non-integers
        ("gamma", "gamma", [_with(_r(3, 5, lo=0.3, hi=4.0), -0.5, -1.5,
                                  -2.5)], {}, "grad"),
    ]
    halves = _with(_r(3, 5), 0.5, 1.5, 2.5, -0.5, -2.5, 0.0, -1.7)
    cases += [(n, n, [halves], {}, "exact")
              for n in ("floor", "ceil", "round", "rint", "trunc", "fix",
                        "logical_not")]
    return cases


def _other_elemwise_cases():
    x = _r(3, 5, seed=1)
    y = _with(_r(3, 5, seed=2), *x.reshape(-1)[:4])          # ties
    xi = np.round(_r(3, 5, seed=3))
    yi = np.round(_r(3, 5, seed=4))
    cases = [
        # exact bounds (XLA fuses 0.2·x + 0.5 into one rounding)
        ("hard_sigmoid_bounds", "hard_sigmoid",
         [_with(_r(3, 5, lo=-4, hi=4), -2.0, 2.0, 0.0)],
         {"alpha": 0.25, "beta": 0.5}, "grad"),
        ("hard_sigmoid", "hard_sigmoid", [x], {}, "grad"),
        ("clip_ties", "clip", [_with(x, -1.0, 1.0)],
         {"a_min": -1.0, "a_max": 1.0}, "grad"),
        ("clip_open_low", "clip", [x], {"a_max": 0.5}, "grad"),
        ("identity", "identity", [x], {}, "grad"),
        ("_copy", "_copy", [x], {}, "grad"),
        ("make_loss", "make_loss", [x], {}, "grad"),
        ("Cast_f16", "Cast", [x], {"dtype": "float16"}, "exact"),
        ("cast_i32", "cast", [x * 3], {"dtype": "int32"}, "exact"),
        ("amp_cast", "amp_cast", [x], {"dtype": "float16"}, "exact"),
        ("amp_multicast", "amp_multicast", [x, x.astype("float16")],
         {"num_outputs": 2}, "exact"),
        ("add_n", "add_n", [x, y, xi], {}, "grad"),
        ("ElementWiseSum", "ElementWiseSum", [x, y], {}, "grad"),
        ("_sum", "_sum", [x, y, y], {}, "grad"),
        ("_power", "_power", [_r(3, 5, **POS), y], {}, "grad"),
        ("pow", "pow", [_r(3, 5, **POS), y], {}, "grad"),
        ("_maximum_ties", "_maximum", [x, y], {}, "grad"),
        ("_minimum_ties", "_minimum", [x, y], {}, "grad"),
        ("_hypot", "_hypot", [x, y], {}, "grad"),
        ("_mod", "_mod", [x * 3, _r(3, 5, seed=5, lo=0.7, hi=1.9)], {},
         "grad"),
        ("mod_negative_divisor", "mod",
         [x * 3, -_r(3, 5, seed=5, lo=0.7, hi=1.9)], {}, "grad"),
    ]
    for name in ("elemwise_add", "_plus", "_add", "elemwise_sub", "_minus",
                 "_sub", "elemwise_mul", "_mul", "elemwise_div", "_div"):
        cases.append((name, name, [x, _r(3, 5, **POS)], {}, "grad"))
    for name in ("_equal", "_not_equal", "_greater", "_greater_equal",
                 "_lesser", "_lesser_equal", "_logical_and", "_logical_or",
                 "_logical_xor"):
        cases.append((name, name, [xi, yi], {}, "exact"))
    xs = _with(x, 0.5, 0.5, -0.25)
    for name in ("_maximum_scalar", "_minimum_scalar", "_hypot_scalar",
                 "_plus_scalar", "_minus_scalar", "_rminus_scalar",
                 "_mul_scalar", "_div_scalar", "_rdiv_scalar"):
        cases.append((name, name, [xs], {"scalar": 0.5}, "grad"))
    for name in ("_equal_scalar", "_not_equal_scalar", "_greater_scalar",
                 "_greater_equal_scalar", "_lesser_scalar",
                 "_lesser_equal_scalar", "_logical_and_scalar",
                 "_logical_or_scalar", "_logical_xor_scalar"):
        cases.append((name, name, [_with(xi, 0.0, 1.0)], {"scalar": 1.0},
                      "exact"))
    cases.append(("_logical_and_scalar_0", "_logical_and_scalar",
                  [_with(xi, 0.0)], {"scalar": 0.0}, "exact"))
    return cases


def _broadcast_reduce_cases():
    a, b = _r(2, 3, 4), _r(1, 3, 1, seed=1)
    ai, bi = np.round(a), np.round(_r(2, 1, 4, seed=2))
    cases = [(n, n, [a, b], {}, "grad")
             for n in ("broadcast_plus", "broadcast_minus",
                       "broadcast_hypot")]
    cases += [(n, n, [np.round(a * 2) / 2, np.round(b * 2) / 2], {}, "grad")
              for n in ("broadcast_maximum", "broadcast_minimum")]
    cases += [(n, n, [ai, bi], {}, "exact")
              for n in ("broadcast_logical_and", "broadcast_logical_or",
                        "broadcast_logical_xor")]
    cases += [
        ("broadcast_like", "broadcast_like", [b, a], {}, "grad"),
        ("broadcast_like_axes", "broadcast_like", [_r(2, 1, 1), _r(5, 4, 3)],
         {"lhs_axes": (1, 2), "rhs_axes": (0, 2)}, "grad"),
        ("broadcast_axis", "broadcast_axis", [_r(2, 1, 4)],
         {"axis": 1, "size": 3}, "grad"),
        ("broadcast_axes", "broadcast_axes", [_r(1, 3, 1)],
         {"axis": (0, 2), "size": (2, 5)}, "grad"),
    ]
    tied = np.round(_r(2, 3, 4, seed=3))                  # many ties
    zeros = _with(_r(2, 3, 4, seed=4), 0.0, 0.0)
    nans = _with(_r(2, 3, 4, seed=5), np.nan, 0.0, np.nan)
    for name, x in (("prod", zeros), ("max", tied), ("min", tied),
                    ("nansum", nans), ("nanprod", nans)):
        for tag, attrs in (("all", {}), ("axis1", {"axis": 1}),
                           ("axes_keep", {"axis": (0, 2), "keepdims": True}),
                           ("exclude", {"axis": 1, "exclude": True}),
                           ("exclude_none", {"exclude": True}),
                           ("neg", {"axis": -1})):
            cases.append((f"{name}_{tag}", name, [x], attrs, "grad"))
    pos = _r(2, 3, 4, seed=6)
    for tag, attrs in (("all", {}), ("ord1", {"ord": 1}),
                       ("axis", {"axis": 1}),
                       ("axes_keep", {"axis": (1, 2), "keepdims": True}),
                       ("ord1_axis", {"ord": 1, "axis": -1}),
                       ("out_dtype", {"axis": 0, "out_dtype": "float16"})):
        cases.append((f"norm_{tag}", "norm", [pos], attrs,
                      "value" if "dtype" in tag else "grad"))
    for name in ("argmax", "argmin"):
        for tag, attrs in (("all", {}), ("axis1", {"axis": 1}),
                           ("keep", {"axis": 2, "keepdims": True})):
            cases.append((f"{name}_{tag}", name, [tied], attrs, "exact"))
    cases.append(("argmax_channel", "argmax_channel", [tied[0]], {},
                  "exact"))
    return cases


def _nn_cases():
    x = _with(_r(2, 3, 4, 5), 0.0, -0.0)
    cases = [
        ("leaky", "LeakyReLU", [x], {"act_type": "leaky", "slope": 0.2},
         "grad"),
        ("prelu_channels", "LeakyReLU", [x, _r(3, seed=1, lo=0, hi=0.5)],
         {"act_type": "prelu"}, "grad"),
        ("prelu_one", "LeakyReLU", [x, np.array([0.3], "float32")],
         {"act_type": "prelu"}, "grad"),
        ("elu", "LeakyReLU", [x], {"act_type": "elu", "slope": 0.7}, "grad"),
        ("selu", "LeakyReLU", [x], {"act_type": "selu"}, "grad"),
        ("gelu", "LeakyReLU", [x], {"act_type": "gelu"}, "grad"),
        ("rrelu_inference", "LeakyReLU", [x],
         {"act_type": "rrelu", "is_train": False}, "grad"),
        ("instance_norm_4d", "InstanceNorm",
         [x * 3 + 1, _r(3, seed=2), _r(3, seed=3)], {}, "grad"),
        ("instance_norm_3d_eps", "InstanceNorm",
         [_r(2, 4, 7), _r(4, seed=2), _r(4, seed=3)], {"eps": 1e-5},
         "grad"),
        ("lrn_5", "LRN", [_r(2, 7, 3, 3)], {}, "grad"),
        ("lrn_3", "LRN", [_r(2, 4, 3, 3)],
         {"nsize": 3, "alpha": 0.1, "beta": 0.5, "knorm": 1.0}, "grad"),
        ("softmin", "softmin", [_r(3, 6)], {}, "grad"),
        ("softmin_axis_temp", "softmin", [_r(3, 6, 2)],
         {"axis": 1, "temperature": 2.0}, "grad"),
        ("softmax_activation", "SoftmaxActivation", [_r(3, 2, 4)], {},
         "grad"),
        ("softmax_activation_channel", "SoftmaxActivation",
         [_r(3, 4, 2, 2)], {"mode": "channel"}, "grad"),
        ("linear_regression", "LinearRegressionOutput",
         [_r(4, 1), _r(4, seed=1)], {"grad_scale": 0.5}, "grad"),
        ("logistic_regression", "LogisticRegressionOutput",
         [_r(4, 3), _r(4, 3, seed=1, lo=0, hi=1)], {}, "grad"),
        ("mae_regression", "MAERegressionOutput",
         [_r(4, 3), _r(4, 3, seed=1)], {"grad_scale": 2.0}, "grad"),
        ("svm_l2", "SVMOutput",
         [_r(4, 5), np.array([0, 3, 4, 1], "float32")],
         {"margin": 0.5, "regularization_coefficient": 0.7}, "grad"),
        ("svm_l1", "SVMOutput",
         [_r(4, 5), np.array([2, 3, 0, 1], "float32")],
         {"use_linear": True}, "grad"),
        ("upsampling_nearest", "UpSampling", [_r(2, 3, 4, 5)],
         {"scale": 2, "sample_type": "nearest"}, "grad"),
        ("upsampling_bilinear", "UpSampling", [_r(2, 3, 4, 5)],
         {"scale": 3, "sample_type": "bilinear"}, "grad"),
    ]
    return cases


def _order_init_cases():
    t = np.array([[3, 1, 3, 2, 0], [0, 5, 5, 1, 5], [2, 2, 2, 2, 2]],
                 "float32")
    v = _with(_r(3, 5), *t.reshape(-1)[:5])
    cases = []
    for tag, attrs in (("", {}), ("_desc", {"is_ascend": False}),
                       ("_axis0", {"axis": 0}), ("_flat", {"axis": None})):
        cases.append((f"sort{tag}", "sort", [v], attrs, "grad"))
        cases.append((f"argsort{tag}", "argsort", [t], attrs, "exact"))
    cases += [
        ("argsort_int32", "argsort", [t], {"dtype": "int32"}, "exact"),
        ("topk_indices", "topk", [t], {"k": 3}, "exact"),
        ("topk_value", "topk", [t], {"k": 2, "ret_typ": "value"}, "exact"),
        ("topk_both_ascend", "topk", [t],
         {"k": 2, "ret_typ": "both", "is_ascend": True}, "exact"),
        ("topk_all", "topk", [t], {"k": 0, "ret_typ": "both"}, "exact"),
        ("topk_axis0", "topk", [t], {"axis": 0, "k": 2}, "exact"),
        ("topk_flat", "topk", [t], {"axis": None, "k": 4,
                                    "ret_typ": "both"}, "exact"),
        ("topk_mask_axis1", "topk", [t], {"axis": 1, "k": 2,
                                          "ret_typ": "mask"}, "exact"),
        ("topk_mask_1d", "topk", [t[1]], {"k": 2, "ret_typ": "mask"},
         "exact"),
        ("topk_int32", "topk", [t], {"k": 2, "dtype": "int32"}, "exact"),
        ("_full", "_full", [], {"shape": (2, 3), "value": 1.5}, "exact"),
        ("full_int", "full", [], {"shape": (4,), "value": 7,
                                  "dtype": "int32"}, "exact"),
        ("_arange_stop", "_arange", [], {"start": 5}, "exact"),
        ("_arange_float", "_arange", [],
         {"start": 0.1, "stop": 1.0, "step": 0.3}, "exact"),
        ("arange_repeat", "arange", [],
         {"start": 2, "stop": 8, "step": 2, "repeat": 3}, "exact"),
        ("_linspace", "_linspace", [], {"start": 0.0, "stop": 1.0,
                                        "num": 7}, "value"),
        ("linspace_open", "linspace", [],
         {"start": -1.0, "stop": 2.0, "num": 6, "endpoint": False}, "value"),
        ("_eye", "_eye", [], {"N": 3}, "exact"),
        ("eye_offset", "eye", [], {"N": 3, "M": 5, "k": 1}, "exact"),
        ("eye_below", "eye", [], {"N": 4, "M": 3, "k": -1,
                                  "dtype": "int32"}, "exact"),
    ]
    return cases


GROUPS = {"unary": _unary_cases, "elemwise": _other_elemwise_cases,
          "broadcast_reduce": _broadcast_reduce_cases, "nn": _nn_cases,
          "order_init": _order_init_cases}


# ---------------------------------------------------------- the JAX side
def _grad_inputs(inputs, how):
    """Indices of the float inputs a gradient is taken for."""
    if how != "grad":
        return []
    return [i for i, a in enumerate(inputs) if a.dtype == np.float32]


def _cotangents(outs, seed):
    rs = np.random.RandomState(seed)
    return [rs.uniform(0.5, 1.5, o.shape).astype(np.float32) for o in outs]


def _jax_group(group):
    cases = GROUPS[group]()

    def run(all_inputs):
        results = []
        for (cid, name, _, attrs, how), inputs in zip(cases, all_inputs):
            fn = jax_op(name).fn
            gi = _grad_inputs(inputs, how)

            def f(*diff, _inputs=inputs, _gi=gi, _fn=fn, _attrs=attrs):
                args = list(_inputs)
                for i, d in zip(_gi, diff):
                    args[i] = d
                out = _fn(*args, **_attrs)
                return tuple(out) if isinstance(out, (tuple, list)) \
                    else (out,)

            if not gi:
                results.append((f(), ()))
                continue
            outs, vjp = jax.vjp(f, *[inputs[i] for i in gi])
            cts = tuple(jnp.asarray(c, o.dtype) for c, o in zip(
                _cotangents(outs, len(results)), outs))
            results.append((outs, vjp(cts)))
        return results

    inputs = [[jnp.asarray(a) for a in c[2]] for c in cases]
    with jmx.cpu():
        out = jax.jit(run)(inputs)
    return [([np.asarray(o) for o in outs], [np.asarray(g) for g in grads])
            for outs, grads in out]


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    return once(tmp_path_factory, "dense-ops-jax",
                lambda: {g: _jax_group(g) for g in GROUPS})


# --------------------------------------------------------- the port side
def _port_case(name, inputs, attrs, how, seed):
    ts = [torch.from_numpy(np.array(a)) for a in inputs]
    gi = _grad_inputs(inputs, how)
    for i in gi:
        ts[i].requires_grad_()
    kw = dict(attrs)
    if "device" in port_op(name).fn.__code__.co_varnames:
        kw["device"] = torch.device("cpu")
    out = port_op(name).fn(*ts, **kw)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    grads = []
    if gi:
        cts = _cotangents([o.detach().numpy() for o in outs], seed)
        torch.autograd.backward(
            [o for o in outs], [torch.from_numpy(c).to(o.dtype)
                                for c, o in zip(cts, outs)])
        grads = [ts[i].grad for i in gi]
    return [o.detach().float().numpy() if o.dtype == torch.float16
            else o.detach().numpy() for o in outs], grads


def _check(cid, got, want, how):
    got_outs, got_grads = got
    want_outs, want_grads = want
    assert len(got_outs) == len(want_outs), cid
    for g, w in zip(got_outs, want_outs):
        w = np.asarray(w)
        assert g.shape == w.shape, (cid, g.shape, w.shape)
        if how == "exact":
            assert g.dtype == w.dtype or w.dtype == np.float16, \
                (cid, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w.astype(g.dtype),
                                          err_msg=cid)
        else:
            _close(cid, g, w)
    for g, w in zip(got_grads, want_grads):
        # an input whose values the op does not read (broadcast_like's
        # ``like``) gets no gradient in torch, zeros in JAX
        g = np.zeros_like(w) if g is None and not np.any(w) else g.numpy()
        _close(cid + " (grad)", g, np.asarray(w))


def _close(cid, got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want)), cid
    ok = ~np.isnan(want)
    scale = max(float(np.abs(want[ok]).max()) if ok.any() else 0.0, 1e-30)
    err = float(np.abs(got[ok] - want[ok]).max()) if ok.any() else 0.0
    assert err <= tol * scale, f"{cid}: {err:.3e} of {scale:.3e}"


def _check_group(group, jax_refs):
    failed = []
    for seed, (case, want) in enumerate(zip(GROUPS[group](),
                                            jax_refs[group])):
        cid, name, inputs, attrs, how = case
        try:
            _check(cid, _port_case(name, inputs, attrs, how, seed), want,
                   how)
        except AssertionError as e:
            failed.append(f"{cid}: {e}")
    assert not failed, "\n".join(failed)


def test_elemwise_ops_match_jax(jax_refs):
    """Every unary op (ranges inside each domain; ``abs`` and ``relu`` at
    0, the rounding ops at halves), the binaries with ties, ``add_n``, the
    comparisons and logical ops and every scalar op."""
    _check_group("unary", jax_refs)
    _check_group("elemwise", jax_refs)


def test_broadcast_reduce_ops_match_jax(jax_refs):
    """The broadcast binaries, ``broadcast_like``/``broadcast_axis``, the
    reductions over every axis form (``exclude``, keepdims, ties, zeros in
    ``prod``, NaNs in the ``nan*`` pair), ``norm`` and the arg
    reductions."""
    _check_group("broadcast_reduce", jax_refs)


def test_nn_ops_match_jax(jax_refs):
    """``LeakyReLU`` in every deterministic mode (rrelu at inference),
    ``InstanceNorm``, ``LRN`` (both outputs), ``softmin``,
    ``SoftmaxActivation``, the regression outputs and ``SVMOutput`` (whose
    backward ignores the head gradient) and ``UpSampling``. Then rrelu in
    training by its statistics: each negative entry's slope lies in
    [lower, upper] and their mean within 0.01 of the middle, in both
    packages (torch's generator and JAX's keys cannot draw alike)."""
    _check_group("nn", jax_refs)
    x = -np.abs(_r(200, 50, seed=9)) - 0.1
    lo, hi = 0.1, 0.4
    jo = np.asarray(jax_op("LeakyReLU").fn(
        jnp.asarray(x), act_type="rrelu", lower_bound=lo, upper_bound=hi,
        rng=jax.random.PRNGKey(0), is_train=True))
    po = port_op("LeakyReLU").fn(
        torch.from_numpy(x), act_type="rrelu", lower_bound=lo,
        upper_bound=hi, rng=torch.Generator().manual_seed(0),
        is_train=True).numpy()
    for out in (jo, po):
        slopes = out / x
        assert slopes.min() >= lo - 1e-6 and slopes.max() <= hi + 1e-6
        assert abs(slopes.mean() - (lo + hi) / 2) < 0.01
        assert slopes.std() > 0.05          # drawn per element
    assert not np.array_equal(jo, po)


def _ctc_cases():
    rs = np.random.RandomState(4)
    x = rs.randn(8, 4, 6).astype("float32")              # (T, N, C)
    last = np.array([[1, 1, 1, 1, 1], [0, 2, 2, 4, -1], [3, -1, -1, -1, -1],
                     [4, 0, 1, -1, -1]], "float32")
    first = np.where(last >= 0, last + 1, 0).astype("float32")
    first[0] = [2, 2, 2, 2, 2]       # repeats needing 9 frames of 8
    dl = np.array([8, 7, 4, 8], "float32")
    ll = np.array([5, 3, 1, 2], "float32")
    return [
        ("last", [x, last], {"blank_label": "last"}),
        ("first", [x, first], {}),
        ("first_data_lengths", [x, first, dl],
         {"use_data_lengths": True}),
        ("last_both_lengths", [x, last, dl, ll],
         {"blank_label": "last", "use_data_lengths": True,
          "use_label_lengths": True}),
        ("label_lengths_only", [x, np.abs(last), np.zeros(1, "float32"),
                                ll],
         {"blank_label": "last", "use_label_lengths": True}),
    ]


def _jax_ctc():
    cases = _ctc_cases()

    def run(all_args):
        out = []
        for (cid, _, attrs), args in zip(cases, all_args):
            def f(d, _args=args, _attrs=attrs):
                return jax_op("CTCLoss").fn(d, *_args[1:], **_attrs)

            loss, vjp = jax.vjp(f, args[0])
            ct = jnp.asarray(_cotangents([loss], 0)[0], loss.dtype)
            out.append((loss, vjp(ct)[0]))
        return out

    out = jax.jit(run)([[jnp.asarray(a) for a in c[1]] for c in cases])
    return [(np.asarray(loss), np.asarray(g)) for loss, g in out]


def test_ctc_op_matches_jax(tmp_path_factory):
    """``CTCLoss`` and its aliases, both blank conventions, with and
    without ``data_lengths``/``label_lengths``, repeats, and rows whose
    labels need more frames than they have. Pinned JAX-side behaviour:
    such a row costs a finite ≈1e5 (optax's ``log_epsilon``), where
    ``F.ctc_loss`` gives ``inf``, and the loss is float64 for float32
    logits."""
    refs = once(tmp_path_factory, "dense-ops-ctc", _jax_ctc)
    for alias, (case, (want, want_g)) in zip(
            ["CTCLoss", "ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss",
             "CTCLoss"], zip(_ctc_cases(), refs)):
        cid, inputs, attrs = case
        assert port_op(alias) is port_op("CTCLoss")
        ts = [torch.from_numpy(a) for a in inputs]
        ts[0].requires_grad_()
        loss = port_op(alias).fn(*ts, **attrs)
        assert loss.dtype == torch.float64 and want.dtype == np.float64
        loss.backward(torch.from_numpy(_cotangents([want], 0)[0]).double())
        np.testing.assert_allclose(loss.detach().numpy(), want,
                                   rtol=TOL_CTC, err_msg=cid)
        _close(cid + " (grad)", ts[0].grad.numpy(), want_g, TOL_CTC)
        if cid in ("last", "first"):
            assert 1e5 < float(loss[0]) < 1.001e5, (cid, loss)
            inf = torch.nn.functional.ctc_loss(
                torch.log_softmax(ts[0].detach()[:, :1], -1), torch.tensor(
                    [[2, 2, 2, 2, 2]]), torch.tensor([8]), torch.tensor([5]),
                reduction="none", blank=0)
            assert torch.isinf(inf).all()


def test_order_and_init_ops_match_jax(jax_refs):
    """``sort``/``argsort``/``topk`` with ties (stable: ``topk`` takes the
    lower index first, a descending sort reverses the ascending one), every
    ``ret_typ``, float32 or int32 indices; ``_full``, ``_arange`` (with
    ``repeat``), ``_linspace``, ``_eye`` in float32 unless told. Pinned
    JAX-side fault, not copied: ``topk(ret_typ="mask")`` along axis −1 of
    an n-D input raises in the JAX package (its one-hot rows are summed
    over the wrong axis); the port's mask is the axis-1 mask there."""
    _check_group("order_init", jax_refs)
    t = np.array([[3, 1, 3, 2, 0], [0, 5, 5, 1, 5]], "float32")
    with pytest.raises(TypeError):
        jax_op("topk").fn(jnp.asarray(t), k=2, ret_typ="mask")
    np.testing.assert_array_equal(
        port_op("topk").fn(torch.from_numpy(t), k=2, ret_typ="mask"),
        np.asarray(jax_op("topk").fn(jnp.asarray(t), axis=1, k=2,
                                     ret_typ="mask")))


def _registered_in(modules):
    return sorted(n for n, op in JAX_REGISTRY.items()
                  if op.fn.__module__ in modules)


# the ops of parity_ops.py that belong to a later slice: the int8
# family's quantized ops
LATER_SLICES = {"_contrib_quantized_conv", "_contrib_quantized_pooling",
                "_contrib_quantized_flatten", "_contrib_quantized_concat"}


def test_every_op_of_the_jax_files_is_registered_and_the_namespaces_match():
    """Every name that the JAX files register (slice 11's, slice 12's:
    ``index``, ``matrix``, ``random_ops``, ``tail_ops``, ``linalg`` and
    ``parity_ops`` but ``LATER_SLICES``, and slice 14's ``contrib_ops``),
    and the ``ops/nn.py`` ops of slices 11 and 12, is in the port's
    registry, ``mx.nd`` and ``mx.sym`` (a ``_contrib_`` name also in
    ``mx.nd.contrib`` and ``mx.sym.contrib``),
    aliases sharing one op; the NDArray methods and ``mx.nd``'s binary
    functions behave as the JAX package's."""
    names = _registered_in({f"mxnet_tpu.ops.{m}" for m in (
        "elemwise", "broadcast_reduce", "ctc", "order", "init_ops", "index",
        "matrix", "random_ops", "tail_ops", "linalg", "parity_ops",
        "contrib_ops")})
    assert LATER_SLICES <= set(names)
    names = [n for n in names if n not in LATER_SLICES]
    names += ["LeakyReLU", "InstanceNorm", "LRN", "softmin",
              "SoftmaxActivation", "LinearRegressionOutput",
              "LogisticRegressionOutput", "MAERegressionOutput", "SVMOutput",
              "UpSampling", "GridGenerator", "BilinearSampler",
              "SpatialTransformer", "BatchNorm_v1", "Convolution_v1",
              "Pooling_v1", "CuDNNBatchNorm", "SyncBatchNorm",
              "_contrib_SyncBatchNorm"]
    assert len(names) > 340
    missing = [n for n in names if n not in PORT_REGISTRY
               or not hasattr(mx.nd, n) or not hasattr(mx.sym, n)]
    missing += [n for n in names if n.startswith("_contrib_") and not (
        hasattr(mx.nd.contrib, n[9:]) and hasattr(mx.sym.contrib, n[9:]))]
    assert not missing, missing
    for n in names:       # aliases share one op, as in the JAX registry
        for m in names:
            if JAX_REGISTRY[n] is JAX_REGISTRY[m]:
                assert PORT_REGISTRY[n] is PORT_REGISTRY[m], (n, m)

    a = np.arange(12, dtype="float32").reshape(3, 4) - 5
    b = np.round(_r(4, 2, seed=3))
    j, p = jmx.nd.array(a, ctx=jmx.cpu()), mx.nd.array(a, ctx=mx.cpu())
    jb, pb = jmx.nd.array(b, ctx=jmx.cpu()), mx.nd.array(b, ctx=mx.cpu())
    pairs = [
        ((j @ jb), (p @ pb)),
        (j.broadcast_like(jmx.nd.zeros((2, 3, 4))),
         p.broadcast_like(mx.nd.zeros((2, 3, 4), ctx=mx.cpu()))),
        (j.reshape_like(jmx.nd.zeros((4, 3))),
         p.reshape_like(mx.nd.zeros((4, 3), ctx=mx.cpu()))),
        (j.as_in_ctx(jmx.cpu()), p.as_in_ctx(mx.cpu())),
    ]
    pairs += [(jr, pr) for jr, pr in zip(j, p)]
    for fn in ("maximum", "minimum", "power", "add", "subtract", "multiply",
               "divide", "modulo", "equal", "not_equal", "greater",
               "greater_equal", "lesser", "lesser_equal", "logical_and",
               "logical_or", "logical_xor"):
        rhs = np.abs(a[:1]) + 1 if fn in ("power", "modulo", "divide") \
            else a[::-1].copy()
        pairs.append((getattr(jmx.nd, fn)(j, jmx.nd.array(rhs)),
                      getattr(mx.nd, fn)(p, mx.nd.array(rhs, ctx=mx.cpu()))))
        pairs.append((getattr(jmx.nd, fn)(j, 2.0),
                      getattr(mx.nd, fn)(p, 2.0)))
    pairs += [(jmx.nd.full((2, 3), 4), mx.nd.full((2, 3), 4, ctx=mx.cpu())),
              (jmx.nd.arange(2, 9, 3, repeat=2),
               mx.nd.arange(2, 9, 3, repeat=2, ctx=mx.cpu())),
              (jmx.nd.empty((2,)), mx.nd.empty((2,), ctx=mx.cpu()))]
    assert len(list(p)) == 3
    for jr, pr in pairs:
        np.testing.assert_allclose(pr.asnumpy(), jr.asnumpy(), rtol=1e-6)
    p.wait_to_write()
