"""PyTorch port, the graph-pass manager against the JAX package:
``passes/`` (``fold``, ``layout``, ``s2d``, ``fusion`` and the pipeline),
``Module(passes=...)`` and ``DataParallelTrainer(passes=...)``.

Graphs: a stem net (7x7/s2 convolution over 3 channels, BatchNorm, max
pooling, a residual add, global pooling, a classifier), a ResNet-18 v1 of
the zoo at 32x32, a graph of creation ops (``fold``), a graph of
transposes (``fusion``) and the stem net fed channel-last. Each pass
alone and the default pipeline, with and without re-homing, give the JAX
package's rewrite counts, nodes (name, op, attributes, wiring), variable
transforms and input layouts; the port's rewritten graph computes what
its original does within 1e-5 of the largest output. ``Module`` and the
trainer run the JAX pipeline by default and match the JAX ones within
1e-5 relative to each tensor's largest entry.
"""
import jax
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jparallel
from mxnet_tpu import passes as jpasses
from mxnet_tpu_torch import gluon, parallel, passes
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def _stem_net(S, prefix=""):
    d = S.sym.Variable("data")
    c = S.sym.Convolution(d, num_filter=8, kernel=(7, 7), stride=(2, 2),
                          pad=(3, 3), name=prefix + "conv0")
    b = S.sym.BatchNorm(c, name=prefix + "bn0")
    r = S.sym.Activation(b, act_type="relu", name=prefix + "relu0")
    p = S.sym.Pooling(r, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max", name=prefix + "pool0")
    c1 = S.sym.Convolution(p, num_filter=8, kernel=(3, 3), pad=(1, 1),
                           name=prefix + "conv1")
    s = S.sym.Activation(S.sym.broadcast_add(c1, p, name=prefix + "add0"),
                         act_type="relu", name=prefix + "relu1")
    g = S.sym.Pooling(s, global_pool=True, kernel=(1, 1), pool_type="avg",
                      name=prefix + "gap")
    return S.sym.FullyConnected(S.sym.Flatten(g, name=prefix + "flat"),
                                num_hidden=5, name=prefix + "fc")


def _resnet(S):
    net = S.gluon.model_zoo.vision.resnet18_v1(classes=10,
                                               prefix="resnet_")
    return net(S.sym.Variable("data"))


def _fold_net(S):
    """Creation ops (named: an unnamed op takes a process-wide count)."""
    d = S.sym.Variable("data")
    z = S.sym._plus_scalar(S.sym.zeros(shape=(2, 4), name="z0"),
                           scalar=1.5, name="z1")
    a = S.sym._mul_scalar(S.sym.arange(start=0, stop=4, name="a0"),
                          scalar=2.0, name="a1")
    cond = S.sym.ones(shape=(2, 4), name="cond")
    w = S.sym.where(cond, d, S.sym.zeros(shape=(2, 4), name="z2"),
                    name="w")
    return S.sym.broadcast_add(S.sym.broadcast_mul(w, z, name="m"), a,
                               name="out")


def _fusion_net(S):
    d = S.sym.Variable("data")
    e = S.sym.Variable("other")
    t = S.sym.transpose(S.sym.transpose(d, axes=(0, 2, 3, 1), name="t0"),
                        axes=(0, 3, 1, 2), name="t1")
    u = S.sym.relu(S.sym.transpose(t, axes=(0, 2, 3, 1), name="t2"),
                   name="r")
    v = S.sym.transpose(e, axes=(0, 2, 3, 1), name="t3")
    return S.sym.transpose(S.sym.broadcast_add(u, v, name="add"),
                           axes=(0, 3, 1, 2), name="t4")


GRAPHS = {  # name -> (graph function, data shapes, input layout)
    "stem": (_stem_net, {"data": (2, 3, 32, 32)}, None),
    "stem_nhwc_feed": (_stem_net, {"data": (2, 3, 32, 32)}, "NHWC"),
    "resnet18": (_resnet, {"data": (2, 3, 32, 32)}, None),
    "fold": (_fold_net, {"data": (2, 4)}, None),
    "fusion": (_fusion_net, {"data": (2, 3, 4, 5), "other": (2, 3, 4, 5)},
               None),
}
PIPELINES = [("fold",), ("layout",), ("layout", "s2d"), ("fusion",), None]


def _fresh_names(S, build):
    """``build(S)`` under a new name manager: its unnamed nodes count from
    0 in both packages, whatever earlier tests built."""
    with S.name.NameManager():
        return build(S)


def _signature(sym):
    """Every node's name, op, attributes and inputs (a variable's name:
    the port's gluon trace also keeps a parameter's shape hint among its
    attributes)."""
    return [(n.name, n.op, sorted((n.attrs or {}).items())
             if n.op else [], [(s.name, i) for s, i in n.inputs])
            for n in sym.topo_nodes()]


def _run(P, sym, shapes, layout, names, rehome):
    mgr = P.PassManager(list(names) if names else None, input_layout=layout)
    params = [n for n in sym.list_arguments() if n not in shapes]
    return mgr.run(sym, shapes=shapes, input_vars=tuple(shapes),
                   param_names=params, rehome_params=rehome)


def _values(sym, shapes):
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rs = np.random.RandomState(0)
    vals = {n: rs.uniform(-0.5, 0.5, s).astype("f")
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    aux = {n: rs.uniform(0.5, 1.0, s).astype("f")
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return vals, aux


def _outputs(sym, vals, aux):
    args = {k: mx.nd.array(v) for k, v in vals.items()
            if k in sym.list_arguments()}
    ex = sym.bind(mx.cpu(), args, grad_req="null",
                  aux_states={k: mx.nd.array(v) for k, v in aux.items()})
    return ex.forward()[0].asnumpy()


def test_each_pass_and_the_pipeline_match_jax():
    """Every graph through each pass alone and the default pipeline, with
    re-homing on and off: the JAX package's counts, nodes, transforms and
    input layouts; the port's rewritten graph (re-homed values transformed
    by the recorded specs) against its original within 1e-5."""
    failed = []
    with mx.cpu():
        for gname, (build, shapes, layout) in GRAPHS.items():
            jsym, psym = (_fresh_names(S, build) for S in (jmx, mx))
            vals, aux = _values(psym, shapes)
            want = _outputs(psym, vals, aux)
            for names in PIPELINES:
                for rehome in (True, False):
                    case = f"{gname}/{names or 'default'}/rehome={rehome}"
                    jres = _run(jpasses, jsym, shapes, layout, names, rehome)
                    pres = _run(passes, psym, shapes, layout, names, rehome)
                    if (pres.counts, pres.var_transforms,
                            pres.input_layouts, _signature(pres.symbol)) \
                            != (jres.counts, jres.var_transforms,
                                jres.input_layouts,
                                _signature(jres.symbol)):
                        failed.append(case + ": differs from JAX")
                        continue
                    if pres.total_rewrites == 0:
                        assert pres.symbol is psym, case
                        continue
                    rv = {k: pres.transform_var(k, v)
                          for k, v in vals.items()}
                    for k, lay in pres.input_layouts.items():
                        if lay == "NHWC":
                            rv[k] = np.ascontiguousarray(
                                rv[k].transpose(0, 2, 3, 1))
                    got = _outputs(pres.symbol, rv, aux)
                    err = np.abs(got - want).max() / np.abs(want).max()
                    if not err <= TOL:
                        failed.append(f"{case}: outputs {err:.2e}")
                    back = {k: pres.inverse_var(k, v) for k, v in rv.items()
                            if k in pres.var_transforms}
                    if not all(np.array_equal(back[k], vals[k])
                               for k in back):
                        failed.append(case + ": inverse transform")
    assert not failed, failed


def test_pass_manager_surface(monkeypatch, caplog):
    """``MXNET_PASSES``, ``resolve``'s spellings, the refusals, the value
    transforms (numpy and tensor, both ways, bitwise the JAX package's),
    ``provenance``'s schema, and a pass that raises: logged and skipped,
    the last good graph kept, as in the JAX package."""
    import torch
    for P in (jpasses, passes):
        assert P.default_names("") == ("fold", "layout", "s2d", "fusion")
        assert P.default_names("off") == ()
        assert P.default_names("-s2d") == ("fold", "layout", "fusion")
        assert P.default_names("layout,fusion") == ("layout", "fusion")
        monkeypatch.setenv("MXNET_PASSES", "-fold")
        assert P.resolve(None).names == ("layout", "s2d", "fusion")
        assert P.resolve(True).names == P.DEFAULT_PIPELINE
        monkeypatch.setenv("MXNET_PASSES", "off")
        assert P.resolve(None) is None
        assert P.resolve(True).names == P.DEFAULT_PIPELINE
        monkeypatch.delenv("MXNET_PASSES")
        for off in (False, 0, "", ()):
            assert P.resolve(off) is None
        mgr = P.PassManager("fusion")
        assert P.resolve(mgr) is mgr and len(mgr) == 1
        assert P.provenance(None, None) == {"enabled": False,
                                            "pipeline": [], "applied": []}
        with pytest.raises(Exception, match="unknown graph pass"):
            P.PassManager("bogus")
        with pytest.raises(Exception, match="input_layout"):
            P.PassManager(input_layout="NCHW")
    assert sorted(passes.PASS_REGISTRY) == sorted(jpasses.PASS_REGISTRY)
    w = np.random.RandomState(1).randn(4, 7, 7, 3).astype("f")
    for spec in (("transpose", (0, 2, 3, 1)), ("s2d_weight", 7, 7)):
        fwd = jpasses.apply_spec(spec, w)
        assert np.array_equal(passes.apply_spec(spec, w), fwd)
        t = passes.apply_spec(spec, torch.from_numpy(w))
        assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(),
                                                              fwd)
        assert passes.spec_shape(spec, w.shape) == \
            jpasses.spec_shape(spec, w.shape) == fwd.shape
        assert np.array_equal(passes.apply_spec(spec, fwd, inverse=True),
                              jpasses.apply_spec(spec, fwd, inverse=True))

    class Broken(passes.Pass):
        name = "broken"

        def apply(self, sym, ctx):
            raise RuntimeError("boom")

    sym = _stem_net(mx)
    res = passes.PassManager([Broken(), "layout"]).run(
        sym, shapes={"data": (2, 3, 32, 32)})
    assert res.counts == {"broken": 0, "layout": 5}
    assert "graph pass 'broken' failed" in caplog.text
    assert passes.provenance(passes.PassManager("layout"), res)["applied"] \
        == ["layout"]


def _module_net(S):
    return S.sym.SoftmaxOutput(_stem_net(S), name="softmax")


def _module_run(pkg, passes_arg, x, y, vals, aux):
    mod = pkg.mod.Module(_module_net(pkg), context=pkg.cpu(),
                         passes=passes_arg)
    mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
    mod.init_params(arg_params={k: pkg.nd.array(v) for k, v in vals.items()
                                if k != "data"},
                    aux_params={k: pkg.nd.array(v) for k, v in aux.items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.5),))
    batch = pkg.io.DataBatch([pkg.nd.array(x)], [pkg.nd.array(y)])
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    mod.forward(batch, is_train=False)
    arg, _ = mod.get_params()
    return (mod.get_outputs()[0].asnumpy(),
            {k: v.asnumpy() for k, v in arg.items()},
            mod.passes_provenance())


def test_module_passes_match_jax():
    """``Module(passes=None)`` (the default pipeline: the convs, BatchNorm
    and pools NHWC through transposes, no variable re-homed) and
    ``passes=False`` against the JAX ``Module``s on a stem over 5
    channels: one SGD step, then the outputs and every parameter; the
    provenance the JAX package's. Over 3 channels the pipeline also
    rewrites the stem into its space-to-depth form, with the weight's
    rearrangement in the graph: the JAX ``Module`` then cannot infer that
    weight's shape and fails to bind (ROADMAP C), the port binds at the
    module's own shapes and matches its ``passes=False`` run."""
    rs = np.random.RandomState(3)
    y = rs.randint(0, 5, (4,)).astype("f")
    runs = {}
    with mx.cpu():
        for c in (5, 3):
            x = rs.uniform(-1, 1, (4, c, 32, 32)).astype("f")
            vals, aux = _values(_module_net(mx), {"data": x.shape,
                                                  "softmax_label": y.shape})
            for pkg in ((jmx, mx) if c == 5 else (mx,)):
                for p in (None, False):
                    runs[(c, pkg.__name__, p)] = _module_run(
                        pkg, p, x, y, vals, aux)
    for c, p, ref in ((5, None, "mxnet_tpu"), (5, False, "mxnet_tpu"),
                      (3, None, "mxnet_tpu_torch")):
        (jo, jarg, jprov) = runs[(c, ref, p if ref == "mxnet_tpu"
                                  else False)]
        (po, parg, pprov) = runs[(c, "mxnet_tpu_torch", p)]
        if ref == "mxnet_tpu":
            assert pprov == jprov
        assert np.abs(po - jo).max() <= TOL * np.abs(jo).max(), (c, p)
        for k in jarg:
            assert np.abs(parg[k] - jarg[k]).max() \
                <= TOL * np.abs(jarg[k]).max(), (c, p, k)
    assert runs[(5, "mxnet_tpu_torch", None)][2]["rewrites"] == \
        {"layout": 5}
    assert runs[(3, "mxnet_tpu_torch", None)][2]["rewrites"] == \
        {"layout": 5, "s2d": 1}
    assert not runs[(5, "mxnet_tpu_torch", False)][2]["enabled"]


def _stem_block(g):
    net = g.nn.HybridSequential(prefix="stem_")
    with net.name_scope():
        net.add(g.nn.Conv2D(8, 7, strides=2, padding=3, in_channels=3,
                            prefix="conv0_"))
        net.add(g.nn.BatchNorm(in_channels=8, prefix="bn0_"))
        net.add(g.nn.Activation("relu"))
        net.add(g.nn.Conv2D(8, 3, padding=1, in_channels=8,
                            prefix="conv1_"))
        net.add(g.nn.GlobalAvgPool2D())
        net.add(g.nn.Dense(5, in_units=8, prefix="fc_"))
    return net


def test_trainer_rehomes_the_stem_and_syncs_back():
    """``DataParallelTrainer(passes=None)`` over an NCHW gluon net: the
    pipeline re-homes every conv weight (OHWI, the stem's to its
    space-to-depth form), as the JAX trainer does; two SGD steps match the
    JAX trainer's losses, and ``sync_to_net`` gives the net its own
    (OIHW) layout back with the JAX net's values."""
    rs = np.random.RandomState(4)
    x = rs.uniform(-1, 1, (4, 3, 16, 16)).astype("f")
    y = rs.randint(0, 5, (4,)).astype("f")
    runs = []
    with mx.cpu():
        for pkg, g, par, mesh in _trainer_packages():
            runs.append(_trainer_run(pkg, g, par, mesh, x, y))
    (jl, jplaced, jprov, jtr, jw), (pl, pplaced, pprov, ptr, pw) = runs
    assert pprov == jprov and ptr == jtr and pplaced == jplaced
    assert ptr["stem_conv0_weight"] == [("transpose", (0, 2, 3, 1)),
                                        ("s2d_weight", 7, 7)]
    assert pplaced["stem_conv0_weight"] == (8, 4, 4, 12)
    np.testing.assert_allclose(pl, jl, rtol=TOL)
    for k in jw:
        assert pw[k].shape == jw[k].shape
        assert np.abs(pw[k] - jw[k]).max() <= TOL * np.abs(jw[k]).max(), k


def _trainer_packages():
    return ((jmx, jgluon, jparallel,
             lambda: jparallel.local_mesh("dp", devices=jax.devices()[:1])),
            (mx, gluon, parallel,
             lambda: parallel.local_mesh(devices=[mx.cpu()])))


def _trainer_run(pkg, g, par, mesh, x, y):
    """Two SGD steps of the stem block; (losses, the trainer's parameter
    shapes, provenance, transforms, the net's parameters after
    ``sync_to_net``)."""
    net = _stem_block(g)
    net.initialize(ctx=pkg.cpu())
    vrs = np.random.RandomState(5)
    for k, p in sorted(net.collect_params().items()):
        v = vrs.uniform(-0.3, 0.3, p.shape).astype("f")
        p.set_data(pkg.nd.array(np.abs(v) + 0.5 if k.endswith("_var")
                                else v))
    trainer = par.DataParallelTrainer(
        net, g.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.1, "momentum": 0.9}, mesh=mesh())
    losses = [float(trainer.step(pkg.nd.array(x), pkg.nd.array(y)))
              for _ in range(2)]
    placed = {k: tuple(v.shape) for k, v in trainer._params.items()}
    trainer.sync_to_net()
    return (losses, placed, trainer.passes_provenance(),
            trainer._pass_result.var_transforms,
            {k: p.data().asnumpy() for k, p in net.collect_params().items()})
