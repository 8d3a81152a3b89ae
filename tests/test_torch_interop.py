"""PyTorch port, the reference's file formats (``interop``: the NDArray
list container with V2, V1 and pre-V1 records, dense and sparse; the
graph JSON of every era with its legacy upgrades), ``mx.nd.load``,
``mx.sym.load_json``, ``mx.model.load_checkpoint``, ``mx.util``'s
reference functions, ``Module``, ``FeedForward`` and ``ModelServer`` over
them, against the JAX package.

The wire layouts are assembled by hand here, byte by byte, from the
reference's sources (records ``src/ndarray/ndarray.cc:1567-1765``, the
list container ``:1767-1795``, the context ``include/mxnet/base.h:188``,
the JSON upgrades ``src/nnvm/legacy_json_util.cc``): the port's writer
must give those bytes exactly, the JAX package's writer's bytes, and each
package must read what the other wrote. Arrays read back are bitwise the
arrays written (structure and dtype exact for sparse records); graph
outputs and the committed ``refmlp`` checkpoint's logits within 1e-5 of
the pinned logits and of the JAX package's. Each item loops over its
cases and names the ones that fail.
"""
import json
import os
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import interop as jinterop
from mxnet_tpu_torch import interop
from mxnet_tpu_torch.base import MXNetError
from test_torch_threads import one_torch_thread  # noqa: F401

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
TOL = 1e-5
_FLAGS = {"float32": 0, "float64": 1, "float16": 2, "uint8": 3, "int32": 4,
          "int8": 5, "int64": 6}


@pytest.fixture(autouse=True)
def on_cpu():
    with mx.cpu():
        yield


def _each(checks):
    failed = []
    for name, check in checks:
        try:
            check()
        except Exception as e:          # noqa: BLE001 — named below
            failed.append(f"{name}: {type(e).__name__}: {e}")
    assert not failed, "\n".join(failed)


# ------------------------------------------------------------ the records
def v2_dense_record(arr, dev_type=1, dev_id=0):
    """One NDARRAY_V2 dense record."""
    arr = np.ascontiguousarray(arr)
    out = struct.pack("<Ii", 0xF993FAC9, 0)
    out += struct.pack("<I", arr.ndim) + struct.pack(f"<{arr.ndim}q",
                                                     *arr.shape)
    out += struct.pack("<ii", dev_type, dev_id)
    out += struct.pack("<i", _FLAGS[str(arr.dtype)]) + arr.tobytes()
    return out


def list_container(records, names):
    out = struct.pack("<QQQ", 0x112, 0, len(records)) + b"".join(records)
    out += struct.pack("<Q", len(names))
    for nm in names:
        out += struct.pack("<Q", len(nm)) + nm.encode()
    return out


def _sparse_records():
    """(row_sparse record, csr record, their dense values)."""
    vals = np.asarray([[1.0, 2.0], [3.0, 4.0]], "float32")
    rs = struct.pack("<Ii", 0xF993FAC9, 1)
    rs += struct.pack("<I2q", 2, 2, 2) + struct.pack("<I2q", 2, 4, 2)
    rs += struct.pack("<ii", 1, 0) + struct.pack("<i", 0)
    rs += struct.pack("<i", 6) + struct.pack("<I1q", 1, 2)
    rs += vals.tobytes() + np.asarray([0, 2], "int64").tobytes()
    data = np.asarray([5.0, 7.0, 9.0], "float32")
    cs = struct.pack("<Ii", 0xF993FAC9, 2)
    cs += struct.pack("<I1q", 1, 3) + struct.pack("<I2q", 2, 3, 3)
    cs += struct.pack("<ii", 1, 0) + struct.pack("<i", 0)
    cs += struct.pack("<i", 6) + struct.pack("<I1q", 1, 4)
    cs += struct.pack("<i", 6) + struct.pack("<I1q", 1, 3)
    cs += data.tobytes() + np.asarray([0, 1, 1, 3], "int64").tobytes()
    cs += np.asarray([1, 0, 2], "int64").tobytes()
    dense_rs = np.zeros((4, 2), "float32")
    dense_rs[[0, 2]] = vals
    dense_cs = np.asarray([[0, 5, 0], [0, 0, 0], [7, 0, 9]], "float32")
    return rs, cs, dense_rs, dense_cs


def _dtype_params():
    rng = np.random.RandomState(3)
    return {
        "arg:f32": rng.randn(3, 4).astype("float32"),
        "arg:f64": rng.randn(2).astype("float64"),
        "arg:f16": rng.randn(5).astype("float16"),
        "arg:u8": rng.randint(0, 255, (4,)).astype("uint8"),
        "arg:i32": rng.randint(-9, 9, (2, 2)).astype("int32"),
        "arg:i64": rng.randint(-9, 9, (3,)).astype("int64"),
        "aux:i8": rng.randint(-9, 9, (3,)).astype("int8"),
        "aux:scalar": np.asarray(2.5, "float32").reshape(1),
    }


def _writer_bytes(tmp):
    w = np.asarray([[1.0, 2.0], [3.0, 4.0]], "float32")
    b = np.asarray([5.0, 6.0], "float32")
    want = list_container([v2_dense_record(w), v2_dense_record(b)],
                          ["arg:w", "arg:b"])
    for pkg, interop_mod, name in ((mx, interop, "port"),
                                   (jmx, jinterop, "jax")):
        fname = str(tmp / f"two_{name}.params")
        interop_mod.save_reference_params(
            fname, {"arg:w": pkg.nd.array(w), "arg:b": pkg.nd.array(b)})
        with open(fname, "rb") as f:
            assert f.read() == want, f"{name}'s writer"
    # the util entry point writes the same file
    fname = str(tmp / "two_util.params")
    mx.util.save_reference_params(
        fname, {"arg:w": mx.nd.array(w), "arg:b": mx.nd.array(b)})
    with open(fname, "rb") as f:
        assert f.read() == want, "util.save_reference_params"


def _dtype_round_trips(tmp):
    params = _dtype_params()
    port_file, jax_file = str(tmp / "rt_port.params"), \
        str(tmp / "rt_jax.params")
    interop.save_reference_params(
        port_file, {k: mx.nd.array(v, dtype=v.dtype)
                    for k, v in params.items()})
    jinterop.save_reference_params(
        jax_file, {k: jmx.nd.array(v, dtype=v.dtype)
                   for k, v in params.items()})
    with open(port_file, "rb") as f, open(jax_file, "rb") as g:
        assert f.read() == g.read(), "the two writers' bytes differ"
    for fname in (port_file, jax_file):
        for what, got in (
                ("interop", interop.load_reference_params(fname)),
                ("util", mx.util.load_reference_params(fname)),
                ("nd.load", mx.nd.load(fname))):
            assert set(got) == set(params), what
            for k, v in params.items():
                g = got[k].asnumpy()
                assert got[k].context == mx.cpu(), (what, k)
                assert g.dtype == v.dtype and np.array_equal(g, v), (what, k)
    jgot = jinterop.load_reference_params(port_file)
    for k, v in params.items():
        assert np.array_equal(jgot[k].asnumpy(), v), ("jax reads", k)
    # a dtype without a type flag raises, bfloat16 among them
    for bad in (mx.nd.array(np.ones(2, "f4"), dtype="bfloat16"),
                np.ones(2, "uint16"), torch.ones(2, dtype=torch.bfloat16)):
        with pytest.raises(MXNetError, match="type flag"):
            interop.save_reference_params(str(tmp / "bad.params"),
                                          {"x": bad})


def _sparse_written_densified(tmp):
    """``save_reference_params`` writes a sparse array as its dense V2
    record, in both packages (the reference writes its storage type)."""
    from mxnet_tpu.ndarray import sparse as jsp
    from mxnet_tpu_torch.ndarray import sparse as psp
    vals = np.arange(6, dtype="float32").reshape(3, 2)
    files = []
    for sp, nm, io_mod in ((psp, "port", interop), (jsp, "jax", jinterop)):
        rs = sp.row_sparse_array((vals, [0, 3, 5]), shape=(6, 2))
        cs = sp.csr_matrix(np.eye(3, 4, dtype="float32") * 2)
        files.append(str(tmp / f"dens_{nm}.params"))
        io_mod.save_reference_params(files[-1], {"rs": rs, "cs": cs})
    dense_rs = np.zeros((6, 2), "float32")
    dense_rs[[0, 3, 5]] = vals
    want = list_container([v2_dense_record(dense_rs), v2_dense_record(
        np.eye(3, 4, dtype="float32") * 2)], ["rs", "cs"])
    for fname in files:
        with open(fname, "rb") as f:
            assert f.read() == want, fname


def _legacy_and_sparse_records(tmp):
    a = np.asarray([1.5, -2.5], "float32")
    v1 = struct.pack("<I", 0xF993FAC8) + struct.pack("<I", 1)
    v1 += struct.pack("<q", 2) + struct.pack("<ii", 1, 0)
    v1 += struct.pack("<i", 0) + a.tobytes()
    b = np.arange(6, dtype="float32").reshape(2, 3)
    pre = struct.pack("<I", 2) + struct.pack("<II", 2, 3)
    pre += struct.pack("<ii", 1, 0) + struct.pack("<i", 0) + b.tobytes()
    c = np.asarray([7], "int64")
    gpu = v2_dense_record(c, dev_type=2, dev_id=3)
    none = struct.pack("<Ii", 0xF993FAC9, 0) + struct.pack("<I", 0)
    rs, cs, dense_rs, dense_cs = _sparse_records()
    fname = str(tmp / "legacy.params")
    with open(fname, "wb") as f:
        f.write(list_container([v1, pre, gpu, none, rs, cs],
                               ["v1", "pre", "gpu", "none", "rs", "cs"]))
    out = interop.load_reference_params(fname)
    jout = jinterop.load_reference_params(fname)
    for k, want in (("v1", a), ("pre", b), ("gpu", c)):
        g = out[k].asnumpy()
        assert g.dtype == want.dtype and np.array_equal(g, want), k
    assert out["none"] is None and jout["none"] is None
    assert out["rs"].stype == "row_sparse" and out["cs"].stype == "csr"
    for k, dense in (("rs", dense_rs), ("cs", dense_cs)):
        assert np.array_equal(out[k].asnumpy(), dense), k
        for part in ("data", "indices") + (("indptr",) if k == "cs" else ()):
            g = getattr(out[k], part).asnumpy()
            w = getattr(jout[k], part).asnumpy()
            assert g.dtype == w.dtype and np.array_equal(g, w), (k, part)
    # an unnamed list: a list from nd.load, positional keys from interop
    anon = str(tmp / "anon.params")
    with open(anon, "wb") as f:
        f.write(list_container([v2_dense_record(a), v2_dense_record(b)], []))
    arrays, names = interop.load_reference_ndarrays(anon)
    assert names == [] and len(arrays) == 2
    assert sorted(interop.load_reference_params(anon)) == [
        "ndarray_0", "ndarray_1"]
    loaded = mx.nd.load(anon)
    assert isinstance(loaded, list) and np.array_equal(loaded[1].asnumpy(),
                                                       b)
    with open(anon, "rb") as f:
        buf = f.read()
    assert np.array_equal(mx.nd.load_frombuffer(buf)[0].asnumpy(), a)
    assert interop.is_reference_params_file(anon)
    assert not interop.is_reference_params_file(str(tmp / "missing"))


def _broken_files(tmp):
    raw = list_container([v2_dense_record(np.ones(3, "float32"))], ["x"])
    bad = {
        "truncated": raw[:len(raw) // 2],
        "names_mismatch": list_container(
            [v2_dense_record(np.ones(3, "float32"))], ["x", "y"]),
        "unknown_stype": list_container(
            [struct.pack("<Ii", 0xF993FAC9, 5)], ["x"]),
        "not_a_list": struct.pack("<QQ", 0x113, 0),
    }
    for name, data in bad.items():
        fname = str(tmp / f"{name}.params")
        with open(fname, "wb") as f:
            f.write(data)
        with pytest.raises(MXNetError):
            interop.load_reference_params(fname)
        with pytest.raises(Exception):
            jinterop.load_reference_params(fname)
        with pytest.raises(MXNetError):
            mx.nd.load(fname)


def test_reference_params_files_match_jax(tmp_path):
    """The writer's bytes against hand-assembled records and the JAX
    writer's; every dtype both ways between the packages; sparse arrays
    written densified; V1, pre-V1, empty, GPU-context and sparse records
    (the sparse ones as the same sparse structure as the JAX package's);
    unnamed lists; broken files raise."""
    _each([
        ("writer_matches_hand_assembled_bytes",
         lambda: _writer_bytes(tmp_path)),
        ("dtype_round_trips", lambda: _dtype_round_trips(tmp_path)),
        ("sparse_written_densified",
         lambda: _sparse_written_densified(tmp_path)),
        ("legacy_and_sparse_records",
         lambda: _legacy_and_sparse_records(tmp_path)),
        ("broken_files", lambda: _broken_files(tmp_path)),
    ])


# ----------------------------------------------------------- graph JSON
def _ref_mlp_json(era="1.0"):
    """data -> FC(4) -> relu -> FC(3) in the reference's JSON of an era."""
    attr_key = {"1.0": "attrs", "0.9": "attr", "0.8": "param"}[era]
    nodes = [
        {"op": "null", "name": "data", "inputs": []},
        {"op": "null", "name": "fc1_weight", "inputs": []},
        {"op": "null", "name": "fc1_bias", "inputs": []},
        {"op": "FullyConnected", "name": "fc1",
         attr_key: {"num_hidden": "4"},
         "inputs": [[0, 0, 0], [1, 0, 0], [2, 0, 0]]},
        {"op": "Activation", "name": "relu1",
         attr_key: {"act_type": "relu"}, "inputs": [[3, 0, 0]]},
        {"op": "null", "name": "fc2_weight", "inputs": []},
        {"op": "null", "name": "fc2_bias", "inputs": []},
        {"op": "FullyConnected", "name": "fc2",
         attr_key: {"num_hidden": "3", "no_bias": "False"},
         "inputs": [[4, 0, 0], [5, 0, 0], [6, 0, 0]]},
    ]
    doc = {"nodes": nodes, "arg_nodes": [0, 1, 2, 5, 6],
           "node_row_ptr": list(range(len(nodes) + 1)),
           "heads": [[7, 0, 0]],
           "attrs": {"mxnet_version": ["int",
                                       10400 if era == "1.0" else 900]}}
    if era == "0.8":
        doc.pop("attrs")
        doc["heads"] = [[7, 0]]
        for n in doc["nodes"]:
            n["inputs"] = [e[:2] for e in n["inputs"]]
    return json.dumps(doc)


def _forward(pkg, sym, feeds, is_train=False):
    ex = sym.bind(pkg.cpu(), {k: pkg.nd.array(v) for k, v in feeds.items()})
    return [o.asnumpy() for o in ex.forward(is_train=is_train)]


def _eras():
    rng = np.random.RandomState(0)
    feeds = {"data": rng.randn(2, 5).astype("f4"),
             "fc1_weight": rng.randn(4, 5).astype("f4"),
             "fc1_bias": rng.randn(4).astype("f4"),
             "fc2_weight": rng.randn(3, 4).astype("f4"),
             "fc2_bias": rng.randn(3).astype("f4")}
    for era in ("1.0", "0.9", "0.8"):
        text = _ref_mlp_json(era)
        sym, jsym = mx.sym.load_json(text), jmx.sym.load_json(text)
        assert sym.list_arguments() == jsym.list_arguments() == [
            "data", "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"], era
        got, want = _forward(mx, sym, feeds), _forward(jmx, jsym, feeds)
        np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL,
                                   err_msg=era)
    # symbol.load reads a file, and interop takes the dict as well
    assert interop.symbol_from_reference_json(
        json.loads(_ref_mlp_json())).list_outputs() == ["fc2_output"]
    with pytest.raises(MXNetError, match="nodes"):
        interop.symbol_from_reference_json({"heads": []})


def _batchnorm_upgrade():
    nodes = [
        {"op": "null", "name": "data", "inputs": []},
        {"op": "null", "name": "bn_gamma", "inputs": []},
        {"op": "null", "name": "bn_beta", "inputs": []},
        {"op": "BatchNorm", "name": "bn", "param": {},
         "inputs": [[0, 0], [1, 0], [2, 0]]},
        {"op": "null", "name": "fc_weight", "inputs": []},
        {"op": "null", "name": "fc_bias", "inputs": []},
        {"op": "FullyConnected", "name": "fc", "param": {"num_hidden": "2"},
         "inputs": [[3, 0], [4, 0], [5, 0]]},
    ]
    text = json.dumps({"nodes": nodes, "arg_nodes": [0, 1, 2, 4, 5],
                       "heads": [[6, 0]]})
    sym, jsym = mx.sym.load_json(text), jmx.sym.load_json(text)
    assert [n.name for n, _ in sym._outputs] == ["fc"]
    names = sym.list_arguments() + sym.list_auxiliary_states()
    assert names == jsym.list_arguments() + jsym.list_auxiliary_states()
    assert "bn_moving_mean" in names and "bn_moving_var" in names
    rng = np.random.RandomState(1)
    feeds = {"data": rng.randn(2, 3).astype("f4"),
             "bn_gamma": rng.rand(3).astype("f4") + 0.5,
             "bn_beta": rng.randn(3).astype("f4"),
             "fc_weight": rng.randn(2, 3).astype("f4"),
             "fc_bias": rng.randn(2).astype("f4")}
    aux = {"bn_moving_mean": rng.randn(3).astype("f4"),
           "bn_moving_var": rng.rand(3).astype("f4") + 0.5}
    outs = []
    for pkg, s in ((mx, sym), (jmx, jsym)):
        ex = s.bind(pkg.cpu(), {k: pkg.nd.array(v) for k, v in
                                feeds.items()},
                    aux_states={k: pkg.nd.array(v) for k, v in aux.items()})
        outs.append(ex.forward(is_train=False)[0].asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=TOL, atol=TOL)


def _hidden_keys_and_axis_upgrade():
    nodes = [
        {"op": "null", "name": "data", "inputs": [],
         "attrs": {"lr_mult": "2", "__shape__": "(1, 3)"}},
        {"op": "null", "name": "fc_weight", "inputs": []},
        {"op": "null", "name": "fc_bias", "inputs": []},
        {"op": "FullyConnected", "name": "fc",
         "attr": {"num_hidden": "2", "weight_lr_mult": "0.5",
                  "bias_wd_mult": "0", "__ctx_group__": "dev1"},
         "inputs": [[0, 0, 0], [1, 0, 0], [2, 0, 0]]},
        {"op": "argmax", "name": "am", "attr": {"axis": "-1"},
         "inputs": [[3, 0, 0]]},
    ]
    text = json.dumps({"nodes": nodes, "arg_nodes": [0, 1, 2],
                       "heads": [[4, 0, 0], [3, 0, 0]],
                       "attrs": {"mxnet_version": ["int", 904]}})
    sym, jsym = mx.sym.load_json(text), jmx.sym.load_json(text)
    feeds = {"data": np.asarray([[1.0, -2.0, 3.0]], "f4"),
             "fc_weight": np.asarray([[1, 1, 1], [0, 2, 1]], "f4"),
             "fc_bias": np.asarray([0.5, -0.5], "f4")}
    got, want = _forward(mx, sym, feeds), _forward(jmx, jsym, feeds)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    # the keys reach the variables' attribute dicts (the JAX package keeps
    # a variable's in its op attrs), never the op
    port_nodes = {n.name: n for n in sym.topo_nodes()}
    jax_nodes = {n.name: n for n in jsym.topo_nodes()}
    for var, key, value in (("fc_weight", "__lr_mult__", "0.5"),
                            ("fc_bias", "__wd_mult__", "0"),
                            ("data", "__lr_mult__", "2"),
                            ("data", "__shape__", "(1, 3)")):
        assert port_nodes[var]._attr_dict.get(key) == value, (var, key)
        assert jax_nodes[var].attrs.get(key) == value, (var, key)
    assert mx.sym.load_json(text).get_internals() is not None
    assert port_nodes["fc"].attrs == {"num_hidden": 2}
    assert "axis" not in port_nodes["am"].attrs


def test_reference_symbol_json_matches_jax():
    """The reference's graph JSON of the 1.x, 0.9 and 0.8 eras, the pre-0.9
    BatchNorm upgrade (aux inputs re-created, node ids intact), the hidden
    ``lr_mult``/``wd_mult``/``ctx_group`` keys rehomed onto variables and
    the argmax ``axis=-1`` upgrade: arguments and outputs against the JAX
    package's graph."""
    _each([
        ("eras", _eras),
        ("batchnorm_upgrade", _batchnorm_upgrade),
        ("hidden_keys_and_axis_upgrade", _hidden_keys_and_axis_upgrade),
    ])


# ----------------------------------------- checkpoints, Module, FeedForward
def _refmlp():
    prefix = os.path.join(FIXDIR, "refmlp")
    x = np.load(os.path.join(FIXDIR, "refmlp_input.npy"))
    return prefix, x, np.load(os.path.join(FIXDIR, "refmlp_output.npy"))


def _refmlp_checkpoint():
    prefix, x, want = _refmlp()
    sym, arg, aux = mx.model.load_checkpoint(prefix, 0)
    jsym, jarg, jaux = jmx.model.load_checkpoint(prefix, 0)
    assert sorted(arg) == sorted(jarg) == ["fc1_bias", "fc1_weight",
                                           "fc2_bias", "fc2_weight"]
    assert aux == {} and jaux == {}
    for k in arg:
        assert arg[k].context == mx.cpu()
        assert np.array_equal(arg[k].asnumpy(), jarg[k].asnumpy()), k
    usym, uarg, _ = mx.util.load_reference_checkpoint(prefix, 0)
    assert usym.list_arguments() == sym.list_arguments()
    out = _forward(mx, usym, dict({k: v.asnumpy() for k, v in uarg.items()},
                                  data=x))[0]
    np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)


def _refmlp_module():
    prefix, x, want = _refmlp()
    sym, arg, aux = mx.model.load_checkpoint(prefix, 0)
    mod = mx.mod.Module(sym, data_names=["data"], label_names=None,
                        context=mx.cpu())
    mod.bind(data_shapes=[("data", x.shape)], for_training=False)
    mod.set_params(arg, aux)
    mod.forward(mx.io.DataBatch(data=[mx.nd.array(x)]), is_train=False)
    np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(), want,
                               rtol=TOL, atol=TOL)
    loaded = mx.mod.Module.load(prefix, 0, data_names=["data"],
                                label_names=None, context=mx.cpu())
    loaded.bind(data_shapes=[("data", x.shape)], for_training=False)
    loaded.init_params()
    got = loaded.predict(mx.io.NDArrayIter(x, batch_size=len(x)))
    np.testing.assert_allclose(got.asnumpy(), want, rtol=TOL, atol=TOL)


def _refmlp_feedforward():
    prefix, x, want = _refmlp()
    ff = mx.model.FeedForward.load(prefix, 0, ctx=mx.cpu())
    jff = jmx.model.FeedForward.load(prefix, 0, ctx=jmx.cpu())
    got, jgot = ff.predict(x), jff.predict(x)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, jgot, rtol=TOL, atol=TOL)


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    h = pkg.sym.Activation(pkg.sym.FullyConnected(
        data, num_hidden=6, name="fc1"), act_type="relu", name="relu1")
    out = pkg.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(out, name="softmax")


def _feedforward_fit_score_save(tmp):
    """fit (one epoch of SGD from the same weights), predict with the
    ``softmax_label`` placeholder, score, save and load, and ``create``,
    in both packages."""
    rng = np.random.RandomState(5)
    X = rng.randn(24, 4).astype("f4")
    y = rng.randint(0, 3, 24).astype("f4")
    w0 = {"fc1_weight": rng.randn(6, 4).astype("f4") * 0.5,
          "fc1_bias": np.zeros(6, "f4"),
          "fc2_weight": rng.randn(3, 6).astype("f4") * 0.5,
          "fc2_bias": np.zeros(3, "f4")}
    runs = []
    for pkg in (mx, jmx):
        ff = pkg.model.FeedForward(
            _mlp(pkg), ctx=pkg.cpu(), num_epoch=2, learning_rate=0.5,
            arg_params={k: pkg.nd.array(v) for k, v in w0.items()},
            aux_params={})
        ff.fit(X, y)
        params = {k: v.asnumpy() for k, v in ff.arg_params.items()}
        acc = ff.score(pkg.io.NDArrayIter(X, y, batch_size=24))
        fresh = pkg.model.FeedForward(
            _mlp(pkg), ctx=pkg.cpu(),
            arg_params={k: pkg.nd.array(v) for k, v in params.items()})
        probs = fresh.predict(X)
        created = pkg.model.FeedForward.create(
            _mlp(pkg), X, y, ctx=pkg.cpu(), num_epoch=1, learning_rate=0.5,
            arg_params={k: pkg.nd.array(v) for k, v in w0.items()},
            aux_params={})
        runs.append((params, acc, probs, {k: v.asnumpy() for k, v in
                                          created.arg_params.items()}))
        if pkg is mx:
            ff.save(str(tmp / "ff"), 2)
    (p, acc, probs, created), (jp, jacc, jprobs, jcreated) = runs
    for k in w0:
        np.testing.assert_allclose(p[k], jp[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
        np.testing.assert_allclose(created[k], jcreated[k], rtol=TOL,
                                   atol=TOL, err_msg=k)
    assert acc == jacc
    np.testing.assert_allclose(probs, jprobs, rtol=TOL, atol=TOL)
    # the port's checkpoint loads in both packages
    for pkg in (mx, jmx):
        back = pkg.model.FeedForward.load(str(tmp / "ff"), 2, ctx=pkg.cpu())
        np.testing.assert_allclose(back.predict(X), probs, rtol=TOL,
                                   atol=TOL)


def _served_from_reference_bytes(tmp):
    """``ModelServer`` (CPU) over the refmlp graph with its reference
    ``.params`` bytes, and over the same weights as ``MXTPU001`` bytes:
    equal responses, the pinned logits."""
    from mxnet_tpu_torch.native.predict_bridge import _load_param_bytes
    from mxnet_tpu_torch.serving import ModelConfig, ModelServer
    prefix, x, want = _refmlp()
    with open(f"{prefix}-symbol.json") as f:
        sym_json = f.read()
    with open(f"{prefix}-0000.params", "rb") as f:
        ref_bytes = f.read()
    arg, _ = _load_param_bytes(ref_bytes, mx.cpu())
    fname = str(tmp / "refmlp_mxtpu.params")
    mx.nd.save(fname, {f"arg:{k}": v for k, v in arg.items()})
    with open(fname, "rb") as f:
        own_bytes = f.read()
    served = []
    for pbytes in (ref_bytes, own_bytes):
        server = ModelServer([ModelConfig(
            "refmlp", sym_json, pbytes, feature_shape=(x.shape[1],),
            buckets=(1, 2, 4), dev_type=1, deadline_ms=0)])
        server.start()
        try:
            served.append(np.stack([server.predict("refmlp", row,
                                                   timeout=30)
                                    for row in x]))
        finally:
            server.close()
    assert np.array_equal(served[0], served[1])
    np.testing.assert_allclose(served[0], want, rtol=TOL, atol=TOL)


def test_reference_checkpoint_module_and_feedforward_match_jax(tmp_path):
    """The committed reference checkpoint ``refmlp`` through
    ``model.load_checkpoint``, ``util.load_reference_checkpoint``,
    ``Module`` (bind, ``set_params``, ``forward``; ``Module.load``) and
    ``FeedForward.load(...).predict`` against its pinned logits and the JAX
    package; ``FeedForward``'s fit, score, save, load and ``create``
    against the JAX package's; ``ModelServer`` over the reference bytes."""
    _each([
        ("refmlp_checkpoint", _refmlp_checkpoint),
        ("refmlp_module", _refmlp_module),
        ("refmlp_feedforward", _refmlp_feedforward),
        ("feedforward_fit_score_save",
         lambda: _feedforward_fit_score_save(tmp_path)),
        ("served_from_reference_bytes",
         lambda: _served_from_reference_bytes(tmp_path)),
    ])
