"""PyTorch port, import hygiene: ``mxnet_tpu_torch``, ``chip_smoke.py`` and
the recipe twins (``example/**/*_torch.py``) import neither JAX nor the JAX
package — not even a module of it that does not import JAX; and the JAX
package's public aliases are there (``mx.kv``, ``mx.nd.sparse``, the lazy
``mx.serving``,
``mx.interop``, ``mx.engine``, ``mx.registry``, ``mx.util`` and
``mx.test_utils``, ``mx.nd.contrib`` and ``mx.sym.contrib``, ``gluon.split_and_load``/``split_data``/
``clip_global_norm``, ``autograd.set_recording``/``set_training``/
``get_symbol``, ``mx.monitor``, ``mx.viz``, ``mx.checkpoint``). Every
public method of a JAX class is on its port twin, but those a ROADMAP A
item owns (``SWEEP_OWNED``), and the repairs of the port's faults against
the JAX package (ROADMAP C1-C5: the host stream's seed, the context names,
``mx.sym.maximum``/``minimum``/``hypot``, the Symbol and Executor
methods, gluon's methods) each have a case fed the same numpy inputs in
both packages: shapes, names and orders exact, computed values within
1e-6 of the largest (float32 products and ``hypot`` round differently in
the two packages)."""
import ast
import contextlib
import io
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")
IMAGE_CLASSIFICATION = tuple(
    "example/image-classification/" + n for n in (
        "common/fit_torch.py", "common/data_torch.py",
        "symbols/lenet_torch.py", "symbols/mlp_torch.py",
        "symbols/resnet_torch.py", "train_mnist_torch.py",
        "train_imagenet_torch.py", "fine_tune_torch.py"))


SLICE_11_TWINS = ("example/gluon/dcgan_torch.py",
                  "example/ctc/lstm_ocr_torch.py",
                  "example/speech_recognition/speech_ctc_torch.py")
SLICE_12_TWINS = ("example/capsnet/capsnet_torch.py",
                  "example/vae/vae_torch.py",
                  "example/restricted-boltzmann-machine/rbm_torch.py",
                  "example/bayesian-methods/bbb_torch.py")
SLICE_13_TWINS = ("example/sparse/linear_classification_torch.py",
                  "example/rcnn/mini_rcnn_torch.py",
                  "example/quantization/quantize_mlp_torch.py")
SLICE_17 = ("mxnet_tpu_torch/checkpoint.py", "mxnet_tpu_torch/monitor.py",
            "mxnet_tpu_torch/visualization.py")
SLICE_15 = ("mxnet_tpu_torch/ops/quantize_ops.py",
            "mxnet_tpu_torch/passes/__init__.py",
            "mxnet_tpu_torch/passes/manager.py",
            "mxnet_tpu_torch/passes/fold.py",
            "mxnet_tpu_torch/passes/layout.py",
            "mxnet_tpu_torch/passes/s2d.py",
            "mxnet_tpu_torch/passes/fusion.py",
            "mxnet_tpu_torch/quant/__init__.py",
            "mxnet_tpu_torch/quant/calib.py",
            "mxnet_tpu_torch/quant/qpass.py",
            "mxnet_tpu_torch/quant/flow.py",
            "mxnet_tpu_torch/contrib/__init__.py",
            "mxnet_tpu_torch/contrib/quantization.py")


def _port_files():
    yield os.path.join(ROOT, "chip_smoke.py")
    for twin in ("example/gluon/word_language_model/train_torch.py",
                 "example/rnn/bucketing/lstm_bucketing_torch.py",
                 "example/gluon/transformer_lm_torch.py",
                 "example/ssd/dataset_torch.py",
                 "example/ssd/symbol_ssd_torch.py",
                 "example/ssd/train_torch.py") + IMAGE_CLASSIFICATION \
            + SLICE_11_TWINS + SLICE_12_TWINS + SLICE_13_TWINS:
        yield os.path.join(ROOT, twin)
    for d, _, names in os.walk(os.path.join(ROOT, "mxnet_tpu_torch")):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_import_in_the_port():
    files = list(_port_files())
    assert len(files) > 30
    rel = {os.path.relpath(p, ROOT) for p in files}
    assert {"mxnet_tpu_torch/autograd.py", "mxnet_tpu_torch/optimizer.py",
            "mxnet_tpu_torch/initializer.py", "mxnet_tpu_torch/name.py",
            "mxnet_tpu_torch/gluon/block.py",
            "mxnet_tpu_torch/gluon/trainer.py",
            "mxnet_tpu_torch/gluon/contrib/transformer.py",
            "mxnet_tpu_torch/rtc.py", "mxnet_tpu_torch/operator.py",
            "mxnet_tpu_torch/lr_scheduler.py",
            "mxnet_tpu_torch/_cuda_driver.py",
            "mxnet_tpu_torch/executor.py", "mxnet_tpu_torch/io/io.py",
            "mxnet_tpu_torch/metric.py", "mxnet_tpu_torch/callback.py",
            "mxnet_tpu_torch/model.py",
            "mxnet_tpu_torch/module/module.py",
            "mxnet_tpu_torch/module/base_module.py",
            "mxnet_tpu_torch/module/executor_group.py",
            "mxnet_tpu_torch/parallel/mesh.py",
            "mxnet_tpu_torch/parallel/data_parallel.py",
            "mxnet_tpu_torch/parallel/fused_rules.py",
            "mxnet_tpu_torch/gluon/nn/conv_layers.py",
            "mxnet_tpu_torch/gluon/model_zoo/__init__.py",
            "mxnet_tpu_torch/gluon/model_zoo/vision/__init__.py",
            "mxnet_tpu_torch/gluon/model_zoo/vision/resnet.py",
            "mxnet_tpu_torch/gluon/model_zoo/vision/vgg.py",
            "mxnet_tpu_torch/gluon/model_zoo/vision/alexnet.py",
            "mxnet_tpu_torch/gluon/model_zoo/vision/squeezenet.py",
            "mxnet_tpu_torch/gluon/model_zoo/vision/mobilenet.py",
            "mxnet_tpu_torch/gluon/model_zoo/vision/densenet.py",
            "mxnet_tpu_torch/gluon/model_zoo/vision/inception.py",
            "mxnet_tpu_torch/ops/rnn.py", "mxnet_tpu_torch/ops/init_ops.py",
            "mxnet_tpu_torch/gluon/rnn/__init__.py",
            "mxnet_tpu_torch/gluon/rnn/rnn_layer.py",
            "mxnet_tpu_torch/gluon/rnn/rnn_cell.py",
            "mxnet_tpu_torch/gluon/utils.py",
            "mxnet_tpu_torch/rnn/__init__.py",
            "mxnet_tpu_torch/rnn/rnn_cell.py", "mxnet_tpu_torch/rnn/io.py",
            "mxnet_tpu_torch/rnn/rnn.py",
            "example/gluon/word_language_model/train_torch.py",
            "example/rnn/bucketing/lstm_bucketing_torch.py",
            "example/gluon/transformer_lm_torch.py",
            "mxnet_tpu_torch/attribute.py", "mxnet_tpu_torch/recordio.py",
            "mxnet_tpu_torch/image.py", "mxnet_tpu_torch/image_detection.py",
            "mxnet_tpu_torch/ops/multibox.py",
            "mxnet_tpu_torch/gluon/data/__init__.py",
            "mxnet_tpu_torch/gluon/data/dataset.py",
            "mxnet_tpu_torch/gluon/data/sampler.py",
            "mxnet_tpu_torch/gluon/data/dataloader.py",
            "mxnet_tpu_torch/gluon/data/vision/datasets.py",
            "mxnet_tpu_torch/gluon/data/vision/transforms.py",
            "example/ssd/dataset_torch.py", "example/ssd/symbol_ssd_torch.py",
            "example/ssd/train_torch.py", "mxnet_tpu_torch/kvstore.py",
            "mxnet_tpu_torch/io/device_feed.py", "mxnet_tpu_torch/ops/ctc.py",
            "mxnet_tpu_torch/ops/order.py", "mxnet_tpu_torch/ops/elemwise.py",
            "mxnet_tpu_torch/ops/broadcast_reduce.py",
            "mxnet_tpu_torch/gluon/loss.py",
            "mxnet_tpu_torch/gluon/nn/activations.py",
            "mxnet_tpu_torch/ops/random_ops.py",
            "mxnet_tpu_torch/ops/tail_ops.py",
            "mxnet_tpu_torch/ops/linalg.py",
            "mxnet_tpu_torch/ops/parity_ops.py",
            "mxnet_tpu_torch/ndarray/contrib.py",
            "mxnet_tpu_torch/symbol/contrib.py",
            "mxnet_tpu_torch/engine.py", "mxnet_tpu_torch/registry.py",
            "mxnet_tpu_torch/util.py", "mxnet_tpu_torch/test_utils.py",
            "mxnet_tpu_torch/native/__init__.py",
            "mxnet_tpu_torch/ndarray/sparse.py", "mxnet_tpu_torch/interop.py",
            "mxnet_tpu_torch/model.py", "mxnet_tpu_torch/io/io.py",
            "mxnet_tpu_torch/ops/contrib_ops.py",
            "mxnet_tpu_torch/gluon/contrib/estimator.py",
            "mxnet_tpu_torch/gluon/contrib/nn/basic_layers.py",
            "mxnet_tpu_torch/gluon/contrib/rnn/rnn_cell.py",
            "mxnet_tpu_torch/gluon/contrib/rnn/conv_rnn_cell.py",
            "mxnet_tpu_torch/gluon/contrib/data/sampler.py"} \
        | set(IMAGE_CLASSIFICATION) | set(SLICE_11_TWINS) \
        | set(SLICE_12_TWINS) | set(SLICE_13_TWINS) | set(SLICE_15) \
        | set(SLICE_17) <= rel
    bad = [(os.path.relpath(p, ROOT), m) for p in files
           for m in _imported(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.serving, "
            "mxnet_tpu_torch.interop, mxnet_tpu_torch.autograd, "
            "mxnet_tpu_torch.gluon, mxnet_tpu_torch.gluon.contrib.transformer, "
            "mxnet_tpu_torch.optimizer, mxnet_tpu_torch.initializer, "
            "mxnet_tpu_torch.name, mxnet_tpu_torch.rtc, "
            "mxnet_tpu_torch.operator, mxnet_tpu_torch.lr_scheduler, "
            "mxnet_tpu_torch._cuda_driver, mxnet_tpu_torch.executor, "
            "mxnet_tpu_torch.io, mxnet_tpu_torch.metric, "
            "mxnet_tpu_torch.callback, mxnet_tpu_torch.model, "
            "mxnet_tpu_torch.module, mxnet_tpu_torch.parallel, "
            "mxnet_tpu_torch.parallel.fused_rules, "
            "mxnet_tpu_torch.gluon.nn.conv_layers, "
            "mxnet_tpu_torch.gluon.model_zoo.vision, mxnet_tpu_torch.rnn, "
            "mxnet_tpu_torch.gluon.rnn, mxnet_tpu_torch.gluon.utils, "
            "mxnet_tpu_torch.ops.rnn, mxnet_tpu_torch.ops.init_ops, "
            "mxnet_tpu_torch.attribute, mxnet_tpu_torch.recordio, "
            "mxnet_tpu_torch.image, mxnet_tpu_torch.image_detection, "
            "mxnet_tpu_torch.ops.multibox, mxnet_tpu_torch.gluon.data, "
            "mxnet_tpu_torch.gluon.data.vision.transforms, "
            "mxnet_tpu_torch.kvstore, mxnet_tpu_torch.io.device_feed; "
            "sys.path[:0] = ['example/ssd']; "
            "import dataset_torch, symbol_ssd_torch, train_torch; "
            "sys.path[:0] = ['example/image-classification']; "
            "import train_mnist_torch, train_imagenet_torch, "
            "fine_tune_torch, common.data_torch, symbols.lenet_torch, "
            "symbols.mlp_torch, symbols.resnet_torch; "
            "sys.path[:0] = ['example/gluon', 'example/ctc', "
            "'example/speech_recognition']; "
            "import dcgan_torch, lstm_ocr_torch, speech_ctc_torch; "
            "import mxnet_tpu_torch.engine, mxnet_tpu_torch.util, "
            "mxnet_tpu_torch.registry, mxnet_tpu_torch.test_utils, "
            "mxnet_tpu_torch.ndarray.contrib, mxnet_tpu_torch.symbol.contrib; "
            "sys.path[:0] = ['example/capsnet', 'example/vae', "
            "'example/restricted-boltzmann-machine', "
            "'example/bayesian-methods']; "
            "import capsnet_torch, vae_torch, rbm_torch, bbb_torch; "
            "import mxnet_tpu_torch.ndarray.sparse; "
            "sys.path[:0] = ['example/sparse']; "
            "import linear_classification_torch; "
            "import mxnet_tpu_torch.ops.contrib_ops, "
            "mxnet_tpu_torch.gluon.contrib.estimator, "
            "mxnet_tpu_torch.gluon.contrib.nn, "
            "mxnet_tpu_torch.gluon.contrib.rnn, "
            "mxnet_tpu_torch.gluon.contrib.data; "
            "sys.path[:0] = ['example/rcnn']; import mini_rcnn_torch; "
            "import mxnet_tpu_torch.passes, mxnet_tpu_torch.quant, "
            "mxnet_tpu_torch.contrib.quantization, "
            "mxnet_tpu_torch.ops.quantize_ops; "
            "sys.path[:0] = ['example/quantization']; "
            "import quantize_mlp_torch; "
            "import mxnet_tpu_torch.checkpoint, mxnet_tpu_torch.monitor, "
            "mxnet_tpu_torch.visualization; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in %r))" % (FORBIDDEN,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr

    # the JAX package's public aliases: mx.kv, mx.nd.sparse, the lazy
    # mx.serving,
    # mx.interop, mx.engine, mx.registry, mx.util and mx.test_utils,
    # mx.nd.contrib and mx.sym.contrib, gluon's batch helpers, autograd's
    # setters
    import mxnet_tpu_torch as mx
    for name in ("serving", "interop", "engine", "registry", "util",
                 "test_utils", "contrib", "passes", "quant"):
        vars(mx).pop(name, None)
        assert getattr(mx, name) is sys.modules[f"mxnet_tpu_torch.{name}"]
    # slice 15: the JAX package's names of passes, quant and the int8 ops
    import mxnet_tpu.passes as jpasses
    import mxnet_tpu.quant as jquant
    assert set(jpasses.__all__) <= set(mx.passes.__all__)
    assert mx.quant.__all__ == jquant.__all__
    from mxnet_tpu_torch.ops.registry import get_op
    for op in ("_contrib_quantize", "_contrib_dequantize",
               "_contrib_requantize", "_contrib_quantized_fully_connected",
               "_contrib_quantized_conv", "_contrib_quantized_pooling",
               "_contrib_quantized_flatten", "_contrib_quantized_concat"):
        assert get_op(op).differentiable is False, op
    assert mx.nd.contrib is sys.modules["mxnet_tpu_torch.ndarray.contrib"]
    assert mx.sym.contrib is sys.modules["mxnet_tpu_torch.symbol.contrib"]
    assert mx.nd.sparse is sys.modules["mxnet_tpu_torch.ndarray.sparse"]
    assert mx.model.FeedForward.load is not None
    assert mx.kv is mx.kvstore
    # slice 14: gluon.CachedOp and every name of the JAX gluon.contrib
    import mxnet_tpu.gluon.contrib as jcontrib
    assert mx.gluon.CachedOp is mx.gluon.block.CachedOp
    for sub in ("nn", "rnn", "data"):
        names = getattr(jcontrib, sub).__all__
        assert getattr(mx.gluon.contrib, sub).__all__ == names, sub
        for name in names:
            assert hasattr(getattr(mx.gluon.contrib, sub), name), name
    for name in jcontrib.estimator.__all__:
        assert hasattr(mx.gluon.contrib.estimator, name), name
    from mxnet_tpu_torch.gluon import utils
    assert (mx.gluon.split_and_load, mx.gluon.split_data,
            mx.gluon.clip_global_norm) == (utils.split_and_load,
                                           utils.split_data,
                                           utils.clip_global_norm)
    ag = mx.autograd
    assert ag.set_recording(True) is False and ag.is_recording()
    assert ag.set_training(True) is False and ag.is_training()
    assert ag.set_recording(False) is True and ag.set_training(False)
    with pytest.raises(mx.MXNetError, match="get_symbol"):
        ag.get_symbol(mx.nd.zeros((1,), ctx=mx.cpu()))
    for name in ("monitor", "visualization", "viz", "checkpoint"):
        vars(mx).pop(name, None)
    assert mx.viz is mx.visualization is \
        sys.modules["mxnet_tpu_torch.visualization"]
    assert mx.monitor.Monitor and mx.checkpoint.ShardedCheckpointer
    failed = []
    for case in (_c1_host_seed, _c2_context, _c3_sym_binaries,
                 _c4_symbol_and_executor, _c5_gluon, _method_sweep):
        try:
            case()
        except Exception as e:
            failed.append(f"{case.__name__}: {type(e).__name__}: {e}")
    assert not failed, "\n".join(failed)


# ------------------------------------------------------------ C1-C5 cases
# public methods of a JAX class that a ROADMAP A item ports (or that name
# JAX itself), by class
SWEEP_OWNED = {
    "Context": {"jax_device": "JAX's device (the port: torch_device)"},
    "Symbol": {"lint": "A9"}, "Executor": {"lint": "A9"},
    "Module": {"lint": "A9"},
    "DataParallelTrainer": {"lint": "A9", "lower": "A9", "perf_stats": "A9",
                            "footprint": "A9", "topology": "A1d",
                            "comm_config": "A1d", "opt_state_bytes": "A1d"},
}


def _pairs():
    import mxnet_tpu as jmx
    import mxnet_tpu.executor as jexec
    import mxnet_tpu_torch as mx
    import mxnet_tpu_torch.executor as pexec
    names = {"Context": lambda m: m.Context, "Symbol": lambda m: m.sym.Symbol,
             "Block": lambda m: m.gluon.Block,
             "HybridBlock": lambda m: m.gluon.HybridBlock,
             "SymbolBlock": lambda m: m.gluon.SymbolBlock,
             "Parameter": lambda m: m.gluon.Parameter,
             "ParameterDict": lambda m: m.gluon.ParameterDict,
             "Trainer": lambda m: m.gluon.Trainer,
             "BaseModule": lambda m: m.mod.BaseModule,
             "Module": lambda m: m.mod.Module,
             "BucketingModule": lambda m: m.mod.BucketingModule,
             "SequentialModule": lambda m: m.mod.SequentialModule,
             "Monitor": lambda m: m.monitor.Monitor,
             "ShardedCheckpointer": lambda m: m.checkpoint.ShardedCheckpointer,
             "DataParallelTrainer": lambda m: m.parallel.DataParallelTrainer,
             "NDArray": lambda m: m.nd.NDArray}
    out = {k: (f(jmx), f(mx)) for k, f in names.items()}
    out["Executor"] = (jexec.Executor, pexec.Executor)
    return out


def _method_sweep():
    missing = {}
    for name, (jcls, pcls) in _pairs().items():
        owned = SWEEP_OWNED.get(name, {})
        gap = sorted(n for n in dir(jcls) if not n.startswith("_")
                     and callable(getattr(jcls, n, None))
                     and not hasattr(pcls, n) and n not in owned)
        if gap:
            missing[name] = gap
    assert not missing, missing


def _c1_host_seed():
    """The host stream is seeded with the seed's low 31 bits: the shuffle
    orders after large seeds are the JAX package's."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    from torch_shared import jax_host_seed
    saved = dict(mx.random._state)
    data = np.arange(40, dtype="float32").reshape(20, 2)
    try:
        for seed in (3_000_000_000, 2 ** 32 + 5, 17):
            orders = []
            for pkg in (jmx, mx):
                with (jax_host_seed(seed) if pkg is jmx
                      else contextlib.nullcontext()):
                    pkg.random.seed(seed)
                    assert pkg.random.current_seed() == seed
                    it = pkg.io.NDArrayIter(data, batch_size=20, shuffle=True)
                    orders.append(next(iter(it)).data[0].asnumpy()[:, 0])
            assert np.array_equal(*orders), (seed, orders)
    finally:
        mx.random._state.clear()
        mx.random._state.update(saved)


def _c2_context():
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    assert mx.Context.devtype2str == jmx.Context.devtype2str
    assert mx.Context.devstr2type == jmx.Context.devstr2type
    for make in ("cpu", "gpu", "cpu_pinned"):
        assert getattr(mx, make)(1).device_typeid == \
            getattr(jmx, make)(1).device_typeid, make
        assert repr(getattr(mx, make)(1)) == repr(getattr(jmx, make)(1))
    assert mx.tpu(1) == mx.gpu(1)          # the JAX accelerator: the card
    assert mx.num_gpus() == mx.num_tpus() == jmx.num_gpus() == 0
    assert sorted(mx.cpu().memory_info()) == sorted(jmx.cpu().memory_info())
    mx.cpu().empty_cache()
    with pytest.raises(mx.MXNetError):     # no card here: never the host's
        mx.gpu_memory_info(0)
    for name in ("tpu", "cpu_pinned", "num_gpus", "num_tpus",
                 "gpu_memory_info"):
        assert name in mx.__all__, name


TOL_VALUES = 1e-6


def _same(a, b) -> bool:
    """Equal, or for float arrays within ``TOL_VALUES`` of the largest."""
    if isinstance(a, np.ndarray) and a.dtype.kind == "f":
        return (a.shape == b.shape and a.dtype == b.dtype and float(
            np.abs(a - b).max(initial=0.0)) <= TOL_VALUES * max(
                float(np.abs(a).max(initial=0.0)), 1e-30))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_same(u, v) for u, v in zip(a, b))
    return a == b


def _sym_eval(pkg, sym, **arrays):
    with pkg.cpu():
        args = {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in arrays.items()}
        return [o.asnumpy() for o in sym.eval(pkg.cpu(), **args)]


def _c3_sym_binaries():
    """Each of ``maximum``, ``minimum``, ``hypot`` on a Symbol pair and
    with a scalar on either side, all nine in one graph a package."""
    import json
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    rs = np.random.RandomState(3)
    feed = {"a": rs.randn(3, 4).astype("float32"),
            "b": rs.randn(1, 4).astype("float32")}
    got = []
    for pkg in (jmx, mx):
        x, y = pkg.sym.Variable("a"), pkg.sym.Variable("b")
        heads = []
        for fn in ("maximum", "minimum", "hypot"):
            f = getattr(pkg.sym, fn)
            heads += [f(x, y), f(x, 0.5), f(-0.25, x)]
        group = pkg.sym.Group(heads)
        graph = json.loads(group.tojson())
        nodes = [graph["nodes"][h[0]] for h in graph["heads"]]
        got.append(([(n["op"], n["attrs"]) for n in nodes],
                    _sym_eval(pkg, group, **feed)))
    (jops, jvals), (pops, pvals) = got
    assert jops == pops, (jops, pops)
    for i, (a, b) in enumerate(zip(jvals, pvals)):
        assert _same(a, b), (jops[i], a, b)


def _c4_symbol_and_executor():
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    rs = np.random.RandomState(4)
    feed = {"x": rs.randn(2, 5).astype("float32"),
            "fc_weight": rs.randn(3, 5).astype("float32"),
            "fc_bias": rs.randn(3).astype("float32")}
    res = []
    for pkg in (jmx, mx):
        x = pkg.sym.Variable("x")
        y = pkg.sym.Activation(pkg.sym.FullyConnected(
            x, num_hidden=3, name="fc"), act_type="relu", name="act")
        with pkg.cpu():
            ex = y.simple_bind(pkg.cpu(), x=(2, 5))
        text = ex.debug_str()
        res.append((y.get_children().list_outputs(),
                    x.get_children(),
                    y.infer_shape_partial(),
                    y.infer_shape_partial(x=(2, 5)),
                    y.infer_type(x="float32"),
                    _sym_eval(pkg, y, **feed)[0],
                    isinstance(text, str) and len(text) > 0))
    j, p = res
    for i, (a, b) in enumerate(zip(j, p)):
        assert _same(a, b), (i, a, b)


def _c5_gluon():
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    rs = np.random.RandomState(5)
    w = {"weight": rs.randn(4, 3).astype("float32"),
         "bias": rs.randn(4).astype("float32")}
    x = rs.randn(2, 3).astype("float32")
    res = {}
    for pkg in (jmx, mx):
        r = res[pkg.__name__] = {}
        with pkg.cpu():
            net = pkg.gluon.nn.HybridSequential(prefix="c5_")
            with net.name_scope():
                net.add(pkg.gluon.nn.Dense(4, in_units=3))
            net.initialize(ctx=pkg.cpu())
            for k, p in net.collect_params().items():
                p.set_data(pkg.nd.array(w[k.rsplit("_", 1)[1]]))
            calls = []
            net.register_forward_pre_hook(
                lambda b, a: calls.append(("pre", type(b).__name__, len(a))))
            net.register_forward_hook(
                lambda b, a, o: calls.append(("post", o.shape)))
            xa = pkg.nd.array(x, ctx=pkg.cpu())
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out = net.summary(xa)
            r["summary"] = (buf.getvalue(), out.asnumpy())
            r["hooks"] = calls
            seen = []
            net.apply(lambda b: seen.append(type(b).__name__))
            r["apply"] = seen
            params = net.collect_params()
            p0 = params["c5_dense0_weight"]
            r["lists"] = ([d.shape for d in p0.list_data()], p0.list_ctx(),
                          len(p0.list_grad()))
            params.reset_ctx(pkg.cpu())
            r["reset"] = p0.data().asnumpy()
            # the split step: allreduce_grads + update is step
            tr = pkg.gluon.Trainer(params, "sgd", {"learning_rate": 0.5})
            with pkg.autograd.record():
                loss = (net(xa) ** 2).sum()
            loss.backward()
            tr.allreduce_grads()
            tr.update(2)
            r["updated"] = p0.data().asnumpy()
            with tempfile.TemporaryDirectory() as d:
                f = os.path.join(d, "net.params")
                net.save_params(f)
                net.load_params(f, ctx=pkg.cpu())
                r["file"] = sorted(pkg.nd.load(f))
            net.hybridize()
            net(xa)
            net.cast("float64")
            r["cast"] = (str(p0.data().dtype), p0.data().asnumpy(),
                         net(pkg.nd.array(x.astype("float64"),
                                          ctx=pkg.cpu())).asnumpy())
            graph = "_cached_op" if pkg is jmx else "_graph"
            r["cast_dropped_graph"] = getattr(net, graph) is None
            params.setattr("grad_req", "null")
            r["setattr"] = sorted({p.grad_req for p in params.values()})
    j, p = res["mxnet_tpu"], res["mxnet_tpu_torch"]
    for key in j:
        a, b = j[key], p[key]
        if key == "lists":
            a, b = (a[0], len(a[1]), a[2]), (b[0], len(b[1]), b[2])
        assert _same(a, b), (key, a, b)
