"""PyTorch port, import hygiene: ``mxnet_tpu_torch``, ``chip_smoke.py`` and
the recipe twins (``example/**/*_torch.py``) import neither JAX nor the JAX
package — not even a module of it that does not import JAX; and the JAX
package's public aliases are there (``mx.kv``, ``mx.nd.sparse``, the lazy
``mx.serving``,
``mx.interop``, ``mx.engine``, ``mx.registry``, ``mx.util`` and
``mx.test_utils``, ``mx.nd.contrib`` and ``mx.sym.contrib``, ``gluon.split_and_load``/``split_data``/
``clip_global_norm``, ``autograd.set_recording``/``set_training``/
``get_symbol``)."""
import ast
import os
import subprocess
import sys

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
        | set(SLICE_12_TWINS) | set(SLICE_13_TWINS) | set(SLICE_15) <= rel
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
