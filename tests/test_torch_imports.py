"""PyTorch port, import hygiene: ``mxnet_tpu_torch``, ``chip_smoke.py`` and
the recipe twins (``example/**/*_torch.py``) import neither JAX nor the JAX
package — not even a module of it that does not import JAX."""
import ast
import os
import subprocess
import sys
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _port_files():
    yield os.path.join(ROOT, "chip_smoke.py")
    for twin in ("example/gluon/word_language_model/train_torch.py",
                 "example/rnn/bucketing/lstm_bucketing_torch.py",
                 "example/gluon/transformer_lm_torch.py",
                 "example/ssd/dataset_torch.py",
                 "example/ssd/symbol_ssd_torch.py",
                 "example/ssd/train_torch.py"):
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
            "example/ssd/train_torch.py"} <= rel
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
            "mxnet_tpu_torch.gluon.data.vision.transforms; "
            "sys.path[:0] = ['example/ssd']; "
            "import dataset_torch, symbol_ssd_torch, train_torch; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in %r))" % (FORBIDDEN,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
