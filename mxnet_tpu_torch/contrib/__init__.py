"""``mx.contrib`` of the port (reference ``python/mxnet/contrib``): the
int8 entry points :mod:`.quantization`. The other modules of the JAX package's
``contrib`` (amp, onnx, text, svrg, tensorboard, tensorrt, control flow)
wait for ROADMAP A9."""
from . import quantization

__all__ = ["quantization"]
