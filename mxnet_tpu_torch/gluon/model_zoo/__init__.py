"""Model zoo (reference: ``python/mxnet/gluon/model_zoo``; counterpart of
``mxnet_tpu/gluon/model_zoo``). Pretrained weights are not downloaded:
ResNet's ``pretrained=True`` raises, as in the JAX package."""
from . import vision
from .vision import get_model
