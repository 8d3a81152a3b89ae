"""Gluon contrib (counterpart of ``mxnet_tpu/gluon/contrib``): in this
slice, the transformer blocks."""
from . import transformer  # noqa: F401
