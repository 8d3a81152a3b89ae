"""Gluon contrib (counterpart of ``mxnet_tpu/gluon/contrib``; reference
``python/mxnet/gluon/contrib``): the estimator with its event handlers,
the contrib layers, the contrib and convolutional recurrent cells, the
interval sampler and the transformer blocks."""
from . import estimator  # noqa: F401
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import data  # noqa: F401
from . import transformer  # noqa: F401
