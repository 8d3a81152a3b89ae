"""Gluon — the imperative model API (counterpart of ``mxnet_tpu/gluon``):
parameters, blocks (``SymbolBlock`` for a saved graph), the layers of the
causal TransformerLM, BatchNorm, the conv and pooling layers, the
recurrent layers and cells, losses, the Trainer, the vision model zoo,
``utils`` and ``data``."""
from .parameter import (Parameter, Constant, ParameterDict,  # noqa: F401
                        DeferredInitializationError)
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import contrib  # noqa: F401
from . import model_zoo  # noqa: F401
from . import rnn  # noqa: F401
from . import utils  # noqa: F401
from . import data  # noqa: F401
