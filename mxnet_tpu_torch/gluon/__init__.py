"""Gluon — the imperative model API (counterpart of ``mxnet_tpu/gluon``):
parameters, blocks (``SymbolBlock`` for a saved graph), the layers of the
causal TransformerLM, BatchNorm, the conv and pooling layers, losses, the
Trainer and the vision model zoo."""
from .parameter import (Parameter, Constant, ParameterDict,  # noqa: F401
                        DeferredInitializationError)
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import contrib  # noqa: F401
from . import model_zoo  # noqa: F401
