"""Graph passes: rewrites over Symbol graphs.

Counterpart of ``mxnet_tpu/passes``. ``Module`` and
:class:`~mxnet_tpu_torch.parallel.DataParallelTrainer` run the default
pipeline (``fold``, ``layout``, ``s2d``, ``fusion``) unless constructed
with ``passes=False``; ``MXNET_PASSES`` tunes it.

    from mxnet_tpu_torch import passes
    res = passes.PassManager().run(sym, shapes={"data": (8, 3, 224, 224)})
    res.symbol          # the rewritten graph
    res.counts          # rewrite counts by pass
    res.var_transforms  # value transforms of re-homed parameters
"""
from .manager import (Pass, PassContext, PassManager, PassResult,
                      DEFAULT_PIPELINE, PASS_REGISTRY, register_pass,
                      default_names, resolve, annotate_graph, apply_spec,
                      spec_shape, provenance, Namer, is_barrier,
                      s2d_weight_forward, s2d_weight_inverse)
# importing the pass modules fills PASS_REGISTRY
from .fold import ConstantFoldPass
from .layout import LayoutPass
from .s2d import SpaceToDepthPass
from .fusion import FusionReorderPass
# the quantization passes register too (quantize/requantize/dequantize)
# but stay opt-in, never in DEFAULT_PIPELINE; imported as a module so the
# quant -> passes -> quant cycle resolves from either side
from ..quant import qpass as _quant_qpass  # noqa: F401

__all__ = ["Pass", "PassContext", "PassManager", "PassResult",
           "DEFAULT_PIPELINE", "PASS_REGISTRY", "register_pass",
           "default_names", "resolve", "annotate_graph", "apply_spec",
           "spec_shape", "provenance", "Namer", "is_barrier",
           "s2d_weight_forward", "s2d_weight_inverse",
           "ConstantFoldPass", "LayoutPass", "SpaceToDepthPass",
           "FusionReorderPass"]
