"""``mx.nd.contrib`` — the experimental-op namespace.

Counterpart of ``mxnet_tpu/ndarray/contrib.py`` (reference
``python/mxnet/ndarray/register.py``, which puts every ``_contrib_*``
registration under ``contrib``): ``mx.nd.contrib.MultiBoxPrior(...)``
calls the op registered as ``_contrib_MultiBoxPrior``. ``foreach``,
``while_loop``, ``cond`` and the ``dgl_*`` graph functions wait for the
port's ``contrib`` package (ROADMAP A9).
"""
from __future__ import annotations

from ..ops.registry import _REGISTRY


def __getattr__(name: str):
    from . import __getattr__ as _nd_getattr
    for cand in (f"_contrib_{name}", f"contrib_{name}"):
        try:
            return _nd_getattr(cand)
        except AttributeError:
            continue
    raise AttributeError(
        f"module 'mxnet_tpu_torch.ndarray.contrib' has no attribute {name!r}")


def __dir__():
    return sorted(n[len("_contrib_"):] for n in _REGISTRY
                  if n.startswith("_contrib_"))
