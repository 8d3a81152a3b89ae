"""``mx.sym.contrib`` — the symbolic experimental-op namespace.

Counterpart of ``mxnet_tpu/symbol/contrib.py`` (see
:mod:`mxnet_tpu_torch.ndarray.contrib`; reference
``python/mxnet/symbol/register.py``).
"""
from __future__ import annotations

from ..ops.registry import _REGISTRY


def __getattr__(name: str):
    from . import __getattr__ as _sym_getattr
    for cand in (f"_contrib_{name}", f"contrib_{name}"):
        try:
            return _sym_getattr(cand)
        except AttributeError:
            continue
    raise AttributeError(
        f"module 'mxnet_tpu_torch.symbol.contrib' has no attribute {name!r}")


def __dir__():
    return sorted(n[len("_contrib_"):] for n in _REGISTRY
                  if n.startswith("_contrib_"))
