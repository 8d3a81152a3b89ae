"""Symbol attribute scoping.

Counterpart of ``mxnet_tpu/attribute.py`` (reference
``python/mxnet/attribute.py``): ``AttrScope`` is a thread-local stack of
attribute dicts applied to every symbol created inside the ``with`` block
(``ctx_group`` placement, ``__lr_mult__``/``__wd_mult__`` and the like).
The attributes land in each node's attribute dict (``Symbol.attr``,
``list_attr``, ``attr_dict``), as in the JAX package.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from .base import MXNetError

__all__ = ["AttrScope"]


class AttrScope:
    """Attribute manager appending scope attrs to each created symbol."""

    _state = threading.local()

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise MXNetError("AttrScope values must be strings")
        self._attr: Dict[str, str] = kwargs
        self._old_scope: Optional["AttrScope"] = None

    def get(self, attr: Optional[Dict[str, str]]) -> Dict[str, str]:
        """Merge scope attrs with per-symbol ``attr`` (symbol wins)."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        self._old_scope = AttrScope.current()
        attr = self._old_scope._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._state.current = self
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope._state.current = self._old_scope

    @staticmethod
    def current() -> "AttrScope":
        if not hasattr(AttrScope._state, "current"):
            AttrScope._state.current = AttrScope()
        return AttrScope._state.current
