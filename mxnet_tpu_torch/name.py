"""Automatic naming of symbol nodes.

Counterpart of ``mxnet_tpu/name.py`` (reference ``python/mxnet/name.py``):
``NameManager`` is a thread-local scope stack that names anonymous ops
``{hint}{counter}``, and ``Prefix`` prepends a fixed prefix to every name.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["NameManager", "Prefix"]


class NameManager:
    """Assigns ``{op}{counter}`` names to anonymous symbols."""

    _state = threading.local()

    def __init__(self):
        self._counter: Dict[str, int] = {}
        self._old_manager: Optional["NameManager"] = None

    def get(self, name: Optional[str], hint: str) -> str:
        if name:
            return name
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return f"{hint}{n}"

    def __enter__(self):
        self._old_manager = NameManager.current()
        NameManager._state.current = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._state.current = self._old_manager

    @staticmethod
    def current() -> "NameManager":
        if not hasattr(NameManager._state, "current"):
            NameManager._state.current = NameManager()
        return NameManager._state.current


class Prefix(NameManager):
    """NameManager that prepends ``prefix`` to every name."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name: Optional[str], hint: str) -> str:
        return self._prefix + super().get(name, hint)
