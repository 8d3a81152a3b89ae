"""Substrate: typed config registry, logging, the framework error type.

Counterpart of ``mxnet_tpu/base.py``: the ``MXNET_*`` environment knobs are
registered once with a type, default and docstring, and read through
:func:`get_env` (environment first, then the default).
"""
from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Type

__all__ = ["MXNetError", "config", "register_config", "get_env", "logger"]

logger = logging.getLogger("mxnet_tpu_torch")


class MXNetError(RuntimeError):
    """Framework error type (the reference's ``MXNetError``)."""


@dataclass
class _ConfigEntry:
    name: str
    default: Any
    typ: Type
    doc: str = ""


class _ConfigRegistry:
    """Typed, environment-overridable config registry."""

    def __init__(self) -> None:
        self._entries: Dict[str, _ConfigEntry] = {}
        self._lock = threading.Lock()

    def register(self, name: str, default: Any, typ: Type = None,
                 doc: str = "") -> None:
        with self._lock:
            self._entries[name] = _ConfigEntry(name, default,
                                               typ or type(default), doc)

    @staticmethod
    def _coerce(entry: _ConfigEntry, raw: str) -> Any:
        if entry.typ is bool:
            return raw.lower() not in ("0", "false", "off", "")
        return entry.typ(raw)

    def get(self, name: str, default: Any = None) -> Any:
        env = os.environ.get(name)
        entry = self._entries.get(name)
        if env is not None:
            return self._coerce(entry, env) if entry is not None else env
        return entry.default if entry is not None else default


config = _ConfigRegistry()


def register_config(name: str, default: Any, typ: Type = None,
                    doc: str = "") -> None:
    config.register(name, default, typ, doc)


def get_env(name: str, default: Any = None) -> Any:
    return config.get(name, default)


register_config("MXNET_SEED", -1, int,
                "Global PRNG seed; -1 = nondeterministic.")
