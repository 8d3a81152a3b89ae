"""Generic named-class registry (``mx.registry``).

Counterpart of ``mxnet_tpu/registry.py`` (reference
``python/mxnet/registry.py``): factory helpers for registries of classes.
Register a class under a (lowercase) name; create an instance from a name,
a ``{nickname: name, ...}`` dict, a JSON string ``'["name", {...}]'``, or
pass an existing instance through.
"""
from __future__ import annotations

import json
import warnings
from typing import Any, Dict, Type

from .base import MXNetError

_REGISTRIES: Dict[type, Dict[str, type]] = {}


def get_registry(base_class: type) -> Dict[str, type]:
    """The (name -> class) dict for a base class (copy-safe view)."""
    return dict(_REGISTRIES.setdefault(base_class, {}))


def get_register_func(base_class: type, nickname: str):
    """Build a ``register(klass, name=None)`` function for ``base_class``."""
    registry = _REGISTRIES.setdefault(base_class, {})

    def register(klass: type, name: str = None):
        assert issubclass(klass, base_class), \
            "Can only register subclass of %s" % base_class.__name__
        if name is None:
            name = klass.__name__
        name = name.lower()
        if name in registry and registry[name] is not klass:
            warnings.warn(
                "New %s %s.%s registered with name %s is overriding existing "
                "%s %s.%s" % (nickname, klass.__module__, klass.__name__, name,
                              nickname, registry[name].__module__,
                              registry[name].__name__), UserWarning)
        registry[name] = klass
        return klass

    register.__doc__ = "Register %s to the %s factory" % (nickname, nickname)
    return register


def get_alias_func(base_class: type, nickname: str):
    """Build an ``alias(*names)`` decorator for ``base_class``."""
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for name in aliases:
                register(klass, name)
            return klass
        return reg
    return alias


def get_create_func(base_class: type, nickname: str):
    """Build a ``create(spec, **kwargs)`` factory for ``base_class``."""
    registry = _REGISTRIES.setdefault(base_class, {})

    def create(*args, **kwargs):
        if len(args):
            name = args[0]
            args = args[1:]
        else:
            name = kwargs.pop(nickname)

        if isinstance(name, base_class):
            assert len(args) == 0 and len(kwargs) == 0, \
                "%s is already an instance. Additional arguments are invalid" % nickname
            return name

        if isinstance(name, dict):
            return create(**name)

        assert isinstance(name, str), "%s must be of string type" % nickname
        if name.startswith('['):
            assert not args and not kwargs
            name, kwargs = json.loads(name)
            return create(name, **kwargs)

        name = name.lower()
        if name not in registry:
            raise MXNetError("%s is not registered. Please register with "
                             "register.%s first" % (name, nickname))
        return registry[name](*args, **kwargs)

    create.__doc__ = "Create a %s instance from config" % nickname
    return create
