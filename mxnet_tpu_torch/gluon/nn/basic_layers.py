"""Basic Gluon layers.

Counterpart of ``Sequential``, ``HybridSequential``, ``Dense``,
``Dropout``, ``BatchNorm``, ``LayerNorm``, ``Embedding``, ``Flatten``,
``Lambda`` and ``HybridLambda`` in
``mxnet_tpu/gluon/nn/basic_layers.py`` (reference
``python/mxnet/gluon/nn/basic_layers.py``); the rest of that module waits
for a later slice.
"""
from __future__ import annotations

import torch

from ... import autograd
from ...ndarray import NDArray
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "LayerNorm", "Embedding", "Flatten", "Lambda", "HybridLambda"]


class Sequential(Block):
    """Stack of Blocks run in order."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def forward(self, x, *args):
        for child in self._children.values():
            x = child(x)
        return x

    def __getitem__(self, idx):
        return list(self._children.values())[idx]

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())


class HybridSequential(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def hybrid_forward(self, F, x):
        for child in self._children.values():
            x = child(x)
        return x

    def __getitem__(self, idx):
        return list(self._children.values())[idx]

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())


class Dense(HybridBlock):
    """Fully-connected layer over the ``FullyConnected`` op."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self._units = units
        self._flatten = flatten
        self._act_type = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out


class Dropout(HybridBlock):
    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        self._rate = rate
        self._axes = tuple(axes)

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis``; the moving statistics are
    ``grad_req="null"`` parameters that a training forward updates (the
    executor's aux rule): ``moving ← moving·momentum + batch·(1 −
    momentum)``."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True,
                grad_req="write" if scale else "null")
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True,
                grad_req="write" if center else "null")
            self.running_mean = self.params.get(
                "running_mean", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                grad_req="null")
            self.running_var = self.params.get(
                "running_var", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                grad_req="null")

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        out = F.BatchNorm(x, gamma, beta, running_mean, running_var,
                          **self._kwargs)
        if isinstance(x, NDArray) and autograd.is_training():
            # eager: fold the batch statistics in here, as the reference's
            # imperative BatchNorm does; in a graph the executor does it
            from ...executor import _bn_aux_update
            moving = (running_mean._data, running_var._data)
            with torch.no_grad():
                upd = _bn_aux_update(self._kwargs, (None, None, None)
                                     + moving, [o._data for o in out])
            for idx, t in zip((3, 4), moving):
                if idx in upd:
                    t.copy_(upd[idx])
        return out[0]


class LayerNorm(HybridBlock):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._axis = axis
        self._eps = epsilon
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         init=gamma_initializer,
                                         allow_deferred_init=True)
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        init=beta_initializer,
                                        allow_deferred_init=True)

    def hybrid_forward(self, F, x, gamma, beta):
        out = F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._eps)
        # keep the normalized output, not the (mean, var) side outputs
        if isinstance(out, (list, tuple)) or (
                hasattr(out, "list_outputs") and len(out.list_outputs()) > 1):
            return out[0]
        return out


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class Flatten(HybridBlock):
    """(N, ...) -> (N, rest)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class Lambda(Block):
    """A function as a block: a callable, or the name of an ``mx.nd``
    function."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd_mod
            function = getattr(nd_mod, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """A function of ``(F, *inputs)`` as a hybrid block, or the name of an
    op (``F.<name>``)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_name = function if isinstance(function, str) else None
        self._func = function

    def hybrid_forward(self, F, *args):
        if self._func_name is not None:
            return getattr(F, self._func_name)(*args)
        return self._func(F, *args)
