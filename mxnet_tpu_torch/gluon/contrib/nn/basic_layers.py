"""Contrib layers (counterpart of
``mxnet_tpu/gluon/contrib/nn/basic_layers.py``; reference
``gluon/contrib/nn/basic_layers.py``)."""
from __future__ import annotations

from .... import ndarray as nd
from ...block import Block, HybridBlock
from ...nn.basic_layers import BatchNorm, HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm"]


class Concurrent(Sequential):
    """Runs each child on the same input and concatenates their outputs
    along ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        out = [block(x) for block in self._children.values()]
        return nd.concat(*out, dim=self.axis)


class HybridConcurrent(HybridSequential):
    """The hybridizable :class:`Concurrent`."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.concat(*out, dim=self.axis)


class Identity(HybridBlock):
    """Returns its input (a branch of a :class:`Concurrent`)."""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Block):
    """Embedding whose weight declares a ``row_sparse`` gradient (the
    reference's ``sparse_grad=True``). As in the JAX package, the weight
    and its gradient are dense; the gradient is zero outside the rows a
    batch touched, and ``nd.sparse.row_sparse_array(weight.grad())`` gives
    those rows as a
    :class:`~mxnet_tpu_torch.ndarray.sparse.RowSparseNDArray`."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype, "sparse_grad": True}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype, grad_stype="row_sparse")

    def forward(self, x):
        return nd.Embedding(x, self.weight.data(),
                            input_dim=self._kwargs["input_dim"],
                            output_dim=self._kwargs["output_dim"])

    def __repr__(self):
        s = "{name}({input_dim} -> {output_dim}, {dtype})"
        return s.format(name=self.__class__.__name__, **self._kwargs)


class SyncBatchNorm(BatchNorm):
    """Cross-device synchronized BatchNorm (reference: a CUDA allreduce of
    the statistics). On one device it is BatchNorm, as in the JAX package;
    ``num_devices`` is accepted and ignored (a multi-card port waits for
    ROADMAP A1d)."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, **kwargs):
        super().__init__(momentum=momentum, epsilon=epsilon,
                         in_channels=in_channels, **kwargs)
        self._num_devices = num_devices
