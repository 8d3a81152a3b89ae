"""Operator library of the PyTorch port: importing it registers every op."""
from . import registry
from . import (matrix, broadcast_reduce, elemwise, index, nn,  # noqa: F401
               init_ops, rnn, multibox, hopper_kernels)
