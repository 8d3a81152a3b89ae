"""Operator library of the PyTorch port: importing it registers every op."""
from . import registry
from . import matrix, broadcast_reduce, index, nn, hopper_kernels  # noqa: F401
