"""The device set of a trainer.

Counterpart of ``local_mesh`` in ``mxnet_tpu/parallel/mesh.py``: where the
JAX package lays devices out on a ``jax.sharding.Mesh`` with named axes,
the port's :class:`Mesh` names the cards a trainer runs on. This slice runs
one card per process, so a mesh holds one device: ``gpu(0)`` unless the
caller asks for another (``cpu()`` in the tests). More than one device
waits for the NCCL data-parallel trainer (ROADMAP A1).
"""
from __future__ import annotations

from typing import Sequence, Tuple

from ..context import Context, current_context

__all__ = ["Mesh", "local_mesh"]


class Mesh:
    """Devices (``Context``s) along named axes; one device here."""

    def __init__(self, devices: Sequence[Context], axis_names: Tuple[str]):
        devices = list(devices)
        if len(devices) != 1:
            raise NotImplementedError(
                f"a mesh of {len(devices)} devices: the port's trainer runs "
                f"one card per process; the NCCL multi-card "
                f"DataParallelTrainer waits for ROADMAP A1")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    def __repr__(self):
        return f"Mesh({self.devices}, {self.axis_names})"


def local_mesh(axis: str = "dp", devices=None) -> Mesh:
    """A one-axis mesh over ``devices`` (default: the current context,
    ``gpu(0)`` outside a ``with mx.cpu():`` scope)."""
    return Mesh([Context(d) for d in (devices or [current_context()])],
                (axis,))
