"""``mx.parallel`` — data-parallel training (counterpart of
``mxnet_tpu/parallel``): ``DataParallelTrainer`` on one card and the mesh
that names it. Multi-card training over NCCL, ring and Ulysses attention,
tensor, pipeline and expert parallelism and the collectives wait for
ROADMAP A1 and A8."""
from .data_parallel import DataParallelTrainer
from .mesh import Mesh, local_mesh

__all__ = ["DataParallelTrainer", "Mesh", "local_mesh"]
