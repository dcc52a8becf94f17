"""The distributed layer on torch.distributed (port of
radixjoin_tpu/parallel/): one process per rank, gloo for CPU tensors,
NCCL for CUDA tensors."""

from .mesh import Mesh, make_mesh
from .dist_join import DistJoinConfig, distributed_join
from .dist_executor import execute_distributed
from . import multihost

__all__ = [
    "Mesh",
    "make_mesh",
    "DistJoinConfig",
    "distributed_join",
    "execute_distributed",
    "multihost",
]
