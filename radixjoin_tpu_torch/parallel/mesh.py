"""The group of ranks the distributed layer runs over (port of
radixjoin_tpu/parallel/mesh.py).

The JAX package runs one controller over a 1-D device mesh inside
``shard_map``. This port runs one process per rank, each owning one
device, joined by a ``torch.distributed`` process group: gloo for CPU
tensors, NCCL for CUDA tensors. :class:`Mesh` names that group, this
process's rank in it and the device its shard lives on. Every public
function of the distributed layer is collective: every rank of the group
calls it with the same plan and the same host inputs, and every rank gets
the same full result.

``SHARD_AXIS``, ``shard_axis`` and ``replicated`` have no counterpart: a
rank holds its row slice as a plain tensor on its device, and a value
every rank needs is uploaded by every rank.
"""

from __future__ import annotations

import dataclasses
import os
import torch
import torch.distributed as dist


@dataclasses.dataclass(eq=False)
class Mesh:
    """One process group and this rank's place in it. Compared and hashed
    by identity, as a JAX mesh object is in the learned-state keys."""

    group: object  # torch.distributed ProcessGroup
    rank: int
    size: int
    device: torch.device
    backend: str


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of ``group`` (default: the world group) with this rank's
    shard on ``device``. ``device=None`` means the card (``cuda:<local
    rank>``) and raises without CUDA; pass ``"cpu"`` to run on the CPU.
    Raises when no process group is initialised (``multihost.init``) and
    when the group's backend cannot carry tensors of that device."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh(): no torch.distributed process group is "
            "initialised; call radixjoin_tpu_torch.parallel.multihost.init "
            "first")
    group = group if group is not None else dist.group.WORLD
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(): CUDA is not available; pass device='cpu' to "
                "run on the CPU")
        device = torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK",
                                       torch.cuda.current_device())))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = str(dist.get_backend(group))
    if backend == "nccl" and device.type != "cuda":
        raise RuntimeError(f"make_mesh(): an NCCL group cannot carry "
                           f"{device} tensors")
    if backend not in ("nccl", "gloo"):
        raise RuntimeError(f"make_mesh(): backend {backend!r} is neither "
                           f"gloo nor nccl")
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                device, backend)
