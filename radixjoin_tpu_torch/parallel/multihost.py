"""Process-group bring-up and the host <-> mesh transfers (port of
radixjoin_tpu/parallel/multihost.py).

One process per rank, each owning one device. Every rank holds the same
host inputs (the replicated-input contract: every process constructs the
same ``Plan`` with the same base tables from deterministic loaders) and
uploads only its own row slice (:func:`put_sharded`); a result leaves the
mesh by an all-gather to every rank and one host transfer
(:func:`fetch_many`), so every rank reads the same values and takes the
same decisions from them.

All collectives of the layer go through :func:`all_to_all`,
:func:`all_reduce_sum` and :func:`all_gather`, which exist on gloo and on
NCCL alike and count their calls and bytes (:func:`collective_stats`);
every host transfer goes through :func:`to_host`, which counts its round
trips (``host_syncs``).
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh

#: per process: collective calls, the bytes this rank sent in them, and the
#: host round trips of :func:`to_host`
COLLECTIVE_STATS = {"calls": 0, "bytes": 0, "host_syncs": 0}


def collective_stats() -> dict:
    return dict(COLLECTIVE_STATS)


def reset_collective_stats() -> None:
    for k in COLLECTIVE_STATS:
        COLLECTIVE_STATS[k] = 0


def init(coordinator: str, num_processes: int, process_id: int,
         device=None, backend: Optional[str] = None) -> None:
    """Join the process group at ``tcp://coordinator`` as rank
    ``process_id`` of ``num_processes`` (idempotent per process).

    The backend follows the device: NCCL for the card (``device=None``
    means ``cuda:<local rank>``, and ``torch.cuda.set_device`` comes before
    the group), gloo for ``"cpu"``. ``backend`` overrides that choice
    explicitly (gloo can also carry CUDA tensors, staged through the host);
    a backend that fails to come up raises, nothing falls back."""
    if dist.is_initialized():
        return
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "multihost.init(): CUDA is not available; pass device='cpu' "
                "for a gloo group on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id)


def free_port() -> int:
    """A free TCP port on localhost, for a group's ``tcp://`` rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def active() -> bool:
    """True when more than one rank shares the group."""
    return dist.is_initialized() and dist.get_world_size() > 1


# ---------------------------------------------------------------------------
# collectives (counted)
# ---------------------------------------------------------------------------


def _wire(t: torch.Tensor) -> torch.Tensor:
    """Bool travels as its bytes: both backends carry uint8."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _count(t: torch.Tensor) -> None:
    COLLECTIVE_STATS["calls"] += 1
    COLLECTIVE_STATS["bytes"] += t.numel() * t.element_size()


def all_to_all(buf: torch.Tensor, mesh: Mesh, async_op: bool = False):
    """Row ``d`` of the ``(size, ...)`` buffer goes to rank ``d``; row ``s``
    of the result came from rank ``s``. Returns ``(out, work)``; ``work``
    is None unless ``async_op``, and ``out`` may be read only after
    ``work.wait()``."""
    send = _wire(buf)
    recv = torch.empty_like(send)
    _count(send)
    work = dist.all_to_all_single(recv, send, group=mesh.group,
                                  async_op=async_op)
    out = recv.view(torch.bool) if buf.dtype == torch.bool else recv
    return out, work


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise sum over the ranks (a new tensor)."""
    out = _wire(t).clone()
    _count(out)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along axis 0 in rank
    order, on every rank."""
    send = _wire(t)
    out = torch.empty((mesh.size * send.shape[0],) + tuple(send.shape[1:]),
                      dtype=send.dtype, device=send.device)
    _count(send)
    with warnings.catch_warnings():
        # torch 2.13 points to all_gather_single, which older torches lack
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, send, group=mesh.group)
    return out.view(torch.bool) if t.dtype == torch.bool else out


# ---------------------------------------------------------------------------
# host <-> mesh
# ---------------------------------------------------------------------------


def _upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.array(array))  # a copy: never aliases the input
    if device.type != "cuda":
        return t
    # pinned staging: the copy is asynchronous, so an upload makes no host
    # sync (the host allocator keeps the staging block until it is done)
    return t.pin_memory().to(device, non_blocking=True)


def put_sharded(array: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """This rank's row slice ``[r·per, (r+1)·per)`` of a host array whose
    length is a multiple of the group size, on ``mesh.device``."""
    per = array.shape[0] // mesh.size
    if per * mesh.size != array.shape[0]:
        raise ValueError(f"put_sharded: {array.shape[0]} rows do not split "
                         f"into {mesh.size} equal shards")
    return _upload(array[mesh.rank * per:(mesh.rank + 1) * per], mesh.device)


def put_replicated(array: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """The whole host array on ``mesh.device`` (every rank uploads it)."""
    return _upload(array, mesh.device)


def to_host(tensors: Sequence[torch.Tensor], mesh: Mesh) -> List[np.ndarray]:
    """One host transfer for the whole batch: on the card every copy starts
    (into pinned memory) before the one synchronisation."""
    COLLECTIVE_STATS["host_syncs"] += 1
    if mesh.device.type != "cuda":
        return [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(mesh.device).synchronize()
    return [h.numpy() for h in host]


def fetch_many(tensors: Sequence[torch.Tensor],
               mesh: Mesh) -> List[np.ndarray]:
    """Sharded tensors -> full host arrays (rank order), valid on every
    rank: one all-gather each (none on a one-rank group), then one host
    transfer for the batch."""
    full = list(tensors) if mesh.size == 1 else [
        all_gather(t, mesh) for t in tensors]
    return to_host(full, mesh)


def fetch(t: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """One sharded tensor -> the full host array, on every rank."""
    return fetch_many([t], mesh)[0]
