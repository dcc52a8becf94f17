"""Radix shuffle: hash-partitioned all-to-all exchange (port of
radixjoin_tpu/parallel/shuffle.py).

Each rank bucketizes its rows by ``murmur64(key) mod ndev`` (unsigned, as
the JAX package's uint64 arithmetic), scatters them into a static
``(ndev, capacity)`` send buffer, and one ``all_to_all`` per array swaps
bucket ``d`` to rank ``d``. Rows beyond ``capacity`` in any bucket are
dropped *and counted*; the caller reads the summed overflow and retries
with a larger capacity, so results are exact, never truncated.

:func:`dest_of` and :func:`bucketize` are per-rank code with no
collective: they equal the JAX functions bit for bit and dtype for dtype.
The exchanging functions take the :class:`~.mesh.Mesh` in place of the
named mesh axis.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.hashing import murmur64, umod
from . import multihost


def dest_of(keys: torch.Tensor, ndev: int) -> torch.Tensor:
    """Destination rank of each key (high-entropy radix of the hash)."""
    return umod(murmur64(keys), ndev).to(torch.int32)


def bucketize(keys, valid, payloads: Dict[str, torch.Tensor], ndev: int,
              capacity: int, keep=None, chunk_ids=None, chunks: int = 1):
    """Scatter local rows into a ``(ndev, capacity)`` send layout — or, with
    ``chunks > 1``, a ``(chunks, ndev, capacity)`` layout from one stable
    sort keyed by (chunk, destination).

    ``keep`` optionally masks rows out of the exchange (the skew path's
    hot rows). Invalid rows are dropped. Returns ``(send_keys, send_valid,
    send_payloads, overflow_count)``; the buffers keep their dtypes, the
    count is int64 (on the device)."""
    n = keys.shape[0]
    dev = keys.device
    nb = ndev * chunks  # real buckets, chunk-major
    live = valid if keep is None else (valid & keep)
    dest = dest_of(keys, ndev)
    if chunks > 1:
        dest = chunk_ids * ndev + dest
    dest = torch.where(live, dest, torch.full_like(dest, nb))

    # stable bucket order: rows sorted by (chunk, destination, row id)
    dest_sorted, perm = torch.sort(dest, stable=True)

    # a histogram by scatter-add: torch.bincount sizes its output from the
    # data's maximum, a host sync on the card
    counts = torch.zeros(nb + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, dest.long(), torch.ones(n, dtype=torch.int64, device=dev))[:nb]
    offsets = torch.cumsum(counts, 0) - counts  # exclusive, per real bucket
    starts = torch.cat([offsets, offsets.new_full((1,), n)]).to(torch.int32)
    rank = torch.arange(n, dtype=torch.int32, device=dev) - starts[
        dest_sorted.long()]

    in_cap = (rank < capacity) & (dest_sorted < nb)
    flat_idx = torch.where(in_cap, dest_sorted.long() * capacity + rank,
                           nb * capacity)

    shape = (chunks, ndev, capacity) if chunks > 1 else (ndev, capacity)

    def scatter(values):
        buf = torch.zeros(nb * capacity + 1, dtype=values.dtype, device=dev)
        buf[flat_idx] = values[perm]
        return buf[:-1].reshape(shape)

    send_keys = scatter(keys)
    send_valid = scatter(live)
    send_payloads = {k: scatter(v) for k, v in payloads.items()}
    overflow = torch.clamp(counts - capacity, min=0).sum()
    return send_keys, send_valid, send_payloads, overflow


def exchange(buf: torch.Tensor, mesh, async_op: bool = False):
    """All-to-all: row d of the local ``(ndev, capacity)`` buffer goes to
    rank d; row s of the result came from rank s. Returns ``(flat
    received rows, work)`` (``work`` None unless ``async_op``)."""
    out, work = multihost.all_to_all(buf, mesh, async_op=async_op)
    return out.reshape(-1), work


def shuffle(keys, valid, payloads: Dict[str, torch.Tensor], mesh,
            capacity: int, keep=None):
    """Full hash shuffle of one side. Returns the received rows, flattened
    to ``(ndev*capacity,)``, plus the overflow count summed over ranks."""
    send_keys, send_valid, send_payloads, overflow = bucketize(
        keys, valid, payloads, mesh.size, capacity, keep)
    recv_keys = exchange(send_keys, mesh)[0]
    recv_valid = exchange(send_valid, mesh)[0]
    recv_payloads = {k: exchange(v, mesh)[0]
                     for k, v in send_payloads.items()}
    total_overflow = multihost.all_reduce_sum(overflow, mesh)
    return recv_keys, recv_valid, recv_payloads, total_overflow


def shuffle_chunked(keys, valid, payloads: Dict[str, torch.Tensor], mesh,
                    chunks: int, capacity: int, chunk_ids, keep=None):
    """Chunked hash shuffle: one sort bucketizes every row by (chunk,
    destination), then every chunk's ``(ndev, capacity)`` slab rides its own
    all-to-alls, all issued at once with ``async_op``: chunk c+1's exchange
    is in flight while chunk c joins. Returns ``([(keys, valid, payloads,
    works)] per chunk, overflow)``; wait on a chunk's ``works`` before
    reading its rows."""
    send_keys, send_valid, send_payloads, overflow = bucketize(
        keys, valid, payloads, mesh.size, capacity, keep,
        chunk_ids=chunk_ids, chunks=chunks)
    out = []
    for c in range(chunks):
        works = []

        def recv(buf):
            flat, work = exchange(buf[c], mesh, async_op=True)
            works.append(work)
            return flat

        rk = recv(send_keys)
        rv = recv(send_valid)
        rp = {k: recv(v) for k, v in send_payloads.items()}
        out.append((rk, rv, rp, works))
    return out, multihost.all_reduce_sum(overflow, mesh)


def global_histogram(keys, valid, num_buckets: int, mesh):
    """Histogram over hash buckets summed over the ranks — the distributed
    analogue of the reference's serial radix histogram
    (src/execute.cpp:124-132)."""
    h = umod(murmur64(keys), num_buckets)
    h = torch.where(valid, h, torch.full_like(h, num_buckets))
    local = torch.zeros(num_buckets + 1, dtype=torch.int64,
                        device=keys.device).scatter_add_(
        0, h, torch.ones_like(h))[:num_buckets]
    return multihost.all_reduce_sum(local, mesh)
