"""The pinned host blocks that large device-to-host fetches land in.

A device-to-host copy into a fresh pageable array first touches every
4 KiB page of its destination, on one thread: glibc serves an allocation
above 32 MiB with a new ``mmap``, and CUDA stages the copy through
its own pinned buffer. A root column of pages (150-340 MB at IMDB's scale
1.0) crossed that way at about 2 GB/s. A pinned block that is reused is
never faulted again, and the copy engine writes it directly.

:class:`PinnedPool` keeps its blocks itself, by size class, and never
frees one. :meth:`PinnedPool.copy` starts a tensor's copy into a block on
the current stream and returns the host array it lands in. The array's
base is a :class:`Lease` of the block; numpy keeps the lease as the base
of the array and of every view of it (``torch.from_numpy`` included), so
the block comes back to the pool only when the last of them is gone. A
block taken again first waits for the event of its last copy.

The pool's capacity, live and free blocks together, is held to
:func:`bound_bytes`: ``min(CEILING_BYTES, MemTotal / 8)``, 16 GiB or an
eighth of the host's memory. A copy that would need a new block past the
bound is turned away (counted as ``pageable_fallbacks``), and the caller
fetches that tensor the pageable way. Blocks come in powers of two
(:func:`size_class`).
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

#: a CUDA tensor of at least this many bytes is fetched into the pool:
#: glibc's largest ``mmap`` threshold, above which every fresh host array
#: is a new mapping that the copy faults in
MIN_BYTES = 32 << 20
#: the most the pool holds on any host, live and free blocks together
CEILING_BYTES = 16 << 30

#: the dtypes the port fetches (pages, validity, int32 / int64 values), as
#: numpy reads them
_NUMPY = {torch.uint8: np.dtype(np.uint8), torch.bool: np.dtype(np.bool_),
          torch.int32: np.dtype(np.int32), torch.int64: np.dtype(np.int64)}


def size_class(nbytes: int) -> int:
    """The size of the block that serves a request of ``nbytes``: the
    power of two at or above it. PyTorch's pinned host allocator rounds
    every allocation up to one (a block asked for 339,148,800 bytes pins
    536,870,912 on the H100's host), so the pool asks for what it gets,
    and its capacity counts the bytes it pins."""
    return 1 << max(0, nbytes - 1).bit_length()


def bound_bytes(meminfo: str = "/proc/meminfo") -> int:
    """``min(CEILING_BYTES, MemTotal / 8)``; 0 (no pool) where ``meminfo``
    has no ``MemTotal`` line or cannot be read."""
    try:
        with open(meminfo) as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    kib = int(line.split()[1])
                    return min(CEILING_BYTES, kib * 1024 // 8)
    except OSError:
        pass
    return 0


def eligible(t: torch.Tensor) -> bool:
    """True for a tensor the fetch takes through the pool: a CUDA tensor
    of at least :data:`MIN_BYTES` of one of the port's dtypes."""
    return t.is_cuda and t.nbytes >= MIN_BYTES and t.dtype in _NUMPY


def pooled(a: np.ndarray) -> bool:
    """True when ``a`` (or the array it views) lies in a pool block."""
    return isinstance(a.base, Lease)


def _pinned_block(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class Lease:
    """The base object of one host array over a pool block: its
    ``__array_interface__`` points numpy at the block's first bytes, and
    it holds the block while any array over it lives."""

    __slots__ = ("__array_interface__", "block", "__weakref__")

    def __init__(self, block: torch.Tensor, dtype: np.dtype, shape: tuple):
        self.block = block
        self.__array_interface__ = {
            "version": 3, "shape": shape, "typestr": dtype.str,
            "data": (block.data_ptr(), False)}


class PinnedPool:
    """Pinned host blocks by size class, made on demand up to ``capacity``
    bytes and never freed. ``stats`` is the ``trace.Counters`` group that
    counts what the pool does (``pinned_arrays``, ``pinned_bytes``,
    ``pool_allocs``, ``pageable_fallbacks``, ``pool_bytes``); ``alloc``
    makes a block of a given size (pinned ``torch.empty`` by default)."""

    def __init__(self, capacity: int, stats,
                 alloc: Optional[Callable[[int], torch.Tensor]] = None):
        self.capacity = capacity
        self._stats = stats
        self._alloc = alloc or _pinned_block
        #: size class -> free blocks, each with the event of its last copy
        self._free: Dict[int, List[Tuple[torch.Tensor, object]]] = {}
        self._made = 0
        self._lock = threading.Lock()

    @property
    def made_bytes(self) -> int:
        """The pool's capacity now: every block made, live or free."""
        with self._lock:
            return self._made

    def free_blocks(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._free.values())

    def _take(self, size: int):
        """A free block of ``size`` bytes, or a new one; None when a new
        one would take the pool past its capacity."""
        with self._lock:
            free = self._free.get(size)
            if free:
                block, last = free.pop()
                made = False
            elif self._made + size > self.capacity:
                return None
            else:
                self._made += size
                made = True
        if not made:
            if last is not None:
                last.synchronize()  # a copy that was never waited for
            return block
        try:
            block = self._alloc(size)
        except BaseException:
            with self._lock:
                self._made -= size
            raise
        self._stats.add("pool_allocs")
        self._stats.add("pool_bytes", size)
        return block

    def _give(self, block: torch.Tensor, event) -> None:
        with self._lock:
            self._free.setdefault(block.numel(), []).append((block, event))

    def copy(self, t: torch.Tensor, event) -> Optional[np.ndarray]:
        """Start the copy of ``t`` into a block, non-blocking on the current
        stream, and return the host array of ``t``'s dtype and shape it
        lands in: valid once ``event``, which the caller records after its
        copies, has passed (``event`` is None where there is nothing to
        wait for). None, counted as a pageable fallback, when the pool's
        capacity turns ``t`` away."""
        block = self._take(size_class(t.nbytes))
        if block is None:
            self._stats.add("pageable_fallbacks")
            return None
        lease = Lease(block, _NUMPY[t.dtype], tuple(t.shape))
        weakref.finalize(lease, self._give, block, event)
        out = np.asarray(lease)
        torch.from_numpy(out).copy_(t, non_blocking=True)
        self._stats.add("pinned_arrays")
        self._stats.add("pinned_bytes", t.nbytes)
        return out
