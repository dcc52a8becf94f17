"""Shared host-side worker pool for column-parallel codec/ingest work.

The reference engine drives page decode/encode, filter kernels, and result
comparison through a persistent 12-thread pool (``FilterThreadPool``,
reference include/inner_column.h:13-105, global ``filter_tp`` :105). The
TPU framework's device work needs no host threads, but its *host* hot
loops — page codec and CSV ingest — are C functions called through ctypes,
which drops the GIL for the duration of the call, so a plain
``ThreadPoolExecutor`` over columns gives the same parallel speedup the
reference gets. (The pure-Python numpy fallbacks also release the GIL in
their array kernels.)

One process-wide lazy pool, like the reference's global ``filter_tp``;
``parallel_map`` preserves input order and degrades to a serial loop for
single items or when ``RJT_HOST_THREADS=0``.
"""

from __future__ import annotations

import concurrent.futures as _cf
import os
import threading
from typing import Callable, Iterable, List, Sequence, TypeVar

_T = TypeVar("_T")
_R = TypeVar("_R")

_lock = threading.Lock()
_pool: _cf.ThreadPoolExecutor | None = None


def num_threads() -> int:
    env = os.environ.get("RJT_HOST_THREADS")
    if env is not None:
        return max(0, int(env))
    # reference pins 12 (inner_column.h:105); don't exceed the machine
    return min(12, os.cpu_count() or 1)


def pool() -> _cf.ThreadPoolExecutor | None:
    """The shared pool, or None when host threading is disabled."""
    global _pool
    n = num_threads()
    if n <= 1:
        return None
    with _lock:
        if _pool is None:
            _pool = _cf.ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="rjt-host"
            )
        return _pool


def parallel_map(fn: Callable[[_T], _R], items: Sequence[_T]) -> List[_R]:
    """Order-preserving map over ``items``, parallel across the pool.

    Exceptions propagate like a serial loop's (first failing item wins).
    """
    items = list(items)
    p = pool()
    if p is None or len(items) < 2:
        return [fn(x) for x in items]
    return list(p.map(fn, items))
