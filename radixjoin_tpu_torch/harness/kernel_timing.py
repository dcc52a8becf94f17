"""Timing a call on the CUDA card three ways: CUDA events around calls made
back to back, the device time ``torch.profiler`` records for the kernels
and copies the call launches, and the host time to issue a call.

The event bracket is what a caller waits for when calls follow each other;
it is the card's time only while one call keeps the card busier than the
wrapper's host work keeps the host. The profiler's device time is the
card's alone; the enqueue time is the host's alone. :func:`profile_busy`
gives a whole run's device busy time and idle share. Used by
``chip_smoke.py`` and ``radixjoin_tpu_torch/bench.py``.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Optional

import torch

#: bytes written to push a call's inputs out of the H100's 50 MB L2
L2_FLUSH_BYTES = 64 << 20


def bracket_ms(fn: Callable, runs: int = 10, inner: int = 5,
               warmup: int = 3) -> float:
    """Median milliseconds per call over ``runs`` brackets of ``inner``
    back-to-back warm calls between two CUDA events. Back to back, the
    host's work for a call (allocating outputs, the launch) overlaps the
    card's work for the call before, so a call that keeps the card busy
    longer than the host is timed on the card alone. A call of more than
    5 ms is timed alone, over half the runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > 5e-3:
        runs, inner = runs // 2, 1
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def enqueue_ms(fn: Callable, calls: int = 200) -> float:
    """Host milliseconds per call to issue ``calls`` warm calls back to back
    without waiting for the card: the wrapper's host work, which bounds
    :func:`bracket_ms` from below."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def _device_events(prof) -> list:
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def device_times(fn: Callable, calls: int = 20,
                 between: Optional[Callable] = None) -> Dict[str, float]:
    """Milliseconds per call of device time, by kernel or copy name, that
    ``torch.profiler`` records over ``calls`` warm calls of ``fn``.
    ``between`` runs before each call, untimed: its kernels are left out by
    name (what a profile of ``fn`` alone shows). Empty where the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    own = None
    if between is not None:
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        own = {e.key for e in _device_events(prof)}
    with profile(activities=activities) as prof:
        for _ in range(calls):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / calls / 1e3
            for e in _device_events(prof) if own is None or e.key in own}


def device_ms(fn: Callable, calls: int = 20,
              between: Optional[Callable] = None) -> Optional[float]:
    """Device milliseconds per call of what ``fn`` launches (see
    :func:`device_times`), or None where the profiler recorded none."""
    times = device_times(fn, calls, between)
    return sum(times.values()) if times else None


def profile_busy(fn: Callable) -> dict:
    """Run ``fn()`` once under ``torch.profiler`` and return the wall
    milliseconds under the profiler (``fn`` then a synchronize), the
    device's busy milliseconds (device-side kernel and copy time summed:
    the CPU operators that launched them carry the same time and are left
    out, so nothing counts twice), the idle share ``1 - busy / wall`` and
    the device events, largest first. ``busy_ms`` and ``idle_share`` are
    None where the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = sorted(_device_events(prof),
                    key=lambda e: -e.self_device_time_total)
    busy_ms = (sum(e.self_device_time_total for e in events) / 1e3
               if events else None)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": None if busy_ms is None else 1 - busy_ms / wall_ms,
            "events": events}


def l2_flusher(device) -> Callable:
    """A function that writes :data:`L2_FLUSH_BYTES` on ``device``, so that
    the next call finds none of its inputs in L2."""
    buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    return buf.zero_
