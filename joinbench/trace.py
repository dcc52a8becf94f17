"""What a ``--trace 1`` run records, from the benchmark's own files: the
profiler's device events over the window, host spans around the calls into
the port's layers (a request, each root or totals fetch, the result page
encode), the stage breakdown the port leaves on each plan, and the least
bytes of every hand-kernel call. The per-layer readers in
``joinbench/metrics/`` take their numbers from a :class:`Record`.

Host spans are stamped with ``time.time_ns()``, the clock the profiler
stamps its events with, so an idle stretch of the device can be set
beside what the host was doing.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Dict, List, Optional, Tuple

from . import kernel_bytes

_HERE = os.path.dirname(os.path.abspath(__file__))

#: kernels of the port's hand-written CUDA (csrc/), by trace name
HAND_KERNELS = tuple(kernel_bytes.KERNEL_NAMES.values()) + ("resident_gather_kernel",)


@dataclasses.dataclass
class Request:
    plan: str
    start_ns: int
    end_ns: int
    ok: bool
    stats: Optional[dict] = None  # the plan's _last_exec_stats after the call
    fetches: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    encode: Optional[Tuple[int, int]] = None

    @property
    def encode_ms(self) -> Optional[float]:
        return None if self.encode is None else (self.encode[1] - self.encode[0]) / 1e6


@dataclasses.dataclass
class DeviceEvent:
    name: str
    kind: str  # "kernel", "htod", "dtoh", "dtod", "memset", "copy"
    start_ns: int
    end_ns: int

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


@dataclasses.dataclass
class Record:
    """One traced window: its requests, device events, hand-kernel calls
    (wrapper name, least bytes) and the card's name."""

    start_ns: int
    end_ns: int
    requests: List[Request]
    events: List[DeviceEvent]
    kernel_calls: List[Tuple[str, int]]
    card: str = ""

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The device's busy time inside the window as disjoint intervals."""
        spans = sorted((max(e.start_ns, self.start_ns), min(e.end_ns, self.end_ns))
                       for e in self.events)
        merged: List[List[int]] = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def stat_mean(self, key: str) -> Optional[float]:
        """Mean over the requests that report it of a ``_last_exec_stats``
        entry; None where none does."""
        vals = [r.stats[key] for r in self.requests
                if r.stats is not None and key in r.stats]
        return sum(vals) / len(vals) if vals else None

    def device_ms_per_request(self, pick) -> Optional[float]:
        """Device milliseconds a request of the events ``pick`` accepts;
        None where there are none."""
        ms = [e.ms for e in self.events if pick(e)]
        if not ms or not self.requests:
            return None
        return sum(ms) / len(self.requests)


def is_hand_kernel(event: DeviceEvent) -> bool:
    return event.kind == "kernel" and any(k in event.name for k in HAND_KERNELS)


def peak_bytes_per_s(card: str) -> Optional[float]:
    with open(os.path.join(_HERE, "peaks.json")) as f:
        entry = json.load(f)["cards"].get(card)
    return None if entry is None else float(entry["hbm_bytes_per_s"])


def _kind(name: str) -> str:
    if name.startswith("Memset"):
        return "memset"
    if name.startswith("Memcpy"):
        for tag, kind in (("HtoD", "htod"), ("DtoH", "dtoh"), ("DtoD", "dtod")):
            if tag in name:
                return kind
        return "copy"
    return "kernel"


class Tracer:
    """Wraps the port's layer entry points for one window and runs the
    profiler over it. ``start()`` before the first timed request,
    ``stop()`` after the last; the wrappers come off again at ``stop()``."""

    def __init__(self, device_type: str):
        self.device_type = device_type
        self.requests: List[Request] = []
        self.kernel_calls: List[Tuple[str, int]] = []
        self._current: Optional[Request] = None
        self._undo = []
        self._prof = None

    # -- wrappers ------------------------------------------------------------

    def _patch(self, module, name, wrapper):
        original = getattr(module, name)
        setattr(module, name, functools.wraps(original)(wrapper(original)))
        self._undo.append((module, name, original))

    def _install(self):
        from radixjoin_tpu_torch import engine
        from radixjoin_tpu_torch.ops import kernels

        def fetch(original):
            def call(*args, **kwargs):
                t0 = time.time_ns()
                try:
                    return original(*args, **kwargs)
                finally:
                    if self._current is not None:
                        self._current.fetches.append((t0, time.time_ns()))
            return call

        def encode(original):
            def call(*args, **kwargs):
                t0 = time.time_ns()
                try:
                    return original(*args, **kwargs)
                finally:
                    if self._current is not None:
                        self._current.encode = (t0, time.time_ns())
            return call

        def counted(name):
            count = kernel_bytes.LEAST_BYTES[name]

            def wrap(original):
                def call(*args, **kwargs):
                    self.kernel_calls.append((name, count(args, kwargs)))
                    return original(*args, **kwargs)
                return call
            return wrap

        self._patch(engine, "_fetch", fetch)
        self._patch(engine, "_encode_result", encode)
        for name in kernel_bytes.LEAST_BYTES:
            self._patch(kernels, name, counted(name))

    def start(self):
        self._install()
        from torch.profiler import ProfilerActivity, profile

        activities = ([ProfilerActivity.CUDA] if self.device_type == "cuda"
                      else [ProfilerActivity.CPU])
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self.start_ns = time.time_ns()

    def begin(self, plan: str) -> None:
        self._current = Request(plan, time.time_ns(), 0, False)

    def end(self, ok: bool, stats: Optional[dict]) -> None:
        req = self._current
        req.end_ns, req.ok = time.time_ns(), ok
        req.stats = dict(stats) if stats else None
        self.requests.append(req)
        self._current = None

    def stop(self, card: str) -> Record:
        end_ns = time.time_ns()
        self._prof.__exit__(None, None, None)
        for module, name, original in reversed(self._undo):
            setattr(module, name, original)
        self._undo.clear()
        events = []
        if self.device_type == "cuda":
            from torch.autograd import DeviceType

            for e in self._prof.profiler.kineto_results.events():
                if e.device_type() != DeviceType.CUDA:
                    continue
                start = e.start_ns()
                events.append(DeviceEvent(e.name(), _kind(e.name()), start,
                                          start + e.duration_ns()))
        return Record(self.start_ns, end_ns, self.requests, events,
                      self.kernel_calls, card)


def host_segments(rec: Record) -> List[Tuple[int, int, str]]:
    """The window cut into what the host was doing: per request dispatch
    (up to and between its fetches), fetch, decode (after the last fetch)
    and encode; between requests outside them."""
    out, prev = [], rec.start_ns
    for req in rec.requests:
        if req.start_ns > prev:
            out.append((prev, req.start_ns, "between requests"))
        t = req.start_ns
        for s, e in req.fetches:
            out += [(t, s, "dispatch"), (s, e, "fetch")]
            t = e
        enc = req.encode or (req.end_ns, req.end_ns)
        out += [(t, enc[0], "decode" if req.fetches else "dispatch"),
                (enc[0], max(enc[1], req.end_ns), "encode")]
        prev = max(prev, req.end_ns)
    out.append((prev, rec.end_ns, "between requests"))
    return [(s, e, label) for s, e, label in out if e > s]


def breakdown(rec: Record, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, by name, and the
    device's idle time shared out by what the host was doing (dispatch,
    fetch, decode, encode, between requests), seconds each, largest
    first."""
    by_name: Dict[str, float] = {}
    for e in rec.events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end_ns - e.start_ns) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle_spans, prev = [], rec.start_ns
    for s, e in rec.busy_intervals() + [(rec.end_ns, rec.end_ns)]:
        if s > prev:
            idle_spans.append((prev, s))
        prev = max(prev, e)
    # each idle stretch shared out over the host segments it overlaps
    idle: Dict[str, float] = {}
    segments = host_segments(rec)
    k = 0
    for s, e in idle_spans:
        while k < len(segments) and segments[k][1] <= s:
            k += 1
        j = k
        while j < len(segments) and segments[j][0] < e:
            lo, hi = max(s, segments[j][0]), min(e, segments[j][1])
            if hi > lo:
                label = segments[j][2]
                idle[label] = idle.get(label, 0.0) + (hi - lo) / 1e9
            j += 1
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
