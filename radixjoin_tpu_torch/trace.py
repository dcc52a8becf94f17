"""Spans and counters of the port, in one registry.

Counters are always on. Each is a key of a :class:`Counters` group
(``engine.ENGINE_STATS``, ``plan.executor.PATH_STATS`` and ``SYNC_STATS``,
each ledger's ``stats``, the kernels' launch counts, the upload, fetch and
fused-executor tallies), a dict that its readers read as before; its full
name is ``<group>.<key>``.

Spans are collected only between :func:`start` and :func:`stop`::

    trace.start()
    execute(plan, ctx)
    log = trace.stop()      # a Log: spans, requests, counters

A span has a name, ``start_ns`` and ``end_ns`` on ``time.time_ns()`` (the
clock ``torch.profiler`` puts its device events on), its own id, its
parent's id, its request's id and a few attributes. Every request
(``engine.execute``, and each plan of ``engine.execute_many``) gets an id
and a ``request`` span that the spans of its layers nest under; a span
opened outside any request has request id None. While tracing is on, every
counter increment is also added to the current request's record
(:attr:`Request.counters`), under the counter's full name.

Spans are kept in memory, one list per thread, and handed over by
:func:`stop`. While tracing is off a boundary checks :data:`ON` and does
nothing else: :func:`span` returns the shared :data:`OFF`, whose methods do
nothing, and reads no clock.

The current request is per thread. ``execute_many`` interleaves many
requests on one thread and makes each current around its steps
(:func:`activate`), so the open spans are kept per request, not per
thread: a span opened in one plan's step and closed in a later one nests
under that plan's request whatever ran in between.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import weakref
from typing import Dict, List, Optional

#: True between :func:`start` and :func:`stop`; every span boundary checks
#: it first (read it as ``trace.ON``, never import the name)
ON = False


class Span:
    """One timed stretch of a request's work. ``end_ns`` is None while the
    span is open. A span is its own context manager: the block's end
    closes it."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "request",
                 "attrs", "_stack")

    def __init__(self, name: str, start_ns: int, parent: Optional[int],
                 request: Optional[int], stack: list):
        self.name = name
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None
        self.id = next(_ids)
        self.parent = parent
        self.request = request
        self.attrs: dict = {}
        self._stack = stack  # the open spans of its request, it included

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def note(self, key: str, value) -> None:
        """Set one attribute."""
        self.attrs[key] = value

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        close(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, {self.start_ns}-{self.end_ns}, "
                f"{self.attrs})")


class _Off:
    """What every span boundary gets while tracing is off."""

    __slots__ = ()

    def note(self, key, value) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class Request:
    """One request: its id, its ``request`` span, its open spans (innermost
    last) and the counter increments made while it was current."""

    __slots__ = ("id", "span", "stack", "counters")

    def __init__(self, rid: Optional[int]):
        self.id = rid
        self.span: Optional[Span] = None
        self.stack: List[Span] = []
        self.counters: Dict[str, int] = {}


@dataclasses.dataclass
class Log:
    """What :func:`stop` hands over: every span closed while tracing was on,
    in order of start; every request begun, in order; and each counter's
    change between :func:`start` and :func:`stop` (full names, changes of 0
    left out)."""

    start_ns: int
    end_ns: int
    spans: List[Span]
    requests: List[Request]
    counters: Dict[str, int]


_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()
#: bumped by every start(): a thread's state of an older session is dropped
_session = 0
_start_ns = 0
_thread_spans: List[List[Span]] = []
_requests: List[Request] = []
_base: Dict[str, int] = {}
_groups: List["weakref.ref[Counters]"] = []


class _ThreadState:
    __slots__ = ("session", "spans", "current")

    def __init__(self, session: int):
        self.session = session
        self.spans: List[Span] = []
        self.current = Request(None)  # outside any request


def _state() -> _ThreadState:
    st = getattr(_local, "state", None)
    if st is None or st.session != _session:
        st = _local.state = _ThreadState(_session)
        with _lock:
            _thread_spans.append(st.spans)
    return st


def _open(name: str, start_ns: int) -> Span:
    req = _state().current
    stack = req.stack
    sp = Span(name, start_ns, stack[-1].id if stack else None, req.id, stack)
    stack.append(sp)
    return sp


def span(name: str):
    """A span opened now under the current request's innermost open span;
    :data:`OFF` while tracing is off. Use it as a context manager."""
    if not ON:
        return OFF
    return _open(name, time.time_ns())


def open_at(name: str, start_ns: int) -> Optional[Span]:
    """A span opened at ``start_ns``, a stamp the caller has read already;
    None while tracing is off. :func:`close` closes it."""
    if not ON:
        return None
    return _open(name, start_ns)


def close(sp, end_ns: Optional[int] = None) -> None:
    """Close ``sp`` at ``end_ns`` (now where None); None and :data:`OFF`
    are passed over."""
    if sp is None or sp is OFF:
        return
    sp.end_ns = time.time_ns() if end_ns is None else end_ns
    stack = sp._stack
    if stack and stack[-1] is sp:
        stack.pop()
    elif sp in stack:  # closed out of turn (a generator dropped mid-span)
        stack.remove(sp)
    if ON and sp.start_ns >= _start_ns:
        _state().spans.append(sp)


def record(name: str, start_ns: int, end_ns: int, attrs: dict) -> None:
    """A span the caller timed itself, under the current request's
    innermost open span. Call it only while :data:`ON`."""
    sp = _open(name, start_ns)
    sp.attrs.update(attrs)
    close(sp, end_ns)


def now() -> int:
    """``time.time_ns()`` while tracing is on, else 0 (no clock read)."""
    return time.time_ns() if ON else 0


# -- requests ---------------------------------------------------------------


def begin_request(plan) -> Optional[Request]:
    """A new request for ``plan`` with its ``request`` span open (not made
    current: see :func:`activate`); None while tracing is off."""
    if not ON:
        return None
    req = Request(next(_ids))
    sp = Span("request", time.time_ns(), None, req.id, req.stack)
    sp.attrs["plan"] = getattr(plan, "_name", None)
    req.span = sp
    req.stack.append(sp)
    with _lock:
        _requests.append(req)
    return req


def end_request(req: Optional[Request], ok: bool) -> None:
    """Close ``req``'s ``request`` span, noting whether it returned a
    result."""
    if req is not None:
        req.span.attrs["ok"] = ok
        close(req.span)


class _Activate:
    __slots__ = ("req", "prev")

    def __init__(self, req: Request):
        self.req = req
        self.prev = None

    def __enter__(self) -> Request:
        st = _state()
        self.prev, st.current = st.current, self.req
        return self.req

    def __exit__(self, *exc) -> bool:
        _state().current = self.prev
        return False


def activate(req: Optional[Request]):
    """Context manager: ``req`` is this thread's current request inside the
    block (:data:`OFF` for None)."""
    return OFF if req is None else _Activate(req)


class _RequestBlock:
    __slots__ = ("plan", "req", "act")

    def __init__(self, plan):
        self.plan = plan

    def __enter__(self) -> Span:
        self.req = begin_request(self.plan)
        self.act = _Activate(self.req)
        self.act.__enter__()
        return self.req.span

    def __exit__(self, exc_type, *exc) -> bool:
        self.act.__exit__()
        end_request(self.req, exc_type is None)
        return False


def request(plan):
    """Context manager: one request for ``plan``, current on this thread
    inside the block; it yields the ``request`` span (:data:`OFF` while
    tracing is off)."""
    return OFF if not ON else _RequestBlock(plan)


def note_request(key: str, value) -> None:
    """Set an attribute of the current request's ``request`` span."""
    if ON:
        sp = _state().current.span
        if sp is not None:
            sp.attrs[key] = value


# -- counters ---------------------------------------------------------------


class Counters(dict):
    """One group of the registry's counters: a dict of key -> count, read
    as a dict (``dict(c)``, ``c[key]``), written only by :meth:`add`.
    Every group is in the registry, and :func:`stop` reports each
    counter's change under ``<group>.<key>``."""

    def __init__(self, group: str, keys=()):
        super().__init__(dict.fromkeys(keys, 0))
        self.group = group
        self._lock = threading.Lock()
        with _lock:
            _groups.append(weakref.ref(self))

    def add(self, key: str, n: int = 1) -> None:
        with self._lock:
            self[key] = self.get(key, 0) + n
        if ON:
            counts = _state().current.counters
            name = f"{self.group}.{key}"
            counts[name] = counts.get(name, 0) + n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self)

    def reset(self, keys=None) -> None:
        """Set ``keys`` (every key where None) back to 0."""
        with self._lock:
            for k in (self if keys is None else keys):
                self[k] = 0


def _totals() -> Dict[str, int]:
    """Every counter of every live group, full names; groups of one name
    (a ledger per device) add up. Called with ``_lock`` held."""
    out: Dict[str, int] = {}
    alive = []
    for ref in _groups:
        group = ref()
        if group is None:
            continue
        alive.append(ref)
        for key, value in group.snapshot().items():
            name = f"{group.group}.{key}"
            out[name] = out.get(name, 0) + value
    _groups[:] = alive
    return out


# -- sessions ---------------------------------------------------------------


def start() -> None:
    """Begin collecting spans (a session already on starts over)."""
    global ON, _session, _start_ns, _base
    with _lock:
        _session += 1
        _thread_spans.clear()
        _requests.clear()
        _base = _totals()
        _start_ns = time.time_ns()
        ON = True


def stop() -> Log:
    """Stop collecting and hand over what was collected."""
    global ON
    with _lock:
        ON = False
        end_ns = time.time_ns()
        spans = [sp for spans in _thread_spans for sp in spans]
        requests = list(_requests)
        totals = _totals()
        _thread_spans.clear()
        _requests.clear()
    counters = {name: value - _base.get(name, 0)
                for name, value in totals.items()
                if value != _base.get(name, 0)}
    spans.sort(key=lambda sp: (sp.start_ns, sp.id))
    return Log(_start_ns, end_ns, spans, requests, counters)
