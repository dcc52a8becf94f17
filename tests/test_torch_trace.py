"""The port's tracer (radixjoin_tpu_torch/trace.py): spans at every layer
boundary of a request on every route, one request id per request, the
counters of the registry (and the tallies that became views of it), the
kernels' least bytes against the benchmark's own count, the stage
breakdown every route leaves, and the ledger's admission under a garbage
collection at any point of its walk.

Everything runs on the CPU route (``build_context("cpu")``), on tiny
JOB-shaped plans over synthetic IMDB.
"""

import gc
import sys
import threading
import weakref

import pytest
import torch

import radixjoin_tpu_torch as port
from radixjoin_tpu_torch import engine, trace
from radixjoin_tpu_torch.dtypes import DataType
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.harness.datagen import SyntheticIMDB
from radixjoin_tpu_torch.ops import join as join_ops
from radixjoin_tpu_torch.ops import kernels
from radixjoin_tpu_torch.plan import fused

from joinbench import kernel_bytes

SCALE = 0.0004
NAMES = sorted(set(job_shapes.S1_TABLES + job_shapes.S2_TABLES))
STAGES = ("dispatch_ms", "fetch_ms", "decode_ms", "rounds")


@pytest.fixture(scope="module")
def tables():
    return SyntheticIMDB(scale=SCALE, seed=0).generate(NAMES)


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    """Every test starts and ends with tracing off, the default knobs and
    no idle device caches."""
    for knob in ("RJT_EXEC_MODE", "RJT_HBM_BUDGET_BYTES"):
        monkeypatch.delenv(knob, raising=False)
    engine.clear_device_caches()
    yield
    if trace.ON:
        trace.stop()
    engine.clear_device_caches()


def _plan(tables, shape="s1"):
    return getattr(job_shapes, f"{shape}_plan")(tables, lazy=shape != "s1")


def _traced(fn):
    """``(fn's value, the log, the wall time in ns)`` of one traced call."""
    trace.start()
    try:
        t0 = trace.now()
        out = fn()
        wall = trace.now() - t0
    finally:
        log = trace.stop()
    return out, log, wall


def _children(log, sp):
    return [c for c in log.spans if c.parent == sp.id]


def _union_ns(spans) -> int:
    total, end = 0, None
    for s, e in sorted((sp.start_ns, sp.end_ns) for sp in spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _assert_nested(log):
    """Every span closed, with a parent (``request`` spans excepted) of its
    own request that it lies inside."""
    by_id = {sp.id: sp for sp in log.spans}
    for sp in log.spans:
        assert sp.end_ns is not None and sp.end_ns >= sp.start_ns, sp
        if sp.name == "request":
            assert sp.parent is None
            continue
        parent = by_id[sp.parent]
        assert parent.request == sp.request, (sp, parent)
        assert parent.start_ns <= sp.start_ns <= sp.end_ns <= parent.end_ns, (
            sp, parent)


# ---------------------------------------------------------------------------
# every route: one request whose children cover its wall time
# ---------------------------------------------------------------------------

ROUTES = {
    # route: (environment, the span the route's top level leaves)
    "fused": ({}, "fused.attempt"),
    "stepwise": ({"RJT_EXEC_MODE": "stepwise"}, "stepwise"),
    "spill": ({"RJT_HBM_BUDGET_BYTES": "4096"}, "spill"),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_leaves_one_request_covered_by_its_children(tables, route,
                                                          monkeypatch):
    env, top = ROUTES[route]
    for knob, value in env.items():
        monkeypatch.setenv(knob, value)
    plan, ctx = _plan(tables), port.build_context("cpu")
    plan._name = f"s1-{route}"
    port.execute(plan, ctx)  # warm: feedback learned, inputs uploaded
    _result, log, _wall = _traced(lambda: port.execute(plan, ctx))
    _assert_nested(log)
    (req,) = log.requests
    assert req.span.attrs == {"plan": plan._name, "route": route, "ok": True}
    assert {sp.request for sp in log.spans} == {req.id}
    names = [c.name for c in _children(log, req.span)]
    assert names[0] == "prepare" and names[-1] == "encode"
    assert top in names
    if route == "spill":
        assert "ledger.admit" not in names  # the inputs alone are over
    else:
        assert "ledger.admit" in names
    covered = _union_ns(_children(log, req.span))
    assert covered >= 0.7 * req.span.duration_ns, (covered, req.span)
    # the decode (the spill has none: its takes materialize every join)
    # and encode spans name each column; the fused route encodes its
    # fixed-width columns on the device and decodes only VARCHAR ones
    attrs = plan.nodes[plan.root].output_attrs
    fixed = sum(dt is not DataType.VARCHAR for _ci, dt in attrs)
    for name in ("encode.column",) if route == "spill" else (
            "decode.column", "encode.column"):
        cols = [sp for sp in log.spans if sp.name == name]
        want = len(attrs)
        if route == "fused" and name == "decode.column":
            want -= fixed
        assert len(cols) == want
        assert all(sp.attrs["rows"] == cols[0].attrs["rows"] for sp in cols)
    on_card = [sp for sp in log.spans
               if sp.name == "encode.column" and sp.attrs.get("on_card")]
    assert len(on_card) == (fixed if route == "fused" else 0)


def test_fused_request_spans_every_layer(tables):
    plan, ctx = _plan(tables), port.build_context("cpu")
    for _ in range(2):  # the second run learns the buckets it then keeps
        port.execute(plan, ctx)
    _result, log, _wall = _traced(lambda: port.execute(plan, ctx))
    (req,) = log.requests
    by_name = {}
    for sp in log.spans:
        by_name.setdefault(sp.name, []).append(sp)
    (attempt,) = by_name["fused.attempt"]
    assert attempt.attrs == {"attempt": 0, "overflowed": False}
    assert [c.name for c in _children(log, attempt)] == [
        "fused.build", "fused.launch", "fetch", "fused.check"]
    assert by_name["fused.build"][0].attrs == {"built": False}
    strategies = plan._fused_struct_cache[1].strategies()
    nodes = {sp.attrs["node"]: sp.attrs["strategy"]
             for sp in by_name["fused.node"]}
    assert nodes == strategies
    assert all(sp.parent == by_name["fused.launch"][0].id
               for sp in by_name["fused.node"])
    fetches = by_name["fetch"]
    assert [sp.attrs["kind"] for sp in fetches] == ["totals", "root"]
    assert fetches[1].parent == req.span.id
    (decode,) = by_name["decode"]
    assert decode.start_ns == fetches[1].end_ns
    assert sum(sp.attrs["bytes"] for sp in fetches) == req.counters[
        "fetch.bytes"]
    # warm and resident: no structure built, every upload a memo hit
    assert req.counters.get("fused.struct_builds", 0) == 0
    assert req.counters.get("upload.memo_misses", 0) == 0
    assert req.counters["upload.memo_hits"] > 0
    assert req.counters["fetch.rounds"] == 2
    want = {}
    for strategy in strategies.values():
        want[f"join.{strategy}"] = want.get(f"join.{strategy}", 0) + 1
    # the joins by strategy; their rows (join.probe_rows.<strategy>,
    # join.out_rows.<strategy>) are held to node_shapes below
    assert {k: v for k, v in req.counters.items()
            if k.startswith("join.") and k.count(".") == 1} == want


def test_fused_leaves_node_shapes_and_no_device_time_on_the_cpu(tables):
    """The fused route leaves every join's shape in ``_last_exec_stats``
    with live row counts (a scan child's rows, a join child's exact total),
    counts the rows by strategy, and on the CPU no ``node_device_ms`` nor a
    span's ``device_ms``: there are no events to read."""
    plan, ctx = _plan(tables), port.build_context("cpu")
    port.execute(plan, ctx)
    _result, log, _wall = _traced(lambda: port.execute(plan, ctx))
    stats = plan._last_exec_stats
    assert "node_device_ms" not in stats
    shapes = stats["node_shapes"]
    structure = plan._fused_struct_cache[1]
    assert set(shapes) == set(structure.strategies())
    totals = plan._last_join_totals
    for node_id, shape in shapes.items():
        assert set(shape) == {"strategy", "probe_rows", "build_rows",
                              "key_bytes", "out_rows", "out_col_bytes"}
        j = plan.nodes[node_id].data
        build, probe = ((j.left, j.right) if j.build_left
                        else (j.right, j.left))
        for child, key in ((build, "build_rows"), (probe, "probe_rows")):
            want = (totals[child] if child in totals else
                    plan.inputs[plan.nodes[child].data.base_table_id].num_rows)
            assert shape[key] == want
        assert shape["strategy"] == structure.strategies()[node_id]
        assert shape["out_rows"] == totals[node_id]
        assert shape["key_bytes"] == 4
        assert shape["out_col_bytes"] == [4] * len(
            plan.nodes[node_id].output_attrs)
    assert shapes[plan.root]["out_rows"] == _result.num_rows
    # live rows, not pads: some join reads fewer rows than its pad
    assert any(s["probe_rows"] < structure.join_specs[n].out_pad
               for n, s in shapes.items())
    assert all("device_ms" not in sp.attrs
               for sp in log.spans if sp.name == "fused.node")
    (req,) = log.requests
    for kind in ("probe_rows", "out_rows"):
        want = {}
        for shape in shapes.values():
            key = f"join.{kind}.{shape['strategy']}"
            want[key] = want.get(key, 0) + shape[kind]
        assert {k: v for k, v in req.counters.items()
                if k.startswith(f"join.{kind}.")} == want


def test_fused_run_returns_its_own_node_marks(tables):
    """Each fused run hands its joins' marks back to its caller: two runs
    of one cached structure (one plan object run twice at once, as
    ``execute_many`` may) share no mark, and the structure keeps none."""
    plan, ctx = _plan(tables), port.build_context("cpu")
    port.execute(plan, ctx)
    structure = plan._fused_struct_cache[1]
    *_first_out, first = fused.run(structure)
    *_second_out, second = fused.run(structure)
    assert [m.node for m in first] == [m.node for m in second] \
        == structure.join_order
    assert all(a is not b for a, b in zip(first, second))
    assert all(m.start is None and m.end is None for m in first + second)
    assert not hasattr(structure, "node_marks")


def test_first_run_uploads_under_upload_spans(tables):
    plan, ctx = _plan(tables), port.build_context("cpu")
    _result, log, _wall = _traced(lambda: port.execute(plan, ctx))
    (req,) = log.requests
    uploads = [sp for sp in log.spans if sp.name == "upload"]
    assert uploads and req.counters["upload.memo_misses"] == len(uploads)
    assert {sp.attrs["kind"] for sp in uploads} <= {"column", "paged", "csr"}
    assert sum(sp.attrs["bytes"] for sp in uploads) == req.counters[
        "upload.bytes"] > 0
    build = next(sp for sp in log.spans if sp.name == "fused.build")
    assert build.attrs == {"built": True}
    assert all(sp.parent == build.id for sp in uploads)
    assert req.counters["fused.struct_builds"] == 1


def test_execute_many_gives_each_plan_one_request(tables):
    ctx = port.build_context("cpu")
    plans = [_plan(tables, shape) for shape in ("s1", "s2", "s3")]
    for i, plan in enumerate(plans):
        plan._name = f"many-{i}"
    port.execute_many(plans, ctx)
    _result, log, wall = _traced(lambda: port.execute_many(plans, ctx))
    _assert_nested(log)
    assert [r.span.attrs["plan"] for r in log.requests] == [
        p._name for p in plans]
    assert all(r.span.attrs["ok"] and r.span.attrs["route"] == "fused"
               for r in log.requests)
    ids = {r.id for r in log.requests}
    assert len(ids) == len(plans) and {sp.request for sp in log.spans} == ids
    for req in log.requests:
        names = [c.name for c in _children(log, req.span)]
        assert names[:2] == ["ledger.admit", "prepare"]
        assert names[-3:] == ["fetch", "decode", "encode"]
    children = [sp for sp in log.spans if sp.parent is not None
                and sp.name != "request"
                and any(sp.parent == r.span.id for r in log.requests)]
    assert _union_ns(children) >= 0.7 * wall


def test_oom_retry_is_a_span_of_the_request(tables, monkeypatch):
    plan, ctx = _plan(tables), port.build_context("cpu")
    port.execute(plan, ctx)  # warm: one attempt a run
    run, calls = fused.run, []

    def failing(structure):
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("injected: out of memory")
        return run(structure)

    monkeypatch.setattr(fused, "run", failing)
    engine.reset_engine_stats()
    _result, log, _wall = _traced(lambda: port.execute(plan, ctx))
    engine.reset_engine_stats()
    _assert_nested(log)
    (req,) = log.requests
    names = [c.name for c in _children(log, req.span)]
    fixed = sum(dt is not DataType.VARCHAR
                for _ci, dt in plan.nodes[plan.root].output_attrs)
    assert names == ["prepare", "ledger.admit", "prepare", "fused.attempt",
                     "oom.retry", "prepare", "fused.attempt"] + [
                         "encode.column"] * fixed + ["fetch", "decode",
                                                     "encode"]
    assert req.counters["engine.oom_retries"] == 1
    covered = _union_ns(_children(log, req.span))
    assert covered >= 0.7 * req.span.duration_ns


def test_failed_request_is_closed_not_ok(tables, monkeypatch):
    plan, ctx = _plan(tables), port.build_context("cpu")

    def broken(structure):
        raise RuntimeError("not an out-of-memory error")

    monkeypatch.setattr(fused, "run", broken)
    trace.start()
    with pytest.raises(RuntimeError):
        port.execute(plan, ctx)
    with pytest.raises(RuntimeError):
        port.execute_many([plan], ctx)
    log = trace.stop()
    assert [r.span.attrs["ok"] for r in log.requests] == [False, False]
    assert all(sp.end_ns is not None for sp in log.spans)


# ---------------------------------------------------------------------------
# threads, counters, tracing off
# ---------------------------------------------------------------------------


def test_two_threads_get_distinct_request_ids(tables):
    ctx = port.build_context("cpu")
    plans = [_plan(tables), _plan(tables)]  # distinct plan objects
    for plan in plans:
        port.execute(plan, ctx)
    errors = []

    def work(plan):
        try:
            for _ in range(3):
                port.execute(plan, ctx)
        except Exception as err:  # reported by the assertion below
            errors.append(err)

    threads = [threading.Thread(target=work, args=(p,)) for p in plans]
    trace.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    log = trace.stop()
    assert not errors and not any(t.is_alive() for t in threads)
    _assert_nested(log)
    ids = [r.id for r in log.requests]
    assert len(ids) == len(set(ids)) == 6
    for req in log.requests:
        mine = [sp for sp in log.spans if sp.request == req.id]
        assert {sp.name for sp in mine} >= {"request", "fused.attempt",
                                            "decode", "encode"}


def test_request_counters_sum_to_process_counters(tables, monkeypatch):
    ctx = port.build_context("cpu")
    plans = [_plan(tables, shape) for shape in ("s1", "s2")]

    def work():
        for plan in plans:
            port.execute(plan, ctx)
        port.execute_many(plans, ctx)
        monkeypatch.setenv("RJT_EXEC_MODE", "stepwise")
        port.execute(_plan(tables, "s3"), ctx)

    _result, log, _wall = _traced(work)
    summed = {}
    for req in log.requests:
        for name, n in req.counters.items():
            summed[name] = summed.get(name, 0) + n
    assert summed == log.counters
    for name in ("fetch.rounds", "fetch.bytes", "upload.memo_misses",
                 "upload.memo_hits", "ledger.charged_bytes",
                 "fused.struct_builds"):
        assert log.counters.get(name, 0) > 0, name
    for plan in plans:
        for strategy in plan._fused_struct_cache[1].strategies().values():
            assert log.counters.get(f"join.{strategy}", 0) > 0, strategy


def test_tracing_off_leaves_no_span(tables):
    plan, ctx = _plan(tables), port.build_context("cpu")
    assert not trace.ON and trace.span("x") is trace.OFF
    assert trace.open_at("x", 1) is None and trace.now() == 0
    assert trace.begin_request(plan) is None
    trace.start()
    trace.stop()
    joins, rounds = fused.JOIN_STATS.snapshot(), engine.FETCH_STATS["rounds"]
    port.execute(plan, ctx)
    port.execute_many([plan], ctx)
    trace.start()
    log = trace.stop()
    assert log.spans == [] and log.requests == [] and log.counters == {}
    # counters stay on
    assert fused.JOIN_STATS.snapshot() != joins
    assert engine.FETCH_STATS["rounds"] > rounds


def test_views_read_the_registry(tables, monkeypatch):
    """``engine_stats()``, the fetch tallies, the ledger's ``stats`` and
    ``launch_counts()`` keep their keys, and each of them and the fused
    executor's ``join`` counters is a group of the registry: their changes
    are the log's counters."""
    ctx = port.build_context("cpu")
    ledger = engine.device_ledger("cpu")
    assert sorted(ledger.stats) == ["charged_bytes", "evicted_bytes",
                                    "evictions", "waits"]
    assert sorted(engine.FETCH_STATS) == [
        "bytes", "pageable_fallbacks", "pinned_arrays", "pinned_bytes",
        "pool_allocs", "pool_bytes", "rounds"]
    assert sorted(engine.engine_stats()) == sorted(
        ("infra_fallbacks", "oom_retries", "oom_host_spills",
         "admission_host_spills", "queries"))
    assert list(kernels.launch_counts()) == [
        fn.__name__ for fn in kernels._WRAPPERS]
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    views = {"join": fused.JOIN_STATS.snapshot,
             "join.unique_probe": join_ops.UNIQUE_PROBE_STATS.snapshot,
             "fetch": engine.FETCH_STATS.snapshot,
             "ledger": lambda: dict(ledger.stats),
             "engine": lambda: {k: v for k, v in engine.engine_stats().items()
                                if k != "queries"}}
    before = {g: view() for g, view in views.items()}
    _result, log, _wall = _traced(
        lambda: port.execute(_plan(tables, "s2"), ctx))
    def group_of(name):
        return max((g for g in views if name.startswith(g + ".")), key=len,
                   default=None)

    for group, view in views.items():
        after = view()
        delta = {k: after[k] - before[group].get(k, 0) for k in after
                 if after[k] != before[group].get(k, 0)}
        assert delta == {name[len(group) + 1:]: n
                         for name, n in log.counters.items()
                         if group_of(name) == group}, group
    assert any(name.startswith("join.") for name in log.counters)
    assert any(name.startswith("fetch.") for name in log.counters)


# ---------------------------------------------------------------------------
# every route's stage breakdown, on the spans' own stamps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_every_route_leaves_its_stage_breakdown(tables, route, monkeypatch):
    for knob, value in ROUTES[route][0].items():
        monkeypatch.setenv(knob, value)
    plan, ctx = _plan(tables), port.build_context("cpu")
    port.execute(plan, ctx)
    plan._last_exec_stats = None
    _result, log, _wall = _traced(lambda: port.execute(plan, ctx))
    stats = plan._last_exec_stats
    assert set(STAGES) <= set(stats) and ctx.last_exec_stats is stats
    assert all(stats[k] >= 0 for k in STAGES)
    fetches = [sp for sp in log.spans if sp.name == "fetch"]
    assert stats["rounds"] == len(fetches) >= 1
    # one clock read serves a boundary of both: they agree to rounding
    assert stats["fetch_ms"] == pytest.approx(
        sum(sp.duration_ns for sp in fetches) / 1e6, abs=1e-6)
    if route != "spill":  # the spill's decode is its host takes
        (decode,) = [sp for sp in log.spans if sp.name == "decode"]
        assert stats["decode_ms"] == pytest.approx(
            decode.duration_ns / 1e6, abs=1e-6)


def test_fused_dispatch_is_the_spans_between_the_fetches(tables):
    """``dispatch_ms`` of the fused executor is the part of ``prepare``
    inside it, ``fused.build``, ``fused.launch``, ``fused.check`` and the
    root's page encode on the device (``encode.column`` with ``on_card``),
    up to the glue between them."""
    plan, ctx = _plan(tables), port.build_context("cpu")
    port.execute(plan, ctx)
    _result, log, _wall = _traced(lambda: port.execute(plan, ctx))
    (req,) = log.requests
    parts = [sp for sp in log.spans if sp.name in (
        "fused.build", "fused.launch", "fused.check")
        or sp.attrs.get("on_card")]
    parts.append([c for c in _children(log, req.span)
                  if c.name == "prepare"][1])  # the generator's own
    spans_ms = sum(sp.duration_ns for sp in parts) / 1e6
    dispatch = plan._last_exec_stats["dispatch_ms"]
    assert spans_ms <= dispatch and spans_ms >= 0.7 * dispatch


# ---------------------------------------------------------------------------
# the kernels' least bytes: the benchmark's own count, on the same shapes
# ---------------------------------------------------------------------------


def _i32(n, hi, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, hi, (n,), dtype=torch.int32, generator=g)


LEAST_BYTES_CASES = {
    "window_gather": lambda: (
        [torch.zeros(4096, dtype=torch.int64),
         torch.zeros(4096, dtype=torch.bool)], _i32(10_001, 4096)),
    "blocked_window_gather_multi": lambda: (
        [torch.zeros(50_000, dtype=torch.int32),
         torch.zeros(30_000, dtype=torch.int64),
         torch.zeros(50_000, dtype=torch.bool)],
        torch.sort(_i32(70_001, 30_000)).values, False),
    "paged_window_gather": lambda: (
        torch.zeros((13, 2048), dtype=torch.int32),
        _i32(13 * 2040, 2048).reshape(13, 2040)),
    "owner_recovery": lambda: (
        torch.arange(0, 3 * 9_999, 3, dtype=torch.int64),
        torch.tensor([3 * 9_999], dtype=torch.int64), 1 << 15),
    "cummax_i32": lambda: (_i32(123_457, 1 << 30),),
}


@pytest.mark.parametrize("name", sorted(LEAST_BYTES_CASES))
def test_least_bytes_equal_the_benchmark_count(name):
    args = LEAST_BYTES_CASES[name]()
    want = kernel_bytes.LEAST_BYTES[name](args, {})
    assert kernels.least_bytes(name, *args) == want > 0
    if name == "blocked_window_gather_multi":  # with the ok flags too
        with_ok = args[:2] + (True,)
        assert kernels.least_bytes(name, *with_ok) == kernel_bytes.LEAST_BYTES[
            name](with_ok, {}) == want + 4 * args[1].numel()
    # counted under kernel.<wrapper>.least_bytes while tracing is on
    fn = getattr(kernels, name)
    trace.start()
    kernels._count_least_bytes(fn, *args)
    log = trace.stop()
    assert log.counters == {f"kernel.{name}.least_bytes": want}


def test_least_bytes_covers_every_wrapper():
    table, idx = torch.zeros(1 << 12, dtype=torch.int32), _i32(1 << 13, 4096)
    for fn in kernels._WRAPPERS:
        if fn.__name__ == "encode_pages_aligned":
            # each row's value and validity byte read, each page written
            values = [torch.zeros(5000, dtype=torch.int32),
                      torch.zeros(5000, dtype=torch.int64)]
            valids = [torch.zeros(5000, dtype=torch.bool)] * 2
            assert kernels.least_bytes(
                fn.__name__, values, valids, 4801,
                [DataType.INT32, DataType.FP64]) == (
                4801 * 5 + 3 * 8192 + 4801 * 9 + 6 * 8192)
        elif fn.__name__ == "unique_probe":
            # each key and validity byte read, the outputs and total written
            keys = torch.zeros(5000, dtype=torch.int64)
            valid = torch.zeros(5000, dtype=torch.bool)
            assert kernels.least_bytes(fn.__name__, table, keys, valid,
                                       0) == 5000 * 9 + 5000 * 5 + 8
            assert kernels.least_bytes(fn.__name__, table, keys, valid,
                                       256) == 5000 * 9 + 256 * 9 + 8
        elif fn.__name__ not in LEAST_BYTES_CASES:
            assert kernels.least_bytes(fn.__name__, table, idx) == (
                4 * (1 << 12) + 8 * (1 << 13))
    with pytest.raises(ValueError):
        kernels.least_bytes("no_such_wrapper")


# ---------------------------------------------------------------------------
# the ledger's admission with a garbage collection inside its walk
# ---------------------------------------------------------------------------


class _Owner:
    def __init__(self):
        self.cycle = self  # freed only by the cyclic garbage collector


def _admit_with_collection_at(k: int):
    """Charge 20 owners held only by reference cycles to a new ledger, let
    them die, and run ``reserve`` with a garbage collection (which frees
    them, running the ledger's weakref callbacks) at the k-th traced step
    of a walk over its entries (a generator expression of a ledger
    method: the sum of the pinned bytes, the eviction candidates).
    Returns the ledger."""
    ledger = engine.DeviceLedger()
    keep = [_Owner() for _ in range(20)]
    for owner in keep:
        ledger.charge(owner, 100, lambda _o: None)
    del owner
    codes = {f.__code__ for f in vars(engine.DeviceLedger).values()
             if hasattr(f, "__code__")}
    seen = [0]

    def tracer(frame, event, _arg):
        walk = (frame.f_code.co_name.startswith("<")
                and frame.f_back is not None
                and frame.f_back.f_code in codes)
        if walk and event in ("call", "line"):
            if seen[0] == k:
                keep.clear()
                gc.collect()
            seen[0] += 1
        return tracer if walk or frame.f_code in codes else None

    gc.disable()
    sys.settrace(tracer)
    try:
        with ledger.reserve(50, 10_000):
            pass
    finally:
        sys.settrace(None)
        gc.enable()
    assert seen[0] > k  # the collection did happen inside a walk
    return ledger


@pytest.mark.parametrize("k", range(12))
def test_admission_survives_a_collection_inside_its_walk(k):
    ledger = _admit_with_collection_at(k)
    # the dead owners' entries go at the next locked entry
    assert ledger.pinned_bytes() == 0


def test_a_dead_owners_key_reused_keeps_the_new_entry():
    """An owner that dies while its thread holds the lock leaves its key
    queued; a new owner charged under the same key before the queue is
    applied keeps its entry."""
    ledger = engine.DeviceLedger()
    old = _Owner()
    ledger.charge(old, 100, lambda _o: None)
    key = id(old)
    with ledger._cond:
        ref = ledger._entries[key].ref
        del old
        gc.collect()  # the callback runs with the lock held: queued
        assert key in ledger._entries and ledger._dead == [(key, ref)]
        new = _Owner()
        ledger._entries[key] = engine._LedgerEntry(
            weakref.ref(new), 7, 0, lambda _o: None)
    assert ledger.pinned_bytes() == 7  # the queue dropped only the old entry
    assert ledger._dead == []
    del new


def test_counters_group_totals_in_the_log():
    group = trace.Counters("test_group", ("a",))
    group.add("a", 2)
    trace.start()
    group.add("a", 3)
    group.add("b")
    log = trace.stop()
    assert dict(group) == {"a": 5, "b": 1}
    assert log.counters == {"test_group.a": 3, "test_group.b": 1}
    group.reset()
    assert dict(group) == {"a": 0, "b": 0}
