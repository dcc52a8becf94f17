"""The port's device-memory ledger, its eviction and its out-of-memory
ladder. The ledger's mechanics run on the JAX package's ``DeviceLedger``
and the port's with the same calls and must give the same observations;
the real plans (JOB-shaped, tiny synthetic IMDB) run under budgets that
force evictions, re-uploads and admission waits and are held to the JAX
package's rows (harness/oracle.py::rows_equal, tolerance 0).
"""

import gc
import threading
import time
import weakref

import pytest
import torch

import radixjoin_tpu as ref
from radixjoin_tpu import engine as ref_engine
from radixjoin_tpu.harness.datagen import SyntheticIMDB as RefIMDB
from radixjoin_tpu.harness.oracle import rows_equal
from radixjoin_tpu.plan.ir import Plan as RefPlan
from radixjoin_tpu.storage.columnar import ColumnarTable as RefTable

import radixjoin_tpu_torch as port
from radixjoin_tpu_torch import engine as port_engine
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.harness.datagen import SyntheticIMDB
from radixjoin_tpu_torch.plan import fused as port_fused

from test_torch_engine import port_rows, ref_rows

SCALE = 0.0004
NAMES = sorted(set(job_shapes.S1_TABLES + job_shapes.S2_TABLES))
SHAPES = (("s1", False), ("s2", True), ("s3", True))

# ---------------------------------------------------------------------------
# Ledger mechanics (no device involved), on both ledgers
# ---------------------------------------------------------------------------


class _Owner:
    def __init__(self):
        self.released = False


def _release(o):
    o.released = True


def _lru_eviction_order(ledger_cls):
    led = ledger_cls()
    owners = [_Owner() for _ in range(3)]
    for o in owners:
        led.charge(o, 100, _release)
    led.touch(owners[0])  # owners[1] is now least recently used
    with led.reserve(0, 250):  # must free >= 50 of 300: exactly the LRU
        pass
    return ([o.released for o in owners], led.pinned_bytes(), dict(led.stats))


def _active_entries_never_evicted(ledger_cls):
    led = ledger_cls()
    hot, cold = _Owner(), _Owner()
    with led.reserve(100, 1000):
        led.charge(hot, 400, _release)  # touched by the active query
        inside = (hot.released, led.pinned_bytes())
    led.charge(cold, 400, _release)
    # hot's query has ended, so both are evictable; LRU = hot
    with led.reserve(300, 1000):
        pass
    return (inside, hot.released, cold.released, led.pinned_bytes(),
            dict(led.stats))


def _inflight_protection(ledger_cls):
    led = ledger_cls()
    mine = _Owner()
    res = led.reserve(100, 1000)
    with led.activate(res.token):
        led.charge(mine, 900, _release)
    refused = led.reserve(500, 1000, block=False) is None
    during = mine.released
    res.close()
    admitted = led.reserve(500, 1000, block=False) is not None
    return (refused, during, admitted, mine.released, led.pinned_bytes(),
            dict(led.stats))


def _weakref_cleanup(ledger_cls):
    led = ledger_cls()
    o = _Owner()
    led.charge(o, 123, lambda _o: None)
    before = led.pinned_bytes()
    del o
    gc.collect()
    return (before, led.pinned_bytes(), dict(led.stats))


def _touch_reports_eviction(ledger_cls):
    led = ledger_cls()
    o = _Owner()
    led.charge(o, 100, lambda _o: None)
    first = led.touch(o)
    with led.reserve(0, 50):  # forces eviction of the idle entry
        pass
    return (first, led.touch(o), led.pinned_bytes(), dict(led.stats))


def _evict_idle_spares_the_in_flight(ledger_cls):
    led = ledger_cls()
    mine, idle = _Owner(), _Owner()
    led.charge(idle, 70, _release)
    res = led.reserve(10, 1000)
    with led.activate(res.token):
        led.charge(mine, 30, _release)
    freed = led.evict_idle()
    state = (freed, mine.released, idle.released, led.pinned_bytes())
    res.close()
    return state + (led.evict_idle(), mine.released, dict(led.stats))


MECHANICS = {
    "lru_eviction_order": (
        _lru_eviction_order,
        ([False, True, False], 200,
         {"evictions": 1, "evicted_bytes": 100, "waits": 0,
          "charged_bytes": 300})),
    "active_entries_never_evicted": (
        _active_entries_never_evicted,
        ((False, 400), True, False, 400,
         {"evictions": 1, "evicted_bytes": 400, "waits": 0,
          "charged_bytes": 800})),
    "inflight_protection": (
        _inflight_protection,
        (True, False, True, True, 0,
         {"evictions": 1, "evicted_bytes": 900, "waits": 0,
          "charged_bytes": 900})),
    "weakref_cleanup": (
        _weakref_cleanup,
        (123, 0, {"evictions": 0, "evicted_bytes": 0, "waits": 0,
                  "charged_bytes": 123})),
    "touch_reports_eviction": (
        _touch_reports_eviction,
        (True, False, 0, {"evictions": 1, "evicted_bytes": 100, "waits": 0,
                          "charged_bytes": 100})),
    "evict_idle_spares_the_in_flight": (
        _evict_idle_spares_the_in_flight,
        (70, False, True, 30, 30, True,
         {"evictions": 2, "evicted_bytes": 100, "waits": 0,
          "charged_bytes": 100})),
}


@pytest.mark.parametrize("case", sorted(MECHANICS))
def test_ledger_mechanics_equal_on_both_ledgers(case):
    scenario, expected = MECHANICS[case]
    got = scenario(port_engine.DeviceLedger)
    assert got == scenario(ref_engine.DeviceLedger)
    assert got == expected


def test_one_ledger_per_device():
    cpu = port_engine.device_ledger("cpu")
    assert cpu is port_engine.device_ledger(torch.device("cpu"))
    if torch.cuda.is_available():
        assert port_engine.device_ledger() is not cpu
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            port_engine.device_ledger()
    assert port_engine._is_oom(torch.cuda.OutOfMemoryError("x"))
    assert not port_engine._is_oom(RuntimeError("CUDA out of memory"))


# ---------------------------------------------------------------------------
# Real plans under tiny budgets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tables():
    return SyntheticIMDB(scale=SCALE, seed=0).generate(NAMES)


@pytest.fixture(scope="module")
def expected():
    """Rows of each shape from the JAX package, under its default budget."""
    ref_tables = RefIMDB(scale=SCALE, seed=0).generate(NAMES)
    out = {}
    for shape, lazy in SHAPES:
        plan = getattr(job_shapes, f"{shape}_plan")(
            ref_tables, lazy=lazy, plan_cls=RefPlan, table_cls=RefTable)
        out[shape] = ref_rows(ref.execute(plan, ref.build_context()))
    return out


@pytest.fixture
def ledger():
    """The CPU route's ledger, emptied before and after the test."""
    port_engine.clear_device_caches()
    port_engine.reset_engine_stats()
    yield port_engine.device_ledger("cpu")
    port_engine.clear_device_caches()
    port_engine.reset_engine_stats()


def _plans(tables):
    return {shape: getattr(job_shapes, f"{shape}_plan")(tables, lazy=lazy)
            for shape, lazy in SHAPES}


def _assert_rows(result, want, tag=""):
    ok, msg = rows_equal(port_rows(result), want)
    assert ok, f"{tag}: {msg}"


def _one_query_budget(plans) -> int:
    return max(port_engine._estimate_query_bytes(p)
               for p in plans.values()) + (64 << 10)


def test_eviction_under_tiny_budget(tables, expected, ledger, monkeypatch):
    """A budget that holds any one query's working set but not the pinned
    uploads of all three forces evictions between queries; results stay
    exact and the pinned bytes stay under the budget."""
    plans = _plans(tables)
    ctx = port.build_context("cpu")
    budget = _one_query_budget(plans)
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", str(budget))
    before = dict(ledger.stats)
    for _round in range(2):  # the second round re-uploads after eviction
        for shape, plan in plans.items():
            _assert_rows(port.execute(plan, ctx), expected[shape], shape)
            assert ledger.pinned_bytes() <= budget
    assert ledger.stats["evictions"] > before["evictions"]
    assert ledger.stats["evicted_bytes"] > before["evicted_bytes"]
    assert port_engine.engine_stats()["admission_host_spills"] == 0
    # nothing is in flight: every entry is idle and goes
    port_engine.clear_device_caches()
    assert ledger.pinned_bytes() == 0


def test_release_drops_every_reference(tables, expected, ledger):
    """A tensor is freed only when its last reference goes: after
    ``clear_device_caches`` no cached upload of the plan is alive (column
    memos, the CSR index, the cached plan structure)."""
    plan = _plans(tables)["s2"]
    ctx = port.build_context("cpu")
    _assert_rows(port.execute(plan, ctx), expected["s2"])
    structure = plan._fused_struct_cache[1]
    assert "csr" in structure.strategies().values()
    refs = [weakref.ref(t) for d, v in structure.col_args for t in (d, v)]
    refs += [weakref.ref(a) for aux in structure.aux_args for a in aux
             if isinstance(a, torch.Tensor)]
    assert len(refs) > 2 * len(structure.col_args)  # the CSR arrays too
    assert ledger.pinned_bytes() > 0
    del structure
    port_engine.clear_device_caches()
    assert ledger.pinned_bytes() == 0
    assert plan._fused_struct_cache is None
    assert [r() for r in refs] == [None] * len(refs)


def test_memo_hit_is_protected_by_the_query_token(tables, ledger):
    """A memo hit passes through ``touch()`` under the query's token: the
    column cannot be evicted until that query's reservation is released."""
    from radixjoin_tpu_torch.plan import executor as port_executor

    hcol = tables["title"].columns[0]
    pad = 1 << 10
    first = port_executor._device_column_cached(port_engine, hcol, pad, "cpu")
    nbytes = ledger.pinned_bytes()
    assert nbytes == pad * (first.data.element_size() + 1)
    res = ledger.reserve(0, 1 << 40)
    with ledger.activate(res.token):
        hit = port_executor._device_column_cached(port_engine, hcol, pad,
                                                  "cpu")
    assert hit is first
    assert ledger.pinned_bytes() == nbytes  # a hit charges nothing
    assert ledger.evict_idle() == 0  # in use by the open reservation
    assert ledger.touch(hcol) and hcol._dev_memo
    res.close()
    assert ledger.evict_idle() == nbytes
    assert not ledger.touch(hcol) and not hcol._dev_memo
    again = port_executor._device_column_cached(port_engine, hcol, pad, "cpu")
    assert again is not first and torch.equal(again.data, first.data)


def test_stale_memo_is_uploaded_again_not_read(tables, expected, ledger,
                                               monkeypatch):
    plan = _plans(tables)["s2"]
    ctx = port.build_context("cpu")
    uploads = []
    upload = port_engine.host_column_to_device
    monkeypatch.setattr(
        port_engine, "host_column_to_device",
        lambda col, pad, device: uploads.append(pad) or upload(
            col, pad, device))
    charged0 = ledger.stats["charged_bytes"]
    _assert_rows(port.execute(plan, ctx), expected["s2"])
    cold = len(uploads)
    assert cold > 0
    _assert_rows(port.execute(plan, ctx), expected["s2"])
    assert len(uploads) == cold  # warm: memo hits, touch() True
    # a structure over the uploaded tensors, under the warm run's state key
    key, stale = plan._fused_struct_cache
    owners = list(stale.owners)
    assert stale.revalidate()
    charged1 = ledger.stats["charged_bytes"]

    assert ledger.evict_idle() > 0
    assert plan._fused_struct_cache is None
    assert not any(ledger.touch(o) for o in owners)
    assert not stale.revalidate()  # the only sign that it is stale
    assert all(not getattr(o, "_dev_memo", None) for o in owners)
    plan._fused_struct_cache = (key, stale)  # as if it had survived
    _assert_rows(port.execute(plan, ctx), expected["s2"])
    assert plan._fused_struct_cache[0] == key
    assert plan._fused_struct_cache[1] is not stale
    assert len(uploads) == 2 * cold
    assert ledger.stats["charged_bytes"] - charged1 == charged1 - charged0 > 0


def test_two_threads_under_a_budget_that_admits_one(tables, expected, ledger,
                                                    monkeypatch):
    """Admission control serializes the overflow without deadlock."""
    plans_a, plans_b = _plans(tables), _plans(tables)
    jobs = {"a": ("s2", plans_a["s2"]), "b": ("s3", plans_b["s3"])}
    ctx = port.build_context("cpu")
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", str(_one_query_budget(plans_a)))
    run = port_fused.run
    started = threading.Event()

    def slow_run(structure):
        started.set()
        time.sleep(0.5)  # hold the reservation while the other one asks
        return run(structure)

    monkeypatch.setattr(port_fused, "run", slow_run)
    errors, got = [], {}

    def worker(name):
        try:
            got[name] = port.execute(jobs[name][1], ctx)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append((name, repr(e)))

    threads = [threading.Thread(target=worker, args=(n,), daemon=True)
               for n in jobs]
    threads[0].start()
    assert started.wait(timeout=60)
    threads[1].start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "admission control deadlocked"
    assert not errors, errors
    assert ledger.stats["waits"] > 0
    for name, (shape, _plan) in jobs.items():
        _assert_rows(got[name], expected[shape], name)


def _fail_run(monkeypatch, times):
    """Make the port's ``fused.run`` raise out-of-memory ``times`` times
    (None: always). Returns the list of calls made."""
    run = port_fused.run
    calls = []

    def failing(structure):
        calls.append(1)
        if times is None or len(calls) <= times:
            raise torch.cuda.OutOfMemoryError("injected: out of memory")
        return run(structure)

    monkeypatch.setattr(port_fused, "run", failing)
    return calls


def test_oom_once_retries_after_dropping_the_caches(tables, expected, ledger,
                                                    monkeypatch):
    plan = _plans(tables)["s1"]
    plan._name = "s1-oom-once"
    ctx = port.build_context("cpu")
    calls = _fail_run(monkeypatch, 1)
    _assert_rows(port.execute(plan, ctx), expected["s1"])
    stats = port_engine.engine_stats()
    assert stats["oom_retries"] == 1 and stats["oom_host_spills"] == 0
    assert stats["admission_host_spills"] == 0
    assert stats["queries"] == {"oom_retries": ["s1-oom-once"]}
    assert len(calls) >= 2
    # the query's own uploads are in use by it and survive the cache drop
    assert ledger.pinned_bytes() > 0


def test_oom_always_spills_to_the_host_staged_executor(tables, expected,
                                                       ledger, monkeypatch):
    plan = _plans(tables)["s2"]
    ctx = port.build_context("cpu")
    calls = _fail_run(monkeypatch, None)
    _assert_rows(port.execute(plan, ctx), expected["s2"])
    stats = port_engine.engine_stats()
    assert stats["oom_retries"] == 1 and stats["oom_host_spills"] == 1
    assert stats["infra_fallbacks"] == 0
    assert len(calls) == 3
    assert plan._last_spill_partitions


def test_only_out_of_memory_is_caught(tables, ledger, monkeypatch):
    plan = _plans(tables)["s1"]
    ctx = port.build_context("cpu")

    def broken(structure):
        raise RuntimeError("CUDA error: out of memory (not the typed one)")

    monkeypatch.setattr(port_fused, "run", broken)
    with pytest.raises(RuntimeError, match="not the typed one"):
        port.execute(plan, ctx)
    with pytest.raises(RuntimeError, match="not the typed one"):
        port.execute_many([plan], ctx)
    stats = port_engine.engine_stats()
    assert all(stats[k] == 0 for k in port_engine.ENGINE_STATS)
    # the failed queries' reservations were released
    assert not ledger._reservations


def test_estimator_includes_join_intermediates(tables):
    plan = _plans(tables)["s1"]
    scans = port_engine._estimate_scan_bytes(plan)
    assert port_engine._estimate_query_bytes(plan) > scans > 0
