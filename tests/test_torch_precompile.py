"""``engine.precompile_fused`` and concurrent ``execute`` from threads, held
against the JAX package.

``precompile_fused`` returns the JAX function's value (True, or False for a
plan the fused structure declines) and leaves the structure where the first
``execute`` looks it up: that execute builds no ``FusedPlan`` and takes the
JAX structure's strategies, with its rows (harness/oracle.py::rows_equal,
tolerance 0). The port of ``tests/test_ledger.py``'s regression test for
precompile-then-concurrent-execute: a precompile pool, then threads
executing their plans under a budget that admits one query at a time, with
evictions churning, no error and exact rows. The kernels' launch counters
stay exact under threads.
"""

import concurrent.futures as cf
import os
import sys
import threading

import pytest
import torch

import radixjoin_tpu as ref
from radixjoin_tpu import engine as ref_engine
from radixjoin_tpu.harness import datagen as ref_datagen
from radixjoin_tpu.harness import run as ref_run
from radixjoin_tpu.harness.datagen import SyntheticIMDB as RefIMDB
from radixjoin_tpu.harness.oracle import rows_equal
from radixjoin_tpu.plan import fused as ref_fused
from radixjoin_tpu.plan.ir import Plan as RefPlan
from radixjoin_tpu.storage.columnar import ColumnarTable as RefTable

import radixjoin_tpu_torch as port
from radixjoin_tpu_torch import convert
from radixjoin_tpu_torch import engine as port_engine
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.ops import kernels
from radixjoin_tpu_torch.plan import fused as port_fused

from test_torch_engine import port_rows, ref_rows, ref_strategies

SHAPE_SCALE = 0.0004
DOC_SCALE = 0.001
SHAPES = {"s1": False, "s2": True, "s3": True}  # name -> lazy
DOCS = sorted(job_shapes.QUERY_DOCUMENTS)
NAMES = sorted(SHAPES) + DOCS


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """What fresh JAX-package plans of every name are built from: the
    synthetic IMDB for S1-S3 and a JAX ``JobHarness`` over the query
    documents."""
    shape_tables = RefIMDB(scale=SHAPE_SCALE, seed=0).generate(sorted(set(
        job_shapes.S1_TABLES + job_shapes.S2_TABLES + job_shapes.S3_TABLES)))
    directory = str(tmp_path_factory.mktemp("query_documents"))
    plans_path = job_shapes.write_query_documents(directory)
    sqls = [job_shapes.QUERY_DOCUMENTS[n][0] for n in DOCS]
    doc_tables = ref_datagen.SyntheticIMDB(scale=DOC_SCALE, seed=0,
                                           queries=sqls).generate()
    harness = ref_run.JobHarness(
        plans_path, ref_run.TableSource(host_tables=doc_tables),
        os.path.join(directory, "job"))
    return shape_tables, harness


def _ref_plan(sources, name):
    shape_tables, harness = sources
    if name in SHAPES:
        return getattr(job_shapes, f"{name}_plan")(
            shape_tables, lazy=SHAPES[name], plan_cls=RefPlan,
            table_cls=RefTable)
    return harness.build_plan(name)[1]


@pytest.fixture(scope="module")
def expected(sources):
    """Each plan's rows from the JAX package."""
    return {name: ref_rows(ref.execute(_ref_plan(sources, name),
                                       ref.build_context()))
            for name in NAMES}


@pytest.fixture
def ledger(monkeypatch):
    """The CPU route's ledger, emptied before and after; no feedback
    store."""
    monkeypatch.delenv("RJT_FEEDBACK_PATH", raising=False)
    monkeypatch.delenv("RJT_HBM_BUDGET_BYTES", raising=False)
    port_engine.clear_device_caches()
    port_engine.reset_engine_stats()
    yield port_engine.device_ledger("cpu")
    port_engine.clear_device_caches()
    port_engine.reset_engine_stats()


@pytest.fixture
def builds(monkeypatch):
    """Every ``FusedPlan`` the port constructs from here on."""
    made = []
    cls = port_fused.FusedPlan

    def counting(*args, **kwargs):
        made.append(args[0])
        return cls(*args, **kwargs)

    monkeypatch.setattr(port_fused, "FusedPlan", counting)
    return made


def _assert_rows(result, want, tag=""):
    ok, msg = rows_equal(port_rows(result), want)
    assert ok, f"{tag}: {msg}"


# ---------------------------------------------------------------------------
# precompile_fused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_precompile_equals_the_jax_function_and_primes_execute(
        sources, expected, ledger, builds, monkeypatch, name):
    ref_plan = _ref_plan(sources, name)
    plan = convert.from_reference(ref_plan)
    want = ref_engine.precompile_fused(ref_plan, ref.build_context())
    ctx = port.build_context("cpu")
    assert port_engine.precompile_fused(plan, ctx) is want is True
    assert len(builds) == 1 and ledger.pinned_bytes() > 0
    structure = plan._fused_struct_cache[1]
    assert structure.strategies() == ref_strategies(ref_plan)
    runs = []  # (structures built so far, structure run) per attempt
    run = port_fused.run
    monkeypatch.setattr(port_fused, "run", lambda st: runs.append(
        (len(builds), st)) or run(st))
    _assert_rows(port.execute(plan, ctx), expected[name], name)
    # the first attempt found the structure under its own state key and
    # built nothing; an overflow retry (S2's cold run) builds its own
    assert runs[0] == (1, structure)
    assert len(builds) == len(runs)


def test_declined_plan_precompiles_to_false(sources, expected, ledger,
                                            monkeypatch):
    """With its VARCHAR key's lowering made to decline in both packages,
    the VARCHAR-key document precompiles to False and caches nothing."""
    name = job_shapes.VARCHAR_KEY_QUERY
    for fused in (ref_fused, port_fused):
        monkeypatch.setattr(fused.FusedPlan, "_varchar_dev_csr",
                            lambda self, *a: None)
    ref_plan = _ref_plan(sources, name)
    plan = convert.from_reference(ref_plan)
    assert ref_engine.precompile_fused(ref_plan, ref.build_context()) is False
    ctx = port.build_context("cpu")
    assert port_engine.precompile_fused(plan, ctx) is False
    assert getattr(plan, "_fused_struct_cache", None) is None
    # execute serves it by the wave executor, as without the precompile
    _assert_rows(port.execute(plan, ctx), expected[name], name)


def test_structure_evicted_after_precompile_is_built_again(
        sources, expected, ledger, builds):
    plan = convert.from_reference(_ref_plan(sources, "s2"))
    ctx = port.build_context("cpu")
    assert port_engine.precompile_fused(plan, ctx)
    port_engine.clear_device_caches()  # every upload idle: all evicted
    assert plan._fused_struct_cache is None
    _assert_rows(port.execute(plan, ctx), expected["s2"], "s2")
    assert len(builds) >= 2


def test_precompile_starts_from_the_store(sources, expected, ledger, builds,
                                          tmp_path, monkeypatch):
    """A plan known to the store precompiles the learned state: its first
    execute builds nothing and runs in one attempt."""
    monkeypatch.setenv("RJT_FEEDBACK_PATH", str(tmp_path / "fb.json"))
    monkeypatch.setattr(port_engine, "_FEEDBACK", port_engine._FeedbackStore())
    ctx = port.build_context("cpu")
    cold = convert.from_reference(_ref_plan(sources, "s2"))
    port.execute(cold, ctx)
    assert cold._last_exec_stats["rounds"] == 3
    port_engine.destroy_context(ctx)
    monkeypatch.setattr(port_engine, "_FEEDBACK", port_engine._FeedbackStore())
    plan = convert.from_reference(_ref_plan(sources, "s2"))
    del builds[:]
    assert port_engine.precompile_fused(plan, ctx)
    assert port_engine.feedback_stats()["loaded"] == 1
    assert plan._learned_buckets == cold._learned_buckets
    _assert_rows(port.execute(plan, ctx), expected["s2"], "s2")
    assert len(builds) == 1 and plan._last_exec_stats["rounds"] == 2


def test_precompile_raises_where_execute_would(sources, ledger):
    plan = convert.from_reference(_ref_plan(sources, "s1"))
    plan.root = len(plan.nodes) + 3
    ctx = port.build_context("cpu")
    with pytest.raises(ValueError):
        port.execute(plan, ctx)
    with pytest.raises(ValueError):
        port_engine.precompile_fused(plan, ctx)
    good = convert.from_reference(_ref_plan(sources, "s1"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_engine.precompile_fused(good)


def test_plan_over_the_budget_is_not_precompiled(sources, expected, ledger,
                                                 monkeypatch):
    """``execute`` spills such a plan through the host; precompile uploads
    nothing for it."""
    plan = convert.from_reference(_ref_plan(sources, "s2"))
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", "4096")
    ctx = port.build_context("cpu")
    assert port_engine.precompile_fused(plan, ctx) is False
    assert ledger.pinned_bytes() == 0
    assert getattr(plan, "_fused_struct_cache", None) is None
    _assert_rows(port.execute(plan, ctx), expected["s2"], "s2")
    assert port_engine.engine_stats()["admission_host_spills"] == 1


# ---------------------------------------------------------------------------
# threads
# ---------------------------------------------------------------------------


def test_precompile_then_concurrent_execute_under_eviction(
        sources, expected, ledger, monkeypatch):
    """The JAX package's regression test for precompile-then-concurrent-
    execute (tests/test_ledger.py): structures precompiled from a pool hold
    device references outside any reservation; threads then execute under
    a budget that admits one query, so evictions churn those references.
    ``revalidate`` and the pin-first memo protocol keep every run exact."""
    plans = {name: convert.from_reference(_ref_plan(sources, name))
             for name in NAMES}
    ctx = port.build_context("cpu")
    budget = max(port_engine._estimate_query_bytes(p)
                 for p in plans.values()) + (64 << 10)
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", str(budget))
    evictions = ledger.stats["evictions"]
    with cf.ThreadPoolExecutor(8) as ex:
        done = list(ex.map(lambda p: port_engine.precompile_fused(p, ctx),
                           plans.values()))
    assert done == [True] * len(plans)

    kernels.reset_launch_counts()
    n_threads = 6
    errors, got, launched = [], {}, []
    mine = {t: NAMES[t::n_threads] for t in range(n_threads)}

    def worker(t):
        kernels.reset_thread_launch_counts()
        try:
            for _ in range(3):  # struct-cache hits under churn
                for name in mine[t]:
                    got[name] = port.execute(plans[name], ctx)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append((mine[t], repr(e)))
        launched.append(kernels.thread_launch_counts())

    threads = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive(), "admission control deadlocked"
    assert not errors, errors
    assert ledger.stats["evictions"] > evictions
    for name in NAMES:
        _assert_rows(got[name], expected[name], name)
    stats = port_engine.engine_stats()
    assert not any(stats[k] for k in port_engine.ENGINE_STATS), stats
    # the process's counts are the threads' (all 0 here: the plain route)
    total = kernels.launch_counts()
    assert total == {k: sum(c[k] for c in launched) for k in total}


def test_launch_counters_are_exact_under_threads():
    """Eight threads count launches at once, with the interpreter switching
    threads as often as it can, and call the wrappers' plain route, which
    launches nothing: the process's counts are the sum of the threads'."""
    n_threads, per_thread = 8, 3000
    tables = [torch.arange(64, dtype=torch.int32)]
    idx = torch.arange(32, dtype=torch.int32)
    counted = (kernels.window_gather, kernels.blocked_window_gather_multi,
               kernels.paged_window_gather)
    barrier = threading.Barrier(n_threads)
    launched = []

    def worker():
        kernels.reset_thread_launch_counts()
        barrier.wait()
        for _ in range(per_thread):
            for fn in counted:
                kernels._count_launch(fn)
        for _ in range(10):
            kernels.window_gather(tables, idx)
            kernels.blocked_window_gather_multi(tables, idx)
            kernels.paged_window_gather(tables[0].view(1, 64), idx.view(1, 32))
        launched.append(kernels.thread_launch_counts())

    kernels.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    total = kernels.launch_counts()
    kernels.reset_launch_counts()
    want = {fn.__name__: n_threads * per_thread for fn in counted}
    assert {k: total[k] for k in want} == want
    assert all(v == 0 for k, v in total.items() if k not in want)
    assert len(launched) == n_threads
    assert all({k: c[k] for k in want} == {k: per_thread for k in want}
               for c in launched)
    assert total == {k: sum(c[k] for c in launched) for k in total}
