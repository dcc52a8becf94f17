"""``execute_many`` of the port against the JAX package's batch and the
port's own serial ``execute``: equal row multisets
(harness/oracle.py::rows_equal, tolerance 0), in input order, under the
default budget and under budgets that defer or spill plans. The JAX package
runs on the CPU with its Pallas kernels in interpret mode, the port on
``build_context("cpu")`` (no streams there: each fetch is a direct read).
"""

import ast
import os
import re

import numpy as np
import pytest

import radixjoin_tpu as ref
from radixjoin_tpu import engine as ref_engine
from radixjoin_tpu.harness.oracle import rows_equal

import radixjoin_tpu_torch as port
from radixjoin_tpu_torch import convert
from radixjoin_tpu_torch import engine as port_engine
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.harness.datagen import SyntheticIMDB

from test_fuzz_plans import gen_plan
from test_torch_engine import port_rows, ref_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = range(5000, 5006)


@pytest.fixture(scope="module")
def batch():
    """Six generated plans, their JAX batch result and the port's plans."""
    ref_plans = [gen_plan(np.random.default_rng(s)) for s in SEEDS]
    port_plans = [convert.from_reference(p) for p in ref_plans]
    ctx = ref.build_context()
    try:
        want = [ref_rows(r) for r in ref.execute_many(ref_plans, ctx)]
    finally:
        ref.destroy_context(ctx)
    return ref_plans, port_plans, want


@pytest.fixture(autouse=True)
def clean_caches():
    port_engine.clear_device_caches()
    port_engine.reset_engine_stats()
    yield
    port_engine.clear_device_caches()
    port_engine.reset_engine_stats()


def _assert_batch(results, want):
    assert len(results) == len(want)
    for i, (res, rows) in enumerate(zip(results, want)):
        ok, msg = rows_equal(port_rows(res), rows)
        assert ok, f"batch plan {i}: {msg}"


def test_batch_matches_reference_batch_and_serial(batch, monkeypatch):
    monkeypatch.delenv("RJT_HBM_BUDGET_BYTES", raising=False)
    _ref_plans, port_plans, want = batch
    ctx = port.build_context("cpu")
    _assert_batch(port.execute_many(port_plans, ctx), want)
    serial = [port.execute(p, ctx) for p in port_plans]
    _assert_batch(serial, want)
    # warm, on the first run's cardinality feedback
    again = port.execute_many(port_plans, ctx)
    _assert_batch(again, want)
    for a, b in zip(again, serial):
        assert a.num_rows == b.num_rows
        assert [int(c.type) for c in a.columns] == [
            int(c.type) for c in b.columns]
    stats = port_engine.engine_stats()
    assert all(stats[k] == 0 for k in port_engine.ENGINE_STATS)
    assert not port_engine.device_ledger("cpu")._reservations


def test_batch_under_a_4_mib_budget(batch, monkeypatch):
    ref_plans, port_plans, want = batch
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", str(4 << 20))
    ref_engine.reset_engine_stats()
    ctx = ref.build_context()
    ref_batch = [ref_rows(r) for r in ref.execute_many(ref_plans, ctx)]
    _assert_batch(port.execute_many(port_plans, port.build_context("cpu")),
                  ref_batch)
    for got, rows in zip(ref_batch, want):
        assert rows_equal(got, rows)[0]
    assert (port_engine.engine_stats()["admission_host_spills"]
            == ref_engine.engine_stats()["admission_host_spills"])
    ref_engine.reset_engine_stats()


def test_batch_of_over_budget_plans_spills_each(batch, monkeypatch):
    ref_plans, port_plans, want = batch
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", "1")
    ref_engine.reset_engine_stats()
    ref.execute_many(ref_plans, ref.build_context())
    _assert_batch(port.execute_many(port_plans, port.build_context("cpu")),
                  want)
    spills = port_engine.engine_stats()["admission_host_spills"]
    assert spills == ref_engine.engine_stats()["admission_host_spills"]
    assert spills == len(port_plans)
    ref_engine.reset_engine_stats()


def test_batch_in_stepwise_mode_is_the_serial_loop(batch, monkeypatch):
    _ref_plans, port_plans, want = batch
    monkeypatch.setenv("RJT_EXEC_MODE", "stepwise")
    for p in port_plans:
        p._fused_struct_cache = None
    _assert_batch(port.execute_many(port_plans, port.build_context("cpu")),
                  want)
    assert all(p._fused_struct_cache is None for p in port_plans)


def test_empty_batch():
    assert port.execute_many([], port.build_context("cpu")) == []


# ---------------------------------------------------------------------------
# admission: deferred plans, a plan object given twice
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shapes():
    names = sorted(set(job_shapes.S1_TABLES + job_shapes.S2_TABLES))
    tables = SyntheticIMDB(scale=0.0004, seed=0).generate(names)
    tables.update(job_shapes.f64_tables(n=3000, seed=0))
    return [job_shapes.s1_plan(tables, lazy=False),
            job_shapes.s2_plan(tables, lazy=True),
            job_shapes.s3_plan(tables, lazy=True),
            job_shapes.f64_plan(tables, lazy=True)]


def test_deferred_queue_runs_and_keeps_input_order(shapes, monkeypatch):
    """Under a budget that admits about one plan at a time the others wait
    in the deferred queue; every result equals the serial one, in input
    order, the same plan object may appear twice, and nothing degrades."""
    ctx = port.build_context("cpu")
    monkeypatch.delenv("RJT_HBM_BUDGET_BYTES", raising=False)
    serial = [port_rows(port.execute(p, ctx)) for p in shapes]
    plans = shapes + shapes
    budget = max(port_engine._estimate_query_bytes(p) for p in shapes) + (
        64 << 10)
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", str(budget))
    port_engine.clear_device_caches()
    ledger = port_engine.device_ledger("cpu")
    refused = []
    reserve = ledger.reserve

    def counting_reserve(est, budget, block=True):
        res = reserve(est, budget, block)
        if res is None:
            refused.append(est)
        return res

    monkeypatch.setattr(ledger, "reserve", counting_reserve)
    evictions = ledger.stats["evictions"]
    results = port.execute_many(plans, ctx)
    _assert_batch(results, serial + serial)
    assert refused, "no plan was deferred"
    assert ledger.stats["evictions"] > evictions
    assert ledger.pinned_bytes() <= budget
    assert not ledger._reservations
    stats = port_engine.engine_stats()
    assert all(stats[k] == 0 for k in port_engine.ENGINE_STATS)


def _fail_first_runs(monkeypatch, times: int):
    """Make the first ``times`` fused runs of each package raise its
    out-of-memory error; returns the two call logs."""
    import torch

    from radixjoin_tpu.plan import fused as ref_fused
    from radixjoin_tpu_torch.plan import fused as port_fused

    port_calls, ref_calls = [], []
    run = port_fused.run

    def failing(structure):
        port_calls.append(1)
        if len(port_calls) <= times:
            raise torch.cuda.OutOfMemoryError("injected: out of memory")
        return run(structure)

    monkeypatch.setattr(port_fused, "run", failing)

    def failing_program(attr):
        compiled = getattr(ref_fused, attr)

        def lookup(structure):
            fn = compiled(structure)

            def program(*args):
                ref_calls.append(1)
                if len(ref_calls) <= times:
                    raise RuntimeError("RESOURCE_EXHAUSTED: injected")
                return fn(*args)

            return program

        monkeypatch.setattr(ref_fused, attr, lookup)

    failing_program("compiled_plan")
    failing_program("compile_plan")
    # the reference waits for its runtime to release buffers: not here
    monkeypatch.setattr(ref_engine, "_settle_deallocs", lambda seconds=0: None)
    return port_calls, ref_calls


def test_out_of_memory_in_a_batch_retries_through_execute(shapes,
                                                          monkeypatch):
    ctx = port.build_context("cpu")
    serial = [port_rows(port.execute(p, ctx)) for p in shapes[:2]]
    port_calls, _ref_calls = _fail_first_runs(monkeypatch, 1)
    _assert_batch(port.execute_many(shapes[:2], ctx), serial)
    stats = port_engine.engine_stats()
    # the batch hands the plan to execute() and tallies nothing itself: the
    # plan then fits, so no retry of execute's own ladder was needed
    assert stats["oom_retries"] == 0 and stats["oom_host_spills"] == 0
    assert len(port_calls) == 3
    assert not port_engine.device_ledger("cpu")._reservations


@pytest.mark.parametrize("n_plans,failures,retries", [(2, 1, 0), (1, 2, 1)])
def test_out_of_memory_in_a_batch_tallies_as_the_reference(
        batch, n_plans, failures, retries, monkeypatch):
    """One plan of a batch runs out of memory: it goes to ``execute``,
    whose ladder alone tallies. A plan that then fits reads ``oom_retries``
    0 in both packages; one that fails once more, in ``execute``, reads
    1."""
    ref_plans, port_plans, want = (part[:n_plans] for part in batch)
    ref_engine.reset_engine_stats()
    ref_engine.clear_device_caches()
    port_calls, ref_calls = _fail_first_runs(monkeypatch, failures)
    ref_ctx = ref.build_context()
    ref_batch = [ref_rows(r) for r in ref.execute_many(ref_plans, ref_ctx)]
    got = port.execute_many(port_plans, port.build_context("cpu"))
    _assert_batch(got, want)
    for rows, expect in zip(ref_batch, want):
        assert rows_equal(rows, expect)[0]
    assert len(port_calls) > failures and len(ref_calls) > failures
    ref_stats, port_stats = ref_engine.engine_stats(), port_engine.engine_stats()
    ref_engine.reset_engine_stats()
    assert port_stats == ref_stats
    assert port_stats["oom_retries"] == retries
    assert port_stats["oom_host_spills"] == 0
    assert not port_engine.device_ledger("cpu")._reservations


# ---------------------------------------------------------------------------
# the package's surface
# ---------------------------------------------------------------------------


def test_public_surface():
    assert "execute_many" in port.__all__
    assert port.execute_many is port_engine.execute_many
    for name in ("engine_stats", "reset_engine_stats", "clear_device_caches",
                 "device_ledger", "DeviceLedger", "execute_device",
                 "register_device_cache_plan"):
        assert callable(getattr(port_engine, name)), name
    assert sorted(port_engine.ENGINE_STATS) == sorted(ref_engine.ENGINE_STATS)


def _package_sources():
    pkg = os.path.join(REPO, "radixjoin_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    yield os.path.relpath(path, REPO), fh.read()


def test_only_the_shared_mode_is_not_implemented():
    """Nothing of the public API is left unported: no module of the package
    raises ``NotImplementedError`` (``RJT_EXEC_MODE=shared`` was the last),
    and every mode runs."""
    hits = [(path, n) for path, source in _package_sources()
            for n, line in enumerate(source.splitlines(), 1)
            if "NotImplementedError" in line]
    assert hits == []
    for mode in ("auto", "fused", "shared", "stepwise"):
        os.environ["RJT_EXEC_MODE"] = mode
        try:
            assert port_engine._exec_mode() == mode
        finally:
            del os.environ["RJT_EXEC_MODE"]


def _imported_roots(source):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            yield name.split(".")[0]


def test_package_imports_neither_jax_nor_reference():
    """Every module of the port, the copied SQL front end, ingest, oracle
    and harness included, imports torch, numpy and the standard library
    only."""
    seen = []
    for path, source in _package_sources():
        seen.append(path)
        for root in _imported_roots(source):
            assert root not in ("jax", "jaxlib", "radixjoin_tpu"), (path, root)
        assert not re.search(r"^\s*(import|from)\s+(jax|radixjoin_tpu\b)",
                             source, re.M), path
    for module in ("sql/predicate.py", "sql/parser.py", "sql/frontend.py",
                   "sql/explain.py", "storage/ingest.py", "harness/oracle.py",
                   "harness/run.py", "harness/datagen.py",
                   "plan/executor.py", "parallel/mesh.py",
                   "parallel/multihost.py", "parallel/shuffle.py",
                   "parallel/dist_join.py", "parallel/dist_executor.py",
                   "tools/multihost_worker.py", "bench.py",
                   "harness/roofline.py", "harness/fuzz.py",
                   "tools/fuzz_campaign.py", "tools/scaling_bench.py"):
        assert os.path.join("radixjoin_tpu_torch", module) in seen


def test_chip_smoke_imports_neither_jax_nor_reference():
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        source = fh.read()
    for root in _imported_roots(source):
        assert root not in ("jax", "jaxlib", "radixjoin_tpu"), root
    assert not re.search(r"^\s*(import|from)\s+jax", source, re.M)
