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


def test_out_of_memory_in_a_batch_retries_through_execute(shapes,
                                                          monkeypatch):
    import torch

    from radixjoin_tpu_torch.plan import fused as port_fused

    ctx = port.build_context("cpu")
    serial = [port_rows(port.execute(p, ctx)) for p in shapes[:2]]
    run = port_fused.run
    calls = []

    def failing(structure):
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("injected: out of memory")
        return run(structure)

    monkeypatch.setattr(port_fused, "run", failing)
    _assert_batch(port.execute_many(shapes[:2], ctx), serial)
    stats = port_engine.engine_stats()
    assert stats["oom_retries"] == 1 and stats["oom_host_spills"] == 0
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


def test_only_the_shared_mode_is_not_implemented():
    hits = []
    pkg = os.path.join(REPO, "radixjoin_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    for n, line in enumerate(fh, 1):
                        if "NotImplementedError" in line:
                            hits.append((os.path.relpath(
                                os.path.join(root, f), REPO), n))
    assert len(hits) == 1 and hits[0][0] == os.path.join(
        "radixjoin_tpu_torch", "engine.py"), hits
    with open(os.path.join(REPO, hits[0][0])) as fh:
        lines = fh.readlines()
    assert "RJT_EXEC_MODE=shared" in lines[hits[0][1]]


def test_chip_smoke_imports_neither_jax_nor_reference():
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        source = fh.read()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib",
                                              "radixjoin_tpu"), name
    assert not re.search(r"^\s*(import|from)\s+jax", source, re.M)
