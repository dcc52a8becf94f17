"""The port's stepwise executor, host-staged radix spill and memory
estimators against the JAX package's, on the same plans (carried over with
``convert.from_reference``). Row multisets are compared with
harness/oracle.py::rows_equal, tallies and estimates as integers: tolerance
0 throughout. The JAX package runs on the CPU with its Pallas kernels in
interpret mode, the port on ``build_context("cpu")``.
"""

import numpy as np
import pytest

import radixjoin_tpu as ref
from radixjoin_tpu import engine as ref_engine
from radixjoin_tpu.harness.datagen import SyntheticIMDB as RefIMDB
from radixjoin_tpu.harness.oracle import rows_equal
from radixjoin_tpu.plan import fused as ref_fused
from radixjoin_tpu.plan.ir import Plan as RefPlan
from radixjoin_tpu.storage.columnar import ColumnarTable as RefTable

import radixjoin_tpu_torch as port
from radixjoin_tpu_torch import convert
from radixjoin_tpu_torch import engine as port_engine
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.plan import fused as port_fused

from test_fuzz_plans import gen_plan
from test_torch_engine import SEMANTICS, port_rows, ref_rows


def run_both(ref_plan):
    """``(reference result, port result, port plan)`` of one plan."""
    port_plan = convert.from_reference(ref_plan)
    want = ref.execute(ref_plan, ref.build_context())
    got = port.execute(port_plan, port.build_context("cpu"))
    return want, got, port_plan


def assert_same_result(want, got):
    ok, msg = rows_equal(port_rows(got), ref_rows(want))
    assert ok, msg
    assert got.num_rows == want.num_rows
    assert [int(c.type) for c in got.columns] == [
        int(c.type) for c in want.columns]


# ---------------------------------------------------------------------------
# stepwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(SEMANTICS))
def test_stepwise_semantics_case_matches_reference(case, monkeypatch):
    monkeypatch.setenv("RJT_EXEC_MODE", "stepwise")
    want, got, port_plan = run_both(SEMANTICS[case]())
    assert_same_result(want, got)
    # the stepwise executor builds no fused structure
    assert getattr(port_plan, "_fused_struct_cache", None) is None


@pytest.mark.parametrize("seed", [*range(1000, 1008), *range(8)])
def test_stepwise_fuzz_plan_matches_reference(seed, monkeypatch):
    monkeypatch.setenv("RJT_EXEC_MODE", "stepwise")
    want, got, _plan = run_both(gen_plan(np.random.default_rng(seed)))
    assert_same_result(want, got)


@pytest.fixture(scope="module")
def imdb_tables():
    names = sorted(set(job_shapes.S1_TABLES + job_shapes.S2_TABLES))
    return RefIMDB(scale=0.0004, seed=0).generate(names)


@pytest.mark.parametrize("shape,lazy", [("s1", False), ("s2", True)])
def test_stepwise_job_shape_matches_reference(imdb_tables, shape, lazy,
                                              monkeypatch):
    """The JOB shapes over synthetic IMDB (S1 on eager pages, which the
    stepwise scans decode on the device route, S2 on lazy ones)."""
    monkeypatch.setenv("RJT_EXEC_MODE", "stepwise")
    build = getattr(job_shapes, f"{shape}_plan")
    want, got, port_plan = run_both(build(
        imdb_tables, lazy=lazy, plan_cls=RefPlan, table_cls=RefTable))
    assert_same_result(want, got)
    assert got.num_rows > 0
    assert getattr(port_plan, "_fused_struct_cache", None) is None


def _check_declined(case, monkeypatch):
    monkeypatch.setattr(ref_fused.FusedPlan, "_varchar_dev_csr",
                        lambda self, *a: None)
    monkeypatch.setattr(port_fused.FusedPlan, "_varchar_dev_csr",
                        lambda self, *a: None)
    stepwise_calls = []
    run_stepwise = port_engine.execute_device
    monkeypatch.setattr(
        port_engine, "execute_device",
        lambda plan, ctx=None: stepwise_calls.append(1) or run_stepwise(
            plan, ctx))
    ref_plan = SEMANTICS[case]()
    port_plan = convert.from_reference(ref_plan)
    got = port.execute(port_plan, port.build_context("cpu"))
    # the JAX package under its default mode (its wave executor)
    monkeypatch.delenv("RJT_EXEC_MODE", raising=False)
    want = ref.execute(ref_plan, ref.build_context())
    assert_same_result(want, got)
    assert stepwise_calls == [1]
    assert port_plan._fused_struct_cache[1].has_varchar_key
    return want, port_plan, stepwise_calls


@pytest.mark.parametrize("case", ["varchar_join_keys",
                                  "varchar_join_keys_fuse"])
def test_varchar_key_without_joint_window_falls_back(case, monkeypatch):
    """A VARCHAR key whose dictionaries have no joint window (here: the
    lowering is made to decline) is declined by the fused structure. In
    ``auto`` mode the port serves it by the stepwise executor, through
    ``execute`` and ``execute_many`` alike; the JAX package serves it by its
    wave executor. The rows are equal."""
    monkeypatch.delenv("RJT_EXEC_MODE", raising=False)
    want, port_plan, stepwise_calls = _check_declined(case, monkeypatch)
    # the batch API takes the same fallback
    (again,) = port.execute_many([port_plan], port.build_context("cpu"))
    assert_same_result(want, again)
    assert stepwise_calls == [1, 1]


@pytest.mark.parametrize("case", ["varchar_join_keys",
                                  "varchar_join_keys_fuse"])
def test_declined_plan_in_fused_mode_takes_the_stepwise_walk(case,
                                                             monkeypatch):
    """``RJT_EXEC_MODE=fused`` names the same route as ``auto``: a plan the
    fused structure declines goes to the stepwise executor, through
    ``execute`` and through ``execute_many``."""
    monkeypatch.setenv("RJT_EXEC_MODE", "fused")
    want, port_plan, stepwise_calls = _check_declined(case, monkeypatch)
    monkeypatch.setenv("RJT_EXEC_MODE", "fused")
    (again,) = port.execute_many([port_plan], port.build_context("cpu"))
    assert_same_result(want, again)
    assert stepwise_calls == [1, 1]


def test_exec_mode_shared_and_unknown_modes_raise(monkeypatch):
    """The port's modes are ``auto``, ``fused`` and ``stepwise``: ``shared``
    (the JAX package's wave executor) raises like any unknown mode, from
    ``execute`` and from ``execute_many``."""
    plan = convert.from_reference(SEMANTICS["simple_join"]())
    ctx = port.build_context("cpu")
    for mode in ("shared", "warp"):
        monkeypatch.setenv("RJT_EXEC_MODE", mode)
        with pytest.raises(ValueError, match="RJT_EXEC_MODE"):
            port.execute(plan, ctx)
        with pytest.raises(ValueError, match="RJT_EXEC_MODE"):
            port.execute_many([plan], ctx)
    monkeypatch.setenv("RJT_EXEC_MODE", "fused")
    assert port.execute(plan, ctx).num_rows == 3


def test_stepwise_device_tables_roundtrip():
    """DevTable helpers: host -> device -> host is the identity, and
    ``execute_device`` returns the root padded to its pow2 bucket."""
    ref_plan = SEMANTICS["null_payloads_flow_through"]()
    port_plan = convert.from_reference(ref_plan)
    host = port_plan.inputs[0].to_host()
    dev = port_engine.host_table_to_device(host, "cpu")
    assert dev.padded_rows == 128 and dev.num_rows == host.num_rows
    back = port_engine.device_table_to_host(dev)
    assert back.to_rows() == host.to_rows()
    root = port_engine.execute_device(port_plan, port.build_context("cpu"))
    assert root.num_rows == 2 and root.padded_rows == 128
    want = ref_engine.execute_device(ref_plan)
    assert want.num_rows == root.num_rows
    for g, w in zip(root.columns, want.columns):
        np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))


# ---------------------------------------------------------------------------
# spill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_spill_fuzz_plan_matches_reference(seed, monkeypatch):
    ref_plan = gen_plan(np.random.default_rng(3000 + seed))
    # 4 KiB, or less where the plan's inputs fit in that: the inputs alone
    # exceed the budget, so every plan takes the spill
    scan_bytes = port_engine._estimate_scan_bytes(
        convert.from_reference(ref_plan))
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES",
                       str(min(4096, scan_bytes - 1)))
    ref_engine.reset_engine_stats()
    port_engine.reset_engine_stats()
    want, got, port_plan = run_both(ref_plan)
    assert_same_result(want, got)
    ref_stats, port_stats = ref_engine.engine_stats(), port_engine.engine_stats()
    assert port_stats == ref_stats
    assert port_stats["admission_host_spills"] == 1
    assert sorted(port_stats) == sorted(ref_stats)  # the same keys
    # the spill computed its partition counts from an eighth of the budget
    assert all(p >= 1 for p in port_plan._last_spill_partitions.values())
    ref_engine.reset_engine_stats()
    port_engine.reset_engine_stats()


@pytest.mark.parametrize("case", sorted(SEMANTICS))
def test_spill_semantics_case_matches_reference(case, monkeypatch):
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", "1")
    port_engine.reset_engine_stats()
    want, got, _plan = run_both(SEMANTICS[case]())
    assert_same_result(want, got)
    assert port_engine.engine_stats()["admission_host_spills"] == 1
    port_engine.reset_engine_stats()
    ref_engine.reset_engine_stats()


def test_host_normalize_keys_equal():
    from radixjoin_tpu.dtypes import DataType as RefDT
    from radixjoin_tpu.storage.columnar import HostColumn as RefHostColumn
    from radixjoin_tpu_torch.dtypes import DataType as PortDT
    from radixjoin_tpu_torch.storage.columnar import HostColumn as PortHostColumn

    a = np.array([0.0, -0.0, float("nan"), 1.5, -2.25])
    b = np.array([-0.0, 0.0, float("nan"), 7.0, 1.5])
    va = np.array([True, True, True, False, True])
    vb = np.array([True, True, True, True, True])
    want = ref_engine._host_normalize_keys(
        RefHostColumn(RefDT.FP64, a, va), RefHostColumn(RefDT.FP64, b, vb))
    got = port_engine._host_normalize_keys(
        PortHostColumn(PortDT.FP64, a, va), PortHostColumn(PortDT.FP64, b, vb))
    for (gk, gv), (wk, wv) in zip(got, want):
        assert isinstance(gk, np.ndarray) and gk.dtype == wk.dtype
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gv, wv)
    assert port_engine._host_normalize_keys(
        PortHostColumn(PortDT.FP64, a, va),
        PortHostColumn(PortDT.INT64, np.arange(5), va)) is None


# ---------------------------------------------------------------------------
# estimators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3000, 3001, 3002, 3003, 1003, 5001])
def test_estimators_equal_before_and_after_a_run(seed, monkeypatch):
    monkeypatch.delenv("RJT_HBM_BUDGET_BYTES", raising=False)
    ref_plan = gen_plan(np.random.default_rng(seed))
    port_plan = convert.from_reference(ref_plan)

    def estimates():
        return ((ref_engine._estimate_scan_bytes(ref_plan),
                 ref_engine._estimate_query_bytes(ref_plan)),
                (port_engine._estimate_scan_bytes(port_plan),
                 port_engine._estimate_query_bytes(port_plan)))

    want, got = estimates()
    assert got == want and got[1] >= got[0] > 0
    ref.execute(ref_plan, ref.build_context())
    port.execute(port_plan, port.build_context("cpu"))
    want, got = estimates()  # with the learned buckets of the run
    assert got == want
    assert getattr(port_plan, "_learned_buckets", None) == getattr(
        ref_plan, "_learned_buckets", None)


def test_hbm_budget_reads_the_environment_or_the_device(monkeypatch):
    from radixjoin_tpu_torch import hardware

    ctx = port.build_context("cpu")
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", "12345")
    assert port_engine._hbm_budget(ctx) == 12345
    monkeypatch.delenv("RJT_HBM_BUDGET_BYTES")
    assert port_engine._hbm_budget(ctx) == hardware.detect("cpu").hbm_bytes // 2
