"""The port's wave executor (``RJT_EXEC_MODE=shared``,
radixjoin_tpu_torch/plan/executor.py) against the JAX package's, on the same
plans (carried over with ``convert.from_reference``): equal row multisets
(harness/oracle.py::rows_equal), equal per-join totals, equal column types
and equal ``path_stats()`` deltas — tolerance 0 throughout. The JAX package
runs on the CPU with its Pallas kernels in interpret mode, the port on
``build_context("cpu")``.
"""

import numpy as np
import pytest

import radixjoin_tpu as ref
from radixjoin_tpu import engine as ref_engine
from radixjoin_tpu.harness.datagen import SyntheticIMDB as RefIMDB
from radixjoin_tpu.harness.oracle import rows_equal
from radixjoin_tpu.plan import executor as ref_exec
from radixjoin_tpu.plan.ir import Plan as RefPlan
from radixjoin_tpu.storage.columnar import ColumnarTable as RefTable
from radixjoin_tpu.storage.columnar import HostTable as RefHostTable

import radixjoin_tpu_torch as port
from radixjoin_tpu_torch import convert
from radixjoin_tpu_torch import engine as port_engine
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.harness.datagen import SyntheticIMDB
from radixjoin_tpu_torch.plan import executor as port_exec

from test_fuzz_plans import gen_plan
from test_torch_engine import SEMANTICS, _paged_plan, port_rows, ref_rows

I64 = ref.DataType.INT64
I32 = ref.DataType.INT32


@pytest.fixture(autouse=True)
def shared_mode(monkeypatch):
    monkeypatch.setenv("RJT_EXEC_MODE", "shared")
    for knob in ("RJT_SHRINK_MIN_PAD", "RJT_SHRINK_MAX_SYNCS",
                 "RJT_CARD_FEEDBACK", "RJT_GENERAL_JOIN"):
        monkeypatch.delenv(knob, raising=False)


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def run_ref(ref_plan, monkeypatch):
    """``(result, per-join totals, path_stats delta)`` of one execution of
    the JAX package's wave executor."""
    seen = {}
    run_plan = ref_exec.run_plan

    def spy(*args, **kwargs):
        out = run_plan(*args, **kwargs)
        seen["totals"] = dict(out[1])
        return out

    monkeypatch.setattr(ref_exec, "run_plan", spy)
    before = ref_exec.path_stats()
    result = ref.execute(ref_plan, ref.build_context())
    monkeypatch.setattr(ref_exec, "run_plan", run_plan)
    return result, seen.get("totals", {}), _delta(ref_exec.path_stats(),
                                                  before)


def run_port(port_plan):
    before = port_exec.path_stats()
    result = port.execute(port_plan, port.build_context("cpu"))
    return (result, dict(port_plan._last_join_totals),
            _delta(port_exec.path_stats(), before))


def assert_same(want, got):
    (w_res, w_totals, w_paths), (g_res, g_totals, g_paths) = want, got
    ok, msg = rows_equal(port_rows(g_res), ref_rows(w_res))
    assert ok, msg
    assert g_res.num_rows == w_res.num_rows
    assert [int(c.type) for c in g_res.columns] == [
        int(c.type) for c in w_res.columns]
    assert g_totals == w_totals
    assert g_paths == w_paths


def check_shared(ref_plan, monkeypatch, runs: int = 2):
    """Hold the port's wave executor to the reference's over ``runs``
    executions of one plan object each (the later ones on the cardinality
    feedback of the first). Returns the port plan."""
    port_plan = convert.from_reference(ref_plan)
    for _run in range(runs):
        assert_same(run_ref(ref_plan, monkeypatch), run_port(port_plan))
        assert getattr(port_plan, "_learned_buckets", None) == getattr(
            ref_plan, "_learned_buckets", None)
    # the wave executor builds no fused structure
    assert getattr(port_plan, "_fused_struct_cache", None) is None
    return port_plan


@pytest.mark.parametrize("case", sorted(SEMANTICS))
def test_shared_semantics_case_matches_reference(case, monkeypatch):
    check_shared(SEMANTICS[case](), monkeypatch)


@pytest.mark.parametrize("seed", range(1000, 1008))
def test_shared_fuzz_plan_matches_reference(seed, monkeypatch):
    check_shared(gen_plan(np.random.default_rng(seed)), monkeypatch)


@pytest.mark.parametrize("general", ["merge", "sort3"])
def test_shared_general_join_formulations(general, monkeypatch):
    """``RJT_GENERAL_JOIN``: the merge and the three-sort formulation of a
    join without a key window (here FP64 and VARCHAR keys)."""
    monkeypatch.setenv("RJT_GENERAL_JOIN", general)
    for case in ("fp64_keys_zero_and_nan", "varchar_join_keys"):
        check_shared(SEMANTICS[case](), monkeypatch, runs=1)
    monkeypatch.setenv("RJT_GENERAL_JOIN", "quick")
    with pytest.raises(ValueError, match="RJT_GENERAL_JOIN"):
        port.execute(convert.from_reference(
            SEMANTICS["fp64_keys_zero_and_nan"]()), port.build_context("cpu"))


@pytest.fixture(scope="module")
def imdb_tables():
    names = sorted(set(job_shapes.S1_TABLES + job_shapes.S2_TABLES))
    return RefIMDB(scale=0.0004, seed=0).generate(names)


@pytest.mark.parametrize("shape,lazy,want", [
    ("s1", False, {"unique_scatter", "dev_csr"}),
    ("s2", True, {"unique_scatter", "general_csr"}),
])
def test_shared_job_shape_matches_reference(imdb_tables, shape, lazy, want,
                                            monkeypatch):
    build = getattr(job_shapes, f"{shape}_plan")
    ref_plan = build(imdb_tables, lazy=lazy, plan_cls=RefPlan,
                     table_cls=RefTable)
    before = port_exec.path_stats()
    check_shared(ref_plan, monkeypatch)
    assert {k.replace("_swapped", "") for k in _delta(
        port_exec.path_stats(), before)} == want


def test_shared_eager_pages_decode_on_device(monkeypatch):
    from radixjoin_tpu_torch.ops import kernels

    calls = []
    plain = kernels.paged_window_gather_plain
    monkeypatch.setattr(kernels, "paged_window_gather_plain",
                        lambda b, i: calls.append(i.shape) or plain(b, i))
    check_shared(_paged_plan(np.random.default_rng(42), lazy=False),
                 monkeypatch)
    # one paged decode per eager column, then served from the upload memo
    assert sorted(tuple(c) for c in calls) == [(1, 1920)] * 3 + [(2, 1920)]


# ---------------------------------------------------------------------------
# cardinality feedback (tests/test_radix_and_unique.py, wave executor cases)
# ---------------------------------------------------------------------------


def _path_counter_plan():
    """PK ⋈ FK under a second PK table: the inner join is eligible for the
    unique fast path, the root is always of the general family."""
    def table(values):
        return RefTable.from_host(RefHostTable.from_rows(
            [(v,) for v in values], [I32]))

    plan = RefPlan()
    a = plan.new_scan_node(plan.new_input(table([1, 2, 3])), [(0, I32)])
    b = plan.new_scan_node(plan.new_input(table([2, 2, 3, 9])), [(0, I32)])
    j1 = plan.new_join_node(True, a, b, 0, 0, [(0, I32)])
    c = plan.new_scan_node(plan.new_input(table([1, 2, 3])), [(0, I32)])
    plan.root = plan.new_join_node(True, c, j1, 0, 0, [(1, I32)])
    return plan


def test_shared_path_stats_counters(monkeypatch):
    port_plan = convert.from_reference(_path_counter_plan())
    result, _totals, paths = run_port(port_plan)
    assert result.num_rows == 3
    assert sum(paths.values()) == 2
    assert any(k.startswith("unique_") for k in paths)
    assert any(k.startswith("general_") for k in paths)
    assert_same(run_ref(_path_counter_plan(), monkeypatch),
                run_port(convert.from_reference(_path_counter_plan())))


def _feedback_plan():
    rng = np.random.default_rng(5)
    n_pk, n_fk = 300, 4000
    pk_rows = [[int(k), int(k) * 7] for k in rng.permutation(n_pk)]
    fk_rows = [[int(k)] for k in rng.integers(0, n_pk, n_fk)]
    dim_rows = [[int(k) * 7, int(k)] for k in range(0, n_pk, 2)]
    plan = RefPlan()
    a = plan.new_scan_node(plan.new_input(RefTable.from_host(
        RefHostTable.from_rows(pk_rows, [I64, I64]))), [(0, I64), (1, I64)])
    b = plan.new_scan_node(plan.new_input(RefTable.from_host(
        RefHostTable.from_rows(fk_rows, [I64]))), [(0, I64)])
    j1 = plan.new_join_node(True, a, b, 0, 0, [(0, I64), (1, I64)])
    c = plan.new_scan_node(plan.new_input(RefTable.from_host(
        RefHostTable.from_rows(dim_rows, [I64, I64]))), [(0, I64), (1, I64)])
    plan.root = plan.new_join_node(True, c, j1, 0, 1, [(1, I64), (2, I64)])
    return plan


def test_shared_cardinality_feedback_repeat_and_stale(monkeypatch):
    """The second execution runs on learned exact buckets; poisoned
    feedback, in both polarities of the compacted flag, is detected and
    recomputed exactly as the reference does (equal path counts: the same
    joins re-ran)."""
    ref_plan = _feedback_plan()
    port_plan = check_shared(ref_plan, monkeypatch)
    assert port_plan._learned_buckets
    for flip in (False, True):
        poisoned = {i: (128, fl != flip)
                    for i, (_p, fl) in port_plan._learned_buckets.items()}
        ref_plan._learned_buckets = dict(poisoned)
        port_plan._learned_buckets = dict(poisoned)
        assert_same(run_ref(ref_plan, monkeypatch), run_port(port_plan))
        assert port_plan._learned_buckets == ref_plan._learned_buckets


def test_shared_feedback_off_learns_nothing(monkeypatch):
    monkeypatch.setenv("RJT_CARD_FEEDBACK", "off")
    ref_plan = _feedback_plan()
    port_plan = convert.from_reference(ref_plan)
    assert_same(run_ref(ref_plan, monkeypatch), run_port(port_plan))
    assert not hasattr(port_plan, "_learned_buckets")
    assert not hasattr(ref_plan, "_learned_buckets")


# ---------------------------------------------------------------------------
# overflow: in a synced wave (re-dispatched at once) and in a never-synced
# wave (the ancestor chain recomputed at the end)
# ---------------------------------------------------------------------------


def _overflow_plan():
    """A fan-out join (300 x 300 equal keys, 90,000 rows in a bucket seeded
    at 512) under a unique join."""
    def table(values):
        return RefTable.from_host(RefHostTable.from_rows(
            [(v,) for v in values], [I32]), lazy=True)

    plan = RefPlan()
    a = plan.new_scan_node(plan.new_input(table([7] * 300 + [8])), [(0, I32)])
    b = plan.new_scan_node(plan.new_input(table([7] * 300 + [9])), [(0, I32)])
    j1 = plan.new_join_node(True, a, b, 0, 0, [(0, I32), (1, I32)])
    c = plan.new_scan_node(plan.new_input(table([7, 8, 9])), [(0, I32)])
    plan.root = plan.new_join_node(True, c, j1, 0, 0, [(0, I32), (2, I32)])
    return plan


@pytest.mark.parametrize("synced", [True, False])
def test_shared_overflow_is_recomputed(synced, monkeypatch):
    if synced:
        monkeypatch.setenv("RJT_SHRINK_MIN_PAD", "128")
    ref_plan = _overflow_plan()
    port_plan = convert.from_reference(ref_plan)
    before = port_exec.sync_stats()
    want, got = run_ref(ref_plan, monkeypatch), run_port(port_plan)
    assert_same(want, got)
    assert got[0].num_rows == 90000
    stats = _delta(port_exec.sync_stats(), before)
    assert port_plan._last_exec_stats["shrink_syncs"] == int(synced)
    if synced:
        # the overflowed join alone re-ran, before its consumer was built:
        # one fetch of the remaining totals was enough
        assert stats["redispatches"] == 1 and stats["totals_fetches"] == 1
    else:
        # found at the end: the join and its ancestor re-ran
        assert stats["redispatches"] == 2 and stats["totals_fetches"] == 2
    # warm: exact buckets from the feedback, nothing re-runs
    before = port_exec.sync_stats()
    assert_same(run_ref(ref_plan, monkeypatch), run_port(port_plan))
    assert "redispatches" not in _delta(port_exec.sync_stats(), before)


# ---------------------------------------------------------------------------
# host syncs: every fetch goes through engine._fetch
# ---------------------------------------------------------------------------


def test_shared_sync_count_cold_and_warm(monkeypatch):
    """An S1-shaped plan whose first wave holds a node over the shrink
    threshold: cold, one shrink sync, one fetch of the remaining totals per
    attempt and the root's fetch; warm, on the feedback, no shrink sync —
    two fetches in all."""
    monkeypatch.setenv("RJT_SHRINK_MIN_PAD", "2048")
    tables = SyntheticIMDB(scale=0.002, seed=0).generate(
        list(job_shapes.S1_TABLES))
    plan = job_shapes.s1_plan(tables, lazy=False)
    fetches = []
    fetch = port_engine._fetch
    monkeypatch.setattr(port_engine, "_fetch",
                        lambda ts: fetches.append(len(ts)) or fetch(ts))
    ctx = port.build_context("cpu")
    cold = port.execute(plan, ctx)
    stats = dict(plan._last_exec_stats)
    assert stats["shrink_syncs"] == 1
    assert stats["rounds"] == len(fetches)
    assert len(fetches) <= 1 + 2 + 1  # at most one overflow attempt
    del fetches[:]
    warm = port.execute(plan, ctx)
    assert plan._last_exec_stats["shrink_syncs"] == 0
    assert plan._last_exec_stats["rounds"] == len(fetches) == 2
    assert fetches[0] == 1  # every remaining total in one stacked tensor
    assert ctx.last_exec_stats is plan._last_exec_stats
    assert rows_equal(port_rows(warm), port_rows(cold))[0]
    # the same rows as the fused executor's
    monkeypatch.setenv("RJT_EXEC_MODE", "fused")
    fused = port.execute(job_shapes.s1_plan(tables, lazy=False), ctx)
    assert rows_equal(port_rows(fused), port_rows(cold))[0]


def test_shared_shrink_copies_its_slice(monkeypatch):
    """A compacted node shrinks to a copy of its leading rows, not to a
    view that would keep the whole bucket alive."""
    import torch

    big = torch.arange(4096)
    node = port_exec._NodeResult([(big, big > 5)], None, 4096, True, [None])
    small = port_exec._shrink_node(node, 100)
    assert small.pad == 128 and small.total_dev == 100 and small.compacted
    data, valid = small.cols[0]
    assert data.untyped_storage().nbytes() == 128 * 8
    assert torch.equal(data, big[:128]) and torch.equal(valid, big[:128] > 5)
    monkeypatch.setattr(port_exec, "SHRINK_COPY", False)
    view = port_exec._shrink_node(node, 100)
    assert view.cols[0][0].untyped_storage().nbytes() == 4096 * 8
    # a bucket already exact is kept as it is
    assert port_exec._shrink_node(node, 3000) is node and node.total_dev == 3000


def test_shared_levels_and_policy(monkeypatch):
    plan = convert.from_reference(SEMANTICS["three_way_join_tree"]())
    assert port_exec._levels(plan, plan.topo_order()) == {
        0: 0, 1: 0, 2: 0, 3: 1, 4: 2}
    assert port_exec._shrink_policy() == ref_exec._shrink_policy() == (
        1 << 18, 1)
    monkeypatch.setenv("RJT_SHRINK_MIN_PAD", "4096")
    monkeypatch.setenv("RJT_SHRINK_MAX_SYNCS", "3")
    assert port_exec._shrink_policy() == ref_exec._shrink_policy() == (4096, 3)
    monkeypatch.setenv("RJT_SHRINK_MAX_SYNCS", "many")
    with pytest.raises(ValueError, match="RJT_SHRINK_MAX_SYNCS"):
        port_exec._shrink_policy()
    assert port_exec._SHRINK_FACTOR == ref_exec._SHRINK_FACTOR


def test_shared_mode_in_a_batch_is_the_serial_loop(monkeypatch):
    ref_plans = [gen_plan(np.random.default_rng(s)) for s in (1000, 1001)]
    port_plans = [convert.from_reference(p) for p in ref_plans]
    calls = []
    run = port_exec.execute_shared
    monkeypatch.setattr(port_exec, "execute_shared",
                        lambda *a: calls.append(1) or run(*a))
    results = port.execute_many(port_plans, port.build_context("cpu"))
    assert calls == [1, 1]
    for res, ref_plan in zip(results, ref_plans):
        want = ref.execute(ref_plan, ref.build_context())
        ok, msg = rows_equal(port_rows(res), ref_rows(want))
        assert ok, msg
    ref_engine.reset_engine_stats()
