"""The port's cross-process cardinality-feedback store
(``engine._FeedbackStore``) against the JAX package's.

The two stores share their key (a sha1 over the plan's nodes, its input row
counts and its root) and their JSON entry, so one file serves both
packages: a file either one writes loads into the other as the same
learned buckets. A fresh plan object over a populated store runs in one
fused attempt (two fetch rounds: the totals and the root) where an empty
store takes an overflow retry (three), with the JAX package's rows and
per-join totals (harness/oracle.py::rows_equal, tolerance 0). Stale,
switched-off, unreadable and unwritable stores stay exact and harmless.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import radixjoin_tpu as ref
from radixjoin_tpu import engine as ref_engine
from radixjoin_tpu.harness.datagen import SyntheticIMDB as RefIMDB
from radixjoin_tpu.harness.oracle import rows_equal
from radixjoin_tpu.plan.ir import Plan as RefPlan
from radixjoin_tpu.dtypes import DataType as RefDataType
from radixjoin_tpu.storage.columnar import ColumnarTable as RefTable
from radixjoin_tpu.storage.columnar import HostColumn as RefHostColumn
from radixjoin_tpu.storage.columnar import HostTable as RefHostTable

import radixjoin_tpu_torch as port
from radixjoin_tpu_torch import convert
from radixjoin_tpu_torch import engine as port_engine
from radixjoin_tpu_torch.harness import fuzz, job_shapes

from test_fuzz_plans import gen_plan
from test_torch_engine import port_rows, ref_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 0.0004
NAMES = sorted(set(job_shapes.S1_TABLES + job_shapes.S2_TABLES
                   + job_shapes.S3_TABLES))
SHAPES = {"s1": False, "s2": True, "s3": True}


@pytest.fixture(scope="module")
def ref_tables():
    tables = RefIMDB(scale=SCALE, seed=0).generate(NAMES)
    for name, t in job_shapes.f64_tables(n=2000, seed=0).items():
        # the port's FP64 tables as the JAX package's host tables
        tables[name] = RefHostTable(t.num_rows, [
            RefHostColumn(RefDataType(int(c.dtype)), c.values.copy(),
                          c.valid.copy())
            for c in t.columns])
    return tables


def _ref_plan(tables, shape):
    build = job_shapes.f64_plan if shape == "f1" else getattr(
        job_shapes, f"{shape}_plan")
    return build(tables, lazy=SHAPES.get(shape, True), plan_cls=RefPlan,
                 table_cls=RefTable)


@pytest.fixture(scope="module")
def expected(ref_tables):
    """The JAX package's rows and per-join totals of each shape, computed
    with its store off."""
    out = {}
    for shape in SHAPES:
        plan = _ref_plan(ref_tables, shape)
        rows = ref_rows(ref.execute(plan, ref.build_context()))
        out[shape] = (rows, dict(plan._last_join_totals))
    return out


@pytest.fixture
def store(tmp_path, monkeypatch):
    """A fresh port store over an empty file in ``tmp_path`` (as in a new
    process); the JAX package's global store is swapped for a fresh one too,
    so nothing of it survives the test."""
    path = tmp_path / "feedback.json"
    monkeypatch.setenv("RJT_FEEDBACK_PATH", str(path))
    monkeypatch.delenv("RJT_CARD_FEEDBACK", raising=False)
    monkeypatch.setattr(port_engine, "_FEEDBACK", port_engine._FeedbackStore())
    monkeypatch.setattr(ref_engine, "_FEEDBACK", ref_engine._FeedbackStore())
    return path


def _new_process(monkeypatch):
    """What a new process sees: a store that has read nothing yet."""
    monkeypatch.setattr(port_engine, "_FEEDBACK", port_engine._FeedbackStore())


def _run(plan):
    """Rows, per-join totals and fetch rounds of one CPU execute."""
    result = port.execute(plan, port.build_context("cpu"))
    return (port_rows(result), dict(plan._last_join_totals),
            plan._last_exec_stats["rounds"])


def _assert_expected(got_rows, got_totals, want):
    ok, msg = rows_equal(got_rows, want[0])
    assert ok, msg
    assert got_totals == want[1]


# ---------------------------------------------------------------------------
# the key and the entry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["s1", "s2", "s3", "f1"])
def test_key_equals_the_jax_key(ref_tables, shape):
    ref_plan = _ref_plan(ref_tables, shape)
    port_plan = convert.from_reference(ref_plan)
    key = port_engine._FeedbackStore._key(port_plan)
    assert key == ref_engine._FeedbackStore._key(ref_plan)
    assert port_plan._feedback_key == key  # cached on the plan
    assert len(key) == 40 and int(key, 16) >= 0


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
def test_key_of_fuzz_plans_equals_the_jax_key(seed):
    ref_plan = gen_plan(np.random.default_rng(seed))
    want = ref_engine._FeedbackStore._key(ref_plan)
    own = fuzz.gen_plan(np.random.default_rng(seed))
    assert port_engine._FeedbackStore._key(own) == want
    assert port_engine._FeedbackStore._key(
        convert.from_reference(ref_plan)) == want


def test_key_changes_with_the_input_rows(ref_tables):
    plan = convert.from_reference(_ref_plan(ref_tables, "s2"))
    other = convert.from_reference(_ref_plan(ref_tables, "s2"))
    other.inputs[0] = port.ColumnarTable(other.inputs[0].num_rows - 1,
                                         other.inputs[0].columns)
    assert (port_engine._FeedbackStore._key(plan)
            != port_engine._FeedbackStore._key(other))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_one_file_serves_both_packages(ref_tables, expected, store, writer):
    if writer == "jax":
        ref_plan = _ref_plan(ref_tables, "s2")
        ref.execute(ref_plan, ref.build_context())
        ref_engine._feedback_store().save()
        learned = ref_plan._learned_buckets
        reader = port_engine._FeedbackStore()
        plan = convert.from_reference(_ref_plan(ref_tables, "s2"))
        assert reader.load_into(plan)
        assert plan._learned_buckets == learned
        assert not hasattr(plan, "_learned_root_rows")
        # the loaded buckets take the plan through in one attempt
        rows, totals, rounds = _run(plan)
        assert rounds == 2
    else:
        plan = convert.from_reference(_ref_plan(ref_tables, "s2"))
        rows, totals, rounds = _run(plan)
        assert rounds == 3
        port_engine.destroy_context(None)  # saves
        learned = plan._learned_buckets
        reader = ref_engine._FeedbackStore()
        ref_plan = _ref_plan(ref_tables, "s2")
        reader.load_into(ref_plan)
        assert ref_plan._learned_buckets == learned
        assert ref_plan._learned_root_rows == len(expected["s2"][0])
    _assert_expected(rows, totals, expected["s2"])
    with open(store) as f:
        (entry,) = json.load(f).values()
    buckets, root_rows = entry
    assert buckets == {str(i): [pad, comp]
                       for i, (pad, comp) in learned.items()}
    assert root_rows == len(expected["s2"][0])


# ---------------------------------------------------------------------------
# what the store saves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["s1", "s2", "s3"])
def test_populated_store_saves_the_retry(ref_tables, expected, store,
                                         monkeypatch, shape):
    """S2 overflows its bucket on a cold run; S1 and S3 do not, and the
    store changes nothing for them but the buckets they start from."""
    cold = convert.from_reference(_ref_plan(ref_tables, shape))
    rows, totals, cold_rounds = _run(cold)
    _assert_expected(rows, totals, expected[shape])
    assert cold_rounds == (3 if shape == "s2" else 2)
    assert port_engine.feedback_stats()["loaded"] == 0
    port_engine.destroy_context(None)
    assert store.exists()

    _new_process(monkeypatch)
    fresh = convert.from_reference(_ref_plan(ref_tables, shape))
    rows, totals, rounds = _run(fresh)
    _assert_expected(rows, totals, expected[shape])
    assert rounds == 2  # one attempt: the totals, then the root
    assert fresh._learned_buckets == cold._learned_buckets
    stats = port_engine.feedback_stats()
    assert stats["loaded"] == 1 and stats["path"] == str(store)
    assert stats["load_errors"] == stats["save_errors"] == 0


def test_execute_many_records_and_reads_the_store(ref_tables, expected,
                                                  store, monkeypatch):
    plans = [convert.from_reference(_ref_plan(ref_tables, s))
             for s in SHAPES]
    port.execute_many(plans, port.build_context("cpu"))
    port_engine._feedback_store().save()
    with open(store) as f:
        assert len(json.load(f)) == len(SHAPES)
    _new_process(monkeypatch)
    fresh = [convert.from_reference(_ref_plan(ref_tables, s))
             for s in SHAPES]
    results = port.execute_many(fresh, port.build_context("cpu"))
    for shape, plan, result in zip(SHAPES, fresh, results):
        _assert_expected(port_rows(result), plan._last_join_totals,
                         expected[shape])
    assert port_engine.feedback_stats()["loaded"] == len(SHAPES)


def test_stale_entry_retries_and_stays_exact(ref_tables, expected, store,
                                             monkeypatch):
    learned = convert.from_reference(_ref_plan(ref_tables, "s2"))
    _run(learned)
    port_engine.destroy_context(None)
    key = port_engine._FeedbackStore._key(learned)
    entry = json.loads(store.read_text())[key]
    # the root's learned bucket an eighth of what it needs
    root = str(learned.root)
    entry[0][root][0] //= 8
    store.write_text(json.dumps({key: entry}))
    _new_process(monkeypatch)
    plan = convert.from_reference(_ref_plan(ref_tables, "s2"))
    rows, totals, rounds = _run(plan)
    _assert_expected(rows, totals, expected["s2"])
    assert rounds == 3  # the undersized pad took the overflow retry
    assert port_engine.feedback_stats()["loaded"] == 1
    port_engine._feedback_store().save()
    with open(store) as f:
        buckets, root_rows = json.load(f)[key]
    assert buckets == {str(i): [pad, comp]
                       for i, (pad, comp) in plan._learned_buckets.items()}
    assert root_rows == len(expected["s2"][0])


@pytest.mark.parametrize("how", ["path_empty", "path_unset"])
def test_switched_off_store_writes_nothing(ref_tables, expected, store,
                                           monkeypatch, how):
    if how == "path_empty":
        monkeypatch.setenv("RJT_FEEDBACK_PATH", "")
    else:
        monkeypatch.delenv("RJT_FEEDBACK_PATH")
    for _run_no in range(2):
        plan = convert.from_reference(_ref_plan(ref_tables, "s2"))
        rows, totals, rounds = _run(plan)
        _assert_expected(rows, totals, expected["s2"])
        assert rounds == 3  # every new plan object starts cold
    port_engine.destroy_context(None)
    port_engine._feedback_store().save()
    assert not os.listdir(store.parent)
    stats = port_engine.feedback_stats()
    assert stats["path"] is None and stats["loaded"] == stats["saves"] == 0


def test_path_is_read_once_per_process(ref_tables, expected, store,
                                       monkeypatch, tmp_path):
    """The store reads ``RJT_FEEDBACK_PATH`` on its first use: a path set
    later in the process moves nothing, and the entries go to the first
    file."""
    plan = convert.from_reference(_ref_plan(ref_tables, "s2"))
    _run(plan)
    other = tmp_path / "other" / "feedback.json"
    monkeypatch.setenv("RJT_FEEDBACK_PATH", str(other))
    fresh = convert.from_reference(_ref_plan(ref_tables, "s2"))
    rows, totals, rounds = _run(fresh)
    _assert_expected(rows, totals, expected["s2"])
    assert rounds == 2  # the first file's entry, still in memory
    port_engine.destroy_context(None)
    assert store.exists() and not other.parent.exists()
    assert port_engine.feedback_stats()["path"] == str(store)


def test_card_feedback_off_neither_reads_nor_writes(ref_tables, expected,
                                                    store, monkeypatch):
    plan = convert.from_reference(_ref_plan(ref_tables, "s2"))
    _run(plan)
    port_engine.destroy_context(None)
    saved = store.read_text()
    monkeypatch.setenv("RJT_CARD_FEEDBACK", "off")
    _new_process(monkeypatch)
    fresh = convert.from_reference(_ref_plan(ref_tables, "s2"))
    rows, totals, rounds = _run(fresh)
    _assert_expected(rows, totals, expected["s2"])
    assert rounds == 3 and not hasattr(fresh, "_learned_buckets")
    port_engine.destroy_context(None)
    assert store.read_text() == saved
    assert port_engine.feedback_stats()["loaded"] == 0


@pytest.mark.parametrize("fault", ["unreadable", "unwritable"])
def test_broken_store_is_harmless_and_tallied(ref_tables, expected, store,
                                              monkeypatch, fault):
    if fault == "unreadable":
        store.write_text("{not json")
    else:
        # a path below a regular file: the directory cannot be made
        blocker = store.parent / "blocker"
        blocker.write_text("")
        monkeypatch.setenv("RJT_FEEDBACK_PATH", str(blocker / "fb.json"))
    plan = convert.from_reference(_ref_plan(ref_tables, "s2"))
    rows, totals, rounds = _run(plan)
    _assert_expected(rows, totals, expected["s2"])
    assert rounds == 3
    port_engine.destroy_context(None)
    stats = port_engine.feedback_stats()
    if fault == "unreadable":
        assert stats["load_errors"] == 1 and stats["save_errors"] == 0
        # the save replaced the broken file with a good one
        assert len(json.loads(store.read_text())) == 1
    else:
        assert stats["save_errors"] == 1 and stats["saves"] == 0
        assert not (blocker / "fb.json").exists()
    # a second run of the same plan object is warm, as without a store
    assert _run(plan)[2] == 2


# ---------------------------------------------------------------------------
# across processes
# ---------------------------------------------------------------------------

_CHILD = """
import json, sys
import radixjoin_tpu_torch as port
from radixjoin_tpu_torch import engine
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.harness.datagen import SyntheticIMDB

tables = SyntheticIMDB(scale=float(sys.argv[1]), seed=0).generate(
    job_shapes.S2_TABLES)
plan = job_shapes.s2_plan(tables, lazy=True)
result = port.execute(plan, port.build_context("cpu"))
print(json.dumps({"rows": result.num_rows,
                  "rounds": plan._last_exec_stats["rounds"],
                  "totals": {str(k): v
                             for k, v in plan._last_join_totals.items()},
                  "loaded": engine.feedback_stats()["loaded"]}))
"""


def test_second_process_loads_what_the_first_saved(tmp_path):
    """The first process saves at exit; the second starts from its
    entry."""
    path = tmp_path / "store" / "feedback.json"
    env = {k: v for k, v in os.environ.items() if not k.startswith("RJT_")}
    env.update(RJT_FEEDBACK_PATH=str(path), PYTHONPATH=REPO)
    runs = []
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, str(SCALE)], cwd=str(tmp_path),
            env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs.append(json.loads(proc.stdout))
        assert path.exists()
    first, second = runs
    assert (first["rounds"], first["loaded"]) == (3, 0)
    assert (second["rounds"], second["loaded"]) == (2, 1)
    assert first["rows"] == second["rows"] > 0
    assert first["totals"] == second["totals"]
