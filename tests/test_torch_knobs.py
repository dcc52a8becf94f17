"""The strategy knobs of docs/CONFIG.md in the port against the JAX package
under the same value: ``RJT_UNIQUE_JOIN``, ``RJT_CSR_JOIN``, ``RJT_DEV_CSR``,
``RJT_BIG_MERGE``, ``RJT_CARD_FEEDBACK`` on the fused executor (equal rows,
per-join totals and join strategies); tolerance 0. An unknown value raises,
and a knob changed between two runs of one plan object changes the route.
The JAX package runs on the CPU with its Pallas kernels in interpret mode,
the port on ``build_context("cpu")``.
"""

import numpy as np
import pytest

from radixjoin_tpu.harness.datagen import SyntheticIMDB as RefIMDB
from radixjoin_tpu.harness.oracle import rows_equal
from radixjoin_tpu.plan.ir import Plan as RefPlan
from radixjoin_tpu.storage.columnar import ColumnarTable as RefTable

import radixjoin_tpu_torch as port
from radixjoin_tpu_torch import convert
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.plan import executor as port_exec
from radixjoin_tpu_torch.plan import fused as port_fused

from test_fuzz_plans import gen_plan
from test_torch_engine import SEMANTICS, check_parity, port_rows

KNOBS = ("RJT_UNIQUE_JOIN", "RJT_CSR_JOIN", "RJT_DEV_CSR", "RJT_BIG_MERGE",
         "RJT_CARD_FEEDBACK")

#: every documented value of every knob the port keeps (defaults included)
VALUES = [
    ("RJT_UNIQUE_JOIN", "auto"), ("RJT_UNIQUE_JOIN", "scatter"),
    ("RJT_UNIQUE_JOIN", "sort"),
    ("RJT_CSR_JOIN", "auto"), ("RJT_CSR_JOIN", "force"),
    ("RJT_CSR_JOIN", "off"),
    ("RJT_DEV_CSR", "auto"), ("RJT_DEV_CSR", "force"), ("RJT_DEV_CSR", "off"),
    ("RJT_BIG_MERGE", "0"), ("RJT_BIG_MERGE", "1024"),
    ("RJT_BIG_MERGE", str(1 << 23)),
    ("RJT_CARD_FEEDBACK", "on"), ("RJT_CARD_FEEDBACK", "off"),
]


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    monkeypatch.delenv("RJT_EXEC_MODE", raising=False)
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module")
def imdb_tables():
    names = sorted(set(job_shapes.S1_TABLES + job_shapes.S2_TABLES))
    return RefIMDB(scale=0.0004, seed=0).generate(names)


def _plans(imdb_tables):
    """Reference plans that between them take every strategy: unique joins
    over dense and (int64 keys) sparse windows, csr on either side, dev_csr,
    merge."""
    def shape(name, lazy):
        return getattr(job_shapes, f"{name}_plan")(
            imdb_tables, lazy=lazy, plan_cls=RefPlan, table_cls=RefTable)

    return {
        "s1": lambda: shape("s1", False),
        "s2": lambda: shape("s2", True),
        "three_way": SEMANTICS["three_way_join_tree"],
        "fanout": SEMANTICS["duplicate_heavy_fanout"],
        "int64": SEMANTICS["int64_keys"],
        "fuzz1003": lambda: gen_plan(np.random.default_rng(1003)),
    }


@pytest.mark.parametrize("knob,value", VALUES)
def test_knob_on_the_fused_executor_matches_reference(knob, value,
                                                      imdb_tables,
                                                      monkeypatch):
    monkeypatch.setenv(knob, value)
    for name, build in _plans(imdb_tables).items():
        port_plan = check_parity(build())
        if knob == "RJT_CARD_FEEDBACK":
            assert hasattr(port_plan, "_learned_buckets") == (value == "on")


def _strategies(plan):
    return sorted(plan._fused_struct_cache[1].strategies().values())


@pytest.mark.parametrize("knob,value,before,after", [
    ("RJT_CSR_JOIN", "off", "csr", "dev_csr"),
    ("RJT_BIG_MERGE", "1024", "csr", "merge"),
    ("RJT_UNIQUE_JOIN", "sort", "unique_scatter", "unique_sort"),
])
def test_knob_changed_between_runs_of_one_plan_changes_the_route(
        knob, value, before, after, imdb_tables, monkeypatch):
    """The fused structure is cached on the plan object; the knobs are part
    of its key, so the second run is not served the first run's structure."""
    plan = job_shapes.s2_plan(
        {n: convert._copy_host_table(t) for n, t in imdb_tables.items()})
    ctx = port.build_context("cpu")
    first = port_rows(port.execute(plan, ctx))
    assert before in _strategies(plan) and after not in _strategies(plan)
    structure = plan._fused_struct_cache[1]
    monkeypatch.setenv(knob, value)
    second = port_rows(port.execute(plan, ctx))
    assert plan._fused_struct_cache[1] is not structure
    assert after in _strategies(plan) and before not in _strategies(plan)
    assert rows_equal(second, first)[0]
    monkeypatch.delenv(knob)
    third = port_rows(port.execute(plan, ctx))
    assert before in _strategies(plan) and rows_equal(third, first)[0]


@pytest.mark.parametrize("mode,knob", [("fused", k) for k in KNOBS])
def test_unknown_knob_value_raises(mode, knob, monkeypatch):
    monkeypatch.setenv("RJT_EXEC_MODE", mode)
    monkeypatch.setenv(knob, "bogus")
    plan = convert.from_reference(SEMANTICS["simple_join"]())
    with pytest.raises(ValueError, match=knob):
        port.execute(plan, port.build_context("cpu"))


def test_knob_defaults_and_state():
    assert port_exec.unique_join_mode() == "auto"
    assert port_exec.csr_join_mode() == "auto"
    assert port_exec.dev_csr_mode() == "auto"
    assert port_exec.card_feedback_on()
    assert port_fused.big_merge_pad() == port_fused.BIG_MERGE_PAD == 1 << 23
    assert port_exec.strategy_knobs() == ("auto", "auto", "auto", 1 << 23)
