"""The two JOB-shaped smoke plans (radixjoin_tpu_torch/harness/job_shapes.py)
at a tiny synthetic-IMDB scale, through the port and the JAX package: the
port's generator must give the JAX package's tables for the same
``(scale, seed)``, and both engines the same rows, per-join totals and
join strategies (unique_scatter, csr and dev_csr between them)."""

import pytest

from radixjoin_tpu.harness.datagen import SyntheticIMDB as RefIMDB
from radixjoin_tpu.plan.ir import Plan as RefPlan
from radixjoin_tpu.storage.columnar import ColumnarTable as RefTable
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.harness.datagen import SyntheticIMDB

from test_torch_engine import assert_same_tables, check_parity

SCALE = 0.0004
NAMES = sorted(set(job_shapes.S1_TABLES + job_shapes.S2_TABLES))


@pytest.fixture(scope="module")
def ref_tables():
    return RefIMDB(scale=SCALE, seed=0).generate(NAMES)


def test_port_datagen_equals_reference(ref_tables):
    assert_same_tables(ref_tables,
                       SyntheticIMDB(scale=SCALE, seed=0).generate(NAMES))


@pytest.mark.parametrize("shape,lazy,want", [
    ("s1", False, {"unique_scatter", "dev_csr"}),
    ("s2", True, {"unique_scatter", "csr"}),
])
def test_job_shape_matches_reference(ref_tables, shape, lazy, want):
    build = getattr(job_shapes, f"{shape}_plan")
    ref_plan = build(ref_tables, lazy=lazy, plan_cls=RefPlan,
                     table_cls=RefTable)
    port_plan = check_parity(ref_plan)
    assert set(port_plan._fused_struct_cache[1].strategies().values()) == want
