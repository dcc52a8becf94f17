"""joingraph_imdb_sf1: the join graphs of JOB over IMDB at scale 1.0 with
the selections removed, the large-intermediate regime of JOB's weakly
filtered queries.

Three plans, copied from the port's ``harness/job_shapes.py`` (S1-S3):

* ``S1`` (JOB 1a-shaped): ``company_type ⋈ movie_companies``,
  ``info_type ⋈ movie_info_idx``, ``title ⋈ (ct ⋈ mc)`` and the root on
  ``movie_id``; inputs as eager pages. Output (movie_id, info_type id,
  production_year, company kind).
* ``S2`` (fan-out): ``movie_keyword ⋈ (role_type ⋈ cast_info)`` on
  ``movie_id``; inputs handed over lazily (host columns). Output
  (movie_id, keyword_id, person_id), about 79.6 M rows.
* ``S3`` (merge): two ``role_type ⋈ cast_info`` intermediates joined on
  ``cast_info.id``; lazy inputs. Output (cast_info id, movie_id,
  person_id, person_role_id), about 36.2 M rows.
"""

from radixjoin_tpu_torch import ColumnarTable, DataType, Plan

from joinbench import datagen

CONFIG = {
    "name": "joingraph_imdb_sf1",
    "source": "JOB (Leis et al., VLDB 2015): the join graphs of its IMDB queries with the selections removed, "
              "over IMDB at its own row counts (scale 1.0)",
    "reduced": [],
    "assumed": [
        "no filters: the large-intermediate regime of JOB's weakly filtered queries",
        "the synthetic IMDB (joinbench/datagen.py, no query literals) stands in for the real dump",
        "S1 reads eager pages, S2 and S3 lazy host columns, as the port's harness/job_shapes.py builds them",
    ],
    "guarantees": [
        "exact results: the row multiset of every output column, NULLs included, equals the plain reference's",
        "SQL NULL semantics: a NULL key joins nothing",
    ],
    "scale": 1.0,
    "tables": ["company_type", "movie_companies", "info_type", "movie_info_idx",
               "title", "role_type", "cast_info", "movie_keyword"],
    # a seeded two of each plan's first four results are compared whole
    # (an S2 result is 80 M rows); every row count is compared
    "check_sample": {"per_plan": 2, "among_first": 4},
    "plans": ["S1", "S2", "S3"],
}

I32, VC = DataType.INT32, DataType.VARCHAR


def generate(seed: int, scale: float = CONFIG["scale"]):
    """name -> HostTable of the configuration's tables."""
    return datagen.SyntheticIMDB(scale=scale, seed=seed).generate(
        CONFIG["tables"])


def _s1(tables):
    plan = Plan()
    for name in ("company_type", "movie_companies", "info_type",
                 "movie_info_idx", "title"):
        plan.new_input(ColumnarTable.from_host(tables[name], lazy=False))
    ct = plan.new_scan_node(0, [(0, I32), (1, VC)])
    mc = plan.new_scan_node(1, [(1, I32), (3, I32)])
    ct_mc = plan.new_join_node(True, ct, mc, 0, 1, [(1, VC), (2, I32)])
    it = plan.new_scan_node(2, [(0, I32)])
    mi = plan.new_scan_node(3, [(1, I32), (2, I32)])
    it_mi = plan.new_join_node(True, it, mi, 0, 1, [(1, I32), (0, I32)])
    t = plan.new_scan_node(4, [(0, I32), (4, I32)])
    t_ct_mc = plan.new_join_node(True, t, ct_mc, 0, 1,
                                 [(0, I32), (1, I32), (2, VC)])
    plan.root = plan.new_join_node(True, it_mi, t_ct_mc, 0, 0,
                                   [(0, I32), (1, I32), (3, I32), (4, VC)])
    return plan


def _s2(tables):
    plan = Plan()
    for name in ("role_type", "cast_info", "movie_keyword"):
        plan.new_input(ColumnarTable.from_host(tables[name], lazy=True))
    rt = plan.new_scan_node(0, [(0, I32)])
    ci = plan.new_scan_node(1, [(2, I32), (1, I32), (6, I32)])
    rt_ci = plan.new_join_node(True, rt, ci, 0, 2, [(1, I32), (2, I32)])
    mk = plan.new_scan_node(2, [(1, I32), (2, I32)])
    plan.root = plan.new_join_node(True, mk, rt_ci, 0, 0,
                                   [(0, I32), (1, I32), (3, I32)])
    return plan


def _s3(tables):
    plan = Plan()
    for name in ("role_type", "cast_info"):
        plan.new_input(ColumnarTable.from_host(tables[name], lazy=True))
    rt_a = plan.new_scan_node(0, [(0, I32)])
    ci_a = plan.new_scan_node(1, [(0, I32), (2, I32), (6, I32)])
    a = plan.new_join_node(True, rt_a, ci_a, 0, 2, [(1, I32), (2, I32)])
    rt_b = plan.new_scan_node(0, [(0, I32)])
    ci_b = plan.new_scan_node(1, [(0, I32), (1, I32), (3, I32), (6, I32)])
    b = plan.new_join_node(True, rt_b, ci_b, 0, 3,
                           [(1, I32), (2, I32), (3, I32)])
    plan.root = plan.new_join_node(True, a, b, 0, 0,
                                   [(0, I32), (1, I32), (3, I32), (4, I32)])
    return plan


def build_plans(tables, names=CONFIG["plans"]):
    """name -> Plan over ``tables`` of the plans ``names``."""
    build = {"S1": _s1, "S2": _s2, "S3": _s3}
    return {name: build[name](tables) for name in names}
