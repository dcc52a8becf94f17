"""JOB-shaped plans over the synthetic IMDB, built in code, and one plan
joining on FP64 keys.

Real JOB plans come from the benchmark's ``plans.json``; these keep
their shape (unfiltered, so every row joins) and together drive every
join strategy and kernel of the fused executor's main path:

* **S1** (JOB 1a-shaped): ``company_type ⋈ movie_companies`` and
  ``info_type ⋈ movie_info_idx`` (unique_scatter over small enum windows:
  the window-gather kernel), ``title ⋈ (ct ⋈ mc)`` (unique_scatter over
  the title id window), and the root joining the two intermediates on
  ``movie_id`` (dev_csr: the blocked-window kernel on the owner stream).
  Built from eager pages, so every INT32 scan column goes through the
  device page decode (the paged-window kernel).
* **S2** (fan-out): ``role_type ⋈ cast_info`` (unique_scatter) under a
  root ``movie_keyword ⋈ (rt ⋈ ci)`` on ``movie_id`` (csr over the
  movie_keyword scan, payloads along the monotone owner stream through
  the blocked-window kernel). Built lazily, the harness route: dense
  host columns upload directly.
* **S3** (merge): two ``role_type ⋈ cast_info`` intermediates joined on
  ``cast_info.id``. Each is probe-shaped at cast_info's pad, so at scale
  0.1 (3.6M rows, pad 2^22) the combined pad reaches 2^23 and the root
  takes the merge join (sort-carried payloads, blocked-window lookups on
  the owner and ``bpos`` streams).
* **F1** (FP64 keys): two generated tables joined on a FP64 column with
  duplicates, ``-0.0``/``0.0`` and NULLs — no CSR window exists for a
  float key, so the join takes the merge path at any size.

Each plan function takes the plan and table classes to build with, so
the same shapes can be built for another engine with the same plan IR.
"""

from __future__ import annotations

import numpy as np

from ..dtypes import DataType
from ..plan.ir import Plan
from ..storage.columnar import ColumnarTable, HostColumn, HostTable

I32 = DataType.INT32
I64 = DataType.INT64
F64 = DataType.FP64
VC = DataType.VARCHAR

S1_TABLES = ("company_type", "movie_companies", "info_type",
             "movie_info_idx", "title")
S2_TABLES = ("role_type", "cast_info", "movie_keyword")
S3_TABLES = ("role_type", "cast_info")


def s1_plan(tables, lazy: bool = False, plan_cls=Plan,
            table_cls=ColumnarTable):
    """S1 over ``tables`` (name -> HostTable). Output columns:
    (movie_id, info_type id, production_year, company kind)."""
    plan = plan_cls()
    for name in S1_TABLES:
        plan.new_input(table_cls.from_host(tables[name], lazy=lazy))
    ct = plan.new_scan_node(0, [(0, I32), (1, VC)])            # id, kind
    mc = plan.new_scan_node(1, [(1, I32), (3, I32)])           # movie_id, ct id
    ct_mc = plan.new_join_node(True, ct, mc, 0, 1, [(1, VC), (2, I32)])
    it = plan.new_scan_node(2, [(0, I32)])                     # id
    mi = plan.new_scan_node(3, [(1, I32), (2, I32)])           # movie_id, it id
    it_mi = plan.new_join_node(True, it, mi, 0, 1, [(1, I32), (0, I32)])
    t = plan.new_scan_node(4, [(0, I32), (4, I32)])            # id, year
    t_ct_mc = plan.new_join_node(True, t, ct_mc, 0, 1,
                                 [(0, I32), (1, I32), (2, VC)])
    plan.root = plan.new_join_node(True, it_mi, t_ct_mc, 0, 0,
                                   [(0, I32), (1, I32), (3, I32), (4, VC)])
    return plan


def s2_plan(tables, lazy: bool = True, plan_cls=Plan,
            table_cls=ColumnarTable):
    """S2 over ``tables`` (name -> HostTable). Output columns:
    (movie_id, keyword_id, person_id)."""
    plan = plan_cls()
    for name in S2_TABLES:
        plan.new_input(table_cls.from_host(tables[name], lazy=lazy))
    rt = plan.new_scan_node(0, [(0, I32)])                     # id
    ci = plan.new_scan_node(1, [(2, I32), (1, I32), (6, I32)])  # movie, person, role
    rt_ci = plan.new_join_node(True, rt, ci, 0, 2, [(1, I32), (2, I32)])
    mk = plan.new_scan_node(2, [(1, I32), (2, I32)])           # movie_id, kw id
    plan.root = plan.new_join_node(True, mk, rt_ci, 0, 0,
                                   [(0, I32), (1, I32), (3, I32)])
    return plan


def s3_plan(tables, lazy: bool = True, plan_cls=Plan,
            table_cls=ColumnarTable):
    """S3 over ``tables`` (name -> HostTable). Output columns:
    (cast_info id, movie_id, person_id, person_role_id)."""
    plan = plan_cls()
    for name in S3_TABLES:
        plan.new_input(table_cls.from_host(tables[name], lazy=lazy))
    rt_a = plan.new_scan_node(0, [(0, I32)])                    # id
    ci_a = plan.new_scan_node(1, [(0, I32), (2, I32), (6, I32)])  # id, movie, role
    a = plan.new_join_node(True, rt_a, ci_a, 0, 2, [(1, I32), (2, I32)])
    rt_b = plan.new_scan_node(0, [(0, I32)])
    ci_b = plan.new_scan_node(1, [(0, I32), (1, I32), (3, I32), (6, I32)])
    b = plan.new_join_node(True, rt_b, ci_b, 0, 3,
                           [(1, I32), (2, I32), (3, I32)])
    plan.root = plan.new_join_node(True, a, b, 0, 0,
                                   [(0, I32), (1, I32), (3, I32), (4, I32)])
    return plan


def f64_tables(n: int = 200_000, seed: int = 0):
    """Two tables ``(key FP64, payload INT64)`` of ``n`` rows each: keys
    are multiples of 0.5 below n/4 (about two rows per key on each side),
    with ``-0.0`` for a share of the zeros and 5% NULLs."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in ("f64_left", "f64_right"):
        keys = rng.integers(0, n // 2, n) * 0.5
        zeros = np.flatnonzero(keys == 0.0)
        keys[zeros[::2]] = -0.0
        out[name] = HostTable(n, [
            HostColumn(F64, keys, rng.random(n) >= 0.05),
            HostColumn(I64, rng.integers(-(1 << 62), 1 << 62, n),
                       rng.random(n) >= 0.1),
        ])
    return out


def f64_plan(tables, lazy: bool = True, plan_cls=Plan,
             table_cls=ColumnarTable):
    """F1 over :func:`f64_tables`: ``f64_left ⋈ f64_right`` on the FP64
    key. Output columns: (key, left payload, right payload)."""
    plan = plan_cls()
    for name in ("f64_left", "f64_right"):
        plan.new_input(table_cls.from_host(tables[name], lazy=lazy))
    left = plan.new_scan_node(0, [(0, F64), (1, I64)])
    right = plan.new_scan_node(1, [(0, F64), (1, I64)])
    plan.root = plan.new_join_node(True, left, right, 0, 0,
                                   [(0, F64), (1, I64), (3, I64)])
    return plan
