"""JOB-shaped plans over the synthetic IMDB, built in code, one plan
joining on FP64 keys, and a small set of query documents (SQL text +
EXPLAIN tree, :data:`QUERY_DOCUMENTS`) for the SQL entry point.

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


# ---------------------------------------------------------------------------
# Query documents: SQL text + EXPLAIN-JSON tree, written in code
# ---------------------------------------------------------------------------
#
# The benchmark's ``plans.json`` (113 names, one PostgreSQL EXPLAIN document
# each) and its ``job/*.sql`` files are not part of this repository. The
# documents below keep their layout — a SQL text over the catalog's tables
# and a tree of ``Hash Join`` / ``Hash`` / ``Seq Scan`` nodes, here and there
# under ``Aggregate`` / ``Gather`` — so the SQL front end, the EXPLAIN
# converter, the filtered ingest, the oracles and the harness run over them
# exactly as over the benchmark's own files.


def _scan(relation: str, alias: str) -> dict:
    return {"Node Type": "Seq Scan", "Relation Name": relation,
            "Alias": alias}


def _hash_join(left: dict, right: dict, build_left: bool = False) -> dict:
    """A ``Hash Join`` whose build side (the child under ``Hash``) is the
    right child, or the left one with ``build_left``."""
    hashed = {"Node Type": "Hash", "Plans": [left if build_left else right]}
    plans = [hashed, right] if build_left else [left, hashed]
    return {"Node Type": "Hash Join", "Plans": plans}


def _wrap(node_type: str, child: dict) -> dict:
    return {"Node Type": node_type, "Plans": [child]}


_Q1A_SQL = """SELECT MIN(mc.note) AS production_note,
       MIN(t.title) AS movie_title,
       MIN(t.production_year) AS movie_year
FROM company_type AS ct,
     info_type AS it,
     movie_companies AS mc,
     movie_info_idx AS mi_idx,
     title AS t
WHERE ct.kind = 'production companies'
  AND it.info IN ('top 250 rank', 'bottom 10 rank')
  AND mc.note NOT LIKE '%(as Metro-Goldwyn-Mayer Pictures)%'
  AND (mc.note LIKE '%(co-production)%'
       OR mc.note LIKE '%(presents)%')
  AND ct.id = mc.company_type_id
  AND t.id = mc.movie_id
  AND t.id = mi_idx.movie_id
  AND mc.movie_id = mi_idx.movie_id
  AND it.id = mi_idx.info_type_id;
"""

_OR_SQL = """SELECT MIN(k.keyword) AS movie_keyword,
       MIN(t.title) AS movie_title
FROM keyword AS k,
     movie_keyword AS mk,
     title AS t
WHERE (k.keyword LIKE '%sequel%'
       OR k.keyword IN ('murder', 'revenge'))
  AND (t.production_year > 2005
       OR t.production_year < 1950)
  AND t.id = mk.movie_id
  AND mk.keyword_id = k.id;
"""

_ALIAS_SQL = """SELECT MIN(lt.link) AS link_type,
       MIN(t1.title) AS first_movie,
       MIN(t2.title) AS second_movie
FROM link_type AS lt,
     movie_link AS ml,
     title AS t1,
     title AS t2
WHERE lt.link IN ('sequel', 'follows', 'followed by')
  AND t2.production_year BETWEEN 2000 AND 2010
  AND lt.id = ml.link_type_id
  AND t1.id = ml.movie_id
  AND t2.id = ml.linked_movie_id;
"""

_VARCHAR_SQL = """SELECT MIN(cn.name) AS company_name,
       MIN(k.keyword) AS sounds_like,
       MIN(mc.note) AS production_note
FROM company_name AS cn,
     keyword AS k,
     movie_companies AS mc
WHERE cn.name_pcode_sf IN ('A5362', 'B6526', 'C4321', 'D1500',
                           'E2630', 'F6523', 'G6253', 'H4163')
  AND k.phonetic_code IN ('A5362', 'B6526', 'C4321', 'D1500',
                        'E2630', 'F6523', 'G6253', 'H4163')
  AND cn.country_code = '[us]'
  AND mc.note LIKE '%(USA)%'
  AND cn.name_pcode_sf = k.phonetic_code
  AND cn.id = mc.company_id;
"""

_Q6A_SQL = """SELECT MIN(k.keyword) AS movie_keyword,
       MIN(n.name) AS actor_name,
       MIN(t.title) AS marvel_movie
FROM cast_info AS ci,
     keyword AS k,
     movie_keyword AS mk,
     name AS n,
     title AS t
WHERE k.keyword = 'marvel-cinematic-universe'
  AND n.name LIKE '%Downey%Robert%'
  AND t.production_year > 2010
  AND k.id = mk.keyword_id
  AND t.id = mk.movie_id
  AND t.id = ci.movie_id
  AND ci.movie_id = mk.movie_id
  AND n.id = ci.person_id;
"""


def _q1a_tree() -> dict:
    ct_mc = _hash_join(_scan("movie_companies", "mc"),
                       _scan("company_type", "ct"))
    it_mi = _hash_join(_scan("movie_info_idx", "mi_idx"),
                       _scan("info_type", "it"))
    t_ct_mc = _hash_join(_scan("title", "t"), ct_mc, build_left=True)
    return _wrap("Aggregate", _hash_join(t_ct_mc, it_mi))


def _or_tree() -> dict:
    k_mk = _hash_join(_scan("movie_keyword", "mk"), _scan("keyword", "k"))
    return _wrap("Gather", _wrap("Aggregate",
                                 _hash_join(k_mk, _scan("title", "t"))))


def _alias_tree() -> dict:
    lt_ml = _hash_join(_scan("movie_link", "ml"), _scan("link_type", "lt"))
    with_t2 = _hash_join(lt_ml, _scan("title", "t2"))
    return _wrap("Aggregate",
                 _hash_join(with_t2, _scan("title", "t1"), build_left=True))


def _varchar_tree() -> dict:
    k_cn = _hash_join(_scan("company_name", "cn"), _scan("keyword", "k"))
    return _wrap("Aggregate",
                 _hash_join(_scan("movie_companies", "mc"), k_cn))


def _q6a_tree() -> dict:
    k_mk = _hash_join(_scan("movie_keyword", "mk"), _scan("keyword", "k"))
    with_ci = _hash_join(_scan("cast_info", "ci"), k_mk)
    with_t = _hash_join(with_ci, _scan("title", "t"))
    return _wrap("Aggregate", _hash_join(with_t, _scan("name", "n")))


#: name -> (SQL text, EXPLAIN-JSON document): a JOB 1a-shaped query (five
#: tables, LIKE / NOT LIKE and IN filters, MIN outputs), OR filters inside
#: one entity, one table under two aliases, a join on a VARCHAR column, and
#: a JOB 6a-shaped chain whose selective general join sits under two more
#: joins
QUERY_DOCUMENTS = {
    "q1a": (_Q1A_SQL, {"Plan": _q1a_tree()}),
    "q_or": (_OR_SQL, {"Plan": _or_tree()}),
    "q_alias": (_ALIAS_SQL, {"Plan": _alias_tree()}),
    "q_varchar": (_VARCHAR_SQL, {"Plan": _varchar_tree()}),
    "q6a": (_Q6A_SQL, {"Plan": _q6a_tree()}),
}

#: the document whose join key is a VARCHAR column
VARCHAR_KEY_QUERY = "q_varchar"


def write_query_documents(directory: str) -> str:
    """Write :data:`QUERY_DOCUMENTS` into ``directory`` in the benchmark's
    layout — ``plans.json`` (``names``, ``plans``, ``sql_directory``) and
    ``job/<name>.sql`` — and return the path of ``plans.json``."""
    import json
    import os

    sql_dir = os.path.join(directory, "job")
    os.makedirs(sql_dir, exist_ok=True)
    names = list(QUERY_DOCUMENTS)
    for name in names:
        with open(os.path.join(sql_dir, f"{name}.sql"), "w") as f:
            f.write(QUERY_DOCUMENTS[name][0])
    path = os.path.join(directory, "plans.json")
    with open(path, "w") as f:
        json.dump({"names": names,
                   "plans": [QUERY_DOCUMENTS[n][1] for n in names],
                   "sql_directory": "job"}, f, indent=1)
    return path
