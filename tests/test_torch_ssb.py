"""The Star Schema Benchmark through the port's SQL front end: the 13
published SQL texts of SSB (joinbench/configs/ssb_sf20.documents.json)
parsed against the SSB catalog, their EXPLAIN trees (``Sort`` over
``Aggregate`` over a Hash Join chain) converted to plans, and every query
executed on the CPU route at scale factor 0.01 (a 60 K-row fact) against the
benchmark's plain reference (joinbench/reference/ssb_sf20.py), by digest.
The JOB documents plan exactly as the JAX package plans them, under the
default (IMDB) catalog, and ``run_cell`` runs the drill-down cell on the
CPU.
"""

import copy
import json

import numpy as np
import pytest

import radixjoin_tpu.sql as ref_sql

import radixjoin_tpu_torch as port
from radixjoin_tpu_torch import DataType
from radixjoin_tpu_torch import sql as port_sql
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.sql import parser
from radixjoin_tpu_torch.storage.columnar import ColumnarTable

from joinbench import digest, pagefmt, run, ssb_datagen
from joinbench.configs import ssb_sf20 as cfg
from joinbench.reference import ssb_sf20 as reference

SCALE = 0.01
SEED = 2 ** 31 + 4_242_424_243
DOCS = cfg.documents()
NAMES = cfg.CONFIG["plans"]

_BRAND = ["lineorder.lo_revenue", "date.d_year", "part.p_brand1"]
_CITY = ["customer.c_city", "supplier.s_city", "date.d_year",
         "lineorder.lo_revenue"]
#: query -> (root columns, in the order the SQL reads them; the filtered
#: tables)
EXPECTED = {
    "q1_1": (["lineorder.lo_extendedprice", "lineorder.lo_discount"],
             {"lineorder", "date"}),
    "q1_2": (["lineorder.lo_extendedprice", "lineorder.lo_discount"],
             {"lineorder", "date"}),
    "q1_3": (["lineorder.lo_extendedprice", "lineorder.lo_discount"],
             {"lineorder", "date"}),
    "q2_1": (_BRAND, {"part", "supplier"}),
    "q2_2": (_BRAND, {"part", "supplier"}),
    "q2_3": (_BRAND, {"part", "supplier"}),
    "q3_1": (["customer.c_nation", "supplier.s_nation", "date.d_year",
              "lineorder.lo_revenue"], {"customer", "supplier", "date"}),
    "q3_2": (_CITY, {"customer", "supplier", "date"}),
    "q3_3": (_CITY, {"customer", "supplier", "date"}),
    "q3_4": (_CITY, {"customer", "supplier", "date"}),
    "q4_1": (["date.d_year", "customer.c_nation", "lineorder.lo_revenue",
              "lineorder.lo_supplycost"], {"customer", "supplier", "part"}),
    "q4_2": (["date.d_year", "supplier.s_nation", "part.p_category",
              "lineorder.lo_revenue", "lineorder.lo_supplycost"],
             {"customer", "supplier", "part", "date"}),
    "q4_3": (["date.d_year", "supplier.s_city", "part.p_brand1",
              "lineorder.lo_revenue", "lineorder.lo_supplycost"],
             {"customer", "supplier", "part", "date"}),
}
_FK = {"date": ("lo_orderdate", "d_datekey"),
       "part": ("lo_partkey", "p_partkey"),
       "supplier": ("lo_suppkey", "s_suppkey"),
       "customer": ("lo_custkey", "c_custkey")}


def _parsed(name):
    return port_sql.ParsedSQL(DOCS[name]["sql"], name, catalog=cfg.CATALOG)


# ---------------------------------------------------------------------------
# parser, catalog, front end
# ---------------------------------------------------------------------------


def test_all_thirteen_documents():
    assert sorted(DOCS) == sorted(EXPECTED) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_ssb_sql_parses_to_its_star(name):
    """Root columns in the order the SQL reads them, one filter a filtered
    table, and one join edge from ``lineorder`` to each dimension."""
    parsed = _parsed(name)
    columns, filtered = EXPECTED[name]
    assert [f"{e.table}.{c}" for e, c in parsed.output_attrs] == columns
    assert {e.table for e in parsed.filters} == filtered
    lo = port_sql.TableEntity("lineorder", 0)
    dims = set(parsed.table_counts) - {"lineorder"}
    assert set(parsed.join_graph) == {lo} | {
        port_sql.TableEntity(d, 0) for d in dims}
    for ent, (lcol, dcol) in parsed.join_graph[lo].items():
        assert _FK[ent.table] == (lcol, dcol)
        assert set(parsed.join_graph[ent]) == {lo}


def test_ssb_parser_forms():
    stmt = parser.parse_sql(DOCS["q1_1"]["sql"])
    (item,) = stmt.select_list
    assert (item.aggregate, item.alias, item.column) == ("SUM", "revenue",
                                                         None)
    assert item.expr == parser.Arith("*", parser.ColumnRef(None,
                                                           "lo_extendedprice"),
                                     parser.ColumnRef(None, "lo_discount"))
    assert stmt.tables == [("lineorder", None), ("date", None)]
    stmt = parser.parse_sql(DOCS["q3_1"]["sql"])
    assert [i.aggregate for i in stmt.select_list] == [None, None, None, "SUM"]
    assert [g.column for g in stmt.group_by] == ["c_nation", "s_nation",
                                                 "d_year"]
    assert [(o.ref.column, o.descending) for o in stmt.order_by] == [
        ("d_year", False), ("revenue", True)]
    stmt = parser.parse_sql(DOCS["q4_1"]["sql"])
    assert [c.column for c in stmt.select_list[2].columns()] == [
        "lo_revenue", "lo_supplycost"]
    # '*' binds tighter than '-', both left to right
    stmt = parser.parse_sql("SELECT SUM(a - b * c - d) FROM t")
    expr = stmt.select_list[0].expr
    assert expr.op == "-" and expr.right == parser.ColumnRef(None, "d")
    assert expr.left.right == parser.Arith("*", parser.ColumnRef(None, "b"),
                                           parser.ColumnRef(None, "c"))
    assert [c.column for c in stmt.select_list[0].columns()] == [
        "a", "b", "c", "d"]
    # the new fields stay out of the statement's repr (JOB's is unchanged)
    assert "group_by" not in repr(stmt) and "expr" not in repr(stmt)


def test_order_by_a_plain_column_adds_it_once():
    parsed = port_sql.ParsedSQL(
        "select sum(lo_revenue) as r from lineorder, part "
        "where lo_partkey = p_partkey group by p_brand1 "
        "order by r desc, p_mfgr, p_brand1", catalog=cfg.CATALOG)
    assert [c for _e, c in parsed.output_attrs] == [
        "lo_revenue", "p_brand1", "p_mfgr"]


def test_catalogs_are_separate():
    with pytest.raises(ValueError, match="no table lineorder in schema"):
        port_sql.ParsedSQL(DOCS["q2_3"]["sql"])  # the IMDB default
    with pytest.raises(ValueError, match="no table keyword in schema"):
        port_sql.ParsedSQL(job_shapes.QUERY_DOCUMENTS["q_or"][0],
                           catalog=cfg.CATALOG)
    assert port_sql.ParsedSQL(job_shapes.QUERY_DOCUMENTS["q_or"][0]
                              ).catalog is port_sql.IMDB
    # the catalog: the schema file's columns (the specification's), less
    # the lineorder columns that are not generated
    with open(ssb_datagen.SCHEMA_PATH) as f:
        schema = json.load(f)
    assert len(schema["tables"]["lineorder"]) == 17
    for table, cols in schema["tables"].items():
        skipped = schema["not_generated"].get(table, [])
        assert cfg.CATALOG.column_names(table) == [
            c for c, _dt in cols if c not in skipped]
        assert cfg.CATALOG.column_types(table) == [
            DataType[dt] for c, dt in cols if c not in skipped]
    assert len(cfg.CATALOG.column_names("lineorder")) == 11
    assert cfg.CATALOG.column_type("part", "p_brand1") is DataType.VARCHAR
    assert cfg.CATALOG.column_type("lineorder", "lo_revenue") is \
        DataType.INT32


# ---------------------------------------------------------------------------
# EXPLAIN trees: Sort is transparent; JOB plans as before
# ---------------------------------------------------------------------------


def _stub_provider(entity, attributes, _filt):
    """An empty input of the table's width (plans' shapes need no data)."""
    return ColumnarTable(0, [])


def _shape(plan):
    nodes = []
    for node in plan.nodes:
        d = node.data
        attrs = [(int(ci), int(dt)) for ci, dt in node.output_attrs]
        if hasattr(d, "base_table_id"):
            nodes.append(("scan", int(d.base_table_id), attrs))
        else:
            nodes.append(("join", bool(d.build_left), int(d.left),
                          int(d.right), int(d.left_attr), int(d.right_attr),
                          attrs))
    return nodes, int(plan.root)


@pytest.mark.parametrize("name", sorted(job_shapes.QUERY_DOCUMENTS))
def test_job_documents_plan_as_before(name):
    """Under the default catalog, and under IMDB passed by hand, each JOB
    document gives the plan and filters the JAX package gives, and a Sort
    over its tree changes nothing."""
    sql, doc = job_shapes.QUERY_DOCUMENTS[name]
    seen = []

    def recording(entity, attributes, filt):
        seen.append((str(entity), len(attributes),
                     None if filt is None else filt.pretty()))
        return ColumnarTable(0, [])

    want = _shape(ref_sql.plan_from_explain(
        doc["Plan"], ref_sql.ParsedSQL(sql, name), recording))
    want_inputs, seen[:] = list(seen), []
    sorted_doc = {"Node Type": "Sort", "Plans": [doc["Plan"]]}
    for tree, catalog in ((doc["Plan"], None), (doc["Plan"], port_sql.IMDB),
                          (sorted_doc, None)):
        parsed = port_sql.ParsedSQL(sql, name, catalog=catalog)
        plan = port_sql.plan_from_explain(tree, parsed, recording)
        assert _shape(plan) == want
        assert seen == want_inputs
        seen[:] = []


@pytest.mark.parametrize("name", ["q1_1", "q3_4", "q4_3"])
def test_sort_is_transparent(name):
    tree = DOCS[name]["explain"]["Plan"]
    under = tree
    while under["Node Type"] in ("Sort", "Aggregate"):
        under = under["Plans"][0]
    assert under["Node Type"] == "Hash Join"
    plans = [port_sql.plan_from_explain(t, _parsed(name), _stub_provider)
             for t in (tree, under, {"Node Type": "Sort",
                                     "Plans": [copy.deepcopy(under)]})]
    assert _shape(plans[0]) == _shape(plans[1]) == _shape(plans[2])
    with pytest.raises(port_sql.explain.ExplainError,
                       match="unsupported node type: Limit"):
        port_sql.plan_from_explain({"Node Type": "Limit", "Plans": [under]},
                                   _parsed(name), _stub_provider)


# ---------------------------------------------------------------------------
# the generator, and every query against the plain reference on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tables():
    return cfg.generate(SEED, scale=SCALE)


@pytest.fixture(scope="module")
def plans(tables):
    return cfg.build_plans(tables), port.build_context("cpu")


def test_generator_follows_the_specification(tables):
    counts = ssb_datagen.row_counts(SCALE)
    assert {t: tables[t].num_rows for t in ("customer", "supplier", "part",
                                            "date")} == {
        "customer": 300, "supplier": 20, "part": 2000, "date": 2556}
    assert ssb_datagen.row_counts(20)["part"] == 1_000_000
    assert ssb_datagen.row_counts(20)["orders"] * 4 == 120_000_000
    lo = {c: tables["lineorder"].columns[i].values
          for i, (c, _dt) in enumerate(ssb_datagen.COLUMNS["lineorder"])}
    n = tables["lineorder"].num_rows
    assert 3.9 * counts["orders"] < n < 4.1 * counts["orders"]
    # the lines of an order share its key, customer and date
    order = lo["lo_orderkey"]
    assert np.all(np.diff(order) >= 0)
    starts = np.flatnonzero(np.diff(order, prepend=0))
    lines = np.diff(np.append(starts, n))
    assert lines.min() == 1 and lines.max() == 7
    for c in ("lo_custkey", "lo_orderdate"):
        assert np.all(lo[c] == np.repeat(lo[c][starts], lines))
    assert lo["lo_orderdate"].min() >= 19920101
    assert lo["lo_orderdate"].max() <= 19980802
    assert set(np.unique(lo["lo_quantity"])) == set(range(1, 51))
    assert set(np.unique(lo["lo_discount"])) == set(range(0, 11))
    assert np.all(lo["lo_revenue"] <= lo["lo_extendedprice"])
    part = tables["part"]
    brands = set(part.columns[4].objects())
    assert all(len(b) in (8, 9) and b.startswith(b"MFGR#") for b in brands)
    assert len(ssb_datagen.CITIES) == len(set(ssb_datagen.CITIES)) == 250
    assert "UNITED KI1" in ssb_datagen.CITIES
    date = tables["date"]
    assert date.columns[0].values[0] == 19920101
    assert set(date.columns[6].objects()) >= {b"Dec1997", b"Jan1992"}
    again = cfg.generate(SEED, scale=SCALE)
    other = cfg.generate(SEED + 1, scale=SCALE)
    assert np.array_equal(again["lineorder"].columns[3].values,
                          tables["lineorder"].columns[3].values)
    assert not np.array_equal(other["lineorder"].columns[3].values[:1000],
                              tables["lineorder"].columns[3].values[:1000])


def test_varchar_between_filter(tables):
    """Q2.2's ``p_brand1 BETWEEN 'MFGR#2221' AND 'MFGR#2228'``: the
    pushed-down filter keeps exactly the eight brands, bytewise."""
    parsed = _parsed("q2_2")
    (filt,) = [f for e, f in parsed.filters.items() if e.table == "part"]
    got = filt.eval_table(tables["part"])
    brands = tables["part"].columns[4].objects()
    want = np.array([b"MFGR#2221" <= b <= b"MFGR#2228" for b in brands])
    assert np.array_equal(got, want) and got.any()
    assert {bytes(b) for b in brands[got]} <= {
        f"MFGR#222{k}".encode() for k in range(1, 9)}


@pytest.mark.parametrize("name", NAMES)
def test_ssb_query_equals_reference(name, tables, plans):
    built, ctx = plans
    plan = built[name]
    result = port.execute(plan, ctx)
    got = digest.digest(*pagefmt.read_columns(result, "cpu"))
    rel, columns = reference.result(name, tables, "cpu")
    assert got == digest.digest(*rel.out(columns))
    assert result.num_rows == len(rel)
    strategies = plan._fused_struct_cache[1].strategies()
    # every dimension probe below the root is a unique-key join
    assert sorted(strategies.values()) == sorted(
        ["unique_scatter"] * (len(strategies) - 1)
        + [strategies[plan.root]])


def test_drilldown_cell_correct_on_cpu():
    out = run.run_cell(run.ROOT, "ssb_sf20.resident_drilldown", SEED, 0.3,
                       False, device="cpu", scale=SCALE)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] % 4 == 0 and out["attempted"] > 0
    assert out["checks"]["plans_checked"]["value"] == 4
    assert set(out["metrics"]) == {"setup_s", "queries_per_s",
                                   "peak_device_gib"}
