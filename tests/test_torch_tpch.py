"""TPC-H through the port's SQL front end: the five join queries of the
configuration tpch_sf30 (Q3, Q8, Q10, Q12, Q14 of the specification's
Clause 2.4, joinbench/configs/tpch_sf30.documents.json) parsed against the
TPC-H catalog, with the forms they need (dates and intervals folded, CASE,
EXTRACT, arithmetic over aggregates, a FROM-clause subquery, a comparison
of two columns of a row, LIMIT); the generator's Clause 4.2 properties;
every query executed on the CPU route at scale factor 0.01 against the
benchmark's plain reference (joinbench/reference/tpch_sf30.py), by digest,
under the default strategies and with the sort-based unique join forced;
why a join sorts (``sort_reason``) where a join is forced past a cap; and
``run_cell`` on the TPC-H cell on the CPU.
"""

import datetime
import json

import numpy as np
import pytest

import radixjoin_tpu_torch as port
from radixjoin_tpu_torch import DataType, Plan, trace
from radixjoin_tpu_torch import sql as port_sql
from radixjoin_tpu_torch.sql import parser
from radixjoin_tpu_torch.sql.predicate import ColumnOperand, Comparison, Op
from radixjoin_tpu_torch.storage.columnar import ColumnarTable, HostTable

from joinbench import digest, pagefmt, run, tpch_datagen
from joinbench.configs import tpch_sf30 as cfg
from joinbench.reference import tpch_sf30 as reference

SCALE = 0.01
SEED = 2 ** 33 + 2_718_281_829
DOCS = cfg.documents()
NAMES = cfg.CONFIG["plans"]


def _day(text):
    return (datetime.date.fromisoformat(text) - datetime.date(1970, 1, 1)).days


#: query -> (root columns in the order the SQL reads them, the filtered
#: tables)
EXPECTED = {
    "q3": (["lineitem.l_orderkey", "lineitem.l_extendedprice",
            "lineitem.l_discount", "orders.o_orderdate",
            "orders.o_shippriority"], {"customer", "orders", "lineitem"}),
    "q8": (["orders.o_orderdate", "nation#1.n_name",
            "lineitem.l_extendedprice", "lineitem.l_discount"],
           {"part", "orders", "region"}),
    "q10": (["customer.c_custkey", "customer.c_name",
             "lineitem.l_extendedprice", "lineitem.l_discount",
             "customer.c_acctbal", "nation.n_name", "customer.c_address",
             "customer.c_phone", "customer.c_comment"],
            {"orders", "lineitem"}),
    "q12": (["lineitem.l_shipmode", "orders.o_orderpriority"],
            {"lineitem"}),
    "q14": (["part.p_type", "lineitem.l_extendedprice",
             "lineitem.l_discount"], {"lineitem"}),
}


def _parsed(name):
    return port_sql.ParsedSQL(DOCS[name]["sql"], name, catalog=cfg.CATALOG)


def _name(ent, column):
    return (f"{ent.table}.{column}" if ent.id == 0
            else f"{ent.table}#{ent.id}.{column}")


# ---------------------------------------------------------------------------
# parser, catalog, front end
# ---------------------------------------------------------------------------


def test_the_five_documents():
    assert sorted(DOCS) == sorted(EXPECTED) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_tpch_sql_parses(name):
    """Root columns in the order the SQL reads them, one filter a filtered
    table, and the join graph a tree over the FROM list."""
    parsed = _parsed(name)
    columns, filtered = EXPECTED[name]
    assert [_name(e, c) for e, c in parsed.output_attrs] == columns
    assert {e.table for e in parsed.filters} == filtered
    entities = {port_sql.TableEntity(t, i)
                for t, n in parsed.table_counts.items() for i in range(n)}
    assert set(parsed.join_graph) == entities
    edges = sum(len(v) for v in parsed.join_graph.values()) // 2
    assert edges == len(entities) - 1


def test_dates_and_intervals_fold_on_the_calendar():
    assert parser.date_days("1970-01-01") == 0
    assert parser.date_days("1995-03-15") == _day("1995-03-15") == 9204
    fold = parser.add_interval
    assert fold(_day("1993-10-01"), 3, "month") == _day("1994-01-01")
    assert fold(_day("1994-01-01"), 1, "year") == _day("1995-01-01")
    assert fold(_day("1995-09-01"), 1, "month") == _day("1995-10-01")
    # the month's last day where the day runs past it; leap years
    assert fold(_day("1995-01-31"), 1, "month") == _day("1995-02-28")
    assert fold(_day("1996-01-31"), 1, "month") == _day("1996-02-29")
    assert fold(_day("1996-02-29"), 1, "years") == _day("1997-02-28")
    assert fold(_day("1995-03-01"), -1, "day") == _day("1995-02-28")
    stmt = parser.parse_sql(
        "select a from t where d >= date '1993-10-01' and "
        "d < date '1993-10-01' + interval '3' month and "
        "e between date '1995-01-01' and date '1996-12-31' and "
        "f > date '1995-03-01' - interval '1' day")
    comps = []
    todo = [stmt.where]
    while todo:
        node = todo.pop()
        if isinstance(node, parser.BoolOp):
            todo += [node.right, node.left]
        else:
            comps.append(node)
    assert [(c.left.column, c.right) for c in comps if
            isinstance(c, parser.Compare)] == [
        ("d", _day("1993-10-01")), ("d", _day("1994-01-01")),
        ("f", _day("1995-02-28"))]
    (between,) = [c for c in comps if isinstance(c, parser.Between)]
    assert (between.low, between.high) == (_day("1995-01-01"),
                                           _day("1996-12-31"))
    with pytest.raises(SyntaxError, match="interval unit"):
        parser.parse_sql("select a from t where d < date '1995-01-01' "
                         "+ interval '1' week")


def test_select_forms():
    # Q14: a constant times an aggregate of a CASE, over another aggregate
    (item,) = parser.parse_sql(DOCS["q14"]["sql"]).select_list
    assert item.alias == "promo_revenue" and item.aggregate is None
    expr = item.expr
    assert expr.op == "/" and expr.left.op == "*" and expr.left.left == 100.0
    case = expr.left.right.arg
    assert isinstance(case, parser.Case) and case.default == 0
    ((cond, value),) = case.whens
    assert cond == parser.Like(False, parser.ColumnRef(None, "p_type"),
                               "PROMO%")
    assert value == parser.Arith(
        "*", parser.ColumnRef(None, "l_extendedprice"),
        parser.Arith("-", 1, parser.ColumnRef(None, "l_discount")))
    assert [c.column for c in item.columns()] == [
        "p_type", "l_extendedprice", "l_discount", "l_extendedprice",
        "l_discount"]
    # Q12: conditions with OR / AND / <> inside CASE; LIMIT; EXTRACT
    stmt = parser.parse_sql(DOCS["q12"]["sql"])
    high = stmt.select_list[1]
    assert (high.aggregate, high.alias) == ("SUM", "high_line_count")
    assert high.expr.whens[0][0].op == "OR"
    low = stmt.select_list[2].expr.whens[0][0]
    assert low.op == "AND" and low.left.op == "!="
    assert parser.parse_sql(DOCS["q3"]["sql"]).limit == 10
    assert parser.parse_sql(DOCS["q10"]["sql"]).limit == 20
    assert stmt.limit is None and "limit" not in repr(stmt)
    (item,) = parser.parse_sql(
        "select extract(year from o_orderdate) as y from orders").select_list
    assert item.expr == parser.Extract("YEAR",
                                       parser.ColumnRef(None, "o_orderdate"))
    # '/' binds as '*' does, '+' as '-', left to right
    expr = parser.parse_sql("select a + b / c - d from t").select_list[0].expr
    assert expr == parser.Arith("-", parser.Arith(
        "+", parser.ColumnRef(None, "a"), parser.Arith(
            "/", parser.ColumnRef(None, "b"), parser.ColumnRef(None, "c"))),
        parser.ColumnRef(None, "d"))
    # SSB's table named date, and words of the new forms as names
    stmt = parser.parse_sql("select d_year from date where d_year = 1993")
    assert stmt.tables == [("date", None)]
    stmt = parser.parse_sql("select case.x from t case limit 5")
    assert stmt.tables == [("t", "case")] and stmt.limit == 5


def test_derived_table_is_flattened():
    """Q8's ``all_nations``: the outer items read the subquery's items,
    whose tables and WHERE are the query's."""
    stmt = parser.parse_sql(DOCS["q8"]["sql"])
    (derived,) = stmt.tables
    assert isinstance(derived, parser.DerivedTable)
    assert derived.alias == "all_nations" and len(derived.stmt.tables) == 8
    flat = port_sql.frontend.flatten(stmt)
    assert flat.tables == derived.stmt.tables
    assert flat.where is derived.stmt.where
    year = flat.select_list[0]
    assert year.expr == parser.Extract("YEAR",
                                       parser.ColumnRef(None, "o_orderdate"))
    assert flat.group_by == [year.expr]
    assert [c.column for c in flat.select_list[1].columns()] == [
        "n_name", "l_extendedprice", "l_discount", "l_extendedprice",
        "l_discount"]
    # a qualified name reads the item too; an unknown one is refused
    sql = ("select s.v from (select a * 2 as v from t) as s")
    (item,) = port_sql.frontend.flatten(parser.parse_sql(sql)).select_list
    assert item.expr == parser.Arith("*", parser.ColumnRef(None, "a"), 2)
    with pytest.raises(ValueError, match="no column w in s"):
        port_sql.frontend.flatten(parser.parse_sql(
            "select s.w from (select a as v from t) s"))
    with pytest.raises(ValueError, match="with aggregation"):
        port_sql.frontend.flatten(parser.parse_sql(
            "select v from (select sum(a) as v from t) s"))
    with pytest.raises(ValueError, match="only table"):
        port_sql.frontend.flatten(parser.parse_sql(
            "select v from (select a as v from t) s, u"))


def test_column_comparison_is_a_filter():
    """Q12's ``l_commitdate < l_receiptdate`` and ``l_shipdate <
    l_commitdate``: two columns of one row, the table's own filter, false
    where either is NULL; a comparison across tables other than ``=`` is
    still refused."""
    parsed = _parsed("q12")
    (filt,) = parsed.filters.values()
    index = cfg.CATALOG.column_index
    ship, commit, receipt = (index("lineitem", c) for c in (
        "l_shipdate", "l_commitdate", "l_receiptdate"))
    assert f"col[{commit}] < col[{receipt}]" in filt.pretty()
    assert f"col[{ship}] < col[{commit}]" in filt.pretty()
    rows = [(1, 2, 1.5, b"a", b"b"), (2, 2, 2.0, b"b", b"a"),
            (None, 5, 9.0, b"c", None), (3, 1, 0.5, None, b"z")]
    table = HostTable.from_rows(rows, [DataType.INT32, DataType.INT32,
                                       DataType.FP64, DataType.VARCHAR,
                                       DataType.VARCHAR])
    for a, b, op, want in ((0, 1, Op.LT, [True, False, False, False]),
                           (0, 1, Op.LEQ, [True, True, False, False]),
                           (1, 2, Op.GT, [True, False, False, True]),
                           (3, 4, Op.LT, [True, False, False, False]),
                           (0, 3, Op.EQ, [False] * 4)):
        cmp = Comparison(a, op, ColumnOperand(b))
        assert cmp.eval_table(table).tolist() == want
        assert [cmp.eval_row(r) for r in rows] == want
    with pytest.raises(ValueError, match="non-equi"):
        port_sql.ParsedSQL("select o_orderkey from orders, lineitem where "
                           "o_orderkey < l_orderkey", catalog=cfg.CATALOG)


def test_limit_and_subquery_scan_are_transparent():
    name = "q3"
    tree = DOCS[name]["explain"]["Plan"]
    assert tree["Node Type"] == "Limit"
    stub = lambda *_a: ColumnarTable(0, [])  # noqa: E731
    base = port_sql.plan_from_explain(tree, _parsed(name), stub)
    wrapped = port_sql.plan_from_explain(
        {"Node Type": "Subquery Scan", "Alias": "s", "Plans": [tree]},
        _parsed(name), stub)
    assert [(n.output_attrs, vars(n.data)) for n in base.nodes] == [
        (n.output_attrs, vars(n.data)) for n in wrapped.nodes]


def test_catalog_from_the_schema_file():
    with open(tpch_datagen.SCHEMA_PATH) as f:
        schema = json.load(f)
    assert len(schema["tables"]) == 8 and len(schema["tables"]["lineitem"]) == 16
    assert "partsupp" not in cfg.CATALOG
    for table, cols in schema["tables"].items():
        skipped = schema["not_generated"].get(table, [])
        kept = [(c, DataType[dt]) for c, dt, _spec in cols if c not in skipped]
        if kept:
            assert cfg.CATALOG.attributes[table] == kept
        for _c, dt, spec in cols:
            want = {"DATE": "INT32", "INTEGER": "INT32", "IDENTIFIER": "INT32"
                    }.get(spec, "FP64" if spec.startswith("DECIMAL")
                          else "VARCHAR")
            assert dt == want
    assert cfg.CATALOG.column_type("lineitem", "l_shipdate") is DataType.INT32
    assert cfg.CATALOG.column_type("lineitem", "l_discount") is DataType.FP64
    with pytest.raises(ValueError, match="no table orders in schema"):
        port_sql.ParsedSQL(DOCS["q12"]["sql"])  # the IMDB default


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tables():
    return cfg.generate(SEED, scale=SCALE)


def _cols(tables, table):
    return {c: tables[table].columns[i]
            for i, (c, _dt) in enumerate(tpch_datagen.COLUMNS[table])}


def test_generator_follows_clause_4_2(tables):
    assert tpch_datagen.row_counts(30) == {
        "supplier": 300_000, "part": 6_000_000, "customer": 4_500_000,
        "orders": 45_000_000, "nation": 25, "region": 5}
    assert {t: tables[t].num_rows for t in ("supplier", "part", "customer",
                                            "orders", "nation", "region")} \
        == {"supplier": 100, "part": 2000, "customer": 1500,
            "orders": 15000, "nation": 25, "region": 5}
    o, li = _cols(tables, "orders"), _cols(tables, "lineitem")
    c = _cols(tables, "customer")
    # sparse order keys: the first 8 of every 32; 180 M at SF 30
    keys = o["o_orderkey"].values
    assert keys[:10].tolist() == [1, 2, 3, 4, 5, 6, 7, 32, 33, 34]
    assert np.all(keys % 32 < 8) and np.all(np.diff(keys) > 0)
    assert int(tpch_datagen.order_keys(45_000_000)[-1]) > 1 << 27
    assert not np.any(o["o_custkey"].values % 3 == 0)
    assert o["o_custkey"].values.max() <= 1500
    # 1 to 7 lines an order, in key order, sharing its date
    lk = li["l_orderkey"].values
    assert np.all(np.diff(lk) >= 0)
    lines = np.bincount(np.searchsorted(keys, lk))
    assert lines.min() == 1 and lines.max() == 7 and len(lines) == len(keys)
    day = np.repeat(o["o_orderdate"].values, lines)
    ship, commit = li["l_shipdate"].values, li["l_commitdate"].values
    receipt = li["l_receiptdate"].values
    assert o["o_orderdate"].values.min() >= _day("1992-01-01")
    assert o["o_orderdate"].values.max() <= _day("1998-08-02")
    assert 1 <= (ship - day).min() and (ship - day).max() <= 121
    assert 30 <= (commit - day).min() and (commit - day).max() <= 90
    assert 1 <= (receipt - ship).min() and (receipt - ship).max() <= 30
    flags = li["l_returnflag"].objects()
    late = receipt > _day("1995-06-17")
    assert set(flags[late]) == {b"N"} and set(flags[~late]) == {b"R", b"A"}
    # the part's suppliers, prices and discounts
    part, supp = li["l_partkey"].values, li["l_suppkey"].values
    s = 100
    corners = [(part + i * (s // 4 + (part - 1) // s)) % s + 1
               for i in range(4)]
    assert np.all(np.any([supp == k for k in corners], axis=0))
    retail = (90000 + (part // 10) % 20001 + 100 * (part % 1000)) / 100.0
    quantity = li["l_extendedprice"].values / retail
    assert np.allclose(quantity, np.round(quantity))
    assert set(np.round(quantity).astype(int)) <= set(range(1, 51))
    assert set(np.round(li["l_discount"].values * 100).astype(int)) == set(
        range(11))
    assert set(li["l_shipmode"].objects()) == {
        m.encode() for m in tpch_datagen.SHIPMODES}
    assert len(tpch_datagen.TYPES) == len(set(tpch_datagen.TYPES)) == 150
    assert set(_cols(tables, "part")["p_type"].objects()) <= {
        t.encode() for t in tpch_datagen.TYPES}
    assert c["c_name"].objects()[0] == b"Customer#000000001"
    assert -999.99 <= c["c_acctbal"].values.min()
    assert c["c_acctbal"].values.max() <= 9999.99
    # every table in key order, so the build sides are unique keys
    for table, key in (("orders", "o_orderkey"), ("customer", "c_custkey"),
                       ("part", "p_partkey"), ("supplier", "s_suppkey"),
                       ("nation", "n_nationkey"), ("region", "r_regionkey")):
        col = _cols(tables, table)[key]
        assert col.is_unique_key(max_check_rows=0), table
    again = cfg.generate(SEED, scale=SCALE)
    other = cfg.generate(SEED + 1, scale=SCALE)
    assert np.array_equal(again["lineitem"].columns[1].values, part)
    assert not np.array_equal(other["lineitem"].columns[1].values[:500],
                              part[:500])


# ---------------------------------------------------------------------------
# every query against the plain reference on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plans(tables):
    return cfg.build_plans(tables), port.build_context("cpu")


@pytest.mark.parametrize("mode", ["auto", "sort"])
@pytest.mark.parametrize("name", NAMES)
def test_tpch_query_equals_reference(name, mode, tables, plans, monkeypatch):
    monkeypatch.setenv("RJT_UNIQUE_JOIN", mode)
    built, ctx = plans
    plan = built[name]
    result = port.execute(plan, ctx)
    got = digest.digest(*pagefmt.read_columns(result, "cpu"))
    rel, columns = reference.result(name, tables, "cpu")
    assert got == digest.digest(*rel.out(columns))
    assert result.num_rows == len(rel) > 0
    strategies = plan._fused_struct_cache[1].strategies()
    below = [s for n, s in strategies.items() if n != plan.root]
    # every join below the root has a unique build side
    want = "unique_sort" if mode == "sort" else "unique_scatter"
    assert below == [want] * len(below)
    shapes = plan._last_exec_stats["node_shapes"]
    for node, strategy in strategies.items():
        assert ("sort_reason" in shapes[node]) == (strategy in ("unique_sort",
                                                                "merge"))
        if strategy == "unique_sort":
            assert shapes[node]["sort_reason"] == "knob"


# ---------------------------------------------------------------------------
# why a join sorts
# ---------------------------------------------------------------------------


def _two_table_plan(build_keys, probe_keys, dtype=DataType.INT32,
                    root_join=False):
    """``probe ⋈ build`` under a root join with a one-row table (so the
    first join is no root and may take a unique strategy), or the join
    alone as the root."""
    plan = Plan()
    for keys in (build_keys, probe_keys, [probe_keys[0]]):
        host = HostTable.from_rows([(k,) for k in keys], [dtype])
        plan.new_input(ColumnarTable.from_host(host))
    b = plan.new_scan_node(0, [(0, dtype)])
    p = plan.new_scan_node(1, [(0, dtype)])
    j = plan.new_join_node(True, b, p, 0, 0, [(1, dtype)])
    if root_join:
        plan.root = j
        return plan, j
    one = plan.new_scan_node(2, [(0, dtype)])
    plan.root = plan.new_join_node(True, one, j, 0, 0, [(1, dtype)])
    return plan, j


CASES = {
    # a unique build side whose key window (2^28) is over the slot cap
    "window_cap": (lambda: _two_table_plan([1, 5, 1 << 27, (1 << 27) + 9],
                                           [5, 9, (1 << 27) + 9]),
                   {}, "unique_sort", 28),
    # a window of 2^22 slots for a few rows: the sparseness test
    "sparse": (lambda: _two_table_plan([1, 3, 1 << 21, 3 << 20],
                                       [3, 3 << 20, 7]),
               {}, "unique_sort", 22),
    "knob": (lambda: _two_table_plan([1, 2, 3], [2, 3, 4]),
             {"RJT_UNIQUE_JOIN": "sort"}, "unique_sort", 7),
    # general joins (the root): pads over RJT_BIG_MERGE; an FP64 key
    "big_merge": (lambda: _two_table_plan([1, 2, 2], [2, 3], root_join=True),
                  {"RJT_BIG_MERGE": "1"}, "merge", None),
    "key_type": (lambda: _two_table_plan([1.5, 2.5, 2.5], [2.5, 3.5],
                                         DataType.FP64, root_join=True),
                 {}, "merge", None),
    # the default pad rule off: an integer window past the device CSR's cap
    "window_cap_merge": (lambda: _two_table_plan(
        [1, 1, 1 << 27], [1, 1 << 27, 5], root_join=True),
        {"RJT_BIG_MERGE": "0"}, "merge", 27),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sort_reason(case, monkeypatch):
    """The reason a join settled on a sort-based strategy, as the counter
    ``join.sort_reason.<reason>``, the node shape's ``sort_reason`` and
    ``window_log2``, and the same two on its ``fused.node`` span; the
    result is the plain join's."""
    make, env, strategy, log2 = CASES[case]
    for knob, value in env.items():
        monkeypatch.setenv(knob, value)
    plan, node = make()
    if case == "big_merge":
        # the pads of two tiny tables sum past the threshold only when
        # it is lowered: the knob, not the default, sent the join there
        want = "knob"
    else:
        want = case.replace("_merge", "")
    ctx = port.build_context("cpu")
    trace.start()
    try:
        result = port.execute(plan, ctx)
    finally:
        log = trace.stop()
    spec = plan._fused_struct_cache[1].join_specs[node]
    assert (spec.strategy, spec.sort_reason, spec.window_log2) == (
        strategy, want, log2)
    shape = plan._last_exec_stats["node_shapes"][node]
    assert (shape["sort_reason"], shape["window_log2"]) == (want, log2)
    (sp,) = [s for s in log.spans if s.name == "fused.node"
             and s.attrs["node"] == node]
    assert (sp.attrs["sort_reason"], sp.attrs["window_log2"]) == (want, log2)
    assert log.counters[f"join.sort_reason.{want}"] == 1
    assert sum(v for k, v in log.counters.items()
               if k.startswith("join.sort_reason.")) == 1
    # the join's rows, as a plain nested loop gives them
    build = [r[0] for r in plan.inputs[0].to_host().to_rows()]
    probe = [r[0] for r in plan.inputs[1].to_host().to_rows()]
    rows = sorted(p for p in probe for b in build if b == p)
    if node != plan.root:
        rows = [r for r in rows if r == probe[0]]
    assert sorted(r[0] for r in result.to_host().to_rows()) == rows


def test_big_merge_by_default_pads(monkeypatch):
    """The pad rule at its default: a join whose pads sum to 2^23 reads
    ``big_merge`` (and no window); lowering the threshold from the default
    where the default would have sent it anyway changes nothing."""
    from radixjoin_tpu_torch.plan import executor as ex
    from radixjoin_tpu_torch.plan import fused

    plan, node = _two_table_plan([1, 2], [2, 3], root_join=True)
    j = plan.nodes[node].data
    for env in (None, str(1 << 22)):
        if env is not None:
            monkeypatch.setenv("RJT_BIG_MERGE", env)
        assert ex.merge_reason(plan, j, 0, 0, 1 << 22, 1 << 22,
                               DataType.INT32, big=True) == ("big_merge",
                                                             None)
    assert fused.BIG_MERGE_PAD == 1 << 23


def test_sort_reasons_leave_dense_strategies_alone(tables, plans):
    """The TPC-H plans at SF 0.01 fit every dense cap: no sort-based join
    under the default knobs, so no reason is counted."""
    built, ctx = plans
    trace.start()
    try:
        for plan in built.values():
            port.execute(plan, ctx)
    finally:
        log = trace.stop()
    assert not any(k.startswith("join.sort_reason.") for k in log.counters)


# ---------------------------------------------------------------------------
# the cell on the CPU
# ---------------------------------------------------------------------------


def test_tpch_cell_correct_on_cpu():
    out = run.run_cell(run.ROOT, "tpch_sf30.resident_q3_q8", SEED, 0.3,
                       False, device="cpu", scale=SCALE)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] % 2 == 0 and out["attempted"] > 0
    assert out["checks"]["plans_checked"]["value"] == 2
    assert set(out["metrics"]) == {"setup_s", "queries_per_s",
                                   "peak_device_gib"}
