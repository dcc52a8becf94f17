"""The port's copies of the SQL front end (parser, frontend, predicate,
EXPLAIN converter) and of the CSV ingest with its filter, against the JAX
package's modules on the same inputs: equal parsed structures, equal plans
(nodes, attributes, build sides) and equal filtered inputs, column for
column — tolerance 0. Nothing here runs on a device.
"""

import types

import numpy as np
import pytest

import radixjoin_tpu.dtypes as ref_dtypes
import radixjoin_tpu.sql as ref_sql
import radixjoin_tpu.sql.explain as ref_explain
import radixjoin_tpu.sql.frontend as ref_frontend
import radixjoin_tpu.sql.parser as ref_parser
import radixjoin_tpu.sql.predicate as ref_predicate
import radixjoin_tpu.storage.columnar as ref_columnar
import radixjoin_tpu.storage.ingest as ref_ingest
from radixjoin_tpu.harness import datagen as ref_datagen
from radixjoin_tpu.harness import run as ref_run

import radixjoin_tpu_torch.dtypes as port_dtypes
import radixjoin_tpu_torch.sql as port_sql
import radixjoin_tpu_torch.sql.explain as port_explain
import radixjoin_tpu_torch.sql.frontend as port_frontend
import radixjoin_tpu_torch.sql.parser as port_parser
import radixjoin_tpu_torch.sql.predicate as port_predicate
import radixjoin_tpu_torch.storage.columnar as port_columnar
import radixjoin_tpu_torch.storage.ingest as port_ingest
from radixjoin_tpu_torch.harness import datagen as port_datagen
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.harness import run as port_run

from test_torch_engine import assert_same_tables

REF = types.SimpleNamespace(
    dtypes=ref_dtypes, frontend=ref_frontend, parser=ref_parser,
    predicate=ref_predicate, columnar=ref_columnar, ingest=ref_ingest,
    explain=ref_explain, sql=ref_sql, datagen=ref_datagen, run=ref_run)
PORT = types.SimpleNamespace(
    dtypes=port_dtypes, frontend=port_frontend, parser=port_parser,
    predicate=port_predicate, columnar=port_columnar, ingest=port_ingest,
    explain=port_explain, sql=port_sql, datagen=port_datagen, run=port_run)


def describe(parsed) -> dict:
    """A ParsedSQL as plain values, comparable between the packages."""
    return {
        "output_attrs": [(str(e), c) for e, c in parsed.output_attrs],
        "table_counts": dict(parsed.table_counts),
        "alias_map": {a: str(e) for a, e in parsed.alias_map.items()},
        "column_vec": [(str(e), c) for e, c in parsed.column_vec],
        "join_graph": {str(a): {str(b): cols for b, cols in nbrs.items()}
                       for a, nbrs in parsed.join_graph.items()},
        "filters": {str(e): s.pretty() for e, s in parsed.filters.items()},
        "executed_sql": parsed.executed_sql(),
    }


# ---------------------------------------------------------------------------
# the twelve inline cases of tests/test_sql_frontend.py, written over a
# package namespace; each returns what it saw, as plain values
# ---------------------------------------------------------------------------


def case_parse_basic_query(p):
    stmt = p.parser.parse_sql(
        "SELECT MIN(t.title) AS movie_title FROM title AS t, "
        "movie_companies AS mc WHERE t.id = mc.movie_id AND "
        "t.production_year > 1990;")
    assert len(stmt.select_list) == 1
    assert stmt.select_list[0].aggregate == "MIN"
    assert stmt.tables == [("title", "t"), ("movie_companies", "mc")]
    return repr(stmt)


def case_join_graph_and_filters(p):
    parsed = p.frontend.ParsedSQL(
        "SELECT MIN(t.title) FROM title AS t, movie_companies AS mc, "
        "company_type AS ct WHERE ct.kind = 'production companies' AND "
        "t.production_year BETWEEN 1990 AND 2000 AND "
        "ct.id = mc.company_type_id AND t.id = mc.movie_id;")
    t = p.frontend.TableEntity("title", 0)
    mc = p.frontend.TableEntity("movie_companies", 0)
    ct = p.frontend.TableEntity("company_type", 0)
    assert parsed.output_attrs == [(t, "title")]
    assert parsed.join_graph[t][mc] == ("id", "movie_id")
    assert parsed.join_graph[mc][ct] == ("company_type_id", "id")
    assert ct in parsed.filters and t in parsed.filters
    assert mc not in parsed.filters
    # BETWEEN lowered to GEQ AND LEQ
    assert isinstance(parsed.filters[t], p.predicate.LogicalOperation)
    return describe(parsed)


def case_transitive_join_closure(p):
    parsed = p.frontend.ParsedSQL(
        "SELECT t.title FROM title AS t, movie_companies AS mc, "
        "movie_info AS mi WHERE t.id = mc.movie_id AND t.id = mi.movie_id;")
    mc = p.frontend.TableEntity("movie_companies", 0)
    mi = p.frontend.TableEntity("movie_info", 0)
    assert parsed.join_graph[mc][mi] == ("movie_id", "movie_id")
    return describe(parsed)


def case_same_table_twice(p):
    parsed = p.frontend.ParsedSQL(
        "SELECT t1.title FROM title AS t1, title AS t2, movie_link AS ml "
        "WHERE t1.id = ml.movie_id AND t2.id = ml.linked_movie_id;")
    assert parsed.table_counts["title"] == 2
    assert p.frontend.TableEntity("title", 0) in parsed.column_map
    assert p.frontend.TableEntity("title", 1) in parsed.column_map
    return describe(parsed)


def case_executed_sql_rewrite(p):
    parsed = p.frontend.ParsedSQL(
        "SELECT MIN(t.title) AS x FROM title AS t "
        "WHERE t.production_year > 2000;")
    out = parsed.executed_sql()
    assert out.startswith("SELECT t.title FROM title AS t")
    assert "MIN" not in out
    return describe(parsed)


def case_or_filter_same_entity(p):
    parsed = p.frontend.ParsedSQL(
        "SELECT mc.note FROM movie_companies AS mc, title AS t WHERE "
        "(mc.note LIKE '%(co-production)%' OR mc.note LIKE '%(presents)%') "
        "AND t.id = mc.movie_id;")
    mc = p.frontend.TableEntity("movie_companies", 0)
    assert isinstance(parsed.filters[mc], p.predicate.LogicalOperation)
    return describe(parsed)


def _rejected(p, sql):
    with pytest.raises(ValueError) as err:
        p.frontend.ParsedSQL(sql)
    return str(err.value)


def case_or_across_entities_rejected(p):
    return _rejected(
        p, "SELECT t.title FROM title AS t, movie_companies AS mc WHERE "
        "(t.production_year > 2000 OR mc.note LIKE '%x%') "
        "AND t.id = mc.movie_id;")


def case_join_condition_inside_or_rejected(p):
    return _rejected(
        p, "SELECT t.title FROM title AS t, movie_companies AS mc WHERE "
        "t.production_year > 2000 OR t.id = mc.movie_id;")


def case_like_match_semantics(p):
    like = p.predicate.like_match
    cases = [(b"(presents)", b"%(presents)%"), (b"abc", b"a_c"),
             (b"abc", b"a_d"), (b"anything", b"%"), (b"a.c", b"a.c"),
             (b"abc", b"a.c"), (b"a\nc", b"a_c"), (b"", b"%"), (b"", b"_"),
             (b"50% off", b"50%% off"), (b"a+b", b"a+b"), (b"aab", b"a+b")]
    got = [like(v, pat) for v, pat in cases]
    assert got[:7] == [True, True, False, True, True, False, False]
    return got


def case_comparison_null_semantics(p):
    DataType, NULL = p.dtypes.DataType, p.dtypes.NULL
    Comparison, Op = p.predicate.Comparison, p.predicate.Op
    table = p.columnar.HostTable.from_rows(
        [(1, "x"), (NULL, "y"), (3, NULL)], [DataType.INT32, DataType.VARCHAR])
    neq = Comparison(0, Op.NEQ, 1)
    isnull = Comparison(1, Op.IS_NULL)
    notlike = Comparison(1, Op.NOT_LIKE, "z%")
    # NOT flips NULL rows to true (reference bitmap semantics)
    noteq = p.predicate.LogicalOperation.make_not(Comparison(0, Op.EQ, 1))
    out = []
    rows = table.to_rows()
    for stmt, want in ((neq, [False, False, True]),
                       (isnull, [False, False, True]),
                       (notlike, [True, True, False]),
                       (noteq, [False, True, True])):
        col = stmt.eval_table(table)
        np.testing.assert_array_equal(col, want)
        # row eval agrees with columnar eval
        assert [stmt.eval_row(r) for r in rows] == [bool(x) for x in col]
        out.append((stmt.pretty(), col.tolist()))
    return out


def case_string_comparisons(p):
    DataType, NULL = p.dtypes.DataType, p.dtypes.NULL
    Comparison, Op = p.predicate.Comparison, p.predicate.Op
    table = p.columnar.HostTable.from_rows(
        [("apple",), ("pear",), (NULL,)], [DataType.VARCHAR])
    out = []
    for op, value, want in ((Op.LT, "b", [True, False, False]),
                            (Op.EQ, "pear", [False, True, False]),
                            (Op.GEQ, "apple", [True, True, False]),
                            (Op.NEQ, "pear", [True, False, False])):
        got = Comparison(0, op, value).eval_table(table)
        np.testing.assert_array_equal(got, want)
        out.append(got.tolist())
    return out


def case_numeric_literal_on_string_column_false(p):
    table = p.columnar.HostTable.from_rows([("5",)],
                                           [p.dtypes.DataType.VARCHAR])
    eq = p.predicate.Comparison(0, p.predicate.Op.EQ, 5)
    got = eq.eval_table(table)
    np.testing.assert_array_equal(got, [False])
    return got.tolist()


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sql_frontend_case_equal_in_both_packages(case):
    assert len(CASES) == 12
    assert CASES[case](PORT) == CASES[case](REF)


# ---------------------------------------------------------------------------
# the query documents: front end, EXPLAIN converter, filtered inputs
# ---------------------------------------------------------------------------

DOCS = job_shapes.QUERY_DOCUMENTS
SQLS = [DOCS[name][0] for name in DOCS]


@pytest.fixture(scope="module")
def both_tables():
    """The query-aware synthetic IMDB of each package (same scale, seed and
    queries): literal mixing and planted witnesses included."""
    ref_tables = ref_datagen.SyntheticIMDB(
        scale=0.001, seed=0, queries=SQLS).generate()
    port_tables = port_datagen.SyntheticIMDB(
        scale=0.001, seed=0, queries=SQLS).generate()
    return ref_tables, port_tables


def test_query_aware_datagen_equals_reference(both_tables):
    ref_tables, port_tables = both_tables
    assert len(ref_tables) == 21
    assert_same_tables(ref_tables, port_tables)
    # the queries moved the data: harvested literals are in the columns
    plain = port_datagen.SyntheticIMDB(scale=0.001, seed=0).generate(
        ["keyword"])["keyword"]
    assert not np.array_equal(plain.columns[1].heap,
                              port_tables["keyword"].columns[1].heap)


@pytest.mark.parametrize("name", sorted(DOCS))
def test_query_document_parses_equal(name):
    sql = DOCS[name][0]
    port_parsed = port_sql.ParsedSQL(sql, name)
    assert describe(port_parsed) == describe(ref_sql.ParsedSQL(sql, name))
    assert port_parsed.output_attrs and port_parsed.join_graph
    assert port_parsed.filters


def _plan_shape(plan):
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


@pytest.mark.parametrize("eager", ["off", "on"])
@pytest.mark.parametrize("name", sorted(DOCS))
def test_plan_from_explain_equal_in_both_packages(name, eager, both_tables,
                                                  monkeypatch):
    """Equal plans and equal filtered inputs, through each package's
    ``TableSource.provider`` (``ingest.filter_table``), lazily and with
    ``RJT_EAGER_PAGES=on`` (eager aligned pages, host twin dropped)."""
    monkeypatch.setenv("RJT_EAGER_PAGES", eager)
    sql, doc = DOCS[name]
    plans = []
    for p, tables in zip((REF, PORT), both_tables):
        source = p.run.TableSource(host_tables=tables)
        plan = p.sql.plan_from_explain(
            doc["Plan"], p.sql.ParsedSQL(sql, name), source.provider)
        plan.validate()
        plans.append(plan)
    ref_plan, port_plan = plans
    assert _plan_shape(port_plan) == _plan_shape(ref_plan)
    assert len(port_plan.inputs) == len(ref_plan.inputs) >= 3
    for a, b in zip(ref_plan.inputs, port_plan.inputs):
        assert (a._host is None) == (b._host is None) == (eager == "on")
        assert_same_tables({"t": a.to_host()}, {"t": b.to_host()})
    if name == "q_alias":  # one table, two aliases: two inputs, two filters
        tables = [i.num_rows for i in port_plan.inputs]
        assert len(tables) == 4 and tables[2] != tables[3]


def test_explain_errors_equal():
    parsed = [p.sql.ParsedSQL(DOCS["q_or"][0]) for p in (REF, PORT)]
    bad = {"Node Type": "Hash Join", "Plans": [
        {"Node Type": "Seq Scan", "Relation Name": "title", "Alias": "t"},
        {"Node Type": "Seq Scan", "Relation Name": "keyword", "Alias": "k"}]}
    messages = []
    for p, ps in zip((REF, PORT), parsed):
        with pytest.raises(p.explain.ExplainError) as err:
            p.sql.plan_from_explain(bad, ps, lambda *a: None)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


# ---------------------------------------------------------------------------
# CSV ingest and the pushed-down filter
# ---------------------------------------------------------------------------


def test_csv_ingest_and_filter_equal(tmp_path, both_tables):
    ref_tables, port_tables = both_tables
    types_of = {"ref": ref_sql.catalog.column_types("movie_companies"),
                "port": port_sql.catalog.column_types("movie_companies")}
    path = str(tmp_path / "movie_companies.csv")
    port_ingest.write_csv(path, port_tables["movie_companies"])
    ref_path = str(tmp_path / "ref_movie_companies.csv")
    ref_ingest.write_csv(ref_path, ref_tables["movie_companies"])
    with open(path, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()
    got = port_ingest.parse_csv(path, types_of["port"])
    want = ref_ingest.parse_csv(path, types_of["ref"])
    assert_same_tables({"mc": want}, {"mc": got})
    # the round trip through CSV gives the generated table back
    assert_same_tables({"mc": ref_tables["movie_companies"]}, {"mc": got})
    filters = [p.sql.ParsedSQL(DOCS["q1a"][0]).filters[
        p.frontend.TableEntity("movie_companies", 0)] for p in (REF, PORT)]
    assert filters[0].pretty() == filters[1].pretty()
    f_want = ref_ingest.filter_table(want, filters[0])
    f_got = port_ingest.filter_table(got, filters[1])
    assert 0 < f_got.num_rows < got.num_rows
    assert_same_tables({"mc": f_want}, {"mc": f_got})
    # the CSV route of the table source, with its parsed-table cache
    source = port_run.TableSource(csv_dir=str(tmp_path))
    assert source.table("movie_companies") is source.table("movie_companies")
    port_ingest.clear_caches()
    with pytest.raises(ValueError):
        port_run.TableSource()


def test_sql_package_exports():
    assert sorted(port_sql.__all__) == sorted(ref_sql.__all__)
    for name in port_sql.__all__:
        assert hasattr(port_sql, name)
