"""The plain reference of tpch_sf30, written from the five TPC-H SQL texts:
each table's WHERE conditions applied to the generated tables in NumPy
(Q12's comparisons of two columns of a row among them, dates as days since
1970-01-01 with each ``date + interval`` summed by hand), each join
condition in plain PyTorch (joinbench/relops.py), ``lineitem`` joined to
the other tables one by one. Its output is every column the query's select
list, GROUP BY and ORDER BY read (through Q8's subquery, to the columns its
items read), in that order of first appearance and once each: the rows
that the SUM(), CASE and grouping would read, as the program returns them.
A FP64 column's code is its bits, as the benchmark's page reader gives
them. The columns of each table are read from the configuration's schema
file, as the generator made them; nothing of the program is imported."""

import datetime
import json
import os

import numpy as np
import torch

from joinbench import relops
from joinbench.relops import Rel, between, compare, eq, isin, join

with open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "tpch_sf30.schema.json")) as _f:
    _SCHEMA = json.load(_f)


def _day(text: str) -> int:
    return (datetime.date.fromisoformat(text) - datetime.date(1970, 1, 1)).days


class _Table(relops.Table):
    """A generated TPC-H table's columns by name."""

    def __init__(self, name: str, host):
        self.name = name
        self.host = host
        skipped = _SCHEMA["not_generated"].get(name, [])
        self.index = {c: i for i, c in enumerate(
            c for c, _dt, _spec in _SCHEMA["tables"][name]
            if c not in skipped)}


def _scan(table: _Table, alias: str, columns, mask, device) -> Rel:
    """``relops.scan`` of the named columns, a FP64 one as its bits."""
    fp64 = [c for c in columns if table.col(c).dtype.name == "FP64"]
    rel = relops.scan(table, alias, [c for c in columns if c not in fp64],
                      mask, device)
    rows = None if mask is None else np.flatnonzero(mask)
    for c in fp64:
        col = table.col(c)
        values = col.values if rows is None else col.values[rows]
        valid = col.valid if rows is None else col.valid[rows]
        codes = np.where(valid, values.view(np.int64), 0)
        rel.cols[f"{alias}.{c}"] = (torch.from_numpy(codes).to(device),
                                    torch.from_numpy(valid.copy()).to(device))
        rel.sources[f"{alias}.{c}"] = col
    return rel


def _before(table, left: str, right: str) -> np.ndarray:
    """``left < right`` of two columns of one row."""
    a, b = table.col(left), table.col(right)
    return a.valid & b.valid & (a.values < b.values)


#: query -> [(table, alias, its WHERE conditions or None, the columns
#: read, the join condition to what came before as (earlier column, this
#: table's column), None for the first)], and the output columns
QUERIES = {
    "q3": ([
        ("lineitem", "l", lambda t: compare(t.col("l_shipdate"), ">",
                                            _day("1995-03-15")),
         ["l_orderkey", "l_extendedprice", "l_discount"], None),
        ("orders", "o", lambda t: compare(t.col("o_orderdate"), "<",
                                          _day("1995-03-15")),
         ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"],
         ("l.l_orderkey", "o_orderkey")),
        ("customer", "c", lambda t: eq(t.col("c_mktsegment"), b"BUILDING"),
         ["c_custkey"], ("o.o_custkey", "c_custkey")),
    ], ["l.l_orderkey", "l.l_extendedprice", "l.l_discount", "o.o_orderdate",
        "o.o_shippriority"]),
    "q8": ([
        ("lineitem", "l", None, ["l_partkey", "l_suppkey", "l_orderkey",
                                 "l_extendedprice", "l_discount"], None),
        ("part", "p", lambda t: eq(t.col("p_type"),
                                   b"ECONOMY ANODIZED STEEL"),
         ["p_partkey"], ("l.l_partkey", "p_partkey")),
        ("orders", "o", lambda t: between(t.col("o_orderdate"),
                                          _day("1995-01-01"),
                                          _day("1996-12-31")),
         ["o_orderkey", "o_custkey", "o_orderdate"],
         ("l.l_orderkey", "o_orderkey")),
        ("customer", "c", None, ["c_custkey", "c_nationkey"],
         ("o.o_custkey", "c_custkey")),
        ("nation", "n1", None, ["n_nationkey", "n_regionkey"],
         ("c.c_nationkey", "n_nationkey")),
        ("region", "r", lambda t: eq(t.col("r_name"), b"AMERICA"),
         ["r_regionkey"], ("n1.n_regionkey", "r_regionkey")),
        ("supplier", "s", None, ["s_suppkey", "s_nationkey"],
         ("l.l_suppkey", "s_suppkey")),
        ("nation", "n2", None, ["n_nationkey", "n_name"],
         ("s.s_nationkey", "n_nationkey")),
    ], ["o.o_orderdate", "n2.n_name", "l.l_extendedprice", "l.l_discount"]),
    "q10": ([
        ("lineitem", "l", lambda t: eq(t.col("l_returnflag"), b"R"),
         ["l_orderkey", "l_extendedprice", "l_discount"], None),
        # 1993-10-01 + interval '3' month
        ("orders", "o", lambda t: compare(t.col("o_orderdate"), ">=",
                                          _day("1993-10-01"))
         & compare(t.col("o_orderdate"), "<", _day("1994-01-01")),
         ["o_orderkey", "o_custkey"], ("l.l_orderkey", "o_orderkey")),
        ("customer", "c", None,
         ["c_custkey", "c_name", "c_acctbal", "c_address", "c_phone",
          "c_comment", "c_nationkey"], ("o.o_custkey", "c_custkey")),
        ("nation", "n", None, ["n_nationkey", "n_name"],
         ("c.c_nationkey", "n_nationkey")),
    ], ["c.c_custkey", "c.c_name", "l.l_extendedprice", "l.l_discount",
        "c.c_acctbal", "n.n_name", "c.c_address", "c.c_phone",
        "c.c_comment"]),
    "q12": ([
        # 1994-01-01 + interval '1' year
        ("lineitem", "l", lambda t: isin(t.col("l_shipmode"),
                                         [b"MAIL", b"SHIP"])
         & _before(t, "l_commitdate", "l_receiptdate")
         & _before(t, "l_shipdate", "l_commitdate")
         & compare(t.col("l_receiptdate"), ">=", _day("1994-01-01"))
         & compare(t.col("l_receiptdate"), "<", _day("1995-01-01")),
         ["l_orderkey", "l_shipmode"], None),
        ("orders", "o", None, ["o_orderkey", "o_orderpriority"],
         ("l.l_orderkey", "o_orderkey")),
    ], ["l.l_shipmode", "o.o_orderpriority"]),
    "q14": ([
        # 1995-09-01 + interval '1' month
        ("lineitem", "l", lambda t: compare(t.col("l_shipdate"), ">=",
                                            _day("1995-09-01"))
         & compare(t.col("l_shipdate"), "<", _day("1995-10-01")),
         ["l_partkey", "l_extendedprice", "l_discount"], None),
        ("part", "p", None, ["p_partkey", "p_type"],
         ("l.l_partkey", "p_partkey")),
    ], ["p.p_type", "l.l_extendedprice", "l.l_discount"]),
}


def result(name: str, tables, device):
    """Query ``name``'s result as a relation and the names of its output
    columns, in the order the SQL text first reads them."""
    steps, out = QUERIES[name]
    r = None
    for table, alias, cond, columns, on in steps:
        t = _Table(table, tables[table])
        side = _scan(t, alias, columns, None if cond is None else cond(t),
                     device)
        r = side if r is None else join(r, side, on[0], f"{alias}.{on[1]}")
        del side
    return r, out
