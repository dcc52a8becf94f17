"""The plain reference of ssb_sf20, written from the SSB SQL texts: each
dimension's WHERE conditions applied to the generated tables in NumPy,
each join condition ``lo_<key> = <dimension key>`` in plain PyTorch
(joinbench/relops.py), the dimensions joined smallest first. Its output is
every column the query's select list, GROUP BY and ORDER BY read, in that
order of first appearance and once each: the rows that the SUM() and the
grouping would read, as the program returns them."""

import numpy as np
import torch

from joinbench import relops, ssb_datagen
from joinbench.relops import Rel, between, compare, eq, isin, join, scan


class _Table(relops.Table):
    """A generated SSB table's columns by name."""

    def __init__(self, name: str, host):
        self.name = name
        self.host = host
        self.index = {c: i for i, (c, _dt) in
                      enumerate(ssb_datagen.COLUMNS[name])}


def _str_between(col, lo: bytes, hi: bytes) -> np.ndarray:
    """``col BETWEEN lo AND hi`` on a VARCHAR column, bytewise."""
    heap, ends, starts = relops._varchar(col)
    lengths = ends - starts
    width = max(int(lengths.max()) if len(lengths) else 0, 1)
    rows = np.zeros((len(lengths), width), np.uint8)
    for k in range(width):
        has = lengths > k
        rows[has, k] = heap[starts[has] + k]
    values = rows.view(f"S{width}").ravel()
    return col.valid & (values >= lo) & (values <= hi)


#: dimension -> (its lineorder key, its key)
_KEYS = {"date": ("lo_orderdate", "d_datekey"),
         "part": ("lo_partkey", "p_partkey"),
         "supplier": ("lo_suppkey", "s_suppkey"),
         "customer": ("lo_custkey", "c_custkey")}
#: a table's alias, the prefix of its columns' names
_ALIAS = {"date": "d", "part": "p", "supplier": "s", "customer": "c"}


def _q1(year_cond, discount, quantity):
    def fact(lo):
        return (between(lo.col("lo_discount"), *discount)
                & quantity(lo.col("lo_quantity")))
    return {"date": year_cond}, fact, ["lo_extendedprice", "lo_discount"]


_BRAND = ["lo_revenue", "d_year", "p_brand1"]
_CITY = ["c_city", "s_city", "d_year", "lo_revenue"]
_KI = [b"UNITED KI1", b"UNITED KI5"]

#: query -> ({dimension: its WHERE conditions as a function of the table,
#: or None}, the lineorder conditions or None, the output columns)
QUERIES = {
    "q1_1": _q1(lambda d: eq(d.col("d_year"), 1993), (1, 3),
                lambda q: compare(q, "<", 25)),
    "q1_2": _q1(lambda d: eq(d.col("d_yearmonthnum"), 199401), (4, 6),
                lambda q: between(q, 26, 35)),
    "q1_3": _q1(lambda d: eq(d.col("d_weeknuminyear"), 6)
                & eq(d.col("d_year"), 1994), (5, 7),
                lambda q: between(q, 26, 35)),
    "q2_1": ({"date": None,
              "part": lambda p: eq(p.col("p_category"), b"MFGR#12"),
              "supplier": lambda s: eq(s.col("s_region"), b"AMERICA")},
             None, _BRAND),
    "q2_2": ({"date": None,
              "part": lambda p: _str_between(p.col("p_brand1"), b"MFGR#2221",
                                             b"MFGR#2228"),
              "supplier": lambda s: eq(s.col("s_region"), b"ASIA")},
             None, _BRAND),
    "q2_3": ({"date": None,
              "part": lambda p: eq(p.col("p_brand1"), b"MFGR#2239"),
              "supplier": lambda s: eq(s.col("s_region"), b"EUROPE")},
             None, _BRAND),
    "q3_1": ({"customer": lambda c: eq(c.col("c_region"), b"ASIA"),
              "supplier": lambda s: eq(s.col("s_region"), b"ASIA"),
              "date": lambda d: compare(d.col("d_year"), ">=", 1992)
              & compare(d.col("d_year"), "<=", 1997)},
             None, ["c_nation", "s_nation", "d_year", "lo_revenue"]),
    "q3_2": ({"customer": lambda c: eq(c.col("c_nation"), b"UNITED STATES"),
              "supplier": lambda s: eq(s.col("s_nation"), b"UNITED STATES"),
              "date": lambda d: compare(d.col("d_year"), ">=", 1992)
              & compare(d.col("d_year"), "<=", 1997)},
             None, _CITY),
    "q3_3": ({"customer": lambda c: isin(c.col("c_city"), _KI),
              "supplier": lambda s: isin(s.col("s_city"), _KI),
              "date": lambda d: compare(d.col("d_year"), ">=", 1992)
              & compare(d.col("d_year"), "<=", 1997)},
             None, _CITY),
    "q3_4": ({"customer": lambda c: isin(c.col("c_city"), _KI),
              "supplier": lambda s: isin(s.col("s_city"), _KI),
              "date": lambda d: eq(d.col("d_yearmonth"), b"Dec1997")},
             None, _CITY),
    "q4_1": ({"customer": lambda c: eq(c.col("c_region"), b"AMERICA"),
              "supplier": lambda s: eq(s.col("s_region"), b"AMERICA"),
              "part": lambda p: isin(p.col("p_mfgr"), [b"MFGR#1", b"MFGR#2"]),
              "date": None},
             None, ["d_year", "c_nation", "lo_revenue", "lo_supplycost"]),
    "q4_2": ({"customer": lambda c: eq(c.col("c_region"), b"AMERICA"),
              "supplier": lambda s: eq(s.col("s_region"), b"AMERICA"),
              "date": lambda d: isin(d.col("d_year"), [1997, 1998]),
              "part": lambda p: isin(p.col("p_mfgr"), [b"MFGR#1", b"MFGR#2"])},
             None, ["d_year", "s_nation", "p_category", "lo_revenue",
                    "lo_supplycost"]),
    "q4_3": ({"customer": lambda c: eq(c.col("c_region"), b"AMERICA"),
              "supplier": lambda s: eq(s.col("s_nation"), b"UNITED STATES"),
              "date": lambda d: isin(d.col("d_year"), [1997, 1998]),
              "part": lambda p: eq(p.col("p_category"), b"MFGR#14")},
             None, ["d_year", "s_city", "p_brand1", "lo_revenue",
                    "lo_supplycost"]),
}


def _fact(lo: _Table, columns, mask, device) -> Rel:
    """``lineorder``'s rows where ``mask`` holds (all when None), the named
    INT32 columns as int64 codes on ``device``."""
    rows = None if mask is None else torch.from_numpy(np.flatnonzero(mask))
    cols, sources = {}, {}
    for c in columns:
        col = lo.col(c)
        codes = torch.from_numpy(col.values).to(device).long()
        valid = torch.from_numpy(col.valid).to(device)
        if rows is not None:
            codes, valid = codes[rows.to(device)], valid[rows.to(device)]
        cols[f"lo.{c}"] = (torch.where(valid, codes, 0), valid)
        sources[f"lo.{c}"] = col
    return Rel(cols, sources)


def result(name: str, tables, device):
    """Query ``name``'s result as a relation and the names of its output
    columns, in the order the SQL text first reads them."""
    dims, fact_cond, out = QUERIES[name]
    t = {n: _Table(n, h) for n, h in tables.items()}
    lo_cols = [_KEYS[d][0] for d in dims] + [c for c in out
                                             if c.startswith("lo_")]
    r = _fact(t["lineorder"], list(dict.fromkeys(lo_cols)),
              None if fact_cond is None else fact_cond(t["lineorder"]), device)
    sides = []
    for dim, cond in dims.items():
        key = _KEYS[dim][1]
        wanted = [key] + [c for c in out if c.startswith(_ALIAS[dim] + "_")]
        mask = None if cond is None else cond(t[dim])
        sides.append(scan(t[dim], _ALIAS[dim], list(dict.fromkeys(wanted)),
                          mask, device))
    for dim, side in sorted(zip(dims, sides), key=lambda ds: len(ds[1])):
        fk, pk = _KEYS[dim]
        r = join(r, side, f"lo.{fk}", f"{_ALIAS[dim]}.{pk}")
    return r, [f"{c.split('_', 1)[0]}.{c}" for c in out]
