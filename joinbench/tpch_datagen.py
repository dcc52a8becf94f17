"""The benchmark's TPC-H data: the tables of the TPC Benchmark H (Standard
Specification revision 3.0.1) at a scale factor, made from a seed in
NumPy by the rules of Clause 4.2, in place of the specification's
``dbgen``.

Row counts are Clause 4.2.5's: ``supplier`` SF x 10,000, ``part`` SF x
200,000, ``customer`` SF x 150,000, ``orders`` SF x 1,500,000, each
order 1 to 7 ``lineitem`` rows (about SF x 6,000,000), ``nation`` 25 and
``region`` 5. Every table is in primary-key order, as ``dbgen`` writes it.

- ``o_orderkey`` is sparse: order i (from 1) has key ``((i >> 3) << 5) |
  (i & 7)``, the first 8 of every 32 keys (``dbgen``'s ``mk_sparse``), so
  at SF 30 the keys run to about 180 M.
- ``o_custkey`` is uniform over the customer keys that are no multiple of 3.
- ``o_orderdate`` is uniform over 1992-01-01 ... 1998-08-02 (ENDDATE less
  151 days); ``l_shipdate`` is the order date plus U[1, 121] days,
  ``l_commitdate`` the order date plus U[30, 90], ``l_receiptdate`` the ship
  date plus U[1, 30]; ``l_returnflag`` is ``R`` or ``A`` at random where the
  receipt date is at most CURRENTDATE (1995-06-17), ``N`` after it.
- ``l_partkey`` is uniform over the parts; ``l_suppkey`` is one of the
  part's four suppliers, ``(partkey + i * (S / 4 + (partkey - 1) / S)) mod
  S + 1`` with i uniform in [0, 3] and S = SF x 10,000 (integer division).
- ``l_extendedprice`` is a uniform quantity in [1, 50] times the part's
  retail price, ``(90000 + (partkey / 10) mod 20001 + 100 x (partkey mod
  1000)) / 100``; ``l_discount`` is uniform in [0.00, 0.10] (in cents,
  then divided by 100).
- ``p_type`` is one of the 150 combinations of three syllables,
  ``o_orderpriority``, ``c_mktsegment`` and ``l_shipmode`` uniform over the
  specification's lists, ``o_shippriority`` 0, ``c_acctbal`` uniform over
  [-999.99, 9999.99] in cents, names ``Customer#`` and nine digits, phones
  the nation's code and three random groups, addresses and comments random
  letters and digits of the lengths Clause 4.2.3 gives.

DATE columns are INT32 days since 1970-01-01, DECIMAL columns FP64 and
CHAR / VARCHAR columns VARCHAR (``configs/tpch_sf30.schema.json``). There
are no NULLs. The columns that no query of the configuration reads
(``not_generated`` in the schema file) are not made.

Each (table, column) draws from its own seeded substream, so a table is
the same whichever other tables are made.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from radixjoin_tpu_torch import DataType
from radixjoin_tpu_torch.storage.columnar import HostColumn, HostTable

from . import ssb_datagen
from .ssb_datagen import NATIONS, REGIONS, SEGMENTS, TYPES

_HERE = os.path.dirname(os.path.abspath(__file__))
SCHEMA_PATH = os.path.join(_HERE, "configs", "tpch_sf30.schema.json")

with open(SCHEMA_PATH) as _f:
    _SCHEMA = json.load(_f)

#: table -> [(column, type name)] of the columns made (the schema's, less
#: ``not_generated``), in the schema's order; a table none of whose
#: columns is made is left out
COLUMNS: Dict[str, List[Tuple[str, str]]] = {
    t: cols for t, cols in (
        (t, [(c, dt) for c, dt, _spec in cols
             if c not in _SCHEMA["not_generated"].get(t, [])])
        for t, cols in _SCHEMA["tables"].items())
    if cols
}
TABLES = list(COLUMNS)

PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
EPOCH = datetime.date(1970, 1, 1)
START_DAY = (datetime.date(1992, 1, 1) - EPOCH).days
#: the last order date, ENDDATE (1998-12-31) less 151 days
LAST_ORDER_DAY = (datetime.date(1998, 8, 2) - EPOCH).days
CURRENT_DAY = (datetime.date(1995, 6, 17) - EPOCH).days
_TABLE_IDS = {t: i for i, t in enumerate(_SCHEMA["tables"])}


def row_counts(scale: float) -> Dict[str, int]:
    """Rows of each table at ``scale``, ``orders`` for ``lineitem`` too."""
    def rows(base):
        return max(1, int(round(base * scale)))
    return {"supplier": rows(10_000), "part": rows(200_000),
            "customer": rows(150_000), "orders": rows(1_500_000),
            "nation": len(NATIONS), "region": len(REGIONS)}


def order_keys(n: int) -> np.ndarray:
    """The keys of orders 1 ... n: the first 8 of every 32."""
    i = np.arange(1, n + 1, dtype=np.int64)
    return (((i >> 3) << 5) | (i & 7)).astype(np.int32)


class _Streams(ssb_datagen._Streams):
    """One seeded generator a (table, column) of TPC-H."""

    def __init__(self, seed: int, table: str):
        self.seed, self.table = int(seed) % (1 << 64), _TABLE_IDS[table]


# -- columns ------------------------------------------------------------------


def _int(values) -> HostColumn:
    values = np.ascontiguousarray(values, dtype=np.int32)
    return HostColumn(DataType.INT32, values, np.ones(len(values), bool))


def _float(values) -> HostColumn:
    values = np.ascontiguousarray(values, dtype=np.float64)
    return HostColumn(DataType.FP64, values, np.ones(len(values), bool))


def _from_set(strings: List[str], codes: np.ndarray) -> HostColumn:
    """A VARCHAR column whose row i is ``strings[codes[i]]``, made through
    a padded byte table (no per-byte index arrays at fact scale)."""
    words = [s.encode("latin-1") for s in strings]
    width = max(len(w) for w in words)
    table = np.zeros((len(words), width), np.uint8)
    for k, w in enumerate(words):
        table[k, :len(w)] = np.frombuffer(w, np.uint8)
    lengths = np.array([len(w) for w in words], np.int64)
    n = len(codes)
    if width == 1:
        heap = table[codes, 0]
    else:
        keep = np.arange(width) < lengths[:, None]
        heap = table[codes][keep[codes]]
    ends = (np.arange(1, n + 1, dtype=np.int64) if (lengths == 1).all()
            else np.cumsum(lengths[codes]))
    return HostColumn.varchar(heap, ends, np.ones(n, bool))


def _nation_key(rng, n: int) -> np.ndarray:
    return rng.integers(0, len(NATIONS), n, dtype=np.int32)


def _customer(s: _Streams, n: int) -> Dict[str, HostColumn]:
    keys = np.arange(1, n + 1)
    nation = _nation_key(s("c_nationkey"), n)
    cents = s("c_acctbal").integers(-99_999, 1_000_000, n)
    return {
        "c_custkey": _int(keys),
        "c_name": ssb_datagen._fixed([b"Customer#", (keys, 9)]),
        "c_address": ssb_datagen._random_text(s("c_address"), n, 10, 40),
        "c_nationkey": _int(nation),
        "c_phone": ssb_datagen._phone(s("c_phone"), nation),
        "c_acctbal": _float(cents / 100.0),
        "c_mktsegment": _from_set(SEGMENTS, s("c_mktsegment").integers(
            0, len(SEGMENTS), n)),
        "c_comment": ssb_datagen._random_text(s("c_comment"), n, 29, 116),
    }


def _supplier(s: _Streams, n: int) -> Dict[str, HostColumn]:
    return {"s_suppkey": _int(np.arange(1, n + 1)),
            "s_nationkey": _int(_nation_key(s("s_nationkey"), n))}


def _part(s: _Streams, n: int) -> Dict[str, HostColumn]:
    return {"p_partkey": _int(np.arange(1, n + 1)),
            "p_type": _from_set(TYPES, s("p_type").integers(
                0, len(TYPES), n))}


def _nation() -> Dict[str, HostColumn]:
    return {"n_nationkey": _int(np.arange(len(NATIONS))),
            "n_name": _from_set([m for m, _r in NATIONS],
                                np.arange(len(NATIONS))),
            "n_regionkey": _int([r for _m, r in NATIONS])}


def _region() -> Dict[str, HostColumn]:
    return {"r_regionkey": _int(np.arange(len(REGIONS))),
            "r_name": _from_set(REGIONS, np.arange(len(REGIONS)))}


def _order_days(s: _Streams, orders: int) -> np.ndarray:
    return s("o_orderdate").integers(START_DAY, LAST_ORDER_DAY + 1, orders,
                                     dtype=np.int32)


def _orders(s: _Streams, counts: Dict[str, int]) -> Dict[str, HostColumn]:
    n = counts["orders"]
    # the r-th customer key that is no multiple of 3, r uniform
    live = counts["customer"] - counts["customer"] // 3
    r = s("o_custkey").integers(0, live, n, dtype=np.int64)
    return {
        "o_orderkey": _int(order_keys(n)),
        "o_custkey": _int((r // 2) * 3 + r % 2 + 1),
        "o_orderdate": _int(_order_days(s, n)),
        "o_orderpriority": _from_set(PRIORITIES, s("o_orderpriority").integers(
            0, len(PRIORITIES), n)),
        "o_shippriority": _int(np.zeros(n)),
    }


def _lineitem(s: _Streams, so: _Streams,
              counts: Dict[str, int]) -> Dict[str, HostColumn]:
    """``so``: the streams of ``orders``, whose keys and dates the lines
    repeat."""
    orders = counts["orders"]
    lines = s("lines").integers(1, 8, orders, dtype=np.int8)
    n = int(lines.sum(dtype=np.int64))
    parts, supps = counts["part"], counts["supplier"]
    partkey = s("l_partkey").integers(1, parts + 1, n, dtype=np.int32)
    corner = s("l_suppkey").integers(0, 4, n, dtype=np.int32)
    suppkey = (partkey + corner * (supps // 4 + (partkey - 1) // supps)) \
        % supps + 1
    del corner
    retail = (90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1000))
    quantity = s("l_quantity").integers(1, 51, n, dtype=np.int32)
    extended = (quantity * retail) / 100.0
    del quantity, retail
    discount = s("l_discount").integers(0, 11, n, dtype=np.int32) / 100.0
    order_day = np.repeat(_order_days(so, orders), lines)
    ship = order_day + s("l_shipdate").integers(1, 122, n, dtype=np.int32)
    commit = order_day + s("l_commitdate").integers(30, 91, n,
                                                    dtype=np.int32)
    del order_day
    receipt = ship + s("l_receiptdate").integers(1, 31, n, dtype=np.int32)
    # R or A at random where received by CURRENTDATE, N after it
    flag = np.where(receipt <= CURRENT_DAY,
                    s("l_returnflag").integers(0, 2, n, dtype=np.int8),
                    2).astype(np.int8)
    return {
        "l_orderkey": _int(np.repeat(order_keys(orders), lines)),
        "l_partkey": _int(partkey),
        "l_suppkey": _int(suppkey),
        "l_extendedprice": _float(extended),
        "l_discount": _float(discount),
        "l_returnflag": _from_set(["R", "A", "N"], flag),
        "l_shipdate": _int(ship),
        "l_commitdate": _int(commit),
        "l_receiptdate": _int(receipt),
        "l_shipmode": _from_set(SHIPMODES, s("l_shipmode").integers(
            0, len(SHIPMODES), n, dtype=np.int8)),
    }


def generate(seed: int, scale: float) -> Dict[str, HostTable]:
    """name -> HostTable of the tables at ``scale``, columns in
    :data:`COLUMNS` order."""
    counts = row_counts(scale)
    makers = {
        "lineitem": lambda s: _lineitem(s, _Streams(seed, "orders"), counts),
        "orders": lambda s: _orders(s, counts),
        "customer": lambda s: _customer(s, counts["customer"]),
        "part": lambda s: _part(s, counts["part"]),
        "supplier": lambda s: _supplier(s, counts["supplier"]),
        "nation": lambda _s: _nation(),
        "region": lambda _s: _region(),
    }
    out = {}
    for t in TABLES:
        cols = makers[t](_Streams(seed, t))
        host = [cols.pop(c) for c, _dt in COLUMNS[t]]
        assert not cols, f"{t}: made columns the schema lacks: {sorted(cols)}"
        out[t] = HostTable(len(host[0]), host)
    return out
