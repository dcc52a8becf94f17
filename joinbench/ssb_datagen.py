"""The benchmark's Star Schema Benchmark data: the five tables of SSB
(O'Neil et al., TPCTC 2009, specification revision 3) at a scale factor,
made from a seed in NumPy, in place of the specification's ``dbgen``.

Row counts follow the specification: ``customer`` SF x 30,000,
``supplier`` SF x 2,000, ``part`` 200,000 x floor(1 + log2 SF) (below SF 1,
where that formula gives no rows, 200,000 x SF like the other tables),
``date`` the 2,556 days from 1992-01-01, and ``lineorder`` SF x 1,500,000
orders of 1 to 7 lines each (about SF x 6,000,000 rows) whose lines share
``lo_orderkey``, ``lo_custkey`` and ``lo_orderdate``. Value sets are the
specification's: 5 regions, the 25 nations of TPC-H, 250 cities (a
nation's name cut or padded to 9 characters and a digit, ``'UNITED
KI1'``), 5 manufacturers ``'MFGR#1'``, 25 categories ``'MFGR#12'``, 1,000
brands ``'MFGR#2239'`` (a category and 1-40), the 92 colours, 150 types,
40 containers and 5 market segments. ``lo_orderdate`` is uniform over
1992-01-01 ... 1998-08-02, ``lo_quantity`` over 1-50, ``lo_discount`` over
0-10; prices are INT32 cents: ``lo_extendedprice`` = quantity x the part's
retail price (TPC-H's formula), ``lo_revenue`` = extended price x
(100 - discount) / 100, ``lo_supplycost`` = 6/10 of the retail price.
There are no NULLs. The ``lineorder`` columns that no query reads
(``not_generated`` in the schema file) are not made.

Each (table, column) draws from its own seeded substream, so a table is
the same whichever other tables are made.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import zlib
from typing import Dict, List, Tuple

import numpy as np

from radixjoin_tpu_torch import DataType
from radixjoin_tpu_torch.storage.columnar import HostColumn, HostTable

from .schema import gather_varlen

_HERE = os.path.dirname(os.path.abspath(__file__))
SCHEMA_PATH = os.path.join(_HERE, "configs", "ssb_sf20.schema.json")

with open(SCHEMA_PATH) as _f:
    _SCHEMA = json.load(_f)

#: table -> [(column, type name)] of the columns made (the schema's, less
#: ``not_generated``), in the schema's order
COLUMNS: Dict[str, List[Tuple[str, str]]] = {
    t: [(c, dt) for c, dt in cols
        if c not in _SCHEMA["not_generated"].get(t, [])]
    for t, cols in _SCHEMA["tables"].items()
}
TABLES = list(COLUMNS)

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
#: TPC-H's nations and the region of each
NATIONS = [("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
           ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
           ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
           ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
           ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
           ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
           ("UNITED KINGDOM", 3), ("UNITED STATES", 1)]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
COLORS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral cornflower "
    "cornsilk cream cyan dark deep dim dodger drab firebrick floral forest "
    "frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory "
    "khaki lace lavender lawn lemon light lime linen magenta maroon medium "
    "metallic midnight mint misty moccasin navajo navy olive orange orchid "
    "pale papaya peach peru pink plum powder puff purple red rose rosy royal "
    "saddle salmon sandy seashell sienna sky slate smoke snow spring steel "
    "tan thistle tomato turquoise violet wheat white yellow").split()
TYPES = [f"{a} {b} {c}"
         for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO")
         for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
         for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")]
CONTAINERS = [f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
              for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN",
                        "DRUM")]
#: every city: nation n's are 10 * n ... 10 * n + 9
CITIES = [f"{name[:9]:<9}{d}" for name, _r in NATIONS for d in range(10)]
FIRST_DAY = datetime.date(1992, 1, 1)
DATE_ROWS = 2556
#: lo_orderdate is drawn from the first ORDER_DAYS days (to 1998-08-02)
ORDER_DAYS = (datetime.date(1998, 8, 2) - FIRST_DAY).days + 1
_ALNUM = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz"
                       b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 ,", np.uint8)
_TABLE_IDS = {t: i for i, t in enumerate(COLUMNS)}


def row_counts(scale: float) -> Dict[str, int]:
    """Rows of each dimension and the orders of ``lineorder`` at ``scale``."""
    parts = (200_000 * int(math.floor(1 + math.log2(scale))) if scale >= 1
             else int(round(200_000 * scale)))
    return {"customer": max(1, int(round(30_000 * scale))),
            "supplier": max(1, int(round(2_000 * scale))),
            "part": max(1, parts), "date": DATE_ROWS,
            "orders": max(1, int(round(1_500_000 * scale)))}


# -- columns ------------------------------------------------------------------


def _int(values) -> HostColumn:
    values = np.ascontiguousarray(values, dtype=np.int32)
    return HostColumn(DataType.INT32, values, np.ones(len(values), bool))


def _from_set(strings: List[str], codes: np.ndarray) -> HostColumn:
    """A VARCHAR column whose row i is ``strings[codes[i]]``."""
    words = [s.encode("latin-1") for s in strings]
    lengths = np.array([len(w) for w in words], np.int64)
    starts = np.cumsum(lengths) - lengths
    heap, ends = gather_varlen(np.frombuffer(b"".join(words), np.uint8),
                               starts[codes], lengths[codes])
    return HostColumn.varchar(heap, ends, np.ones(len(codes), bool))


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    """(n, width) uint8 ASCII digits of ``values``, zero-padded."""
    out = np.empty((len(values), width), np.uint8)
    v = values.astype(np.int64)
    for k in range(width - 1, -1, -1):
        out[:, k] = ord("0") + v % 10
        v //= 10
    return out


def _fixed(parts) -> HostColumn:
    """A VARCHAR column of equal-length rows joined from ``parts``: bytes
    constants and (values, width) digit fields."""
    n = next(len(p[0]) for p in parts if not isinstance(p, bytes))
    cols = [np.tile(np.frombuffer(p, np.uint8), (n, 1)) if isinstance(p, bytes)
            else _digits(*p) for p in parts]
    rows = np.concatenate(cols, axis=1)
    width = rows.shape[1]
    return HostColumn.varchar(rows.ravel(),
                              np.arange(1, n + 1, dtype=np.int64) * width,
                              np.ones(n, bool))


def _random_text(rng, n: int, lo: int, hi: int) -> HostColumn:
    """Random letters, digits, spaces and commas, ``lo``-``hi`` long."""
    lengths = rng.integers(lo, hi + 1, n)
    ends = np.cumsum(lengths)
    heap = _ALNUM[rng.integers(0, len(_ALNUM), int(ends[-1]) if n else 0)]
    return HostColumn.varchar(heap, ends, np.ones(n, bool))


class _Streams:
    """One seeded generator a (table, column)."""

    def __init__(self, seed: int, table: str):
        self.seed, self.table = int(seed) % (1 << 64), _TABLE_IDS[table]

    def __call__(self, column: str):
        return np.random.default_rng([self.seed, self.table,
                                      zlib.crc32(column.encode())])


def _place(rng, n: int):
    """(nation, city) codes of ``n`` rows: a uniform nation, a uniform
    digit."""
    nation = rng.integers(0, len(NATIONS), n)
    return nation, nation * 10 + rng.integers(0, 10, n)


def _region_of(nation: np.ndarray) -> np.ndarray:
    return np.array([r for _n, r in NATIONS])[nation]


def _phone(rng, nation: np.ndarray) -> HostColumn:
    n = len(nation)
    return _fixed([(nation + 10, 2), b"-", (rng.integers(100, 1000, n), 3),
                   b"-", (rng.integers(100, 1000, n), 3), b"-",
                   (rng.integers(1000, 10000, n), 4)])


def _customer(s: _Streams, n: int) -> Dict[str, HostColumn]:
    keys = np.arange(1, n + 1)
    nation, city = _place(s("place"), n)
    return {
        "c_custkey": _int(keys),
        "c_name": _fixed([b"Customer#", (keys, 9)]),
        "c_address": _random_text(s("c_address"), n, 10, 25),
        "c_city": _from_set(CITIES, city),
        "c_nation": _from_set([m for m, _r in NATIONS], nation),
        "c_region": _from_set(REGIONS, _region_of(nation)),
        "c_phone": _phone(s("c_phone"), nation),
        "c_mktsegment": _from_set(SEGMENTS, s("c_mktsegment").integers(
            0, len(SEGMENTS), n)),
    }


def _supplier(s: _Streams, n: int) -> Dict[str, HostColumn]:
    keys = np.arange(1, n + 1)
    nation, city = _place(s("place"), n)
    return {
        "s_suppkey": _int(keys),
        "s_name": _fixed([b"Supplier#", (keys, 9)]),
        "s_address": _random_text(s("s_address"), n, 10, 25),
        "s_city": _from_set(CITIES, city),
        "s_nation": _from_set([m for m, _r in NATIONS], nation),
        "s_region": _from_set(REGIONS, _region_of(nation)),
        "s_phone": _phone(s("s_phone"), nation),
    }


def _part(s: _Streams, n: int) -> Dict[str, HostColumn]:
    # manufacturer m, category m*5+c, brand category*40+b, all from 0
    rng = s("brand")
    mfgr = rng.integers(0, 5, n)
    category = mfgr * 5 + rng.integers(0, 5, n)
    brand = category * 40 + rng.integers(0, 40, n)
    categories = [f"MFGR#{m}{c}" for m in range(1, 6) for c in range(1, 6)]
    names = s("p_name").integers(0, len(COLORS), (n, 2))
    return {
        "p_partkey": _int(np.arange(1, n + 1)),
        "p_name": _from_set([f"{a} {b}" for a in COLORS for b in COLORS],
                            names[:, 0] * len(COLORS) + names[:, 1]),
        "p_mfgr": _from_set([f"MFGR#{m}" for m in range(1, 6)], mfgr),
        "p_category": _from_set(categories, category),
        "p_brand1": _from_set([f"{c}{b}" for c in categories
                               for b in range(1, 41)], brand),
        "p_color": _from_set(COLORS, s("p_color").integers(0, len(COLORS), n)),
        "p_type": _from_set(TYPES, s("p_type").integers(0, len(TYPES), n)),
        "p_size": _int(s("p_size").integers(1, 51, n)),
        "p_container": _from_set(CONTAINERS, s("p_container").integers(
            0, len(CONTAINERS), n)),
    }


_SEASONS = {12: "Christmas", 1: "Winter", 2: "Winter", 3: "Spring",
            4: "Spring", 5: "Spring", 6: "Summer", 7: "Summer", 8: "Summer",
            9: "Fall", 10: "Fall", 11: "Fall"}


def _date_rows():
    days = [FIRST_DAY + datetime.timedelta(i) for i in range(DATE_ROWS)]
    return days, np.array([d.year * 10000 + d.month * 100 + d.day
                           for d in days])


def _date() -> Dict[str, HostColumn]:
    days, keys = _date_rows()
    n = len(days)
    ints = {
        "d_datekey": keys,
        "d_year": [d.year for d in days],
        "d_yearmonthnum": [d.year * 100 + d.month for d in days],
        # Sunday is 1
        "d_daynuminweek": [d.isoweekday() % 7 + 1 for d in days],
        "d_daynuminmonth": [d.day for d in days],
        "d_daynuminyear": [d.timetuple().tm_yday for d in days],
        "d_monthnuminyear": [d.month for d in days],
        "d_weeknuminyear": [(d.timetuple().tm_yday - 1) // 7 + 1
                            for d in days],
    }
    last_in_month = [(d + datetime.timedelta(1)).month != d.month for d in days]
    text = {
        "d_date": [f"{d:%B} {d.day}, {d.year}" for d in days],
        "d_dayofweek": [f"{d:%A}" for d in days],
        "d_month": [f"{d:%B}" for d in days],
        "d_yearmonth": [f"{d:%b}{d.year}" for d in days],
        "d_sellingseason": [_SEASONS[d.month] for d in days],
        "d_lastdayinweekfl": ["1" if d.isoweekday() == 6 else "0"
                              for d in days],
        "d_lastdayinmonthfl": ["1" if f else "0" for f in last_in_month],
        "d_holidayfl": ["1" if (d.month, d.day) in ((1, 1), (7, 4), (12, 25))
                        else "0" for d in days],
        "d_weekdayfl": ["1" if d.isoweekday() <= 5 else "0" for d in days],
    }
    out = {c: _int(v) for c, v in ints.items()}
    for c, v in text.items():
        out[c] = _from_set(v, np.arange(n))
    return out


def _lineorder(s: _Streams, counts: Dict[str, int]) -> Dict[str, HostColumn]:
    orders = counts["orders"]
    lines = s("lines").integers(1, 8, orders, dtype=np.int32)
    n = int(lines.sum())
    first = np.cumsum(lines, dtype=np.int64) - lines

    def per_order(values):
        return np.repeat(values.astype(np.int32), lines)

    _days, datekeys = _date_rows()
    partkey = s("lo_partkey").integers(1, counts["part"] + 1, n,
                                       dtype=np.int32)
    quantity = s("lo_quantity").integers(1, 51, n, dtype=np.int32)
    discount = s("lo_discount").integers(0, 11, n, dtype=np.int32)
    retail = (90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000))
    extended = quantity * retail
    cols = {
        "lo_orderkey": per_order(np.arange(1, orders + 1)),
        "lo_linenumber": (np.arange(n, dtype=np.int64)
                          - np.repeat(first, lines) + 1),
        "lo_custkey": per_order(s("lo_custkey").integers(
            1, counts["customer"] + 1, orders)),
        "lo_partkey": partkey,
        "lo_suppkey": s("lo_suppkey").integers(1, counts["supplier"] + 1, n,
                                               dtype=np.int32),
        "lo_orderdate": per_order(datekeys[s("lo_orderdate").integers(
            0, ORDER_DAYS, orders)]),
        "lo_quantity": quantity,
        "lo_extendedprice": extended,
        "lo_discount": discount,
        "lo_revenue": (extended.astype(np.int64) * (100 - discount)
                       // 100),
        "lo_supplycost": 6 * retail // 10,
    }
    return {c: _int(v) for c, v in cols.items()}


def generate(seed: int, scale: float) -> Dict[str, HostTable]:
    """name -> HostTable of the five tables at ``scale``, columns in
    :data:`COLUMNS` order."""
    counts = row_counts(scale)
    makers = {"customer": lambda s: _customer(s, counts["customer"]),
              "supplier": lambda s: _supplier(s, counts["supplier"]),
              "part": lambda s: _part(s, counts["part"]),
              "date": lambda _s: _date(),
              "lineorder": lambda s: _lineorder(s, counts)}
    out = {}
    for t in TABLES:
        cols = makers[t](_Streams(seed, t))
        host = [cols.pop(c) for c, _dt in COLUMNS[t]]
        assert not cols, f"{t}: made columns the schema lacks: {sorted(cols)}"
        out[t] = HostTable(len(host[0]), host)
    return out
