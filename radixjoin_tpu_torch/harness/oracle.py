"""Correctness oracles.

Two independent ground-truth paths, replacing the reference's DuckDB check
(tests/read_sql.cpp:1159-1249):

1. :func:`execute_plan_rows` — a deliberately naive row-at-a-time
   interpreter over the same ``Plan`` (dict-based hash join, scalar filter
   eval). It shares *no* code with the vectorized device engine, so it
   validates the engine's kernels and data movement.
2. :func:`SqliteOracle` — loads the synthetic tables into sqlite and runs
   the rewritten raw-column SQL (``ParsedSQL.executed_sql``), validating the
   whole stack (SQL frontend + plan conversion + engine) from the query
   text. LIKE is overridden with the engine's exact byte-level matcher.

Comparison is multiset equality over rows, like the reference's sorted
row-by-row compare.
"""

from __future__ import annotations

import sqlite3
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..dtypes import NULL, DataType, is_null
from ..plan.ir import JoinNode, Plan, ScanNode
from ..sql import catalog
from ..sql.predicate import like_match
from ..storage.columnar import HostTable

# ---------------------------------------------------------------------------
# Plan-level row oracle
# ---------------------------------------------------------------------------


def execute_plan_rows(plan: Plan) -> List[tuple]:
    """Row-at-a-time reference execution of a Plan (oracle only; slow)."""
    plan.validate()
    results: Dict[int, List[tuple]] = {}
    for idx in plan.topo_order():
        node = plan.nodes[idx]
        if isinstance(node.data, ScanNode):
            host = plan.inputs[node.data.base_table_id].to_host()
            rows = host.to_rows()
            cols = [c for c, _ in node.output_attrs]
            results[idx] = [tuple(r[c] for c in cols) for r in rows]
        else:
            results[idx] = _join_rows(plan, node.data, node.output_attrs, results)
    return results[plan.root]


def _join_rows(plan: Plan, join: JoinNode, output_attrs, results) -> List[tuple]:
    left = results[join.left]
    right = results[join.right]
    if not left or not right:
        return []
    left_w = len(plan.nodes[join.left].output_attrs)
    left_key_t = plan.nodes[join.left].output_attrs[join.left_attr][1]
    right_key_t = plan.nodes[join.right].output_attrs[join.right_attr][1]
    if left_key_t is not right_key_t:
        # variant-extraction semantics: mismatched key types never match
        return []
    if join.build_left:
        build, probe = left, right
        build_attr, probe_attr = join.left_attr, join.right_attr
    else:
        build, probe = right, left
        build_attr, probe_attr = join.right_attr, join.left_attr
    index: Dict[object, List[int]] = {}
    for i, row in enumerate(build):
        k = row[build_attr]
        if is_null(k):
            continue
        if isinstance(k, float) and k != k:  # NaN never matches
            continue
        index.setdefault(k, []).append(i)
    out: List[tuple] = []
    cols = [c for c, _ in output_attrs]
    for j, prow in enumerate(probe):
        k = prow[probe_attr]
        if is_null(k):
            continue
        matches = index.get(k)
        if not matches:
            continue
        for bi in matches:
            lrow = build[bi] if join.build_left else prow
            rrow = prow if join.build_left else build[bi]
            out.append(
                tuple(
                    lrow[c] if c < left_w else rrow[c - left_w] for c in cols
                )
            )
    return out


# ---------------------------------------------------------------------------
# SQLite oracle
# ---------------------------------------------------------------------------


class SqliteOracle:
    """In-memory sqlite mirror of a set of host tables."""

    def __init__(self, tables: Dict[str, HostTable]):
        self.conn = sqlite3.connect(":memory:")
        self.conn.create_function("like", 2, self._like, deterministic=True)
        for name, table in tables.items():
            self._load(name, table)
        # index id/fk columns so 20-table joins stay tractable
        cur = self.conn.cursor()
        for name in tables:
            for column, dtype in catalog.ATTRIBUTES[name]:
                if column == "id" or column.endswith("_id"):
                    cur.execute(
                        f"CREATE INDEX idx_{name}_{column} ON {name}({column})"
                    )
        self.conn.commit()

    @staticmethod
    def _like(pattern, value):
        # sqlite calls like(P, X) for "X LIKE P"; exact byte semantics.
        # NULL operands must yield SQL NULL (not False!) so that
        # "x NOT LIKE p" excludes NULL rows: NOT NULL -> NULL -> filtered.
        if pattern is None or value is None:
            return None
        p = pattern.encode("latin-1") if isinstance(pattern, str) else pattern
        v = value.encode("latin-1") if isinstance(value, str) else value
        return like_match(v, p)

    def _load(self, name: str, table: HostTable) -> None:
        attrs = catalog.ATTRIBUTES[name]
        decls = []
        for (column, dtype), col in zip(attrs, table.columns):
            sql_type = "TEXT" if dtype is DataType.VARCHAR else (
                "REAL" if dtype is DataType.FP64 else "INTEGER"
            )
            decls.append(f"{column} {sql_type}")
        cur = self.conn.cursor()
        cur.execute(f"CREATE TABLE {name} ({', '.join(decls)})")
        # one Python list per column (NULL as None), zipped into rows: the
        # same values as a row-by-row walk, built column-wise
        lists = []
        for c in table.columns:
            if c.dtype is DataType.VARCHAR:
                vals = [bytes(v).decode("latin-1") for v in c.objects()]
            else:
                vals = c.values.tolist()  # Python ints / floats
            arr = np.empty(table.num_rows, dtype=object)
            arr[:] = vals
            arr[~c.valid] = None
            lists.append(arr.tolist())
        rows = zip(*lists)
        placeholders = ", ".join(["?"] * len(table.columns))
        cur.executemany(f"INSERT INTO {name} VALUES ({placeholders})", rows)
        self.conn.commit()

    def query(self, sql: str) -> List[tuple]:
        cur = self.conn.cursor()
        cur.execute(sql)
        out = []
        for row in cur.fetchall():
            out.append(
                tuple(
                    NULL
                    if v is None
                    else (v.encode("latin-1") if isinstance(v, str) else v)
                    for v in row
                )
            )
        return out


# ---------------------------------------------------------------------------
# Multiset comparison
# ---------------------------------------------------------------------------


def _canonical(row: tuple) -> tuple:
    out = []
    for v in row:
        if is_null(v):
            out.append(("\0null",))
        elif isinstance(v, float):
            out.append(("f", v))
        elif isinstance(v, bytes):
            out.append(("s", v))
        else:
            out.append(("i", int(v)))
    return tuple(out)


def rows_equal(
    actual: List[tuple], expected: List[tuple]
) -> Tuple[bool, Optional[str]]:
    """Exact multiset comparison (order-insensitive, NULL-safe)."""
    if len(actual) != len(expected):
        return False, f"row count {len(actual)} != expected {len(expected)}"
    ca = Counter(map(_canonical, actual))
    ce = Counter(map(_canonical, expected))
    if ca != ce:
        missing = ce - ca
        extra = ca - ce
        msg = []
        for r, k in list(missing.items())[:3]:
            msg.append(f"missing x{k}: {r}")
        for r, k in list(extra.items())[:3]:
            msg.append(f"extra x{k}: {r}")
        return False, "; ".join(msg)
    return True, None
