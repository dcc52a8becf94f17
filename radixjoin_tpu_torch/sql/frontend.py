"""SQL frontend: lower a parsed JOB or SSB query into filters + join graph.

Reimplements the semantics of the reference's ``ParsedSQL``
(tests/read_sql.cpp:680-859) on our own AST:

* FROM list assigns each table occurrence a ``TableEntity(table, id)`` and a
  global column numbering over the concatenated schemas (``column_map``);
* the WHERE tree is walked with a nesting level: conjuncts of the top-level
  AND split into per-entity filters; ``col = col`` equi-join conditions are
  only legal at the top level and feed a DSU (union-find) over global column
  ids (read_sql.cpp:379-406, :501);
* BETWEEN lowers to GEQ∧LEQ, IN to an OR-chain of EQ (read_sql.cpp:551-629);
* every pair of columns in a DSU equivalence class becomes an edge of the
  join graph, at most one edge per entity pair (read_sql.cpp:818-857);
* ``executed_sql`` rewrites the select list to the raw joined columns
  (stripping MIN aggregates) for oracle execution (read_sql.cpp:694-729).

The root's output (``output_attrs``) is, in the order the SQL text reads
them, one column a plain or ``MIN`` select item, as in the reference, and
each column that an expression item (``SUM(a * b)``), GROUP BY or ORDER BY
reads and no earlier item did: the caller aggregates and orders the joined
rows. Tables and columns resolve against ``catalog`` (IMDB's by default).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .catalog import IMDB, Catalog
from .parser import (
    Between,
    BoolOp,
    ColumnRef,
    Compare,
    InList,
    IsNull,
    Like,
    NotOp,
    SelectStatement,
    parse_sql,
)
from .predicate import Comparison, LogicalOperation, Op, Statement, and_filters


@dataclasses.dataclass(frozen=True, order=True)
class TableEntity:
    """One occurrence of a base table in the FROM list (table, occurrence)."""

    table: str
    id: int

    def __str__(self) -> str:
        return f"{self.table}#{self.id}"


class DSU:
    """Union-find over global column ids (reference include/common.h:109-120)."""

    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def unite(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


class ParsedSQL:
    def __init__(self, sql: str, name: str = "<query>",
                 catalog: Optional[Catalog] = None):
        self.name = name
        self.sql = sql
        self.catalog = IMDB if catalog is None else catalog
        stmt = parse_sql(sql)
        self.table_counts: Dict[str, int] = {}
        self.alias_map: Dict[str, TableEntity] = {}
        self.entity_to_alias: Dict[TableEntity, str] = {}
        self.column_map: Dict[TableEntity, Dict[str, int]] = {}
        self.column_vec: List[Tuple[TableEntity, str]] = []
        self.output_attrs: List[Tuple[TableEntity, str]] = []
        self.filters: Dict[TableEntity, Statement] = {}
        # entity -> {other entity -> (my_column, other_column)}
        self.join_graph: Dict[TableEntity, Dict[TableEntity, Tuple[str, str]]] = {}
        self._build(stmt)

    # -- name resolution -------------------------------------------------

    def resolve(self, ref: ColumnRef) -> Tuple[str, TableEntity]:
        if ref.table is not None:
            ent = self.alias_map.get(ref.table)
            if ent is None:
                count = self.table_counts.get(ref.table)
                if count is None:
                    raise ValueError(f"unknown table name: {ref.table}")
                if count != 1:
                    raise ValueError(f"ambiguous table: {ref.table}")
                ent = TableEntity(ref.table, 0)
            return ref.column, ent
        tables = self.catalog.column_to_tables.get(ref.column)
        if not tables:
            raise ValueError(f"no such column: {ref.column}")
        if len(tables) > 1:
            raise ValueError(f"ambiguous column: {ref.column}")
        table = tables[0]
        if self.table_counts.get(table, 0) != 1:
            raise ValueError(f"ambiguous table: {table}")
        return ref.column, TableEntity(table, 0)

    def _global_col(self, ent: TableEntity, column: str) -> int:
        cols = self.column_map.get(ent)
        if cols is None:
            raise ValueError(f"no table: {ent}")
        idx = cols.get(column)
        if idx is None:
            raise ValueError(f"no column {column} in table {ent}")
        return idx

    # -- construction -----------------------------------------------------

    def _build(self, stmt: SelectStatement) -> None:
        column_count = 0
        for table, alias in stmt.tables:
            if table not in self.catalog:
                raise ValueError(f"no table {table} in schema")
            occurrence = self.table_counts.get(table, 0)
            self.table_counts[table] = occurrence + 1
            ent = TableEntity(table, occurrence)
            colmap: Dict[str, int] = {}
            for name in self.catalog.column_names(table):
                colmap[name] = column_count
                self.column_vec.append((ent, name))
                column_count += 1
            self.column_map[ent] = colmap
            if alias:
                self.alias_map[alias] = ent
                self.entity_to_alias[ent] = alias

        for item in stmt.select_list:
            if item.expr is None:
                column, ent = self.resolve(item.column)
                self.output_attrs.append((ent, column))
            else:
                self._add_outputs(item.columns())
        self._add_outputs(stmt.group_by)
        # an ORDER BY name that is a select item's alias reads its columns
        aliases = {item.alias: item for item in stmt.select_list
                   if item.alias is not None}
        for order in stmt.order_by:
            ref = order.ref
            if ref.table is None and ref.column in aliases:
                self._add_outputs(aliases[ref.column].columns())
            else:
                self._add_outputs([ref])

        dsu = DSU(column_count)
        if stmt.where is not None:
            top_stmt, top_ent = self._walk(stmt.where, dsu, level=0)
            if top_stmt is not None:
                self._insert_filter(top_ent, top_stmt)

        # all-pairs join edges per DSU equivalence class
        classes: Dict[int, List[int]] = {}
        for i in range(column_count):
            classes.setdefault(dsu.find(i), []).append(i)
        for members in classes.values():
            for a in range(len(members) - 1):
                for b in range(a + 1, len(members)):
                    le, lc = self.column_vec[members[a]]
                    re_, rc = self.column_vec[members[b]]
                    if re_ in self.join_graph.get(le, {}):
                        raise ValueError(
                            "at least two join conditions between the same pair of tables"
                        )
                    self.join_graph.setdefault(le, {})[re_] = (lc, rc)
                    self.join_graph.setdefault(re_, {})[le] = (rc, lc)

    def _add_outputs(self, refs) -> None:
        """Append each column of ``refs`` not in ``output_attrs`` yet."""
        for ref in refs:
            column, ent = self.resolve(ref)
            if (ent, column) not in self.output_attrs:
                self._global_col(ent, column)  # raises for an unknown column
                self.output_attrs.append((ent, column))

    def _insert_filter(self, ent: TableEntity, stmt: Statement) -> None:
        existing = self.filters.get(ent)
        self.filters[ent] = and_filters(existing, stmt)

    def _comparison(self, ent: TableEntity, column: str, op: Op, value) -> Comparison:
        return Comparison(self.catalog.column_index(ent.table, column), op,
                          value)

    def _walk(self, expr, dsu: DSU, level: int):
        """Returns (statement | None, entity) — a None statement means the
        node contributed only join edges (or pushed filters at level 0)."""
        if isinstance(expr, BoolOp):
            add = 1 if expr.op == "OR" else 0
            left_stmt, left_ent = self._walk(expr.left, dsu, level + add)
            right_stmt, right_ent = self._walk(expr.right, dsu, level + add)
            if level == 0 and expr.op == "AND":
                if left_stmt is not None:
                    self._insert_filter(left_ent, left_stmt)
                if right_stmt is not None:
                    self._insert_filter(right_ent, right_stmt)
                return None, None
            if left_stmt is None or right_stmt is None:
                raise ValueError(
                    "non-top-level expression contains a join condition"
                )
            if left_ent != right_ent:
                raise ValueError("filter cannot be pushed down to one table")
            maker = (
                LogicalOperation.make_and
                if expr.op == "AND"
                else LogicalOperation.make_or
            )
            return maker(left_stmt, right_stmt), left_ent
        if isinstance(expr, NotOp):
            child_stmt, child_ent = self._walk(expr.child, dsu, level + 1)
            if child_stmt is None:
                raise ValueError("NOT over a join condition is not supported")
            return LogicalOperation.make_not(child_stmt), child_ent
        if isinstance(expr, Compare):
            column, ent = self.resolve(expr.left)
            if isinstance(expr.right, ColumnRef):
                if expr.op != "=":
                    raise ValueError("non-equi joins are not supported")
                rcolumn, rent = self.resolve(expr.right)
                dsu.unite(self._global_col(ent, column), self._global_col(rent, rcolumn))
                return None, None
            op = {
                "=": Op.EQ, "!=": Op.NEQ, "<": Op.LT, ">": Op.GT,
                "<=": Op.LEQ, ">=": Op.GEQ,
            }[expr.op]
            return self._comparison(ent, column, op, expr.right), ent
        if isinstance(expr, Like):
            column, ent = self.resolve(expr.left)
            op = Op.NOT_LIKE if expr.negated else Op.LIKE
            return self._comparison(ent, column, op, expr.pattern), ent
        if isinstance(expr, Between):
            column, ent = self.resolve(expr.left)
            low = self._comparison(ent, column, Op.GEQ, expr.low)
            high = self._comparison(ent, column, Op.LEQ, expr.high)
            return LogicalOperation.make_and(low, high), ent
        if isinstance(expr, InList):
            column, ent = self.resolve(expr.left)
            stmt: Optional[Statement] = None
            for value in expr.values:
                eq = self._comparison(ent, column, Op.EQ, value)
                stmt = eq if stmt is None else LogicalOperation.make_or(stmt, eq)
            return stmt, ent
        if isinstance(expr, IsNull):
            column, ent = self.resolve(expr.left)
            op = Op.IS_NOT_NULL if expr.negated else Op.IS_NULL
            return self._comparison(ent, column, op, None), ent
        raise TypeError(f"unhandled expression node: {expr!r}")

    # -- oracle SQL rewrite -------------------------------------------------

    def executed_sql(self) -> str:
        """The raw-column query an oracle runs for row-level comparison."""
        names = []
        for ent, column in self.output_attrs:
            alias = self.entity_to_alias.get(ent, ent.table)
            names.append(f"{alias}.{column}")
        select_list = ", ".join(names)
        pos = self.sql.find("FROM")
        if pos < 0:
            pos = self.sql.find("from")
        if pos < 0:
            raise ValueError('cannot find "FROM" in SQL')
        rest = self.sql[pos:].rstrip().rstrip(";")
        return f"SELECT {select_list} {rest}"
