"""SQL frontend: lower a parsed JOB, SSB or TPC-H query into filters + join
graph.

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
  (stripping MIN aggregates) for oracle execution (read_sql.cpp:694-729);
* a comparison of two columns of one table occurrence is that table's
  filter (:class:`~.predicate.ColumnOperand`);
* a FROM list that is one subquery with no aggregation is read as the
  subquery: the outer select list, GROUP BY and ORDER BY name the
  subquery's items, which stand in for those names.

The root's output (``output_attrs``) is, in the order the SQL text reads
them, one column a plain or ``MIN`` select item, as in the reference, and
each column that an expression item (``SUM(a * b)``), GROUP BY or ORDER BY
reads and no earlier item did (a CASE's conditions before its values): the
caller aggregates, orders and limits the joined rows. Tables and columns
resolve against ``catalog`` (IMDB's by default).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .catalog import IMDB, Catalog
from .parser import (
    Aggregate,
    Arith,
    Between,
    BoolOp,
    Case,
    ColumnRef,
    Compare,
    DerivedTable,
    Extract,
    InList,
    IsNull,
    Like,
    NotOp,
    OrderItem,
    SelectItem,
    SelectStatement,
    columns_of,
    parse_sql,
)
from .predicate import (Comparison, ColumnOperand, LogicalOperation, Op,
                        Statement, and_filters)

_OPS = {"=": Op.EQ, "!=": Op.NEQ, "<": Op.LT, ">": Op.GT, "<=": Op.LEQ,
        ">=": Op.GEQ}


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


def _alias_ref(ref, aliases) -> bool:
    """Whether ``ref`` is an unqualified name of one of ``aliases``."""
    return (isinstance(ref, ColumnRef) and ref.table is None
            and ref.column in aliases)


def _substitute(node, fn):
    """``node`` with every column reference ``ref`` replaced by
    ``fn(ref)``."""
    if isinstance(node, ColumnRef):
        return fn(node)
    if isinstance(node, (Arith, BoolOp)):
        return dataclasses.replace(node, left=_substitute(node.left, fn),
                                   right=_substitute(node.right, fn))
    if isinstance(node, Aggregate):
        return dataclasses.replace(node, arg=_substitute(node.arg, fn))
    if isinstance(node, Case):
        return Case([(_substitute(c, fn), _substitute(v, fn))
                     for c, v in node.whens], _substitute(node.default, fn))
    if isinstance(node, NotOp):
        return NotOp(_substitute(node.child, fn))
    if isinstance(node, (Extract, Compare, Like, Between, InList, IsNull)):
        field = "column" if isinstance(node, Extract) else "left"
        column = _substitute(getattr(node, field), fn)
        if not isinstance(column, ColumnRef):
            raise ValueError(f"a subquery's expression where a column "
                             f"must stand: {column!r}")
        node = dataclasses.replace(node, **{field: column})
        if isinstance(node, Compare):
            node = dataclasses.replace(node,
                                       right=_substitute(node.right, fn))
        return node
    return node  # a constant


def flatten(stmt: SelectStatement) -> SelectStatement:
    """A statement whose FROM list is one subquery with no aggregation, as
    the subquery itself: its tables and WHERE, and the outer select list,
    GROUP BY and ORDER BY with each name of a subquery item (bare or
    qualified by the subquery's alias) replaced by that item's expression.
    Any other statement is returned as it is."""
    derived = [t for t in stmt.tables if isinstance(t, DerivedTable)]
    if not derived:
        return stmt
    if len(stmt.tables) != 1 or stmt.where is not None:
        raise ValueError("a FROM-clause subquery must be the only table, "
                         "with no outer WHERE")
    (sub,) = derived
    inner = flatten(sub.stmt)
    if inner.group_by or any(i.aggregate for i in inner.select_list):
        raise ValueError("a FROM-clause subquery with aggregation is not "
                         "supported")
    names = {}
    for item in inner.select_list:
        name = item.alias or (item.column.column if item.expr is None
                              else None)
        if name is not None:
            names[name] = item.column if item.expr is None else item.expr

    def fn(ref: ColumnRef):
        if ref.table in (None, sub.alias) and ref.column in names:
            return names[ref.column]
        if ref.table == sub.alias:
            raise ValueError(f"no column {ref.column} in {sub.alias}")
        return ref

    items = []
    for item in stmt.select_list:
        value = _substitute(item.expr if item.expr is not None
                            else item.column, fn)
        if isinstance(value, ColumnRef) and item.expr is None:
            items.append(SelectItem(value, item.aggregate, item.alias))
        else:
            items.append(SelectItem(None, item.aggregate, item.alias,
                                    expr=value))
    aliases = {i.alias for i in stmt.select_list if i.alias is not None}
    order_by = [o if _alias_ref(o.ref, aliases)
                else OrderItem(_substitute(o.ref, fn), o.descending)
                for o in stmt.order_by]
    return SelectStatement(items, inner.tables, inner.where,
                           [_substitute(g, fn) for g in stmt.group_by],
                           order_by, stmt.limit)


class ParsedSQL:
    def __init__(self, sql: str, name: str = "<query>",
                 catalog: Optional[Catalog] = None):
        self.name = name
        self.sql = sql
        self.catalog = IMDB if catalog is None else catalog
        stmt = flatten(parse_sql(sql))
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
        for group in stmt.group_by:
            self._add_outputs(columns_of(group))
        # an ORDER BY name that is a select item's alias reads its columns
        aliases = {item.alias: item for item in stmt.select_list
                   if item.alias is not None}
        for order in stmt.order_by:
            ref = order.ref
            if _alias_ref(ref, aliases):
                self._add_outputs(aliases[ref.column].columns())
            else:
                self._add_outputs(columns_of(ref))

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
                rcolumn, rent = self.resolve(expr.right)
                if rent == ent:
                    # two columns of one row: the table's filter
                    other = ColumnOperand(
                        self.catalog.column_index(ent.table, rcolumn))
                    return self._comparison(ent, column, _OPS[expr.op],
                                            other), ent
                if expr.op != "=":
                    raise ValueError("non-equi joins are not supported")
                dsu.unite(self._global_col(ent, column), self._global_col(rent, rcolumn))
                return None, None
            return self._comparison(ent, column, _OPS[expr.op],
                                    expr.right), ent
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
