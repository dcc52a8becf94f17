"""Minimal SQL parser for the JOB and SSB query shapes.

The reference harness uses the hsql parser and supports exactly:
``SELECT <MIN(col)|col>, ... FROM t [AS a], ... WHERE <condition>;`` with
conditions built from AND/OR/NOT, comparisons (=, !=, <>, <, >, <=, >=),
LIKE / NOT LIKE, BETWEEN, IN (...), IS [NOT] NULL, and column = column
equi-join predicates (reference tests/read_sql.cpp:329-655, :731-858).
The Star Schema Benchmark's queries add select items ``SUM(<expr>)``,
``<expr>`` columns joined by ``*`` and ``-``, and the clauses
``GROUP BY col, ...`` and ``ORDER BY <col|alias> [ASC|DESC], ...`` after
WHERE. This module parses that subset from scratch into a small expression
AST; :mod:`.frontend` lowers the AST into per-table filters + a join graph.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple, Union


# -- tokens -------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    \s+
  | (?P<string>'(?:[^']|'')*')
  | (?P<number>-?\d+(?:\.\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*(?:\.[A-Za-z_][A-Za-z_0-9]*)?)
  | (?P<op><>|!=|<=|>=|=|<|>)
  | (?P<punct>[(),;*-])
    """,
    re.VERBOSE,
)

_KEYWORDS = {
    "select", "from", "where", "and", "or", "not", "like", "between",
    "in", "is", "null", "as", "min", "sum", "group", "order", "by", "asc",
    "desc",
}


@dataclasses.dataclass
class Token:
    kind: str  # 'string' | 'number' | 'ident' | 'keyword' | 'op' | 'punct'
    value: str
    pos: int


def tokenize(sql: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SyntaxError(f"cannot tokenize SQL at offset {pos}: {sql[pos:pos+30]!r}")
        pos = m.end()
        for kind in ("string", "number", "ident", "op", "punct"):
            text = m.group(kind)
            if text is not None:
                if kind == "ident" and text.lower() in _KEYWORDS:
                    tokens.append(Token("keyword", text.lower(), m.start()))
                else:
                    tokens.append(Token(kind, text, m.start()))
                break
    return tokens


# -- expression AST -----------------------------------------------------------


@dataclasses.dataclass
class ColumnRef:
    table: Optional[str]  # alias or table name; None if unqualified
    column: str


@dataclasses.dataclass
class Compare:
    op: str  # '=', '!=', '<', '>', '<=', '>='
    left: ColumnRef
    right: Union[ColumnRef, int, float, str]


@dataclasses.dataclass
class Like:
    negated: bool
    left: ColumnRef
    pattern: str


@dataclasses.dataclass
class Between:
    left: ColumnRef
    low: Union[int, float, str]
    high: Union[int, float, str]


@dataclasses.dataclass
class InList:
    left: ColumnRef
    values: List[Union[int, float, str]]


@dataclasses.dataclass
class IsNull:
    negated: bool
    left: ColumnRef


@dataclasses.dataclass
class BoolOp:
    op: str  # 'AND' | 'OR'
    left: "Expr"
    right: "Expr"


@dataclasses.dataclass
class NotOp:
    child: "Expr"


Expr = Union[Compare, Like, Between, InList, IsNull, BoolOp, NotOp]


@dataclasses.dataclass
class Arith:
    """``left op right`` between columns of a select item (op ``*`` or
    ``-``)."""

    op: str
    left: Union[ColumnRef, "Arith"]
    right: Union[ColumnRef, "Arith"]


@dataclasses.dataclass
class SelectItem:
    column: Optional[ColumnRef]  # None for an expression item
    aggregate: Optional[str] = None  # 'MIN', 'SUM' or None
    alias: Optional[str] = None
    #: the item's expression where it is not one plain column (``SUM``'s
    #: argument, which may be one column)
    expr: Optional[Union[ColumnRef, Arith]] = dataclasses.field(
        default=None, repr=False)

    def columns(self) -> List[ColumnRef]:
        """The columns the item reads, left to right."""
        if self.expr is None:
            return [self.column]
        out, todo = [], [self.expr]
        while todo:
            node = todo.pop()
            if isinstance(node, Arith):
                todo += [node.right, node.left]
            else:
                out.append(node)
        return out


@dataclasses.dataclass
class OrderItem:
    ref: ColumnRef  # a column, or (unqualified) a select item's alias
    descending: bool = False


@dataclasses.dataclass
class SelectStatement:
    select_list: List[SelectItem]
    tables: List[Tuple[str, Optional[str]]]  # (table_name, alias)
    where: Optional[Expr]
    group_by: List[ColumnRef] = dataclasses.field(default_factory=list,
                                                  repr=False)
    order_by: List[OrderItem] = dataclasses.field(default_factory=list,
                                                  repr=False)


# -- recursive-descent parser ---------------------------------------------------


class _Parser:
    def __init__(self, tokens: List[Token]):
        self.tokens = tokens
        self.i = 0

    def peek(self) -> Optional[Token]:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self) -> Token:
        tok = self.peek()
        if tok is None:
            raise SyntaxError("unexpected end of SQL")
        self.i += 1
        return tok

    def accept(self, kind: str, value: Optional[str] = None) -> Optional[Token]:
        tok = self.peek()
        if tok and tok.kind == kind and (value is None or tok.value == value):
            self.i += 1
            return tok
        return None

    def expect(self, kind: str, value: Optional[str] = None) -> Token:
        tok = self.accept(kind, value)
        if tok is None:
            got = self.peek()
            raise SyntaxError(f"expected {kind} {value or ''}, got {got}")
        return tok

    # statement -----------------------------------------------------------

    def parse_select(self) -> SelectStatement:
        self.expect("keyword", "select")
        items = [self.parse_select_item()]
        while self.accept("punct", ","):
            items.append(self.parse_select_item())
        self.expect("keyword", "from")
        tables = [self.parse_table()]
        while self.accept("punct", ","):
            tables.append(self.parse_table())
        where = None
        if self.accept("keyword", "where"):
            where = self.parse_or()
        group_by: List[ColumnRef] = []
        if self.accept("keyword", "group"):
            self.expect("keyword", "by")
            group_by.append(self.parse_column_ref())
            while self.accept("punct", ","):
                group_by.append(self.parse_column_ref())
        order_by: List[OrderItem] = []
        if self.accept("keyword", "order"):
            self.expect("keyword", "by")
            order_by.append(self.parse_order_item())
            while self.accept("punct", ","):
                order_by.append(self.parse_order_item())
        self.accept("punct", ";")
        if self.peek() is not None:
            raise SyntaxError(f"trailing tokens: {self.peek()}")
        return SelectStatement(items, tables, where, group_by, order_by)

    def parse_alias(self) -> Optional[str]:
        if self.accept("keyword", "as"):
            return self.next().value
        return None

    def parse_select_item(self) -> SelectItem:
        if self.accept("keyword", "min"):
            self.expect("punct", "(")
            col = self.parse_column_ref()
            self.expect("punct", ")")
            return SelectItem(col, aggregate="MIN", alias=self.parse_alias())
        if self.accept("keyword", "sum"):
            self.expect("punct", "(")
            expr = self.parse_arith()
            self.expect("punct", ")")
            return SelectItem(None, aggregate="SUM", alias=self.parse_alias(),
                              expr=expr)
        expr = self.parse_arith()
        if isinstance(expr, Arith):
            return SelectItem(None, alias=self.parse_alias(), expr=expr)
        return SelectItem(expr, alias=self.parse_alias())

    def parse_arith(self) -> Union[ColumnRef, Arith]:
        """Columns joined by ``-`` and ``*`` (``*`` binds tighter), left
        to right."""
        left = self.parse_product()
        while self.accept("punct", "-"):
            left = Arith("-", left, self.parse_product())
        return left

    def parse_product(self) -> Union[ColumnRef, Arith]:
        left = self.parse_column_ref()
        while self.accept("punct", "*"):
            left = Arith("*", left, self.parse_column_ref())
        return left

    def parse_order_item(self) -> OrderItem:
        ref = self.parse_column_ref()
        if self.accept("keyword", "desc"):
            return OrderItem(ref, True)
        self.accept("keyword", "asc")
        return OrderItem(ref)

    def parse_table(self) -> Tuple[str, Optional[str]]:
        name = self.expect("ident").value
        alias = None
        if self.accept("keyword", "as"):
            alias = self.expect("ident").value
        elif self.peek() and self.peek().kind == "ident":
            alias = self.next().value
        return name, alias

    def parse_column_ref(self) -> ColumnRef:
        tok = self.expect("ident")
        if "." in tok.value:
            table, column = tok.value.split(".", 1)
            return ColumnRef(table, column)
        return ColumnRef(None, tok.value)

    # expressions (precedence: OR < AND < NOT < primary) --------------------

    def parse_or(self) -> Expr:
        left = self.parse_and()
        while self.accept("keyword", "or"):
            left = BoolOp("OR", left, self.parse_and())
        return left

    def parse_and(self) -> Expr:
        left = self.parse_not()
        while self.accept("keyword", "and"):
            left = BoolOp("AND", left, self.parse_not())
        return left

    def parse_not(self) -> Expr:
        if self.accept("keyword", "not"):
            return NotOp(self.parse_not())
        return self.parse_primary()

    def parse_literal(self) -> Union[int, float, str]:
        tok = self.next()
        if tok.kind == "number":
            return float(tok.value) if "." in tok.value else int(tok.value)
        if tok.kind == "string":
            return tok.value[1:-1].replace("''", "'")
        raise SyntaxError(f"expected literal, got {tok}")

    def parse_primary(self) -> Expr:
        if self.accept("punct", "("):
            inner = self.parse_or()
            self.expect("punct", ")")
            return inner
        left = self.parse_column_ref()
        if self.accept("keyword", "is"):
            negated = bool(self.accept("keyword", "not"))
            self.expect("keyword", "null")
            return IsNull(negated, left)
        if self.accept("keyword", "not"):
            self.expect("keyword", "like")
            pattern = self.parse_literal()
            if not isinstance(pattern, str):
                raise SyntaxError("LIKE pattern must be a string")
            return Like(True, left, pattern)
        if self.accept("keyword", "like"):
            pattern = self.parse_literal()
            if not isinstance(pattern, str):
                raise SyntaxError("LIKE pattern must be a string")
            return Like(False, left, pattern)
        if self.accept("keyword", "between"):
            low = self.parse_literal()
            self.expect("keyword", "and")
            high = self.parse_literal()
            return Between(left, low, high)
        if self.accept("keyword", "in"):
            self.expect("punct", "(")
            values = [self.parse_literal()]
            while self.accept("punct", ","):
                values.append(self.parse_literal())
            self.expect("punct", ")")
            return InList(left, values)
        op_tok = self.expect("op")
        op = "!=" if op_tok.value == "<>" else op_tok.value
        nxt = self.peek()
        if nxt and nxt.kind == "ident":
            return Compare(op, left, self.parse_column_ref())
        return Compare(op, left, self.parse_literal())


def parse_sql(sql: str) -> SelectStatement:
    return _Parser(tokenize(sql)).parse_select()
