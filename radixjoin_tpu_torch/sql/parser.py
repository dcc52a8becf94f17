"""Minimal SQL parser for the JOB, SSB and TPC-H join query shapes.

The reference harness uses the hsql parser and supports exactly:
``SELECT <MIN(col)|col>, ... FROM t [AS a], ... WHERE <condition>;`` with
conditions built from AND/OR/NOT, comparisons (=, !=, <>, <, >, <=, >=),
LIKE / NOT LIKE, BETWEEN, IN (...), IS [NOT] NULL, and column = column
equi-join predicates (reference tests/read_sql.cpp:329-655, :731-858).
The Star Schema Benchmark's queries add select items ``SUM(<expr>)``,
``<expr>`` columns joined by ``*`` and ``-``, and the clauses
``GROUP BY col, ...`` and ``ORDER BY <col|alias> [ASC|DESC], ...`` after
WHERE. TPC-H's join queries add, in select items, numeric constants, ``+``
and ``/``, parentheses, aggregates inside arithmetic, ``CASE WHEN <cond>
THEN <expr> ... [ELSE <expr>] END`` and ``EXTRACT(YEAR FROM col)``; in
conditions, ``date 'YYYY-MM-DD'`` literals with ``+`` / ``- interval 'n'
day|month|year`` folded on the calendar (a date reads as its days since
1970-01-01, the INT32 a DATE column holds), and a comparison of two
columns; a FROM-clause subquery ``(SELECT ...) [AS] alias``; and ``LIMIT
n`` at the end. This module parses that subset from scratch into a small
expression AST; :mod:`.frontend` lowers the AST into per-table filters + a
join graph.
"""

from __future__ import annotations

import calendar
import dataclasses
import datetime
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
  | (?P<punct>[(),;*/+-])
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
    """``left op right`` of a select item's expression (op ``+``, ``-``,
    ``*`` or ``/``); an operand is a column, a number or another
    expression node."""

    op: str
    left: "Value"
    right: "Value"


@dataclasses.dataclass
class Aggregate:
    """``func(arg)`` inside an expression (``SUM`` or ``MIN``)."""

    func: str
    arg: "Value"


@dataclasses.dataclass
class Case:
    """``CASE WHEN cond THEN value ... ELSE default END``."""

    whens: List[Tuple[Expr, "Value"]]
    default: "Value" = None


@dataclasses.dataclass
class Extract:
    """``EXTRACT(field FROM column)``."""

    field: str
    column: ColumnRef


Value = Union[ColumnRef, Arith, Aggregate, Case, Extract, int, float, None]


def columns_of(node) -> List[ColumnRef]:
    """The columns an expression or condition reads, left to right (a
    CASE's conditions before the values they choose)."""
    if isinstance(node, ColumnRef):
        return [node]
    if isinstance(node, (Arith, BoolOp)):
        return columns_of(node.left) + columns_of(node.right)
    if isinstance(node, Aggregate):
        return columns_of(node.arg)
    if isinstance(node, Extract):
        return [node.column]
    if isinstance(node, Case):
        out = []
        for cond, value in node.whens:
            out += columns_of(cond) + columns_of(value)
        return out + columns_of(node.default)
    if isinstance(node, NotOp):
        return columns_of(node.child)
    if isinstance(node, Compare):
        return [node.left] + columns_of(node.right)
    if isinstance(node, (Like, Between, InList, IsNull)):
        return [node.left]
    return []  # a constant


@dataclasses.dataclass
class SelectItem:
    column: Optional[ColumnRef]  # None for an expression item
    aggregate: Optional[str] = None  # 'MIN', 'SUM' or None
    alias: Optional[str] = None
    #: the item's expression where it is not one plain column (``SUM``'s
    #: argument, which may be one column)
    expr: Optional[Value] = dataclasses.field(default=None, repr=False)

    def columns(self) -> List[ColumnRef]:
        """The columns the item reads, left to right."""
        if self.expr is None:
            return [self.column]
        return columns_of(self.expr)


@dataclasses.dataclass
class OrderItem:
    #: a column, (unqualified) a select item's alias, or an expression
    ref: Union[ColumnRef, Value]
    descending: bool = False


@dataclasses.dataclass
class DerivedTable:
    """A FROM-clause subquery ``(SELECT ...) [AS] alias``."""

    stmt: "SelectStatement"
    alias: str


@dataclasses.dataclass
class SelectStatement:
    select_list: List[SelectItem]
    #: (table_name, alias) of each base table, or a DerivedTable
    tables: List[Union[Tuple[str, Optional[str]], DerivedTable]]
    where: Optional[Expr]
    group_by: List[Value] = dataclasses.field(default_factory=list,
                                              repr=False)
    order_by: List[OrderItem] = dataclasses.field(default_factory=list,
                                                  repr=False)
    limit: Optional[int] = dataclasses.field(default=None, repr=False)


_EPOCH = datetime.date(1970, 1, 1)


def date_days(text: str) -> int:
    """Days since 1970-01-01 of a ``YYYY-MM-DD`` date."""
    return (datetime.date.fromisoformat(text) - _EPOCH).days


def add_interval(days: int, count: int, unit: str) -> int:
    """``days`` (since 1970-01-01) plus ``count`` days, months or years on
    the calendar; a day past the end of its month becomes the month's last
    day, as PostgreSQL reads ``date + interval``."""
    unit = unit.lower().rstrip("s")
    day = _EPOCH + datetime.timedelta(days)
    if unit == "day":
        return days + count
    if unit not in ("month", "year"):
        raise SyntaxError(f"interval unit {unit!r}: day, month or year")
    months = day.year * 12 + day.month - 1 + (count if unit == "month"
                                              else 12 * count)
    year, month = divmod(months, 12)
    last = calendar.monthrange(year, month + 1)[1]
    return date_days(f"{year:04d}-{month + 1:02d}-{min(day.day, last):02d}")


# -- recursive-descent parser ---------------------------------------------------


class _Parser:
    def __init__(self, tokens: List[Token]):
        self.tokens = tokens
        self.i = 0

    def peek(self, ahead: int = 0) -> Optional[Token]:
        i = self.i + ahead
        return self.tokens[i] if i < len(self.tokens) else None

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

    def at_word(self, word: str, ahead: int = 0) -> bool:
        """Whether the token ``ahead`` is the identifier ``word`` (any
        case). The words of CASE, EXTRACT, DATE, INTERVAL and LIMIT are no
        keywords, so a table or column may still bear the name (SSB's
        ``date``)."""
        tok = self.peek(ahead)
        return (tok is not None and tok.kind == "ident"
                and tok.value.lower() == word)

    def accept_word(self, word: str) -> bool:
        if self.at_word(word):
            self.i += 1
            return True
        return False

    def expect_word(self, word: str) -> None:
        if not self.accept_word(word):
            raise SyntaxError(f"expected {word.upper()}, got {self.peek()}")

    # statement -----------------------------------------------------------

    def parse_select(self, nested: bool = False) -> SelectStatement:
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
        group_by: List[Value] = []
        if self.accept("keyword", "group"):
            self.expect("keyword", "by")
            group_by.append(self.parse_value())
            while self.accept("punct", ","):
                group_by.append(self.parse_value())
        order_by: List[OrderItem] = []
        if self.accept("keyword", "order"):
            self.expect("keyword", "by")
            order_by.append(self.parse_order_item())
            while self.accept("punct", ","):
                order_by.append(self.parse_order_item())
        limit = None
        if self.accept_word("limit"):
            limit = int(self.expect("number").value)
        if not nested:
            self.accept("punct", ";")
            if self.peek() is not None:
                raise SyntaxError(f"trailing tokens: {self.peek()}")
        return SelectStatement(items, tables, where, group_by, order_by,
                               limit)

    def parse_alias(self) -> Optional[str]:
        if self.accept("keyword", "as"):
            return self.next().value
        return None

    def parse_select_item(self) -> SelectItem:
        expr = self.parse_value()
        alias = self.parse_alias()
        if isinstance(expr, Aggregate):
            if expr.func == "MIN" and isinstance(expr.arg, ColumnRef):
                return SelectItem(expr.arg, aggregate="MIN", alias=alias)
            return SelectItem(None, aggregate=expr.func, alias=alias,
                              expr=expr.arg)
        if isinstance(expr, ColumnRef):
            return SelectItem(expr, alias=alias)
        return SelectItem(None, alias=alias, expr=expr)

    def parse_value(self) -> Value:
        """Terms joined by ``+`` and ``-``, left to right."""
        left = self.parse_term()
        while True:
            tok = self.accept("punct", "+") or self.accept("punct", "-")
            if tok is None:
                return left
            left = Arith(tok.value, left, self.parse_term())

    def parse_term(self) -> Value:
        """Factors joined by ``*`` and ``/`` (binding tighter than ``+``
        and ``-``), left to right."""
        left = self.parse_factor()
        while True:
            tok = self.accept("punct", "*") or self.accept("punct", "/")
            if tok is None:
                return left
            left = Arith(tok.value, left, self.parse_factor())

    def parse_factor(self) -> Value:
        tok = self.peek()
        if tok is None:
            raise SyntaxError("unexpected end of SQL")
        if self.accept("punct", "("):
            inner = self.parse_value()
            self.expect("punct", ")")
            return inner
        if tok.kind == "number":
            return self.parse_literal()
        for func in ("min", "sum"):
            if self.accept("keyword", func):
                self.expect("punct", "(")
                arg = self.parse_value()
                self.expect("punct", ")")
                return Aggregate(func.upper(), arg)
        if self.at_word("case") and self.at_word("when", 1):
            return self.parse_case()
        if self.at_word("extract") and self.peek(1) is not None \
                and self.peek(1).value == "(":
            self.i += 1
            self.expect("punct", "(")
            field = self.expect("ident").value.upper()
            self.expect("keyword", "from")
            column = self.parse_column_ref()
            self.expect("punct", ")")
            return Extract(field, column)
        return self.parse_column_ref()

    def parse_case(self) -> Case:
        self.expect_word("case")
        whens = []
        while self.accept_word("when"):
            cond = self.parse_or()
            self.expect_word("then")
            whens.append((cond, self.parse_value()))
        default = self.parse_value() if self.accept_word("else") else None
        self.expect_word("end")
        return Case(whens, default)

    def parse_order_item(self) -> OrderItem:
        ref = self.parse_value()
        if self.accept("keyword", "desc"):
            return OrderItem(ref, True)
        self.accept("keyword", "asc")
        return OrderItem(ref)

    def parse_table(self) -> Union[Tuple[str, Optional[str]], DerivedTable]:
        if self.accept("punct", "("):
            stmt = self.parse_select(nested=True)
            self.expect("punct", ")")
            self.accept("keyword", "as")
            return DerivedTable(stmt, self.expect("ident").value)
        name = self.expect("ident").value
        alias = None
        if self.accept("keyword", "as"):
            alias = self.expect("ident").value
        elif (self.peek() and self.peek().kind == "ident"
              and not self.at_word("limit")):
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

    def at_date(self) -> bool:
        nxt = self.peek(1)
        return self.at_word("date") and nxt is not None and nxt.kind == "string"

    def parse_literal(self) -> Union[int, float, str]:
        if self.at_date():
            self.i += 1
            days = date_days(self.parse_literal())
            while (self.at_word("interval", 1)
                   and self.peek().value in ("+", "-")):
                sign = 1 if self.next().value == "+" else -1
                self.i += 1
                count = self.parse_literal()
                unit = self.expect("ident").value
                days = add_interval(days, sign * int(count), unit)
            return days
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
        if nxt and nxt.kind == "ident" and not self.at_date():
            return Compare(op, left, self.parse_column_ref())
        return Compare(op, left, self.parse_literal())


def parse_sql(sql: str) -> SelectStatement:
    return _Parser(tokenize(sql)).parse_select()
