"""Filter / predicate engine.

AST + dual evaluation, mirroring the reference's ``Statement`` hierarchy
(reference include/statement.h:45-245, src/statement.cpp):

* ``eval_row(row) -> bool`` — scalar semantics used by oracles/tests;
* ``eval_table(HostTable) -> np.ndarray[bool]`` — the vectorized kernels the
  ingest path uses (reference parallelizes these over a thread pool,
  include/inner_column.h:248-324; here they are numpy array ops).

Replicated NULL semantics (NOT three-valued SQL logic — the reference is
bitmap-based): every comparison, including NEQ/NOT_LIKE, is **false** on a
NULL value; IS_NULL is true exactly on NULLs; NOT flips the bitmap, so
``NOT (x = 5)`` is true for NULL ``x`` (reference src/statement.cpp:8-16).

A comparison's operand is a literal or, as in TPC-H's ``l_shipdate <
l_commitdate``, another column of the same row (:class:`ColumnOperand`),
false where either side is NULL.

LIKE compiles ``%``/``_`` to an anchored regex with all regex
metacharacters escaped; ``.`` does not match newlines (RE2 default in the
reference, statement.h:118-161 — Python ``re`` matches that default).
"""

from __future__ import annotations

import abc
import dataclasses
import enum
import re
from typing import List, Optional, Union

import numpy as np

from ..dtypes import DataType, is_null
from ..storage import native
from ..storage.columnar import HostTable


@dataclasses.dataclass(frozen=True)
class ColumnOperand:
    """A comparison's right operand that is another column of the same
    row, by its index in the table."""

    column: int


Literal = Union[int, float, bytes, None, ColumnOperand]


class Op(enum.Enum):
    EQ = "="
    NEQ = "!="
    LT = "<"
    GT = ">"
    LEQ = "<="
    GEQ = ">="
    LIKE = "LIKE"
    NOT_LIKE = "NOT LIKE"
    IS_NULL = "IS NULL"
    IS_NOT_NULL = "IS NOT NULL"


_LIKE_CACHE: dict = {}


def like_regex(pattern: bytes) -> "re.Pattern":
    compiled = _LIKE_CACHE.get(pattern)
    if compiled is None:
        parts = []
        for ch in pattern:
            c = bytes([ch])
            if c == b"%":
                parts.append(b".*")
            elif c == b"_":
                parts.append(b".")
            elif c in b"\\.^$|?*+()[]{}":
                parts.append(b"\\" + c)
            else:
                parts.append(c)
        compiled = re.compile(b"(?:" + b"".join(parts) + b")\\Z")
        _LIKE_CACHE[pattern] = compiled
    return compiled


def like_match(value: bytes, pattern: bytes) -> bool:
    return like_regex(pattern).match(value) is not None


class Statement(abc.ABC):
    """A filter over one table's rows: a comparison or a logical tree."""

    @abc.abstractmethod
    def eval_row(self, row) -> bool:
        """Whether one row (a tuple of Python values) passes."""

    @abc.abstractmethod
    def eval_table(self, table: HostTable) -> np.ndarray:
        """The boolean mask of the table's passing rows."""

    @abc.abstractmethod
    def pretty(self, indent: int = 0) -> str:
        """An indented rendering of the tree."""


@dataclasses.dataclass
class Comparison(Statement):
    column: int
    op: Op
    value: Literal = None

    def __post_init__(self):
        # latin-1 mirrors the ingest path's byte-preserving decode, keeping
        # literal bytes identical to column bytes.
        if isinstance(self.value, str):
            self.value = self.value.encode("latin-1")

    # -- scalar (reference src/statement.cpp:135-184) -------------------------

    def eval_row(self, row) -> bool:
        v = row[self.column]
        if isinstance(self.value, ColumnOperand):
            w = row[self.value.column]
            if is_null(v) or is_null(w):
                return False
            if isinstance(v, str):
                v = v.encode("latin-1")
            if isinstance(w, str):
                w = w.encode("latin-1")
            return _scalar_cmp(self.op, v, w)
        if self.op is Op.IS_NULL:
            return is_null(v)
        if self.op is Op.IS_NOT_NULL:
            return not is_null(v)
        if self.op in (Op.LIKE, Op.NOT_LIKE):
            if is_null(v) or not isinstance(v, (bytes, str)) or not isinstance(self.value, bytes):
                return False
            vb = v.encode("latin-1") if isinstance(v, str) else v
            m = like_match(vb, self.value)
            return m if self.op is Op.LIKE else not m
        if is_null(v):
            return False
        lhs_num = isinstance(v, (int, float)) and not isinstance(v, bool)
        rhs_num = isinstance(self.value, (int, float))
        if lhs_num and rhs_num:
            return _scalar_cmp(self.op, float(v), float(self.value))
        lhs_str = isinstance(v, (bytes, str))
        rhs_str = isinstance(self.value, bytes)
        if lhs_str and rhs_str:
            vb = v.encode("latin-1") if isinstance(v, str) else v
            return _scalar_cmp(self.op, vb, self.value)
        return False

    # -- columnar -------------------------------------------------------------

    def eval_table(self, table: HostTable) -> np.ndarray:
        col = table.columns[self.column]
        valid = col.valid
        if self.op is Op.IS_NULL:
            return ~valid
        if self.op is Op.IS_NOT_NULL:
            return valid.copy()
        if isinstance(self.value, ColumnOperand):
            return self._eval_columns(col, table.columns[self.value.column])
        if col.dtype is DataType.VARCHAR:
            return self._eval_varchar(col, valid)
        return self._eval_numeric(col, valid)

    def _eval_numeric(self, col, valid: np.ndarray) -> np.ndarray:
        if not isinstance(self.value, (int, float)):
            return np.zeros(len(valid), dtype=bool)
        values = col.values
        lit = self.value
        # Compare in a domain wide enough for both operands (the reference
        # row path compares as doubles, statement.cpp:163-170; its columnar
        # path compares in the column type — for JOB's small int literals
        # these agree, and int64 comparison is exact for int columns).
        if col.dtype is DataType.FP64 or isinstance(lit, float):
            lhs = values.astype(np.float64, copy=False)
            rhs = np.float64(lit)
        else:
            lhs = values.astype(np.int64, copy=False)
            rhs = np.int64(lit)
        mask = _vector_cmp(self.op, lhs, rhs)
        return mask & valid

    def _eval_columns(self, col, other) -> np.ndarray:
        """Column against column, row by row; false where either is
        NULL."""
        valid = col.valid & other.valid
        varchar = (col.dtype is DataType.VARCHAR,
                   other.dtype is DataType.VARCHAR)
        if varchar == (True, True):
            lhs, rhs = col.objects(), other.objects()
            out = np.zeros(len(valid), dtype=bool)
            for i in np.nonzero(valid)[0]:
                out[i] = _scalar_cmp(self.op, lhs[i], rhs[i])
            return out
        if any(varchar):
            return np.zeros(len(valid), dtype=bool)
        wide = (np.float64 if DataType.FP64 in (col.dtype, other.dtype)
                else np.int64)
        return _vector_cmp(self.op, col.values.astype(wide, copy=False),
                           other.values.astype(wide, copy=False)) & valid

    def _eval_varchar(self, col, valid: np.ndarray) -> np.ndarray:
        n = len(valid)
        out = np.zeros(n, dtype=bool)
        if not isinstance(self.value, bytes):
            return out
        if self.op in (Op.LIKE, Op.NOT_LIKE):
            res = native.like(
                col.heap, col.ends, valid, self.value, self.op is Op.NOT_LIKE
            )
            if res is not None:
                return res
            values = col.objects()
            rx = like_regex(self.value)
            want = self.op is Op.LIKE
            for i in np.nonzero(valid)[0]:
                if (rx.match(values[i]) is not None) == want:
                    out[i] = True
            return out
        res = native.str_compare(col.heap, col.ends, valid, self.value, self.op.name)
        if res is not None:
            return res
        values = col.objects()
        lit = self.value
        op = self.op
        for i in np.nonzero(valid)[0]:
            if _scalar_cmp(op, values[i], lit):
                out[i] = True
        return out

    def pretty(self, indent: int = 0) -> str:
        if isinstance(self.value, ColumnOperand):
            v = f"col[{self.value.column}]"
        elif self.op in (Op.IS_NULL, Op.IS_NOT_NULL):
            v = ""
        else:
            v = repr(self.value)
        return " " * indent + f"col[{self.column}] {self.op.value} {v}"


def _scalar_cmp(op: Op, a, b) -> bool:
    if op is Op.EQ:
        return a == b
    if op is Op.NEQ:
        return a != b
    if op is Op.LT:
        return a < b
    if op is Op.GT:
        return a > b
    if op is Op.LEQ:
        return a <= b
    if op is Op.GEQ:
        return a >= b
    raise ValueError(op)


def _vector_cmp(op: Op, a: np.ndarray, b) -> np.ndarray:
    if op is Op.EQ:
        return a == b
    if op is Op.NEQ:
        return a != b
    if op is Op.LT:
        return a < b
    if op is Op.GT:
        return a > b
    if op is Op.LEQ:
        return a <= b
    if op is Op.GEQ:
        return a >= b
    raise ValueError(op)


class LogicalType(enum.Enum):
    AND = "AND"
    OR = "OR"
    NOT = "NOT"


@dataclasses.dataclass
class LogicalOperation(Statement):
    op_type: LogicalType
    children: List[Statement]

    @staticmethod
    def make_and(left: Statement, right: Statement) -> "LogicalOperation":
        return LogicalOperation(LogicalType.AND, [left, right])

    @staticmethod
    def make_or(left: Statement, right: Statement) -> "LogicalOperation":
        return LogicalOperation(LogicalType.OR, [left, right])

    @staticmethod
    def make_not(child: Statement) -> "LogicalOperation":
        return LogicalOperation(LogicalType.NOT, [child])

    def eval_row(self, row) -> bool:
        if self.op_type is LogicalType.AND:
            return self.children[0].eval_row(row) and self.children[1].eval_row(row)
        if self.op_type is LogicalType.OR:
            return self.children[0].eval_row(row) or self.children[1].eval_row(row)
        return not self.children[0].eval_row(row)

    def eval_table(self, table: HostTable) -> np.ndarray:
        if self.op_type is LogicalType.AND:
            return self.children[0].eval_table(table) & self.children[1].eval_table(table)
        if self.op_type is LogicalType.OR:
            return self.children[0].eval_table(table) | self.children[1].eval_table(table)
        return ~self.children[0].eval_table(table)

    def pretty(self, indent: int = 0) -> str:
        head = " " * indent + f"[{self.op_type.value}]"
        return "\n".join([head] + [c.pretty(indent + 2) for c in self.children])


def and_filters(a: Optional[Statement], b: Optional[Statement]) -> Optional[Statement]:
    if a is None:
        return b
    if b is None:
        return a
    return LogicalOperation.make_and(a, b)
