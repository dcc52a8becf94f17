"""Scalar type system of the engine.

Mirrors the reference's attribute types (reference include/attribute.h:8-13)
and its ``Data = variant<int32, int64, double, string, monostate>`` row value
model (reference include/statement.h:13). In this framework rows only exist
at the test/oracle boundary; the engine itself is columnar.
"""

from __future__ import annotations

import enum

import numpy as np


class DataType(enum.IntEnum):
    """Column data types (reference include/attribute.h:8-13)."""

    INT32 = 0
    INT64 = 1
    FP64 = 2
    VARCHAR = 3

    @property
    def numpy_dtype(self):
        return _NUMPY_DTYPES[self]

    @property
    def is_varchar(self) -> bool:
        return self is DataType.VARCHAR

    @property
    def fixed_size(self) -> int:
        """Value byte width on a page (VARCHAR raises)."""
        if self is DataType.INT32:
            return 4
        if self in (DataType.INT64, DataType.FP64):
            return 8
        raise ValueError("VARCHAR has no fixed size")

    @property
    def page_data_begin(self) -> int:
        """Offset of the first value on a fixed-width page.

        max(4, sizeof(T)) per reference include/plan.h:159-165.
        """
        return max(4, self.fixed_size)


_NUMPY_DTYPES = {
    DataType.INT32: np.dtype(np.int32),
    DataType.INT64: np.dtype(np.int64),
    DataType.FP64: np.dtype(np.float64),
    DataType.VARCHAR: np.dtype(object),
}


class _Null:
    """Singleton NULL marker (reference ``std::monostate``).

    Used in row-level test fixtures and oracle comparisons. Sorts before any
    value (matches ``std::variant`` ordering where monostate is the last
    alternative... note: the reference sorts rows of variants in alternative
    order INT32<INT64<FP64<VARCHAR<NULL; our comparisons canonicalize within
    one column type so only the NULL-vs-value order matters and is fixed).
    """

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "NULL"

    def __bool__(self) -> bool:
        return False

    def __copy__(self):
        return self

    def __deepcopy__(self, memo):
        return self


NULL = _Null()


def is_null(value) -> bool:
    return value is NULL or value is None


PAGE_SIZE = 8192  # reference include/plan.h:54

# VARCHAR values longer than this spill to dedicated long-string pages
# flagged 0xffff/0xfffe (reference include/plan.h:301-306).
MAX_INLINE_STRING = PAGE_SIZE - 7

LONG_STRING_FIRST = 0xFFFF
LONG_STRING_CONT = 0xFFFE
