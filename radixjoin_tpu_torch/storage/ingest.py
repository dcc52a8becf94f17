"""CSV ingest: base-table loading with filter pushdown and caching.

Python counterpart of the reference's ``Table::from_csv``
(src/build_table.cpp:135-304): stream-parse the CSV into dense typed columns
(empty field -> NULL), evaluate the pushed-down filter as a bitmap over the
full table, compact, and encode to pages. Two process-global caches mirror
the reference's (src/build_table.cpp:91-92): a parsed-table cache and an
unfiltered-encoding cache.

CSV dialect (reference src/csv_parser.cpp + build_table.cpp:228): comma
separator, double-quote quoting, backslash escape (IMDB exports), no header.
Bytes are preserved exactly via latin-1 round-tripping. A native C++ parser
accelerates this path when built (storage/native).
"""

from __future__ import annotations

import csv
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..dtypes import DataType
from . import native
from .columnar import Column, ColumnarTable, HostColumn, HostTable
from . import page as page_codec

csv.field_size_limit(sys.maxsize)

# path -> parsed full table
_table_cache: Dict[str, HostTable] = {}
# path -> encoded unfiltered ColumnarTable
_result_cache: Dict[str, ColumnarTable] = {}


def clear_caches() -> None:
    _table_cache.clear()
    _result_cache.clear()


def parse_csv(path: str, types: Sequence[DataType]) -> HostTable:
    """Parse a whole CSV file into a dense HostTable (empty field = NULL)."""
    res = native.parse_csv(str(path), [int(t) for t in types])
    if res is not None:
        nrows, cols_raw = res
        columns = []
        for dt, parsed in zip(types, cols_raw):
            if parsed[0] == "varchar":
                _, heap, ends, valid = parsed
                columns.append(HostColumn.varchar(heap, ends, valid))
            else:
                _, raw, valid = parsed
                columns.append(
                    HostColumn(DataType(dt), raw.view(dt.numpy_dtype), valid)
                )
        return HostTable(nrows, columns)
    ncols = len(types)
    raw_cols: List[List] = [[] for _ in range(ncols)]
    with open(path, "r", encoding="latin-1", newline="") as f:
        reader = csv.reader(
            f, delimiter=",", quotechar='"', escapechar="\\", doublequote=False
        )
        for row in reader:
            if len(row) != ncols:
                raise ValueError(
                    f"{path}: row has {len(row)} fields, expected {ncols}"
                )
            for j, field in enumerate(row):
                raw_cols[j].append(field)
    n = len(raw_cols[0]) if ncols else 0
    columns = []
    for j, dt in enumerate(types):
        raw = raw_cols[j]
        valid = np.array([f != "" for f in raw], dtype=bool)
        if dt is DataType.VARCHAR:
            values = np.empty(n, dtype=object)
            values[:] = b""
            for i, f in enumerate(raw):
                if f:
                    values[i] = f.encode("latin-1")
        else:
            np_dtype = dt.numpy_dtype
            values = np.zeros(n, dtype=np_dtype)
            conv = float if dt is DataType.FP64 else int
            for i, f in enumerate(raw):
                if f:
                    values[i] = conv(f)
        columns.append(HostColumn(dt, values, valid))
    return HostTable(n, columns)


def filter_table(table: HostTable, filt) -> HostTable:
    """Apply a predicate bitmap and compact rows (NULL payloads survive)."""
    if filt is None:
        return table
    mask = filt.eval_table(table)
    idx = np.nonzero(mask)[0]
    return HostTable(len(idx), [c.take(idx) for c in table.columns])


def from_csv(
    types: Sequence[DataType],
    path: str,
    filt=None,
) -> ColumnarTable:
    """Load, filter, and page-encode one base table (with caching)."""
    key = str(path)
    if filt is None and key in _result_cache:
        return _result_cache[key].copy()
    table = _table_cache.get(key)
    if table is None:
        table = parse_csv(key, types)
        _table_cache[key] = table
    filtered = filter_table(table, filt)
    encoded = ColumnarTable.from_host(filtered)
    if filt is None:
        _result_cache[key] = encoded.copy()
    return encoded


def _csv_field(value: bytes) -> bytes:
    """Encode one field in the reference dialect: quote when the field
    contains a separator/quote/newline/backslash; inside quotes, escape
    '"' and '\\' with a backslash (escape is only meaningful inside quotes,
    reference src/csv_parser.cpp:143-156)."""
    if any(c in value for c in (b",", b'"', b"\n", b"\r", b"\\")):
        return b'"' + value.replace(b"\\", b"\\\\").replace(b'"', b'\\"') + b'"'
    return value


def write_csv(path: str, table: HostTable) -> None:
    """Emit a HostTable as a reference-dialect CSV (for fixtures/benchmarks)."""
    varchar_objs = {
        j: c.objects()
        for j, c in enumerate(table.columns)
        if c.dtype is DataType.VARCHAR
    }
    with open(path, "wb") as f:
        for i in range(table.num_rows):
            row = []
            for j, c in enumerate(table.columns):
                if not c.valid[i]:
                    row.append(b"")
                elif c.dtype is DataType.VARCHAR:
                    row.append(_csv_field(bytes(varchar_objs[j][i])))
                elif c.dtype is DataType.FP64:
                    row.append(repr(float(c.values[i])).encode())
                else:
                    row.append(str(int(c.values[i])).encode())
            f.write(b",".join(row) + b"\n")
