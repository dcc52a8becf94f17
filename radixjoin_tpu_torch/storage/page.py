"""8 KiB page codec (numpy reference implementation).

Page format (reference README.md:88-98, include/plan.h:151-335):

Fixed-width column page (INT32 / INT64 / FP64):
    [0:2)   u16 num_rows
    [2:4)   u16 num_values (non-null count)
    [db:..) packed non-null values; db = max(4, sizeof(T))
    tail    NULL bitmap, (num_rows+7)//8 bytes at PAGE_SIZE - size,
            bit i (little bit order) set <=> row i is non-null

VARCHAR page:
    [0:2)   u16 num_rows  (< 0xfffe; 0xffff/0xfffe flag long-string pages)
    [2:4)   u16 num_offsets (non-null count)
    [4:4+2*nv)  u16 cumulative END offsets of each non-null string within the
                char payload of this page
    then    char payload
    tail    NULL bitmap as above

Long-string pages (value longer than PAGE_SIZE-7 bytes):
    u16 0xffff (first page) / 0xfffe (continuation), u16 num_chars, payload at
    [4:4+num_chars). A 0xffff page starts a new row; 0xfffe appends to it
    (reference src/build_table.cpp:382-405).

Encoding reproduces the greedy row-packing of the reference's
``Table::to_columnar`` (src/build_table.cpp:456-681). Exact byte layout of
page *splits* is not part of the correctness contract (the reference itself
has two encoders that split differently); any split that decodes to the same
rows is valid. Decoders accept any valid page stream.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..dtypes import (
    DataType,
    LONG_STRING_CONT,
    LONG_STRING_FIRST,
    MAX_INLINE_STRING,
    PAGE_SIZE,
)
from . import native

# Max num_rows for a VARCHAR page: must stay clear of the 0xfffe/0xffff
# long-string markers.
_MAX_VARCHAR_PAGE_ROWS = 0xFFFD
# For fixed-width pages num_rows is bounded by the bitmap capacity alone
# (all-NULL page): 4 + 0 + (r//8 + 1) <= 8192.
_MAX_FIXED_PAGE_ROWS = (PAGE_SIZE - 5) * 8


def _pack_bitmap(valid: np.ndarray) -> np.ndarray:
    return np.packbits(valid.astype(np.uint8), bitorder="little")


def _unpack_bitmap(raw: np.ndarray, num_rows: int) -> np.ndarray:
    return np.unpackbits(raw, count=num_rows, bitorder="little").astype(bool)


def _u16(page: np.ndarray, offset: int) -> int:
    return int(page[offset]) | (int(page[offset + 1]) << 8)


def _put_u16(page: np.ndarray, offset: int, value: int) -> None:
    page[offset] = value & 0xFF
    page[offset + 1] = (value >> 8) & 0xFF


# ---------------------------------------------------------------------------
# Fixed-width encode / decode
# ---------------------------------------------------------------------------


def encode_fixed(
    values: np.ndarray, valid: np.ndarray, dtype: DataType
) -> np.ndarray:
    """Encode a dense fixed-width column into pages.

    ``values`` may hold arbitrary data at NULL positions. Returns an
    (n_pages, PAGE_SIZE) uint8 array.
    """
    size = dtype.fixed_size
    db = dtype.page_data_begin
    values = np.ascontiguousarray(values, dtype=dtype.numpy_dtype)
    native_pages = native.encode_fixed(values, valid, size, db)
    if native_pages is not None:
        return native_pages
    n = len(valid)
    values = np.ascontiguousarray(values, dtype=dtype.numpy_dtype)
    valid = np.asarray(valid, dtype=bool)
    # cumulative non-null counts: C[i] = number of non-null rows in [0, i)
    cum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(valid, out=cum[1:])

    pages: List[np.ndarray] = []
    start = 0
    while start < n:
        limit = min(n - start, _MAX_FIXED_PAGE_ROWS)
        # cost(r) = db + values_bytes_through_r + bitmap_bytes(r_local)
        local = np.arange(limit, dtype=np.int64)
        cost = (
            db
            + (cum[start + 1 : start + limit + 1] - cum[start]) * size
            + (local // 8 + 1)
        )
        take = int(np.searchsorted(cost, PAGE_SIZE, side="right"))
        if take == 0:
            raise AssertionError("page cannot fit a single row")
        end = start + take
        nr = take
        v = valid[start:end]
        nv = int(cum[end] - cum[start])
        page = np.zeros(PAGE_SIZE, dtype=np.uint8)
        _put_u16(page, 0, nr)
        _put_u16(page, 2, nv)
        if nv:
            data = values[start:end][v]
            raw = data.view(np.uint8).reshape(-1)
            page[db : db + nv * size] = raw
        bm = _pack_bitmap(v)
        page[PAGE_SIZE - len(bm) :] = bm
        pages.append(page)
        start = end
    if not pages:
        return np.zeros((0, PAGE_SIZE), dtype=np.uint8)
    return np.stack(pages)


def decode_fixed(pages: np.ndarray, num_rows: int, dtype: DataType):
    """Decode pages of a fixed-width column into (values, valid).

    NULL positions hold 0 in ``values``.
    """
    size = dtype.fixed_size
    db = dtype.page_data_begin
    res = native.decode_fixed(pages, num_rows, size, db)
    if res is not None:
        raw, valid = res
        return raw.view(dtype.numpy_dtype), valid
    values = np.zeros(num_rows, dtype=dtype.numpy_dtype)
    valid = np.zeros(num_rows, dtype=bool)
    row = 0
    for page in pages:
        nr = _u16(page, 0)
        nv = _u16(page, 2)
        bm_bytes = (nr + 7) // 8
        bits = _unpack_bitmap(page[PAGE_SIZE - bm_bytes :], nr)
        if row + nr > num_rows:
            raise ValueError("page stream has more rows than table.num_rows")
        vals = page[db : db + nv * size].view(dtype.numpy_dtype)
        out_slice_vals = values[row : row + nr]
        out_slice_vals[bits] = vals
        valid[row : row + nr] = bits
        row += nr
    if row != num_rows:
        raise ValueError(f"decoded {row} rows, expected {num_rows}")
    return values, valid


# ---------------------------------------------------------------------------
# VARCHAR encode / decode
# ---------------------------------------------------------------------------


def encode_varchar(values: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Encode a VARCHAR column (object array of ``bytes``) into pages."""
    n = len(valid)
    valid = np.asarray(valid, dtype=bool)
    lengths = np.zeros(n, dtype=np.int64)
    for i in range(n):
        if valid[i]:
            lengths[i] = len(values[i])

    pages: List[np.ndarray] = []

    def flush(start: int, end: int) -> None:
        """Emit normal pages for rows [start, end) — no long strings inside."""
        if start >= end:
            return
        seg_valid = valid[start:end]
        seg_len = lengths[start:end]
        m = end - start
        cum_v = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(seg_valid, out=cum_v[1:])
        cum_b = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(seg_len, out=cum_b[1:])
        s = 0
        while s < m:
            limit = min(m - s, _MAX_VARCHAR_PAGE_ROWS)
            local = np.arange(limit, dtype=np.int64)
            cost = (
                4
                + (cum_v[s + 1 : s + limit + 1] - cum_v[s]) * 2
                + (cum_b[s + 1 : s + limit + 1] - cum_b[s])
                + (local // 8 + 1)
            )
            take = int(np.searchsorted(cost, PAGE_SIZE, side="right"))
            if take == 0:
                raise AssertionError("varchar page cannot fit a single row")
            e = s + take
            v = seg_valid[s:e]
            nv = int(cum_v[e] - cum_v[s])
            page = np.zeros(PAGE_SIZE, dtype=np.uint8)
            _put_u16(page, 0, take)
            _put_u16(page, 2, nv)
            payload = b"".join(
                values[start + s + j] for j in np.nonzero(v)[0]
            )
            ends = np.cumsum(seg_len[s:e][v]).astype(np.uint16)
            page[4 : 4 + 2 * nv] = ends.view(np.uint8)
            off = 4 + 2 * nv
            page[off : off + len(payload)] = np.frombuffer(payload, dtype=np.uint8)
            bm = _pack_bitmap(v)
            page[PAGE_SIZE - len(bm) :] = bm
            pages.append(page)
            s = e

    def emit_long(value: bytes) -> None:
        offset = 0
        first = True
        while offset < len(value):
            chunk = value[offset : offset + PAGE_SIZE - 4]
            page = np.zeros(PAGE_SIZE, dtype=np.uint8)
            _put_u16(page, 0, LONG_STRING_FIRST if first else LONG_STRING_CONT)
            _put_u16(page, 2, len(chunk))
            page[4 : 4 + len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)
            pages.append(page)
            offset += len(chunk)
            first = False

    seg_start = 0
    for i in range(n):
        if valid[i] and lengths[i] > MAX_INLINE_STRING:
            flush(seg_start, i)
            emit_long(values[i])
            seg_start = i + 1
    flush(seg_start, n)

    if not pages:
        return np.zeros((0, PAGE_SIZE), dtype=np.uint8)
    return np.stack(pages)


def decode_varchar(pages: np.ndarray, num_rows: int):
    """Decode VARCHAR pages into (values: object array of bytes, valid)."""
    values = np.empty(num_rows, dtype=object)
    valid = np.zeros(num_rows, dtype=bool)
    values[:] = b""
    row = 0
    long_parts: List[bytes] = []

    def finish_long() -> None:
        nonlocal row
        if long_parts:
            values[row - 1] = b"".join(long_parts)
            long_parts.clear()

    for page in pages:
        nr = _u16(page, 0)
        if nr == LONG_STRING_FIRST:
            finish_long()
            num_chars = _u16(page, 2)
            if row >= num_rows:
                raise ValueError("long-string page overflows table.num_rows")
            valid[row] = True
            row += 1
            long_parts.append(page[4 : 4 + num_chars].tobytes())
            continue
        if nr == LONG_STRING_CONT:
            if not long_parts:
                raise ValueError("0xfffe continuation page without 0xffff start")
            num_chars = _u16(page, 2)
            long_parts.append(page[4 : 4 + num_chars].tobytes())
            continue
        finish_long()
        nv = _u16(page, 2)
        bm_bytes = (nr + 7) // 8
        bits = _unpack_bitmap(page[PAGE_SIZE - bm_bytes :], nr)
        ends = page[4 : 4 + 2 * nv].view(np.uint16)
        payload = page[4 + 2 * nv : 4 + 2 * nv + (int(ends[-1]) if nv else 0)]
        raw = payload.tobytes()
        if row + nr > num_rows:
            raise ValueError("page stream has more rows than table.num_rows")
        idx = np.nonzero(bits)[0]
        start = 0
        for j, e in zip(idx, ends):
            values[row + j] = raw[start:e]
            start = int(e)
        valid[row : row + nr] = bits
        row += nr
    finish_long()
    if row != num_rows:
        raise ValueError(f"decoded {row} rows, expected {num_rows}")
    return values, valid


# ---------------------------------------------------------------------------
# Heap-form VARCHAR codec (canonical hot path; native with python fallback)
# ---------------------------------------------------------------------------


def encode_varchar_heap(
    heap: np.ndarray, ends: np.ndarray, valid: np.ndarray
) -> np.ndarray:
    native_pages = native.encode_varchar(heap, ends, valid)
    if native_pages is not None:
        return native_pages
    from .columnar import heap_to_objects  # local import to avoid a cycle

    return encode_varchar(heap_to_objects(heap, ends, valid), valid)


def decode_varchar_heap(pages: np.ndarray, num_rows: int):
    res = native.decode_varchar(pages, num_rows)
    if res is not None:
        return res
    from .columnar import objects_to_heap

    values, valid = decode_varchar(pages, num_rows)
    heap, ends = objects_to_heap(values, valid)
    return heap, ends, valid


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def encode_column(values: np.ndarray, valid: np.ndarray, dtype: DataType) -> np.ndarray:
    if dtype is DataType.VARCHAR:
        return encode_varchar(values, valid)
    return encode_fixed(values, valid, dtype)


def decode_column(pages: np.ndarray, num_rows: int, dtype: DataType):
    if dtype is DataType.VARCHAR:
        return decode_varchar(pages, num_rows)
    return decode_fixed(pages, num_rows, dtype)
