"""Columnar containers.

``ColumnarTable`` is the paged interchange format at the engine boundary
(reference include/plan.h:54-105): inputs of a ``Plan`` and the result of
``execute`` are paged. ``HostTable`` is the dense in-memory form the engine
computes on: one contiguous typed numpy array + validity mask per column.

VARCHAR columns are stored as a **byte heap + per-row end offsets**
(``ends[i]`` cumulative; NULL rows repeat the previous end) — never as
Python object arrays on any hot path. This is the columnar dual of the
reference's ``InnerColumn<std::string>`` (include/inner_column.h:327-335)
and what the native kernels (storage/native) operate on. Object arrays of
``bytes`` exist only at test/oracle boundaries via ``objects()``.

Row-oriented helpers (``to_rows``/``from_rows``) exist only for tests and
oracle comparison — the hot path never materializes rows (the reference's
row-variant materialization is what made it allocator-bound, SURVEY.md §3.2).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence

import numpy as np

from .. import trace
from ..dtypes import NULL, DataType, PAGE_SIZE, is_null
from . import device_decode
from . import host_pool
from . import native as _native
from . import page as page_codec


def gather_varlen(heap: np.ndarray, starts: np.ndarray, lengths: np.ndarray):
    """Vectorized variable-length gather: returns (new_heap, new_ends)."""
    lengths = lengths.astype(np.int64, copy=False)
    total = int(lengths.sum())
    new_ends = np.cumsum(lengths)
    if total == 0:
        return np.zeros(0, dtype=np.uint8), new_ends
    native_out = _native.gather_varlen(heap, starts, lengths, new_ends, total)
    if native_out is not None:
        return native_out, new_ends
    out_starts = new_ends - lengths
    nz = lengths > 0
    src = (
        np.repeat(starts[nz].astype(np.int64) - out_starts[nz], lengths[nz])
        + np.arange(total, dtype=np.int64)
    )
    return heap[src], new_ends


def objects_to_heap(values: Sequence, valid: np.ndarray):
    """Object array / list of bytes -> (heap, ends)."""
    n = len(valid)
    lengths = np.zeros(n, dtype=np.int64)
    chunks = []
    for i in range(n):
        if valid[i]:
            v = values[i]
            if isinstance(v, str):
                v = v.encode("latin-1")
            lengths[i] = len(v)
            chunks.append(v)
    heap = np.frombuffer(b"".join(chunks), dtype=np.uint8).copy() if chunks else np.zeros(0, np.uint8)
    return heap, np.cumsum(lengths)


def heap_to_objects(heap: np.ndarray, ends: np.ndarray, valid: np.ndarray):
    out = np.empty(len(valid), dtype=object)
    out[:] = b""
    raw = heap.tobytes()
    prev = 0
    for i in range(len(valid)):
        end = int(ends[i])
        if valid[i]:
            out[i] = raw[prev:end]
        prev = end
    return out


#: the root decode of dictionary VARCHAR columns (:meth:`StringDict.decode`):
#: columns decoded (``varchar_columns``), their rows (``varchar_rows``), and
#: those decoded by NumPy because the native library is unavailable
#: (``numpy_fallbacks``; 0 wherever g++ built it)
DECODE_STATS = trace.Counters(
    "decode", ("varchar_columns", "varchar_rows", "numpy_fallbacks"))


@dataclasses.dataclass
class StringDict:
    """Sorted distinct string values (dictionary for device-side VARCHAR)."""

    heap: np.ndarray
    ends: np.ndarray  # int64, cumulative; len == dictionary size

    _objects: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def size(self) -> int:
        return len(self.ends)

    @property
    def starts(self) -> np.ndarray:
        return self.ends - self.lengths

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.ends, prepend=0)

    def decode(self, ids: np.ndarray, valid: np.ndarray):
        """The strings that ``ids`` name, as ``(heap, ends)`` of one row per
        id: each id clipped to ``[0, size - 1]``, an invalid row (and every
        row of an empty dictionary) the empty string. Reads only the
        entries the ids name, so its work follows the rows, not the
        dictionary. Counted in :data:`DECODE_STATS`."""
        n = len(valid)
        DECODE_STATS.add("varchar_columns")
        DECODE_STATS.add("varchar_rows", n)
        if n == 0 or self.size == 0:
            return np.zeros(0, np.uint8), np.zeros(n, np.int64)
        out = _native.dict_decode(self.heap, self.ends, ids, valid)
        if out is not None:
            return out
        DECODE_STATS.add("numpy_fallbacks")
        ids = np.clip(ids, 0, self.size - 1)
        starts = np.where(ids > 0, self.ends[ids - 1], 0)
        lengths = np.where(valid, self.ends[ids] - starts, 0)
        return gather_varlen(self.heap, starts, lengths)

    def objects(self) -> np.ndarray:
        if self._objects is None:
            self._objects = heap_to_objects(
                self.heap, self.ends, np.ones(self.size, dtype=bool)
            )
        return self._objects

    @staticmethod
    def empty() -> "StringDict":
        return StringDict(np.zeros(0, np.uint8), np.zeros(0, np.int64))

    @staticmethod
    def from_objects(values: Sequence) -> "StringDict":
        heap, ends = objects_to_heap(values, np.ones(len(values), dtype=bool))
        d = StringDict(heap, ends)
        arr = np.empty(len(values), dtype=object)
        arr[:] = [v if isinstance(v, bytes) else v.encode("latin-1") for v in values]
        d._objects = arr
        return d


@dataclasses.dataclass
class HostColumn:
    """One dense host column.

    Fixed-width: ``values`` typed array (+ ``valid``). VARCHAR: ``heap`` +
    ``ends`` (+ ``valid``); ``values`` is a lazy object-array cache.
    """

    dtype: DataType
    values: Optional[np.ndarray]
    valid: np.ndarray
    heap: Optional[np.ndarray] = None
    ends: Optional[np.ndarray] = None
    #: memo for is_unique_key (None = not yet computed)
    _unique: Optional[bool] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    #: memo for valid_range ("unset" = not yet computed)
    _range: object = dataclasses.field(
        default="unset", repr=False, compare=False
    )
    #: memo for csr_index ("unset" = not yet computed)
    _csr: object = dataclasses.field(
        default="unset", repr=False, compare=False
    )

    def is_unique_key(self, max_check_rows: int = 1 << 22) -> bool:
        """True iff all *valid* values are pairwise distinct.

        Used to pick the FK->PK join fast path (a unique build side makes
        duplicate expansion statically unnecessary). Sorted columns (the
        common primary-key layout) are detected in O(n); otherwise falls
        back to ``np.unique`` for columns up to ``max_check_rows`` and
        conservatively reports False beyond that. The result is memoized on
        the column, so shared/cached tables pay the check once.
        """
        if self._unique is None:
            if self.dtype is DataType.VARCHAR:
                self._unique = False  # fast path is int-key only
            else:
                vals = self.values[self.valid]
                if len(vals) <= 1:
                    self._unique = True
                elif bool(np.all(vals[1:] > vals[:-1])):
                    self._unique = True  # strictly increasing => distinct
                elif len(vals) > max_check_rows:
                    self._unique = False  # too big to check; be conservative
                else:
                    self._unique = len(np.unique(vals)) == len(vals)
        return self._unique

    def valid_range(self):
        """(min, max) over *valid* values, or None if no valid rows.

        Int columns only. Memoized; drives the static key-window size of
        the scatter-table FK->PK join (ops/join.py
        join_unique_scatter_impl).
        """
        if self._range == "unset":
            if self.dtype not in (DataType.INT32, DataType.INT64):
                self._range = None
            else:
                vals = self.values[self.valid]
                self._range = (
                    (int(vals.min()), int(vals.max())) if len(vals) else None
                )
        return self._range

    def csr_index(self, max_window: int = 1 << 25):
        """CSR grouping of row ids by key value over the valid window.

        Returns ``(base, counts_w, starts_w, grouped)`` — all numpy, sizes
        pow2-padded so the executor can upload them directly as
        shape-shared device operands (ops/join.py join_csr_impl):

          * ``counts_w[k]`` = number of valid rows with value ``base + k``
          * ``starts_w`` = exclusive prefix sum of ``counts_w``
          * ``grouped`` = row ids ordered by value (ties in row order)

        or None for non-int columns / windows wider than ``max_window``
        (the dense window tables would not pay for themselves). Memoized:
        base tables shared across the query suite compute this once. This
        is the reference's radix-partition + per-bucket hash build
        (src/execute.cpp:124-223) collapsed to its dense-key limit, done
        once on the host instead of per query on the device.
        """
        if self._csr == "unset":
            self._csr = self._csr_compute(max_window)
        return self._csr

    def _csr_compute(self, max_window: int):
        def pow2(n, minimum=128):
            n = max(int(n), minimum)
            return 1 << (n - 1).bit_length()

        rng = self.valid_range()
        if self.dtype not in (DataType.INT32, DataType.INT64):
            return None
        if rng is None:  # no valid rows: nothing ever matches
            z = np.zeros(128, np.int32)
            return 0, z, z, z
        base, hi = rng
        if hi - base + 1 > max_window:
            return None
        r_pad = pow2(hi - base + 1)
        off = (self.values.astype(np.int64) - base)[self.valid]
        counts_w = np.bincount(off, minlength=r_pad).astype(np.int32)
        starts_w = (np.cumsum(counts_w) - counts_w).astype(np.int32)
        order = np.argsort(off, kind="stable").astype(np.int32)
        row_ids = np.flatnonzero(self.valid).astype(np.int32)
        grouped = np.zeros(pow2(len(off)), np.int32)
        grouped[: len(off)] = row_ids[order]
        return base, counts_w, starts_w, grouped

    def __post_init__(self):
        if self.dtype is DataType.VARCHAR and self.heap is None:
            # accept object-array input; canonicalize to heap form
            self.heap, self.ends = objects_to_heap(self.values, self.valid)
            self.values = None

    def __len__(self) -> int:
        return len(self.valid)

    @staticmethod
    def varchar(heap: np.ndarray, ends: np.ndarray, valid: np.ndarray) -> "HostColumn":
        return HostColumn(DataType.VARCHAR, None, valid, heap=heap, ends=ends)

    def objects(self) -> np.ndarray:
        """Object array of bytes (oracle/test boundary only)."""
        assert self.dtype is DataType.VARCHAR
        if self.values is None:
            self.values = heap_to_objects(self.heap, self.ends, self.valid)
        return self.values

    @property
    def starts(self) -> np.ndarray:
        return self.ends - self.lengths

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.ends, prepend=0)

    def take(self, indices: np.ndarray) -> "HostColumn":
        if self.dtype is not DataType.VARCHAR:
            return HostColumn(self.dtype, self.values[indices], self.valid[indices])
        starts = self.starts[indices]
        lengths = self.lengths[indices]
        heap, ends = gather_varlen(self.heap, starts, lengths)
        return HostColumn.varchar(heap, ends, self.valid[indices])


class Column:
    """A paged column: (n_pages, PAGE_SIZE) uint8 array.

    ``pages`` may be passed as a zero-arg callable: the page encode then
    runs lazily on first access (and is memoized). The engine computes on
    the decoded ``HostTable`` memo, so plan inputs built from host tables
    (harness/bench path) never pay the encode unless something actually
    reads the bytes — the byte format itself stays exact and fully tested
    (tests/test_page_codec.py)."""

    # _dev_memo: device page-decode upload memo (plan/executor.py);
    # __weakref__: engine._DEVICE_CACHE_COLS eviction registry
    __slots__ = ("type", "_pages", "_dev_memo", "__weakref__")

    def __init__(self, type: DataType, pages):
        self.type = type
        if pages is None:
            pages = np.zeros((0, PAGE_SIZE), dtype=np.uint8)
        if not callable(pages):
            assert pages.ndim == 2 and pages.shape[1] == PAGE_SIZE
        self._pages = pages

    @property
    def pages(self) -> np.ndarray:
        if callable(self._pages):
            pages = self._pages()
            assert pages.ndim == 2 and pages.shape[1] == PAGE_SIZE
            self._pages = pages
        return self._pages

    @pages.setter
    def pages(self, value: np.ndarray) -> None:
        self._pages = value


#: first decodes of tables (``ColumnarTable.to_host``), striped by id
_DECODE_LOCKS = [threading.Lock() for _ in range(16)]


@dataclasses.dataclass
class ColumnarTable:
    num_rows: int = 0
    columns: List[Column] = dataclasses.field(default_factory=list)
    #: decoded-form memo; engine treats host tables as immutable. Mirrors
    #: the reference harness's unfiltered-result cache (build_table.cpp:91-92)
    #: at the table level: page decode runs once per distinct table, not
    #: once per query.
    _host: Optional["HostTable"] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def copy(self) -> "ColumnarTable":
        # not-yet-encoded lazy columns share the encode thunk (the engine
        # treats pages as immutable; the deep copy below exists for
        # reference cache-hit parity, build_table.cpp:121-133)
        return ColumnarTable(
            self.num_rows,
            [
                Column(
                    c.type,
                    c._pages if callable(c._pages) else c.pages.copy(),
                )
                for c in self.columns
            ],
            _host=self._host,  # pages are copied bit-identical
        )

    # -- conversions ---------------------------------------------------------

    @staticmethod
    def from_host(table: "HostTable", lazy: bool = False) -> "ColumnarTable":
        # column-parallel page encode (reference: to_columnar drives
        # per-column save_page tasks through filter_tp,
        # build_table.cpp:438-681); fixed-width columns use the
        # row-aligned layout (storage/device_decode.py) so scans can
        # upload raw pages and decode on device — still standard pages,
        # any decoder accepts them
        def enc_pages(c: "HostColumn") -> np.ndarray:
            if c.dtype is DataType.VARCHAR:
                return page_codec.encode_varchar_heap(c.heap, c.ends, c.valid)
            return device_decode.encode_fixed_aligned(c.values, c.valid, c.dtype)

        if lazy:
            import functools

            cols = [
                Column(c.dtype, functools.partial(enc_pages, c))
                for c in table.columns
            ]
            return ColumnarTable(table.num_rows, cols, _host=table)
        cols = host_pool.parallel_map(
            lambda c: Column(c.dtype, enc_pages(c)), table.columns
        )
        return ColumnarTable(table.num_rows, cols, _host=table)

    def to_host(self) -> "HostTable":
        if self._host is not None:
            return self._host

        # column-parallel page decode (reference: Table::from_columnar
        # fans columns out over filter_tp, build_table.cpp:306-436)
        def dec(c: Column) -> "HostColumn":
            if c.type is DataType.VARCHAR:
                heap, ends, valid = page_codec.decode_varchar_heap(
                    c.pages, self.num_rows
                )
                return HostColumn.varchar(heap, ends, valid)
            values, valid = page_codec.decode_fixed(c.pages, self.num_rows, c.type)
            return HostColumn(c.type, values, valid)

        # threads asking at once share one decode: the engine keys device
        # uploads by the host column objects, so two twins would upload twice
        with _DECODE_LOCKS[id(self) % len(_DECODE_LOCKS)]:
            if self._host is None:
                self._host = HostTable(
                    self.num_rows, host_pool.parallel_map(dec, self.columns)
                )
        return self._host


@dataclasses.dataclass
class HostTable:
    num_rows: int
    columns: List[HostColumn]

    @property
    def num_cols(self) -> int:
        return len(self.columns)

    # -- row-level helpers (tests / oracle only) -----------------------------

    @staticmethod
    def from_rows(rows: Sequence[Sequence], types: Sequence[DataType]) -> "HostTable":
        n = len(rows)
        cols = []
        for j, dt in enumerate(types):
            valid = np.zeros(n, dtype=bool)
            if dt is DataType.VARCHAR:
                values = np.empty(n, dtype=object)
                values[:] = b""
                for i, row in enumerate(rows):
                    v = row[j]
                    if not is_null(v):
                        valid[i] = True
                        values[i] = v.encode("latin-1") if isinstance(v, str) else bytes(v)
                cols.append(HostColumn(DataType.VARCHAR, values, valid))
            else:
                values = np.zeros(n, dtype=dt.numpy_dtype)
                for i, row in enumerate(rows):
                    v = row[j]
                    if not is_null(v):
                        valid[i] = True
                        values[i] = v
                cols.append(HostColumn(DataType(dt), values, valid))
        return HostTable(n, cols)

    def to_rows(self) -> List[tuple]:
        cols = []
        for c in self.columns:
            if c.dtype is DataType.VARCHAR:
                cols.append(c.objects())
            else:
                cols.append(c.values)
        out = []
        for i in range(self.num_rows):
            row = []
            for c, vals in zip(self.columns, cols):
                if not c.valid[i]:
                    row.append(NULL)
                elif c.dtype is DataType.VARCHAR:
                    row.append(bytes(vals[i]))
                elif c.dtype is DataType.FP64:
                    row.append(float(vals[i]))
                else:
                    row.append(int(vals[i]))
            out.append(tuple(row))
        return out

    def type_signature(self) -> List[DataType]:
        return [c.dtype for c in self.columns]

    def pretty(self, max_rows: int = 20) -> str:
        """Human-readable table dump for debugging (reference
        ``Table::print``, include/table.h:38-79): one aligned row per
        line, ``NULL`` for invalid cells, truncated past ``max_rows``."""
        head = [c.dtype.name for c in self.columns]
        rows = self.to_rows()[:max_rows]
        body = [
            [
                "NULL" if is_null(v)
                else v.decode("latin-1", "replace") if isinstance(v, bytes)
                else str(v)
                for v in r
            ]
            for r in rows
        ]
        widths = [
            max(len(head[j]), *(len(b[j]) for b in body)) if body else len(head[j])
            for j in range(len(head))
        ]
        lines = ["  ".join(h.ljust(w) for h, w in zip(head, widths))]
        for b in body:
            lines.append("  ".join(v.ljust(w) for v, w in zip(b, widths)))
        if self.num_rows > max_rows:
            lines.append(f"... ({self.num_rows - max_rows} more rows)")
        return "\n".join(lines)


def sorted_rows(rows: List[tuple]) -> List[tuple]:
    def k(row):
        out = []
        for v in row:
            if is_null(v):
                out.append((2, 0))
            elif isinstance(v, bytes):
                out.append((1, v))
            else:
                out.append((0, v))
        return out

    return sorted(rows, key=k)
