"""Native runtime loader.

Compiles ``_native.cpp`` with g++ on first use (cached in the package's
``_build`` directory, keyed by source hash) and exposes numpy-facing
wrappers. Every entry point has a pure-Python fallback in the package, so
a missing toolchain degrades performance, not correctness: ``lib()``
returns None when unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "_native.cpp")
#: build outputs stay out of the source tree (listed in .gitignore)
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")

_lock = threading.Lock()
_lib = None
_lib_failed = False

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_I32 = np.iinfo(np.int32)


def _ptr(arr: np.ndarray, typ):
    return arr.ctypes.data_as(typ)


def _build() -> Optional[ctypes.CDLL]:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"_native_{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            "-pthread", _SRC, "-o", tmp,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, so_path)
        except (subprocess.CalledProcessError, OSError) as e:
            msg = getattr(e, "stderr", b"")
            print(
                f"radixjoin_tpu_torch: native build failed ({e}): "
                f"{msg[:500] if msg else ''} — using pure-Python fallbacks",
                file=sys.stderr,
            )
            return None
    lib = ctypes.CDLL(so_path)

    lib.rjt_decode_fixed.restype = ctypes.c_int64
    lib.rjt_decode_fixed.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        _u8p, _u8p,
    ]
    lib.rjt_count_pages_fixed.restype = ctypes.c_int64
    lib.rjt_count_pages_fixed.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.rjt_encode_fixed.restype = ctypes.c_int64
    lib.rjt_encode_fixed.argtypes = [
        _u8p, _u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, _u8p,
        ctypes.c_int64,
    ]
    lib.rjt_decode_varchar_scan.restype = ctypes.c_int64
    lib.rjt_decode_varchar_scan.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64, _u8p, _i64p,
    ]
    lib.rjt_decode_varchar_fill.restype = ctypes.c_int64
    lib.rjt_decode_varchar_fill.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64, _u8p]
    lib.rjt_count_pages_varchar.restype = ctypes.c_int64
    lib.rjt_count_pages_varchar.argtypes = [_u8p, _i64p, _u8p, ctypes.c_int64]
    lib.rjt_encode_varchar.restype = ctypes.c_int64
    lib.rjt_encode_varchar.argtypes = [
        _u8p, _i64p, _u8p, ctypes.c_int64, _u8p, ctypes.c_int64,
    ]
    lib.rjt_gather_varlen.restype = None
    lib.rjt_gather_varlen.argtypes = [
        _u8p, _i64p, _i64p, ctypes.c_int64, _i64p, _u8p,
    ]
    lib.rjt_dict_decode_ends.restype = ctypes.c_int64
    lib.rjt_dict_decode_ends.argtypes = [
        _i64p, ctypes.c_int64, _i32p, _u8p, ctypes.c_int64, _i64p,
    ]
    lib.rjt_dict_decode_fill.restype = None
    lib.rjt_dict_decode_fill.argtypes = [
        _u8p, _i64p, ctypes.c_int64, _i32p, _i64p, ctypes.c_int64, _u8p,
    ]
    lib.rjt_like.restype = None
    lib.rjt_like.argtypes = [
        _u8p, _i64p, _u8p, ctypes.c_int64, _u8p, ctypes.c_int64,
        ctypes.c_int32, _u8p,
    ]
    lib.rjt_str_compare.restype = None
    lib.rjt_str_compare.argtypes = [
        _u8p, _i64p, _u8p, ctypes.c_int64, _u8p, ctypes.c_int64,
        ctypes.c_int32, _u8p,
    ]
    lib.rjt_dict_build.restype = ctypes.c_void_p
    lib.rjt_dict_build.argtypes = [_u8p, _i64p, _u8p, ctypes.c_int64, _i32p]
    lib.rjt_dict_size.restype = ctypes.c_int64
    lib.rjt_dict_size.argtypes = [ctypes.c_void_p]
    lib.rjt_dict_heap_bytes.restype = ctypes.c_int64
    lib.rjt_dict_heap_bytes.argtypes = [ctypes.c_void_p]
    lib.rjt_dict_export.restype = None
    lib.rjt_dict_export.argtypes = [ctypes.c_void_p, _u8p, _i64p]
    lib.rjt_dict_free.restype = None
    lib.rjt_dict_free.argtypes = [ctypes.c_void_p]
    lib.rjt_csv_parse.restype = ctypes.c_void_p
    lib.rjt_csv_parse.argtypes = [ctypes.c_char_p, ctypes.c_int32, _i32p]
    lib.rjt_csv_rows.restype = ctypes.c_int64
    lib.rjt_csv_rows.argtypes = [ctypes.c_void_p]
    lib.rjt_csv_error.restype = ctypes.c_char_p
    lib.rjt_csv_error.argtypes = [ctypes.c_void_p]
    lib.rjt_csv_get_fixed.restype = None
    lib.rjt_csv_get_fixed.argtypes = [ctypes.c_void_p, ctypes.c_int32, _u8p, _u8p]
    lib.rjt_csv_heap_bytes.restype = ctypes.c_int64
    lib.rjt_csv_heap_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.rjt_csv_get_varchar.restype = None
    lib.rjt_csv_get_varchar.argtypes = [ctypes.c_void_p, ctypes.c_int32, _u8p, _i64p, _u8p]
    lib.rjt_csv_free.restype = None
    lib.rjt_csv_free.argtypes = [ctypes.c_void_p]
    return lib


def lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is None and not _lib_failed:
        with _lock:
            if _lib is None and not _lib_failed:
                built = _build()
                if built is None:
                    _lib_failed = True
                else:
                    _lib = built
    return _lib


# ---------------------------------------------------------------------------
# numpy-facing wrappers (return None when native lib is unavailable)
# ---------------------------------------------------------------------------


def decode_fixed(pages: np.ndarray, num_rows: int, esize: int, dbegin: int):
    L = lib()
    if L is None:
        return None
    pages = np.ascontiguousarray(pages)
    values = np.empty(num_rows * esize, dtype=np.uint8)
    valid = np.empty(num_rows, dtype=np.uint8)
    rows = L.rjt_decode_fixed(
        _ptr(pages, _u8p), pages.shape[0], num_rows, esize, dbegin,
        _ptr(values, _u8p), _ptr(valid, _u8p),
    )
    if rows != num_rows:
        raise ValueError(f"native decode_fixed failed ({rows} != {num_rows})")
    return values, valid.view(bool)


def encode_fixed(values: np.ndarray, valid: np.ndarray, esize: int, dbegin: int):
    L = lib()
    if L is None:
        return None
    raw = np.ascontiguousarray(values).view(np.uint8).reshape(-1)
    v8 = np.ascontiguousarray(valid, dtype=np.uint8)
    n = len(valid)
    n_pages = L.rjt_count_pages_fixed(_ptr(v8, _u8p), n, esize, dbegin)
    pages = np.empty((n_pages, 8192), dtype=np.uint8)
    got = L.rjt_encode_fixed(
        _ptr(raw, _u8p), _ptr(v8, _u8p), n, esize, dbegin,
        _ptr(pages, _u8p), n_pages,
    )
    if got != n_pages:
        raise ValueError("native encode_fixed page count mismatch")
    return pages


def decode_varchar(pages: np.ndarray, num_rows: int):
    L = lib()
    if L is None:
        return None
    pages = np.ascontiguousarray(pages)
    valid = np.empty(num_rows, dtype=np.uint8)
    lengths = np.empty(num_rows, dtype=np.int64)
    total = L.rjt_decode_varchar_scan(
        _ptr(pages, _u8p), pages.shape[0], num_rows,
        _ptr(valid, _u8p), _ptr(lengths, _i64p),
    )
    if total < 0:
        raise ValueError("native decode_varchar: malformed pages")
    heap = np.empty(total, dtype=np.uint8)
    filled = L.rjt_decode_varchar_fill(
        _ptr(pages, _u8p), pages.shape[0], num_rows, _ptr(heap, _u8p)
    )
    if filled != total:
        raise ValueError("native decode_varchar fill mismatch")
    ends = np.cumsum(lengths)
    return heap, ends, valid.view(bool)


def gather_varlen(heap, starts, lengths, new_ends, total: int):
    """Concatenating substring gather (see columnar.gather_varlen).
    Returns the new heap, or None when the native lib is unavailable."""
    L = lib()
    if L is None:
        return None
    heap = np.ascontiguousarray(heap, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    new_ends = np.ascontiguousarray(new_ends, dtype=np.int64)
    out = np.empty(total, dtype=np.uint8)
    L.rjt_gather_varlen(
        _ptr(heap, _u8p), _ptr(starts, _i64p), _ptr(lengths, _i64p),
        ctypes.c_int64(len(lengths)), _ptr(new_ends, _i64p), _ptr(out, _u8p),
    )
    return out


def dict_decode(heap, ends, ids, valid):
    """The strings that dictionary ``ids`` name, as ``(heap, ends)``: each id
    clipped to the dictionary, an invalid row empty (see
    ``StringDict.decode``). Two passes over the rows, a large column's cut
    into parts on up to four threads; nothing scales with the dictionary.
    None when the native lib is unavailable."""
    L = lib()
    if L is None:
        return None
    heap = np.ascontiguousarray(heap, dtype=np.uint8)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    if ids.dtype != np.int32:  # the device column's ids are int32 already
        # saturate to int32; the C passes clip to the dictionary
        ids = np.clip(ids, _I32.min, _I32.max).astype(np.int32)
    ids = np.ascontiguousarray(ids)
    v8 = np.ascontiguousarray(valid, dtype=bool).view(np.uint8)
    n = len(v8)
    if len(ids) != n:
        raise ValueError(f"dict_decode: {len(ids)} ids for {n} rows")
    out_ends = np.empty(n, dtype=np.int64)
    total = L.rjt_dict_decode_ends(
        _ptr(ends, _i64p), len(ends), _ptr(ids, _i32p), _ptr(v8, _u8p), n,
        _ptr(out_ends, _i64p),
    )
    out = np.empty(total, dtype=np.uint8)
    if total:
        L.rjt_dict_decode_fill(
            _ptr(heap, _u8p), _ptr(ends, _i64p), len(ends), _ptr(ids, _i32p),
            _ptr(out_ends, _i64p), n, _ptr(out, _u8p),
        )
    return out, out_ends


def encode_varchar(heap: np.ndarray, ends: np.ndarray, valid: np.ndarray):
    L = lib()
    if L is None:
        return None
    heap = np.ascontiguousarray(heap, dtype=np.uint8)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    v8 = np.ascontiguousarray(valid, dtype=np.uint8)
    n = len(valid)
    n_pages = L.rjt_count_pages_varchar(
        _ptr(heap, _u8p), _ptr(ends, _i64p), _ptr(v8, _u8p), n
    )
    if n_pages < 0:
        raise ValueError("native count_pages_varchar failed")
    pages = np.empty((n_pages, 8192), dtype=np.uint8)
    got = L.rjt_encode_varchar(
        _ptr(heap, _u8p), _ptr(ends, _i64p), _ptr(v8, _u8p), n,
        _ptr(pages, _u8p), n_pages,
    )
    if got != n_pages:
        raise ValueError("native encode_varchar page count mismatch")
    return pages


def like(heap, ends, valid, pattern: bytes, negate: bool):
    L = lib()
    if L is None:
        return None
    heap = np.ascontiguousarray(heap, dtype=np.uint8)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    v8 = np.ascontiguousarray(valid, dtype=np.uint8)
    n = len(valid)
    out = np.empty(n, dtype=np.uint8)
    pat = np.frombuffer(pattern, dtype=np.uint8) if pattern else np.zeros(0, np.uint8)
    L.rjt_like(
        _ptr(heap, _u8p), _ptr(ends, _i64p), _ptr(v8, _u8p), n,
        _ptr(pat, _u8p), len(pattern), 1 if negate else 0, _ptr(out, _u8p),
    )
    return out.view(bool)


_STR_OPS = {"EQ": 0, "NEQ": 1, "LT": 2, "GT": 3, "LEQ": 4, "GEQ": 5}


def str_compare(heap, ends, valid, literal: bytes, op_name: str):
    L = lib()
    if L is None:
        return None
    heap = np.ascontiguousarray(heap, dtype=np.uint8)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    v8 = np.ascontiguousarray(valid, dtype=np.uint8)
    n = len(valid)
    out = np.empty(n, dtype=np.uint8)
    lit = np.frombuffer(literal, dtype=np.uint8) if literal else np.zeros(0, np.uint8)
    L.rjt_str_compare(
        _ptr(heap, _u8p), _ptr(ends, _i64p), _ptr(v8, _u8p), n,
        _ptr(lit, _u8p), len(literal), _STR_OPS[op_name], _ptr(out, _u8p),
    )
    return out.view(bool)


def dict_encode(heap, ends, valid):
    """Sorted-unique dictionary over heap+ends. Returns (ids, dict_heap, dict_ends)."""
    L = lib()
    if L is None:
        return None
    heap = np.ascontiguousarray(heap, dtype=np.uint8)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    v8 = np.ascontiguousarray(valid, dtype=np.uint8)
    n = len(valid)
    ids = np.empty(n, dtype=np.int32)
    h = L.rjt_dict_build(
        _ptr(heap, _u8p), _ptr(ends, _i64p), _ptr(v8, _u8p), n, _ptr(ids, _i32p)
    )
    try:
        size = L.rjt_dict_size(h)
        nbytes = L.rjt_dict_heap_bytes(h)
        dheap = np.empty(nbytes, dtype=np.uint8)
        dends = np.empty(size, dtype=np.int64)
        L.rjt_dict_export(h, _ptr(dheap, _u8p), _ptr(dends, _i64p))
    finally:
        L.rjt_dict_free(h)
    return ids, dheap, dends


def parse_csv(path: str, type_codes) -> Optional[Tuple]:
    """Parse a CSV; returns list of per-column (kind, arrays...) or None.

    kind 'fixed': (values uint8 raw, valid); 'varchar': (heap, ends, valid).
    """
    L = lib()
    if L is None:
        return None
    codes = np.asarray(type_codes, dtype=np.int32)
    h = L.rjt_csv_parse(path.encode(), len(codes), _ptr(codes, _i32p))
    try:
        err = L.rjt_csv_error(h)
        if err:
            raise ValueError(f"native csv parse {path}: {err.decode()}")
        rows = L.rjt_csv_rows(h)
        out = []
        sizes = {0: 4, 1: 8, 2: 8}
        for col, code in enumerate(codes):
            valid = np.empty(rows, dtype=np.uint8)
            if code == 3:
                nbytes = L.rjt_csv_heap_bytes(h, col)
                heap = np.empty(nbytes, dtype=np.uint8)
                ends = np.empty(rows, dtype=np.int64)
                L.rjt_csv_get_varchar(
                    h, col, _ptr(heap, _u8p), _ptr(ends, _i64p), _ptr(valid, _u8p)
                )
                out.append(("varchar", heap, ends, valid.view(bool)))
            else:
                values = np.empty(rows * sizes[int(code)], dtype=np.uint8)
                L.rjt_csv_get_fixed(h, col, _ptr(values, _u8p), _ptr(valid, _u8p))
                out.append(("fixed", values, valid.view(bool)))
        return rows, out
    finally:
        L.rjt_csv_free(h)
