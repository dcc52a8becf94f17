"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

The join engine's three TPU kernels (radixjoin_tpu/ops/pallas_kernels.py)
become CUDA C++ for Hopper (``sm_90a``), in ``radixjoin_tpu_torch/csrc``:

* :func:`window_gather` (``csrc/window_gather.cu``) — lookups into up to
  ``WINDOW_GATHER_MAX``-entry tables sharing one index stream;
* :func:`blocked_window_gather_multi` (``csrc/blocked_window_gather.cu``) —
  lookups on a monotone index stream through 2048-entry block windows;
* :func:`paged_window_gather` (``csrc/paged_window_gather.cu``) — the
  per-page realignment of the device page decode.

The sources are compiled with ``nvcc`` into one shared library at first
use (into the package's ``_build`` directory, keyed by a hash of the
sources) and called through ``ctypes`` on PyTorch's current stream.

Every wrapper checks its arguments the same way on every device. It then
takes the plain PyTorch version for tensors on the CPU, and only there;
for CUDA tensors it launches its kernel or raises. Each wrapper counts its
kernel launches in its ``launches`` attribute (see :func:`launch_counts`).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence, Tuple

import torch

#: largest table :func:`window_gather` takes (the TPU route's bound)
WINDOW_GATHER_MAX = 4096
#: outputs per block window of :func:`blocked_window_gather_multi`
BWG_BLK = 1024
#: window alignment unit; each block covers two units
BWG_WIN = 1024

_MAX_TABLES = 8  # RJT_MAX_TABLES in csrc/gather_common.cuh
#: shared memory one launch may stage; more tables split into more launches
_SMEM_CAP = 96 * 1024

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "_build")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
#: what the last build did: library path, seconds, and ptxas' report
BUILD_INFO: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of radixjoin_tpu_torch are built "
        "from csrc/ at first use and need the CUDA toolkit"
    )


def build() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
        h = hashlib.sha256(repr(_NVCC_FLAGS).encode())
        for f in sorted(glob.glob(os.path.join(_CSRC, "*.cu*"))):
            h.update(os.path.basename(f).encode())
            with open(f, "rb") as fh:
                h.update(fh.read())
        so = os.path.join(_BUILD_DIR, f"libkernels_{h.hexdigest()[:16]}.so")
        t0 = time.perf_counter()
        log = ""
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.tmp{os.getpid()}"
            proc = subprocess.run(
                [_nvcc(), *_NVCC_FLAGS, "-o", tmp, *srcs],
                capture_output=True, text=True,
            )
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{log[-4000:]}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rjt_window_gather.restype = i32
        lib.rjt_window_gather.argtypes = [
            i32, i32, i32, vp, vp, i32, vp, i64, i32, i32, vp,
        ]
        lib.rjt_blocked_window_gather.restype = i32
        lib.rjt_blocked_window_gather.argtypes = [
            i32, i32, i32, vp, vp, vp, vp, i64, i64, vp, vp,
        ]
        lib.rjt_paged_window_gather.restype = i32
        lib.rjt_paged_window_gather.argtypes = [
            i32, vp, vp, vp, i64, i32, i32, i32, vp,
        ]
        BUILD_INFO.update(
            path=so, seconds=time.perf_counter() - t0, log=log,
        )
        _lib = lib
        return lib


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


# ---------------------------------------------------------------------------
# shared argument handling
# ---------------------------------------------------------------------------


def _check_index(idx: torch.Tensor, ndim: int, name: str) -> None:
    if idx.dtype != torch.int32 or idx.dim() != ndim:
        raise TypeError(f"{name}: index must be a {ndim}-D int32 tensor, got "
                        f"{idx.dtype} with shape {tuple(idx.shape)}")
    if not idx.is_contiguous():
        raise ValueError(f"{name}: index must be contiguous")


def _check_tables(tables: Sequence[torch.Tensor], device, name: str) -> None:
    if not tables:
        raise ValueError(f"{name}: no tables")
    for t in tables:
        if t.dim() != 1 or t.shape[0] == 0:
            raise ValueError(f"{name}: tables must be non-empty 1-D tensors")
        if t.device != device:
            raise ValueError(f"{name}: table on {t.device}, index on {device}")
        if t.element_size() not in (1, 4, 8):
            raise TypeError(f"{name}: unsupported table dtype {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tables must be contiguous")


def _cuda_or_raise(device: torch.device, name: str) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, not {device}")


def _launch_groups(tables, staged: int) -> List[Tuple[int, List[int]]]:
    """Split table positions into launches: one element size per launch,
    at most ``_MAX_TABLES`` tables and ``_SMEM_CAP`` bytes of shared memory
    for their ``staged`` entries each. Returns
    ``[(elem_bytes, [table positions]), ...]``."""
    by_size: Dict[int, List[int]] = {}
    for i, t in enumerate(tables):
        by_size.setdefault(t.element_size(), []).append(i)
    out = []
    for eb, members in sorted(by_size.items()):
        per = max(1, min(_MAX_TABLES, _SMEM_CAP // (staged * eb)))
        for s in range(0, len(members), per):
            out.append((eb, members[s:s + per]))
    return out


def _ptr_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * _MAX_TABLES)(*[t.data_ptr() for t in tensors])


def _raw(t: torch.Tensor) -> torch.Tensor:
    """Byte-for-byte view the kernels copy (bool travels as uint8)."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


_SM_COUNT: Dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    i = _index(device)
    if i not in _SM_COUNT:
        _SM_COUNT[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SM_COUNT[i]


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


# ---------------------------------------------------------------------------
# window_gather
# ---------------------------------------------------------------------------


def window_gather_plain(tables, idx: torch.Tensor) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`window_gather`."""
    w = tables[0].shape[0]
    pos = idx.clamp(0, w - 1)
    return [t.index_select(0, pos) for t in tables]


def window_gather(tables, idx: torch.Tensor) -> List[torch.Tensor]:
    """``[t[idx] for t in tables]`` for tables of equal length
    ``w <= WINDOW_GATHER_MAX`` sharing one int32 index stream, which the
    caller has clamped to ``[0, w)``. Any 1-, 4- or 8-byte dtype (int32,
    int64 and bool columns gather natively).

    Staging limit: one launch holds at most 8 tables and 96 KB of them in
    shared memory (three int64 tables of 4096 entries); longer lists are
    split into several launches over the same index stream."""
    tables = list(tables)
    name = "window_gather"
    _check_index(idx, 1, name)
    _check_tables(tables, idx.device, name)
    w = tables[0].shape[0]
    if w > WINDOW_GATHER_MAX or any(t.shape[0] != w for t in tables):
        raise ValueError(f"{name}: tables must share one length <= "
                         f"{WINDOW_GATHER_MAX}")
    if idx.device.type == "cpu":
        return window_gather_plain(tables, idx)
    _cuda_or_raise(idx.device, name)
    lib = build()
    n = idx.shape[0]
    outs = [torch.empty(n, dtype=t.dtype, device=t.device) for t in tables]
    if n == 0:
        return outs
    block = 1024
    grid = max(1, min(-(-n // (block * 4)), 2 * _sm_count(idx.device)))
    dev = _index(idx.device)
    for eb, members in _launch_groups(tables, w):
        ins = _ptr_array([_raw(tables[i]) for i in members])
        dst = _ptr_array([_raw(outs[i]) for i in members])
        rc = lib.rjt_window_gather(
            dev, eb, len(members), ins, dst, w, idx.data_ptr(), n,
            grid, block, _stream(idx.device),
        )
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
        window_gather.launches += 1
    return outs


# ---------------------------------------------------------------------------
# blocked_window_gather_multi
# ---------------------------------------------------------------------------


def _block_window_ok(idx: torch.Tensor, longest: int) -> torch.Tensor:
    """The TPU kernel's window-hit flag: per block of ``BWG_BLK`` outputs,
    window start ``clip(min(idx) // BWG_WIN, 0, kmax - 1) * BWG_WIN`` over
    ``2 * BWG_WIN`` entries. The ragged tail is edge-padded, as there."""
    n = idx.shape[0]
    kmax = -(-longest // BWG_WIN)
    nb = -(-n // BWG_BLK)
    i64 = idx.long()
    tail = nb * BWG_BLK - n
    padded = torch.cat([i64, i64[-1:].expand(tail)]) if tail else i64
    blo = padded.view(nb, BWG_BLK).amin(dim=1)
    kblk = torch.div(blo, BWG_WIN, rounding_mode="floor").clamp(0, max(kmax - 1, 0))
    base = (kblk * BWG_WIN).repeat_interleave(BWG_BLK)[:n]
    rel = i64 - base
    return ((rel >= 0) & (rel < 2 * BWG_WIN)).to(torch.int32)


def blocked_window_gather_multi_plain(tables, idx: torch.Tensor):
    """Plain PyTorch version of :func:`blocked_window_gather_multi`."""
    n = idx.shape[0]
    if n == 0:
        return [t[:0].clone() for t in tables], idx.new_zeros(0)
    ok = _block_window_ok(idx, max(t.shape[0] for t in tables))
    i64 = idx.long()
    vals = []
    for t in tables:
        length = t.shape[0]
        g = t.index_select(0, i64.clamp(0, length - 1))
        # an in-window row past a shorter table's end reads the zero pad
        vals.append(torch.where((ok != 0) & (i64 >= length),
                                torch.zeros((), dtype=t.dtype), g))
    return vals, ok


def blocked_window_gather_multi(tables, idx: torch.Tensor):
    """``(vals, ok)``: ``vals[t][j] = tables[t][idx[j]]`` for every row and
    ``ok[j] = 1`` where ``idx[j]`` fell in its block's 2048-entry window
    (the TPU kernel's flag, bit for bit). ``idx`` is int32, clamped to
    ``[0, len(t))`` by the caller and block-windowed (monotone) for the
    window to pay; missed rows are read from device memory inside the
    kernel, so no host sync and no second pass is needed. Tables may
    differ in length and dtype (1, 4 or 8 bytes).

    Staging limit: one launch holds at most 8 tables and 96 KB of windows
    (six int64 tables); longer lists are split into several launches over
    the same index stream, and only the first writes ``ok``."""
    tables = list(tables)
    name = "blocked_window_gather_multi"
    _check_index(idx, 1, name)
    _check_tables(tables, idx.device, name)
    if idx.device.type == "cpu":
        return blocked_window_gather_multi_plain(tables, idx)
    _cuda_or_raise(idx.device, name)
    lib = build()
    n = idx.shape[0]
    outs = [torch.empty(n, dtype=t.dtype, device=t.device) for t in tables]
    ok = torch.empty(n, dtype=torch.int32, device=idx.device)
    if n == 0:
        return outs, ok
    kmax = -(-max(t.shape[0] for t in tables) // BWG_WIN)
    dev = _index(idx.device)
    ok_ptr = ok.data_ptr()
    for eb, members in _launch_groups(tables, 2 * BWG_WIN):
        ins = _ptr_array([_raw(tables[i]) for i in members])
        dst = _ptr_array([_raw(outs[i]) for i in members])
        lens = (ctypes.c_longlong * _MAX_TABLES)(
            *[tables[i].shape[0] for i in members]
        )
        rc = lib.rjt_blocked_window_gather(
            dev, eb, len(members), ins, dst, lens, idx.data_ptr(), n,
            kmax, ok_ptr, _stream(idx.device),
        )
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
        blocked_window_gather_multi.launches += 1
        ok_ptr = None
    return outs, ok


# ---------------------------------------------------------------------------
# paged_window_gather
# ---------------------------------------------------------------------------


def paged_window_gather_plain(body: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`paged_window_gather`."""
    return body.gather(1, idx.long().clamp(0, body.shape[1] - 1))


def paged_window_gather(body: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[p, r] = body[p, idx[p, r]]``: the per-page gather of the device
    page decode. ``body`` is (npages, w) int32 with w <= 12288 (one page in
    shared memory; a page is 2048 words), ``idx`` (npages, Ro) int32 in
    ``[0, w)``."""
    name = "paged_window_gather"
    _check_index(idx, 2, name)
    if body.dtype != torch.int32 or body.dim() != 2 or not body.is_contiguous():
        raise TypeError(f"{name}: body must be a contiguous 2-D int32 tensor")
    if body.device != idx.device or body.shape[0] != idx.shape[0]:
        raise ValueError(f"{name}: body and index disagree in device or pages")
    npages, w = body.shape
    if not 0 < w <= 12288:
        raise ValueError(f"{name}: page width {w} out of range")
    if idx.device.type == "cpu":
        return paged_window_gather_plain(body, idx)
    _cuda_or_raise(idx.device, name)
    lib = build()
    ro = idx.shape[1]
    out = torch.empty((npages, ro), dtype=torch.int32, device=idx.device)
    if npages == 0 or ro == 0:
        return out
    dev = _index(idx.device)
    rc = lib.rjt_paged_window_gather(
        dev, body.data_ptr(), idx.data_ptr(), out.data_ptr(), npages, w, ro,
        256, _stream(idx.device),
    )
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    paged_window_gather.launches += 1
    return out


_WRAPPERS = (window_gather, blocked_window_gather_multi, paged_window_gather)
reset_launch_counts()
