"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

The join engine's three TPU kernels (radixjoin_tpu/ops/pallas_kernels.py)
become CUDA C++ for Hopper (``sm_90a``), in ``radixjoin_tpu_torch/csrc``:

* :func:`window_gather` (``csrc/window_gather.cu``) — lookups into small
  tables sharing one index stream;
* :func:`blocked_window_gather_multi` (``csrc/blocked_window_gather.cu``) —
  lookups on a monotone index stream through 2048-entry block windows;
* :func:`paged_window_gather` (``csrc/paged_window_gather.cu``) — the
  per-page realignment of the device page decode.

The four kernels of the in-kernel gather experiments (``tools/``) follow:

* :func:`pallas_gather`, :func:`gather_pallas_vmem` and :func:`mk_gather`
  (one source, ``csrc/resident_gather.cu``) — gathers from a table held on
  chip, one wrapper per TPU function with its bodies as ``body=``;
* :func:`onehot_gather` (``csrc/onehot_gather.cu``) — the gather written
  as a one-hot product.

Each source is compiled with its own ``nvcc`` into a shared library at
first use (all sources at once, into the package's ``_build`` directory,
keyed by a hash of the source and the shared header) and called through
``ctypes`` on PyTorch's current stream.

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
import types
from typing import Dict, List, Sequence, Tuple

import torch

#: largest table the join engine routes to :func:`window_gather`
WINDOW_GATHER_MAX = 4096
#: largest table :func:`window_gather` takes (one int32 table is 64 KiB of
#: shared memory; the device-time harness measures up to this size)
WINDOW_GATHER_TABLE_MAX = 16384
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

_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C entry points and their argument types (each defined in one source)
_SIGNATURES = {
    "rjt_window_gather": [_I32, _I32, _I32, _VP, _VP, _I32, _VP, _I64,
                          _I32, _I32, _VP],
    "rjt_blocked_window_gather": [_I32, _I32, _I32, _VP, _VP, _VP, _VP,
                                  _I64, _I64, _VP, _VP],
    "rjt_paged_window_gather": [_I32, _VP, _VP, _VP, _I64, _I32, _I32,
                                _I32, _VP],
    "rjt_resident_gather": [_I32, _I32, _I32, _VP, _I64, _VP, _VP, _I64,
                            _I32, _I32, _I32, _VP],
    "rjt_onehot_gather": [_I32, _VP, _I32, _VP, _VP, _I64, _I32, _VP],
}

_lock = threading.Lock()
_lib = None
#: what the last build did: library paths, seconds, and ptxas' report
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


def build():
    """Build (once per source hash) and load the kernel libraries: one
    ``nvcc`` process per source, all started together. Returns a namespace
    of the bound C entry points."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        common = hashlib.sha256(repr(_NVCC_FLAGS).encode())
        for f in sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
            with open(f, "rb") as fh:
                common.update(fh.read())
        t0 = time.perf_counter()
        os.makedirs(_BUILD_DIR, exist_ok=True)
        jobs = []
        for src in sorted(glob.glob(os.path.join(_CSRC, "*.cu"))):
            h = common.copy()
            with open(src, "rb") as fh:
                h.update(fh.read())
            stem = os.path.splitext(os.path.basename(src))[0]
            so = os.path.join(_BUILD_DIR,
                              f"lib{stem}_{h.hexdigest()[:16]}.so")
            proc = None
            if not os.path.exists(so):
                proc = subprocess.Popen(
                    [_nvcc(), *_NVCC_FLAGS, "-o", f"{so}.tmp{os.getpid()}",
                     src],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )
            jobs.append((src, so, proc))
        logs, failed = [], []
        for src, so, proc in jobs:
            if proc is None:
                continue
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)}:\n{out[-4000:]}")
            else:
                os.replace(f"{so}.tmp{os.getpid()}", so)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = types.SimpleNamespace()
        for _src, so, _proc in jobs:
            cdll = ctypes.CDLL(so)
            for name, argtypes in _SIGNATURES.items():
                if hasattr(cdll, name):
                    fn = getattr(cdll, name)
                    fn.restype, fn.argtypes = _I32, argtypes
                    setattr(lib, name, fn)
        missing = [n for n in _SIGNATURES if not hasattr(lib, n)]
        if missing:
            raise RuntimeError(f"kernel libraries lack {missing}")
        BUILD_INFO.update(
            paths=[so for _s, so, _p in jobs],
            seconds=time.perf_counter() - t0, log="".join(logs),
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
    ``w <= WINDOW_GATHER_TABLE_MAX`` sharing one int32 index stream, which the
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
    if w > WINDOW_GATHER_TABLE_MAX or any(t.shape[0] != w for t in tables):
        raise ValueError(f"{name}: tables must share one length <= "
                         f"{WINDOW_GATHER_TABLE_MAX}")
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


# ---------------------------------------------------------------------------
# resident gathers: pallas_gather, gather_pallas_vmem, mk_gather
# ---------------------------------------------------------------------------

#: index maps of csrc/resident_gather.cu (RjtMap)
_MAPS = {"full": 0, "lane": 1, "row": 2, "sublane": 3}
#: body of each TPU function -> (index map, table is 2-D (w / 128, 128))
_PALLAS_GATHER_BODIES = {"take": ("full", False),
                         "take_unique": ("full", False),
                         "ta_lanes": ("lane", True)}
_MK_BODIES = {"rows": ("row", True), "lanes": ("lane", True),
              "2level": ("full", True), "sub": ("sublane", True)}


def resident_gather_plain(table: torch.Tensor, idx: torch.Tensor, mode: str,
                          blk: int) -> torch.Tensor:
    """Plain PyTorch version of the resident gathers: ``table`` flattened
    to ``w`` entries and read at the position ``mode`` maps each output to
    (see ``csrc/resident_gather.cu``)."""
    flat = table.reshape(-1)
    w = flat.shape[0]
    i = idx.long()
    if mode == "full":
        pos = i.clamp(0, w - 1)
    elif mode == "lane":
        pos = i & 127
    elif mode == "row":
        pos = (i >> 7).clamp(0, w // 128 - 1) * 128
    else:  # "sublane": the first 128 indices of each block of blk outputs
        j = torch.arange(i.shape[0], device=i.device)
        pos = (i[torch.div(j, blk, rounding_mode="floor") * blk + (j & 127)]
               & 7) * 128
    return flat.index_select(0, pos)


def _smem_optin(device: torch.device) -> int:
    return torch.cuda.get_device_properties(
        _index(device)).shared_memory_per_block_optin


def _resident_gather(fn, table: torch.Tensor, idx: torch.Tensor, mode: str,
                     two_d: bool, blk: int) -> torch.Tensor:
    name = fn.__name__
    _check_index(idx, 1, name)
    if table.dtype != torch.int32 or not table.is_contiguous():
        raise TypeError(f"{name}: table must be a contiguous int32 tensor")
    if table.device != idx.device:
        raise ValueError(f"{name}: table on {table.device}, index on "
                         f"{idx.device}")
    if two_d:
        if table.dim() != 2 or table.shape[1] != 128 or table.shape[0] == 0:
            raise ValueError(f"{name}: this body takes a (w / 128, 128) table")
        if mode == "sublane" and table.shape[0] < 8:
            raise ValueError(f"{name}: the sublane body reads 8 table rows")
    elif table.dim() != 1 or table.shape[0] == 0:
        raise ValueError(f"{name}: this body takes a non-empty 1-D table")
    n = idx.shape[0]
    if blk <= 0 or blk % 128 or n % blk:
        raise ValueError(f"{name}: blk must be a multiple of 128 dividing "
                         f"n = {n} (the TPU grid covers n // blk blocks)")
    w = table.numel()
    if idx.device.type == "cpu":
        return resident_gather_plain(table, idx, mode, blk)
    _cuda_or_raise(idx.device, name)
    lib = build()
    use_smem = 4 * w <= _smem_optin(idx.device)
    out = torch.empty(n, dtype=torch.int32, device=idx.device)
    fn.last_route = "smem" if use_smem else "l2"
    if n == 0:
        return out
    block = 1024
    per_sm = 2 if not use_smem or 4 * w <= 100 * 1024 else 1
    grid = max(1, min(-(-n // block), per_sm * _sm_count(idx.device)))
    rc = lib.rjt_resident_gather(
        _index(idx.device), _MAPS[mode], int(use_smem), table.data_ptr(), w,
        idx.data_ptr(), out.data_ptr(), n, blk, grid, block,
        _stream(idx.device),
    )
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    fn.launches += 1
    return out


def pallas_gather_plain(table, idx, body: str = "take", blk: int = 2048):
    """Plain PyTorch version of :func:`pallas_gather`."""
    return resident_gather_plain(table, idx, _PALLAS_GATHER_BODIES[body][0],
                                 blk)


def pallas_gather(table: torch.Tensor, idx: torch.Tensor, body: str = "take",
                  blk: int = 2048) -> torch.Tensor:
    """Counterpart of tools/expt_pallas.py::_pallas_gather. ``take`` and
    ``take_unique``: ``table[idx]`` over a 1-D int32 table; ``ta_lanes``:
    ``t2[0, idx & 127]`` over a (w / 128, 128) table. The table is staged
    in shared memory when it fits the opt-in limit, else read through L2;
    ``pallas_gather.last_route`` says which route the last launch took."""
    if body not in _PALLAS_GATHER_BODIES:
        raise ValueError(f"pallas_gather: unknown body {body!r}")
    mode, two_d = _PALLAS_GATHER_BODIES[body]
    return _resident_gather(pallas_gather, table, idx, mode, two_d, blk)


def gather_pallas_vmem_plain(table, idx, blk: int = 4096):
    """Plain PyTorch version of :func:`gather_pallas_vmem`."""
    return resident_gather_plain(table, idx, "full", blk)


def gather_pallas_vmem(table: torch.Tensor, idx: torch.Tensor,
                       blk: int = 4096) -> torch.Tensor:
    """Counterpart of tools/expt_primitives.py::case_gather_pallas_vmem:
    ``table[idx]`` with the 1-D int32 table resident on chip where it fits
    (routes as in :func:`pallas_gather`)."""
    return _resident_gather(gather_pallas_vmem, table, idx, "full", False,
                            blk)


def mk_gather_plain(table, idx, body: str = "2level", blk: int = 2048):
    """Plain PyTorch version of :func:`mk_gather`."""
    return resident_gather_plain(table, idx, _MK_BODIES[body][0], blk)


def mk_gather(table: torch.Tensor, idx: torch.Tensor, body: str = "2level",
              blk: int = 2048) -> torch.Tensor:
    """Counterpart of tools/expt_gather2.py::_mk over a (w / 128, 128) int32
    table ``t2``, per body: ``rows`` ``t2[idx >> 7, 0]``; ``lanes``
    ``t2[0, idx & 127]``; ``2level`` ``t2[idx >> 7, idx & 127]`` (=
    ``table[idx]``); ``sub`` ``t2[idx[b0 + i % 128] & 7, 0]`` with ``b0``
    the start of output i's block of ``blk``. Routes as in
    :func:`pallas_gather`."""
    if body not in _MK_BODIES:
        raise ValueError(f"mk_gather: unknown body {body!r}")
    mode, two_d = _MK_BODIES[body]
    return _resident_gather(mk_gather, table, idx, mode, two_d, blk)


# ---------------------------------------------------------------------------
# onehot_gather
# ---------------------------------------------------------------------------


def onehot_gather_plain(table: torch.Tensor, idx: torch.Tensor,
                        chunk: int = 1 << 14) -> torch.Tensor:
    """Plain PyTorch version of :func:`onehot_gather`: the one-hot product
    in float64 (exact for any float32 table value), ``chunk`` rows at a
    time so that the one-hot matrix stays small. A float64 product never
    runs in TF32."""
    w = table.shape[0]
    tab = table.to(torch.float32).to(torch.float64)
    cols = torch.arange(w, dtype=torch.int32, device=idx.device)
    out = torch.empty(idx.shape[0], dtype=torch.int32, device=idx.device)
    for s in range(0, idx.shape[0], chunk):
        onehot = (idx[s:s + chunk, None] == cols).to(torch.float64)
        out[s:s + chunk] = (onehot @ tab).to(torch.int32)
    return out


def onehot_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Counterpart of tools/expt_pallas.py::case_pallas_onehot_mxu:
    ``int32(onehot(idx) . float32(table))`` for a 1-D int32 table whose
    float32 copy fits shared memory — ``table[idx]`` for values below 2^24
    in magnitude, 0 for an index outside ``[0, w)``."""
    name = "onehot_gather"
    _check_index(idx, 1, name)
    if (table.dtype != torch.int32 or table.dim() != 1
            or not table.is_contiguous() or table.shape[0] == 0):
        raise TypeError(f"{name}: table must be a non-empty contiguous 1-D "
                        "int32 tensor")
    if table.device != idx.device:
        raise ValueError(f"{name}: table on {table.device}, index on "
                         f"{idx.device}")
    if idx.device.type == "cpu":
        return onehot_gather_plain(table, idx)
    _cuda_or_raise(idx.device, name)
    w = table.shape[0]
    if 4 * w > _smem_optin(idx.device):
        raise ValueError(f"{name}: a {w}-entry table does not fit shared "
                         "memory")
    lib = build()
    n = idx.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=idx.device)
    if n == 0:
        return out
    grid = max(1, min(-(-n // 2048), 8 * _sm_count(idx.device)))
    rc = lib.rjt_onehot_gather(
        _index(idx.device), table.data_ptr(), w, idx.data_ptr(),
        out.data_ptr(), n, grid, _stream(idx.device),
    )
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    onehot_gather.launches += 1
    return out


_WRAPPERS = (window_gather, blocked_window_gather_multi, paged_window_gather,
             pallas_gather, gather_pallas_vmem, mk_gather, onehot_gather)
reset_launch_counts()
for _fn in (pallas_gather, gather_pallas_vmem, mk_gather):
    _fn.last_route = None
