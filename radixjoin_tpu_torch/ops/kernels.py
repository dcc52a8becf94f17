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

Two kernels have no Pallas original: they compute on the card what the
JAX package writes with XLA ops for the TPU (a scatter-max into a sentinel
slot and ``lax.cummax``), held to the JAX functions' values
(``csrc/owner_recovery.cu``):

* :func:`owner_recovery` — the owner row of every output slot of a join
  expansion, a merge-path search of the slots among the offsets;
* :func:`cummax_i32` — the running max of an int32 stream (the merge
  join's run scans).

One has no JAX counterpart on the device: the JAX package encodes result
pages on the host. It is held to ``encode_fixed_aligned`` of both
packages (``csrc/page_encode.cu``):

* :func:`encode_pages_aligned` — dense fixed-width columns into
  row-aligned 8 KiB pages (the fused executor's root columns, before the
  fetch).

One does on the card what the JAX package writes as XLA ops around a slot
table, held to its ``join_unique_scatter_impl`` and the owner recovery of
its ``_compact_probe_shaped`` (``csrc/unique_probe.cu``):

* :func:`unique_probe` — the probe of a unique-key join against its dense
  key-window slot table, probe-shaped or, where the join node has a learned
  output pad, compacted to its matches in the same pass.

The four kernels of the in-kernel gather experiments (``tools/``) follow:

* :func:`pallas_gather`, :func:`gather_pallas_vmem` and :func:`mk_gather`
  (one source, ``csrc/resident_gather.cu``) — gathers from a table held on
  chip, one wrapper per TPU function with its bodies as ``body=``;
* :func:`onehot_gather` (a fifth index map of the same source) — the
  TPU's one-hot product, on this card a gather from the table rounded
  through float32 in shared memory.

Each source is compiled with its own ``nvcc`` into a shared library at
first use (all sources at once, into the package's ``_build`` directory,
keyed by a hash of the source and the shared header) and called through
``ctypes`` on PyTorch's current stream.

Every wrapper checks its arguments the same way on every device. It then
takes the plain PyTorch version for tensors on the CPU, and only there;
for CUDA tensors it launches its kernel or raises. Each wrapper counts its
kernel launches (``kernel.<wrapper>.launches`` in the trace registry, read
by :func:`launch_counts`), and for the launching thread
(:func:`thread_launch_counts`). While tracing is on, a call that launches
also counts its least bytes (``kernel.<wrapper>.least_bytes``): each
input read once and each output written once, from the call's shapes
(:func:`least_bytes`; the blocked gather's table reads, which depend on
the values, left out).
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

from .. import trace
from ..dtypes import PAGE_SIZE, DataType
from ..storage import device_decode

#: largest table the join engine routes to :func:`window_gather`
WINDOW_GATHER_MAX = 4096
#: largest table :func:`window_gather` takes (one int32 table is 64 KiB of
#: shared memory; the device-time harness measures up to this size)
WINDOW_GATHER_TABLE_MAX = 16384
#: outputs per block window of :func:`blocked_window_gather_multi`
BWG_BLK = 1024
#: window alignment unit; each block covers two units
BWG_WIN = 1024

#: tables one launch takes (RJT_MAX_TABLES in csrc/gather_common.cuh: the
#: descriptors travel as one by-value kernel argument); a longer list is
#: split into several launches over the same index stream
_MAX_TABLES = 16
#: shared memory a block leaves free of staged tables: the static shared
#: memory of ``window_gather_kernel`` and ``resident_gather_kernel`` (their
#: 8-byte copy barrier), rounded up to the staging alignment
_SMEM_RESERVE = 16

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
    "rjt_window_gather": [_I32, _I32, _VP, _VP, _VP, _VP, _I32, _I32, _VP,
                          _I64, _I32, _VP],
    "rjt_blocked_window_gather": [_I32, _I32, _VP, _VP, _VP, _VP, _VP, _I64,
                                  _I64, _VP, _I32, _VP],
    "rjt_paged_window_gather": [_I32, _VP, _VP, _VP, _I64, _I32, _I32,
                                _I32, _I32, _VP],
    "rjt_resident_gather": [_I32, _I32, _I32, _VP, _I64, _VP, _VP, _I64,
                            _I32, _I32, _VP],
    "rjt_owner_recovery": [_I32, _VP, _I32, _I64, _VP, _I32, _VP, _I64,
                           _I32, _VP],
    "rjt_cummax_i32": [_I32, _VP, _VP, _I64, _VP, _I64, _VP],
    "rjt_encode_pages": [_I32, _I32, _VP, _VP, _VP, _VP, _I64, _VP],
    "rjt_unique_probe": [_I32, _VP, _I32, _VP, _I64, _VP, _I64, _I64, _VP,
                         _I64, _VP, _VP, _VP, _I64, _VP, _VP, _I64, _I32,
                         _VP],
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


#: launches and least bytes per wrapper: ``<wrapper>.launches``,
#: ``<wrapper>.least_bytes``
KERNEL_STATS = trace.Counters("kernel")
#: launches by the launching thread
_thread_counts = threading.local()


def _count_launch(fn) -> None:
    """Count one launch of ``fn``'s kernel: called by the wrappers where
    they launch, and nowhere else."""
    KERNEL_STATS.add(f"{fn.__name__}.launches")
    counts = getattr(_thread_counts, "counts", None)
    if counts is None:
        counts = _thread_counts.counts = {}
    counts[fn.__name__] = counts.get(fn.__name__, 0) + 1


def _count_least_bytes(fn, *args) -> None:
    """Count the least bytes of one call of ``fn`` that launched (``args``
    as :func:`least_bytes` takes them). The wrappers call it only while
    tracing is on."""
    KERNEL_STATS.add(f"{fn.__name__}.least_bytes",
                     least_bytes(fn.__name__, *args))


def least_bytes(name: str, *args) -> int:
    """The least bytes one call of the wrapper ``name`` moves: each input
    read once, each output written once (the rule of the port's kernel
    table). Arguments: ``window_gather`` and
    ``blocked_window_gather_multi`` ``(tables, idx)`` (the second also
    ``with_ok``; its table reads depend on the values and are left out, so
    this is a lower bound), ``paged_window_gather`` ``(body, idx)``,
    ``owner_recovery`` ``(offsets, total, s_pad)``, ``cummax_i32``
    ``(x,)``, ``encode_pages_aligned`` ``(values, valids, n, dtypes)``
    (the first ``n`` rows of each column read, its pages written), the
    resident gathers and ``onehot_gather`` ``(table,
    idx)``, ``unique_probe`` ``(slots, keys, valid, compact_pad)`` (each key
    and validity byte read, the outputs written; the slot lookups, which
    depend on the values, left out, so this is a lower bound)."""
    if name == "window_gather":
        tables, idx = args
        n, w = idx.numel(), tables[0].shape[0]
        return (n * idx.element_size()
                + (n + w) * sum(t.element_size() for t in tables))
    if name == "blocked_window_gather_multi":
        tables, idx, with_ok = args
        return idx.numel() * (idx.element_size()
                              + sum(t.element_size() for t in tables)
                              + (4 if with_ok else 0))
    if name == "paged_window_gather":
        body, idx = args
        return (body.numel() * body.element_size()
                + 2 * idx.numel() * idx.element_size())
    if name == "owner_recovery":
        offsets, total, s_pad = args
        return (offsets.numel() * offsets.element_size()
                + total.numel() * total.element_size() + 4 * s_pad)
    if name == "cummax_i32":
        (x,) = args
        return 2 * x.numel() * x.element_size()
    if name == "encode_pages_aligned":
        values, valids, n, dtypes = args
        return sum(n * (v.element_size() + m.element_size())
                   + _aligned_pages(n, dt) * PAGE_SIZE
                   for v, m, dt in zip(values, valids, dtypes))
    if name in ("pallas_gather", "gather_pallas_vmem", "mk_gather",
                "onehot_gather"):
        table, idx = args
        return 4 * table.numel() + 2 * 4 * idx.numel()
    if name == "unique_probe":
        _slots, keys, valid, compact_pad = args
        out = compact_pad * 9 if compact_pad else keys.numel() * 5
        return keys.numel() * (keys.element_size() + valid.element_size()) \
            + out + 8
    raise ValueError(f"least_bytes: unknown wrapper {name!r}")


def launch_counts() -> Dict[str, int]:
    """Launches per wrapper in this process since the last
    :func:`reset_launch_counts`."""
    counts = KERNEL_STATS.snapshot()
    return {fn.__name__: counts.get(f"{fn.__name__}.launches", 0)
            for fn in _WRAPPERS}


def reset_launch_counts() -> None:
    KERNEL_STATS.reset([f"{fn.__name__}.launches" for fn in _WRAPPERS])


def thread_launch_counts() -> Dict[str, int]:
    """Launches per wrapper made by the calling thread since its last
    :func:`reset_thread_launch_counts` (or its start)."""
    counts = getattr(_thread_counts, "counts", None) or {}
    return {fn.__name__: counts.get(fn.__name__, 0) for fn in _WRAPPERS}


def reset_thread_launch_counts() -> None:
    _thread_counts.counts = {}


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


def _launch_groups(count: int) -> List[List[int]]:
    """Table positions ``0 .. count - 1`` split, in order, into launches of
    at most ``_MAX_TABLES`` tables each, whatever their element sizes."""
    return [list(range(s, min(s + _MAX_TABLES, count)))
            for s in range(0, count, _MAX_TABLES)]


def _staging_plan(elem_sizes: Sequence[int], w: int,
                  budget: int) -> Tuple[List[int], int]:
    """Where :func:`window_gather` stages each of one launch's tables (of
    ``w`` entries and the given element sizes) in ``budget`` bytes of shared
    memory: ``(offsets, bytes used)``, every offset a multiple of 16. Tables
    are placed in order while they fit; one that does not gets offset -1
    and is read from device memory by the same launch."""
    offsets, used = [], 0
    for eb in elem_sizes:
        start = -(-used // 16) * 16
        if start + w * eb <= budget:
            offsets.append(start)
            used = start + w * eb
        else:
            offsets.append(-1)
    return offsets, used


def _ptr_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * _MAX_TABLES)(*[t.data_ptr() for t in tensors])


def _int_array(values) -> ctypes.Array:
    return (ctypes.c_int * _MAX_TABLES)(*values)


#: per device index: (SM count, opt-in shared memory per block)
_DEVICE_LIMITS: Dict[int, Tuple[int, int]] = {}


def _device_limits(device: torch.device) -> Tuple[int, int]:
    i = _index(device)
    if i not in _DEVICE_LIMITS:
        props = torch.cuda.get_device_properties(i)
        _DEVICE_LIMITS[i] = (props.multi_processor_count,
                             props.shared_memory_per_block_optin)
    return _DEVICE_LIMITS[i]


def _stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``. (The public
    ``torch.cuda.current_stream(device).cuda_stream`` builds a Stream object
    first, which costs each launch several microseconds of host time: as
    much as a small decode's kernel takes on the card.)"""
    return torch._C._cuda_getCurrentRawStream(_index(device))


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

    One launch serves up to 16 tables of any mix of element sizes (a longer
    list is split). Its blocks hold as many of the tables in shared memory
    as the card's opt-in limit allows (227 KB on Hopper: seven int64 tables
    of 4096 entries) and read the rest from device memory in the same
    launch (see :func:`_staging_plan`)."""
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
    dev = _index(idx.device)
    sm_count, smem_optin = _device_limits(idx.device)
    budget = smem_optin - _SMEM_RESERVE
    for members in _launch_groups(len(tables)):
        elems = [tables[i].element_size() for i in members]
        offsets, smem_bytes = _staging_plan(elems, w, budget)
        rc = lib.rjt_window_gather(
            dev, len(members), _ptr_array([tables[i] for i in members]),
            _ptr_array([outs[i] for i in members]), _int_array(elems),
            _int_array(offsets), smem_bytes, w, idx.data_ptr(), n,
            sm_count, _stream(idx.device),
        )
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
        _count_launch(window_gather)
    if trace.ON:
        _count_least_bytes(window_gather, tables, idx)
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


def blocked_window_gather_multi(tables, idx: torch.Tensor,
                                with_ok: bool = True):
    """``(vals, ok)``: ``vals[t][j] = tables[t][idx[j]]`` for every row and
    ``ok[j] = 1`` where ``idx[j]`` fell in its block's 2048-entry window
    (the TPU kernel's flag, bit for bit). ``idx`` is int32, clamped to
    ``[0, len(t))`` by the caller and block-windowed (monotone) for the
    window to pay; missed rows are read from device memory inside the
    kernel, so no host sync and no second pass is needed. Tables may
    differ in length and dtype (1, 4 or 8 bytes).

    ``with_ok=False`` returns ``(vals, None)`` and the kernel writes no
    flags: for callers that drop them.

    One launch serves up to 16 tables of any mix of element sizes; a longer
    list is split into several launches over the same index stream, and
    only the first writes ``ok``."""
    tables = list(tables)
    name = "blocked_window_gather_multi"
    _check_index(idx, 1, name)
    _check_tables(tables, idx.device, name)
    if idx.device.type == "cpu":
        vals, ok = blocked_window_gather_multi_plain(tables, idx)
        return vals, (ok if with_ok else None)
    _cuda_or_raise(idx.device, name)
    lib = build()
    n = idx.shape[0]
    outs = [torch.empty(n, dtype=t.dtype, device=t.device) for t in tables]
    ok = (torch.empty(n, dtype=torch.int32, device=idx.device)
          if with_ok else None)
    if n == 0:
        return outs, ok
    kmax = -(-max(t.shape[0] for t in tables) // BWG_WIN)
    dev = _index(idx.device)
    ok_ptr = ok.data_ptr() if with_ok else None
    sm_count, _smem = _device_limits(idx.device)
    for members in _launch_groups(len(tables)):
        rc = lib.rjt_blocked_window_gather(
            dev, len(members), _ptr_array([tables[i] for i in members]),
            _ptr_array([outs[i] for i in members]),
            (ctypes.c_longlong * _MAX_TABLES)(
                *[tables[i].shape[0] for i in members]),
            _int_array([tables[i].element_size() for i in members]),
            idx.data_ptr(), n, kmax, ok_ptr, sm_count,
            _stream(idx.device),
        )
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
        _count_launch(blocked_window_gather_multi)
        ok_ptr = None
    if trace.ON:
        _count_least_bytes(blocked_window_gather_multi, tables, idx, with_ok)
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
    ``[0, w)`` (the kernel and the plain version clamp to it).

    On the card the kernel takes its vector route (bodies by bulk copy,
    16-byte index loads and stores) where ``body`` and ``idx`` start on 16
    bytes and w and Ro are multiples of 4, as every decode call does, and
    its scalar route otherwise; ``paged_window_gather.last_route`` says
    which (``"vector"`` or ``"scalar"``)."""
    name = "paged_window_gather"
    _check_index(idx, 2, name)
    if body.dtype != torch.int32 or body.dim() != 2 or not body.is_contiguous():
        raise TypeError(f"{name}: body must be a contiguous 2-D int32 tensor")
    device = idx.device
    if body.device != device or body.shape[0] != idx.shape[0]:
        raise ValueError(f"{name}: body and index disagree in device or pages")
    if not 0 < body.shape[1] <= 12288:
        raise ValueError(f"{name}: page width {body.shape[1]} out of range")
    if device.type == "cpu":
        return paged_window_gather_plain(body, idx)
    _cuda_or_raise(device, name)
    lib = build()
    npages, w = body.shape
    ro = idx.shape[1]
    out = torch.empty((npages, ro), dtype=torch.int32, device=device)
    if npages == 0 or ro == 0:
        return out
    vec = _paged_vector_route(body, idx)
    paged_window_gather.last_route = "vector" if vec else "scalar"
    rc = lib.rjt_paged_window_gather(
        _index(device), body.data_ptr(), idx.data_ptr(), out.data_ptr(),
        npages, w, ro, int(vec), _device_limits(device)[0], _stream(device),
    )
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    _count_launch(paged_window_gather)
    if trace.ON:
        _count_least_bytes(paged_window_gather, body, idx)
    return out


def _paged_vector_route(body: torch.Tensor, idx: torch.Tensor) -> bool:
    """Whether ``csrc/paged_window_gather.cu`` may take its vector route
    for these inputs (its output, a fresh allocation, starts on 16 bytes)."""
    return (body.data_ptr() % 16 == 0 and idx.data_ptr() % 16 == 0
            and body.shape[1] % 4 == 0 and idx.shape[1] % 4 == 0)


# ---------------------------------------------------------------------------
# resident gathers: pallas_gather, gather_pallas_vmem, mk_gather
# ---------------------------------------------------------------------------

#: rows one warp of ``resident_gather_kernel`` covers a trip; ``blk`` is a
#: multiple of it (RJT_WARP_ROWS in csrc/gather_common.cuh)
RESIDENT_SPAN = 128
#: index maps of csrc/resident_gather.cu (RjtMap)
_MAPS = {"full": 0, "lane": 1, "row": 2, "sublane": 3, "onehot": 4}
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


def _table_fits_shared_memory(w: int, smem_optin: int) -> bool:
    """Whether an int32 table of ``w`` entries takes the shared-memory route
    of ``csrc/resident_gather.cu`` on a card whose blocks may opt in to
    ``smem_optin`` bytes: the table and the kernel's copy barrier must fit
    one block. (How many such blocks share an SM, and hence the grid, the
    launch asks of the card's occupancy calculator.)"""
    return 4 * w + _SMEM_RESERVE <= smem_optin


def _launch_resident(fn, mode: str, use_smem: bool, table: torch.Tensor,
                     idx: torch.Tensor, blk: int) -> torch.Tensor:
    """One launch of ``resident_gather_kernel`` for checked CUDA tensors,
    counted on ``fn``."""
    n = idx.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=idx.device)
    if n == 0:
        return out
    rc = build().rjt_resident_gather(
        _index(idx.device), _MAPS[mode], int(use_smem), table.data_ptr(),
        table.numel(), idx.data_ptr(), out.data_ptr(), n, blk,
        _device_limits(idx.device)[0], _stream(idx.device),
    )
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA launch failed with error "
                           f"{rc}")
    _count_launch(fn)
    if trace.ON:
        _count_least_bytes(fn, table, idx)
    return out


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
    if blk <= 0 or blk % RESIDENT_SPAN or n % blk:
        raise ValueError(f"{name}: blk must be a multiple of 128 dividing "
                         f"n = {n} (the TPU grid covers n // blk blocks)")
    w = table.numel()
    if idx.device.type == "cpu":
        return resident_gather_plain(table, idx, mode, blk)
    _cuda_or_raise(idx.device, name)
    use_smem = _table_fits_shared_memory(w, _device_limits(idx.device)[1])
    fn.last_route = "smem" if use_smem else "l2"
    return _launch_resident(fn, mode, use_smem, table, idx, blk)


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
    ``int32(onehot(idx) . float32(table))`` for a 1-D int32 table that fits
    shared memory — ``int32(float32(table))[idx]``, which is ``table[idx]``
    for values below 2^24 in magnitude, and 0 for an index outside
    ``[0, w)``. Table values lie in ``[-2^31, 2^31 - 64)``: from 2^31 - 64
    up, float32 rounds to 2^31, which no int32 holds.

    On the card no product is formed: each block rounds the table through
    float32 into shared memory and gathers from there (the ONEHOT map of
    ``csrc/resident_gather.cu``)."""
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
    if not _table_fits_shared_memory(w, _device_limits(idx.device)[1]):
        raise ValueError(f"{name}: a {w}-entry table does not fit shared "
                         "memory")
    return _launch_resident(onehot_gather, "onehot", True, table, idx,
                            RESIDENT_SPAN)


# ---------------------------------------------------------------------------
# owner_recovery, cummax_i32
# ---------------------------------------------------------------------------

#: merge items (slots plus rows) one tile of ``owner_merge_kernel`` walks
#: (kOwnTile in csrc/owner_recovery.cu)
OWNER_TILE = 2044
#: the most rows and slots :func:`owner_recovery` takes on the card: the
#: kernel counts them in int32, a tile's staging span past them
OWNER_MAX = 2 ** 31 - 1 - 2048
#: values one block of ``max_scan_kernel`` scans (RJT_SCAN_TILE in
#: csrc/owner_recovery.cu); the scratch holds a status word a tile and the
#: tile counter
SCAN_TILE = 4096


def _scan_scratch(n: int, device: torch.device) -> torch.Tensor:
    return torch.empty(-(-n // SCAN_TILE) + 1, dtype=torch.int64,
                       device=device)


def _check_total(total: torch.Tensor, device: torch.device, name: str) -> None:
    if (total.dtype not in (torch.int32, torch.int64) or total.numel() != 1
            or total.dim() > 1):
        raise TypeError(f"{name}: total must be a one-element int32 or int64 "
                        f"tensor, got {total.dtype} with shape "
                        f"{tuple(total.shape)}")
    if total.device != device:
        raise ValueError(f"{name}: total on {total.device}, offsets on "
                         f"{device}")


def owner_recovery_plain(offsets: torch.Tensor, total: torch.Tensor,
                         s_pad: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`owner_recovery`, the JAX package's
    formulation: ``emits[i] = offsets[i + 1] > offsets[i]`` with
    ``offsets[n] = total``, each emitting row's id scatter-maxed at its
    output start, starts at or past ``s_pad`` into a sentinel slot (JAX's
    ``mode="drop"``), a running max, the clamp."""
    n = offsets.shape[0]
    emits = torch.diff(offsets, append=total.reshape(1).to(offsets.dtype)) > 0
    starts = torch.where(emits & (offsets < s_pad), offsets.long(), s_pad)
    marker = torch.full((s_pad + 1,), -1, dtype=torch.int32,
                        device=offsets.device)
    marker.scatter_reduce_(0, starts, torch.arange(
        n, dtype=torch.int32, device=offsets.device), "amax")
    owner = torch.cummax(marker[:s_pad], dim=0).values
    return owner.clamp(0, n - 1)


def owner_recovery(offsets: torch.Tensor, total: torch.Tensor,
                   s_pad: int) -> torch.Tensor:
    """The owner of every output slot ``0 <= j < s_pad`` of a join
    expansion, int32 and monotone::

        owner[j] = clamp(upper_bound(offsets, min(j, total - 1)) - 1, 0, n - 1)

    (0 everywhere when ``total`` is 0; -1 when n is 0). ``offsets`` is the
    1-D int32 or int64 exclusive prefix sum of n non-negative counts and
    ``total`` (a one-element int32 or int64 tensor on the same device) their
    sum; ``s_pad`` is static. Below ``min(total, s_pad)`` a slot's owner is
    the row whose run holds it, in the dead tail the last row with a
    non-zero count: the JAX package's scatter-max + cummax with
    ``emits[i] = offsets[i + 1] > offsets[i]`` (``offsets[n] = total``).

    Precondition: ``offsets`` is such a prefix sum (non-decreasing, from 0)
    and ``total`` its end. The wrapper cannot check that on the card without
    a host sync, so it does not; every caller in the package forms
    ``offsets`` as ``cumsum(counts) - counts`` and ``total`` as their sum.
    Offsets that break it (an int32 cumsum that wrapped, before the
    caller's overflow check) give unspecified owners, and the kernel still
    reads and writes only inside its buffers.

    On the card: one launch on the current stream (a merge-path partition
    of the slots and the offsets, ``csrc/owner_recovery.cu``), no memset,
    no atomics, no host sync. At most :data:`OWNER_MAX` rows and slots."""
    name = "owner_recovery"
    if offsets.dtype not in (torch.int32, torch.int64) or offsets.dim() != 1:
        raise TypeError(f"{name}: offsets must be a 1-D int32 or int64 tensor")
    device = offsets.device
    _check_total(total, device, name)
    if not offsets.is_contiguous():
        raise ValueError(f"{name}: offsets must be contiguous")
    s_pad = int(s_pad)
    if s_pad < 0:
        raise ValueError(f"{name}: s_pad must be >= 0, got {s_pad}")
    if device.type == "cpu":
        return owner_recovery_plain(offsets, total, s_pad)
    _cuda_or_raise(device, name)
    if max(s_pad, offsets.shape[0]) > OWNER_MAX:
        raise ValueError(f"{name}: at most {OWNER_MAX} rows and slots on the "
                         "card")
    lib = build()
    out = torch.empty(s_pad, dtype=torch.int32, device=device)
    if s_pad == 0:
        return out
    rc = lib.rjt_owner_recovery(
        _index(device), offsets.data_ptr(), int(offsets.dtype == torch.int64),
        offsets.shape[0], total.data_ptr(), int(total.dtype == torch.int64),
        out.data_ptr(), s_pad, _device_limits(device)[0], _stream(device),
    )
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    _count_launch(owner_recovery)
    if trace.ON:
        _count_least_bytes(owner_recovery, offsets, total, s_pad)
    return out


def cummax_i32_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`cummax_i32`."""
    return torch.cummax(x, 0).values


def cummax_i32(x: torch.Tensor) -> torch.Tensor:
    """``out[j] = max(x[0 .. j])`` for a 1-D int32 tensor: on the card one
    decoupled look-back max-scan on the current stream, with no host
    sync."""
    name = "cummax_i32"
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise TypeError(f"{name}: x must be a contiguous 1-D int32 tensor")
    if x.device.type == "cpu":
        return cummax_i32_plain(x)
    _cuda_or_raise(x.device, name)
    lib = build()
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    scratch = _scan_scratch(n, x.device)
    rc = lib.rjt_cummax_i32(_index(x.device), x.data_ptr(), out.data_ptr(), n,
                            scratch.data_ptr(), scratch.shape[0],
                            _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    _count_launch(cummax_i32)
    if trace.ON:
        _count_least_bytes(cummax_i32, x)
    return out


# ---------------------------------------------------------------------------
# encode_pages_aligned
# ---------------------------------------------------------------------------

#: the torch dtype each fixed-width column arrives in (FP64 as its bits)
_PAGE_VALUE_DTYPES = {DataType.INT32: torch.int32,
                      DataType.INT64: torch.int64,
                      DataType.FP64: torch.int64}


def _aligned_pages(n: int, dtype: DataType) -> int:
    return -(-n // device_decode.ALIGNED_ROWS[dtype])


def _encode_column_plain(values: torch.Tensor, valid: torch.Tensor, n: int,
                         dtype: DataType) -> torch.Tensor:
    r = device_decode.ALIGNED_ROWS[dtype]
    npages = _aligned_pages(n, dtype)
    out = torch.zeros((npages, PAGE_SIZE), dtype=torch.uint8,
                      device=values.device)
    if npages == 0:
        return out
    vals = torch.zeros(npages * r, dtype=values.dtype, device=values.device)
    vals[:n] = values[:n]
    live = torch.zeros(npages * r, dtype=torch.bool, device=values.device)
    live[:n] = valid[:n]
    vals, live = vals.view(npages, r), live.view(npages, r)
    nr = torch.full((npages,), r, dtype=torch.int16, device=values.device)
    nr[-1] = n - (npages - 1) * r
    header = out.view(torch.int16)
    header[:, 0] = nr
    header[:, 1] = live.sum(dim=1).to(torch.int16)
    # non-null values packed from byte max(4, width) in row order
    words = out.view(values.dtype)
    first = max(4, values.element_size()) // values.element_size()
    rank = torch.cumsum(live, dim=1) - 1
    page, row = torch.nonzero(live, as_tuple=True)
    words[page, first + rank[page, row]] = vals[page, row]
    # the bitmap, little bit order, in the page's last ceil(rows / 8) bytes
    weights = torch.tensor([1 << b for b in range(8)], dtype=torch.int32,
                           device=values.device)
    bitmap = (live.view(npages, r // 8, 8).to(torch.int32) * weights).sum(
        dim=2).to(torch.uint8)
    full = n // r
    out[:full, PAGE_SIZE - r // 8:] = bitmap[:full]
    if full < npages:
        nb = (int(nr[-1]) + 7) // 8
        out[-1, PAGE_SIZE - nb:] = bitmap[-1, :nb]
    return out


def encode_pages_aligned_plain(values, valids, n: int,
                               dtypes) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`encode_pages_aligned`."""
    return [_encode_column_plain(v, m, n, DataType(dt))
            for v, m, dt in zip(values, valids, dtypes)]


def encode_pages_aligned(values, valids, n: int,
                         dtypes) -> List[torch.Tensor]:
    """The first ``n`` rows of each fixed-width column as row-aligned 8 KiB
    pages: a ``(ceil(n / R), PAGE_SIZE)`` uint8 tensor a column, bit-equal
    to ``storage.device_decode.encode_fixed_aligned`` (R =
    ``device_decode.ALIGNED_ROWS``: 1,920 INT32 rows a page, 960 INT64 or
    FP64; the last page holds the rest). ``values[t]`` is 1-D int32 for
    INT32 and int64 for INT64 and FP64 (its bit pattern, as the engine
    keeps it on the card), ``valids[t]`` 1-D bool, both at least ``n``
    long; ``dtypes[t]`` the column's ``DataType``.

    On the card one launch serves up to 16 columns of any mix of widths (a
    longer list is split), one block a page (``csrc/page_encode.cu``), on
    the current stream, with no memset, atomics or host sync."""
    name = "encode_pages_aligned"
    values, valids = list(values), list(valids)
    dtypes = [DataType(dt) for dt in dtypes]
    n = int(n)
    if not len(values) == len(valids) == len(dtypes):
        raise ValueError(f"{name}: values, valids and dtypes differ in "
                         "length")
    if not values:
        raise ValueError(f"{name}: no columns")
    if n < 0:
        raise ValueError(f"{name}: n must be >= 0, got {n}")
    device = values[0].device
    for v, m, dt in zip(values, valids, dtypes):
        want = _PAGE_VALUE_DTYPES.get(dt)
        if want is None:
            raise TypeError(f"{name}: {dt.name} is not a fixed-width type")
        if v.dtype != want or v.dim() != 1 or not v.is_contiguous():
            raise TypeError(f"{name}: a {dt.name} column must be a contiguous "
                            f"1-D {want} tensor, got {v.dtype} with shape "
                            f"{tuple(v.shape)}")
        if m.dtype != torch.bool or m.dim() != 1 or not m.is_contiguous():
            raise TypeError(f"{name}: validity must be a contiguous 1-D bool "
                            "tensor")
        if v.device != device or m.device != device:
            raise ValueError(f"{name}: columns on more than one device")
        if v.shape[0] < n or m.shape[0] < n:
            raise ValueError(f"{name}: a column is shorter than n = {n}")
    if device.type == "cpu":
        return encode_pages_aligned_plain(values, valids, n, dtypes)
    _cuda_or_raise(device, name)
    lib = build()
    outs = [torch.empty((_aligned_pages(n, dt), PAGE_SIZE), dtype=torch.uint8,
                        device=device) for dt in dtypes]
    if n == 0:
        return outs
    dev = _index(device)
    for members in _launch_groups(len(values)):
        rc = lib.rjt_encode_pages(
            dev, len(members), _ptr_array([values[i] for i in members]),
            _ptr_array([valids[i] for i in members]),
            _ptr_array([outs[i] for i in members]),
            _int_array([values[i].element_size() for i in members]), n,
            _stream(device),
        )
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
        _count_launch(encode_pages_aligned)
    if trace.ON:
        _count_least_bytes(encode_pages_aligned, values, valids, n, dtypes)
    return outs


# ---------------------------------------------------------------------------
# unique_probe
# ---------------------------------------------------------------------------

#: probe rows one tile of the compacting kernel takes at the least (256
#: threads: csrc/unique_probe.cu); its scratch holds a status word a tile
#: and the tile counter
PROBE_TILE = 4096
#: the widest key window whose bitmap of filled slots the kernel stages in
#: shared memory (a bit a slot: 128 KiB)
PROBE_BITS_MAX_SLOTS = 1 << 20
#: the most probe rows :func:`unique_probe` takes on the card: a row + 1 and
#: a count travel in 31 bits of a tile's status word
PROBE_MAX = 2 ** 31 - 2


def unique_probe_plain(slots: torch.Tensor, keys: torch.Tensor,
                       valid: torch.Tensor, base: int, compact_pad: int = 0):
    """Plain PyTorch version of :func:`unique_probe`: the probe of
    ``join.join_unique_scatter_impl`` and, with a pad, the owner recovery
    of ``plan.executor._compact_probe_shaped`` along the matches."""
    r_pad = slots.shape[0]
    off = keys.long() - base
    in_window = (off >= 0) & (off < r_pad)
    hit = slots.index_select(0, off.clamp(0, r_pad - 1))
    found = valid & in_window & (hit >= 0)
    bidx = torch.where(found, hit, 0)
    total = found.sum(dtype=torch.int64)
    if not compact_pad:
        return bidx, found, total
    counts = found.to(torch.int64)
    pidx = owner_recovery_plain(torch.cumsum(counts, 0) - counts, total,
                                compact_pad)
    live = torch.arange(compact_pad, device=keys.device) < total
    return pidx, bidx.index_select(0, pidx), live, total


def unique_probe(slots: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor,
                 base: int, compact_pad: int = 0):
    """The probe of a unique-key join against its slot table (``slots[k -
    base]`` the build row of key k, -1 where none; ``r_pad`` =
    ``len(slots)``). A probe row matches where its key is valid, ``0 <= key
    - base < r_pad`` and the slot holds a build row.

    ``compact_pad == 0``: ``(bidx, found, total)``, probe-shaped: the build
    row of each probe row (0 where it does not match), the match mask and
    the exact match count (int64), as ``join.join_unique_scatter_impl``
    returns them.

    ``compact_pad > 0``: ``(pidx, bidx, live, total)`` in ``compact_pad``
    slots: the matches in probe order (probe row, int32 and monotone; build
    row), ``live`` below ``total``, and the exact count, also past the pad
    (those matches are dropped; the caller detects it from ``total``). The
    dead tail holds the last match's probe and build rows (0 and 0 without a
    match): the values of ``_compact_probe_shaped``'s owner recovery.

    ``keys`` is 1-D int32 or int64, ``valid`` 1-D bool of the same length,
    ``slots`` 1-D int32, all contiguous on one device. On the card one
    probe kernel on the current stream (``csrc/unique_probe.cu``) reads
    each key and validity byte once; with a pad it compacts in the same
    pass (a decoupled look-back over tiles of rows). Where the window has
    at most :data:`PROBE_BITS_MAX_SLOTS` slots, a first small kernel makes
    a bitmap of the filled slots, which the probe stages in shared memory,
    so that only rows whose bit is set read the table. No host sync. At
    most :data:`PROBE_MAX` probe rows."""
    name = "unique_probe"
    if slots.dtype != torch.int32 or slots.dim() != 1 or slots.shape[0] == 0:
        raise TypeError(f"{name}: slots must be a non-empty 1-D int32 tensor")
    if keys.dtype not in (torch.int32, torch.int64) or keys.dim() != 1:
        raise TypeError(f"{name}: keys must be a 1-D int32 or int64 tensor")
    if valid.dtype != torch.bool or valid.shape != keys.shape:
        raise TypeError(f"{name}: valid must be a bool tensor shaped like "
                        "keys")
    device = keys.device
    if slots.device != device or valid.device != device:
        raise ValueError(f"{name}: tensors on more than one device")
    if not (slots.is_contiguous() and keys.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    compact_pad = int(compact_pad)
    n = keys.shape[0]
    if compact_pad < 0:
        raise ValueError(f"{name}: compact_pad must be >= 0, got "
                         f"{compact_pad}")
    if compact_pad and n == 0:
        raise ValueError(f"{name}: no probe rows to compact")
    if device.type == "cpu":
        return unique_probe_plain(slots, keys, valid, base, compact_pad)
    _cuda_or_raise(device, name)
    if n > PROBE_MAX:
        raise ValueError(f"{name}: at most {PROBE_MAX} probe rows on the card")
    lib = build()
    total = torch.empty((), dtype=torch.int64, device=device)
    rows = compact_pad or n
    # (pidx, bidx, live) at the pad, or (bidx, found) at the probe's rows
    out = [torch.empty(rows, dtype=torch.int32, device=device)
           for _ in range(2 if compact_pad else 1)]
    out += [torch.empty(rows, dtype=torch.bool, device=device), total]
    if n == 0:
        total.zero_()
        return tuple(out)
    # the compaction's status word a tile and tile counter; the bitmap
    scratch = (torch.empty(-(-n // PROBE_TILE) + 1, dtype=torch.int64,
                           device=device) if compact_pad else None)
    r_pad = slots.shape[0]
    bits = (torch.empty(-(-r_pad // 128) * 4, dtype=torch.int32,
                        device=device)
            if r_pad <= PROBE_BITS_MAX_SLOTS else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.rjt_unique_probe(
        _index(device), keys.data_ptr(), int(keys.dtype == torch.int64),
        valid.data_ptr(), n, slots.data_ptr(), r_pad, int(base), ptr(bits),
        0 if bits is None else bits.shape[0], out[0].data_ptr(),
        ptr(out[1]) if compact_pad else None, out[-2].data_ptr(),
        compact_pad, total.data_ptr(), ptr(scratch),
        0 if scratch is None else scratch.shape[0],
        _device_limits(device)[0], _stream(device),
    )
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    _count_launch(unique_probe)
    if trace.ON:
        _count_least_bytes(unique_probe, slots, keys, valid, compact_pad)
    return tuple(out)


_WRAPPERS = (window_gather, blocked_window_gather_multi, paged_window_gather,
             pallas_gather, gather_pallas_vmem, mk_gather, onehot_gather,
             owner_recovery, cummax_i32, encode_pages_aligned, unique_probe)
reset_launch_counts()
for _fn in (paged_window_gather, pallas_gather, gather_pallas_vmem,
            mk_gather):
    _fn.last_route = None
