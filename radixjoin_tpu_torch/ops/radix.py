"""Multi-pass radix partitioning — the join path for inputs larger than
the device budget (port of radixjoin_tpu/ops/radix.py).

The reference does ONE radix pass sized so each build bucket fits L2
(src/execute.cpp:86-92). Here the tiers are host memory and the card's
memory (see :mod:`radixjoin_tpu_torch.hardware`):

* **On-device repartition** (:func:`partition_device`): bucket ids from
  the murmur finalizer's top bits, then one stable sort by bucket carrying
  the row id.
* **Host-staged partitioning** (:func:`partition_host`): pass 1 runs on
  the host (bincount + stable argsort) and yields partition slices whose
  *pairs* fit the device budget; pass 2 streams each pair through the
  single-device two-phase join. On a CUDA device pair p+1 is uploaded from
  pinned host memory on a copy stream while pair p computes.

:func:`partitioned_join` is exact for any inputs and bounds peak device
memory to O(N / num_partitions); it is the engine's path when a query's
inputs do not fit the device budget.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import hardware, trace
from . import join as join_ops
from .hashing import murmur64, murmur64_np


def choose_num_partitions(
    build_rows: int,
    probe_rows: int,
    bytes_per_row: int = 16,
    budget_bytes: Optional[int] = None,
    max_partitions: int = 128,
    device=None,
) -> int:
    """Partition count so one build+probe partition pair fits the budget:
    the reference's bucket sizing (src/execute.cpp:86-92) with L2 swapped
    for a fraction of the device's memory (the sorts need a few times the
    partition size; pairs stay under 1/8 of ``device``'s memory by
    default)."""
    if budget_bytes is None:
        budget_bytes = hardware.detect(device).hbm_bytes // 8
    budget_bytes = max(1, budget_bytes)
    total = (build_rows + probe_rows) * bytes_per_row
    p = 1 << max(0, math.ceil(math.log2(max(1, total / budget_bytes))))
    return int(min(max(p, 1), max_partitions))


def bucket_of(keys: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Partition id (int32) from the hash's TOP bits, so a later routing on
    the low bits stays independent of it."""
    if num_partitions <= 1:
        return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    bits = int(math.log2(num_partitions))
    # logical shift of the int64 bit pattern: arithmetic, then mask
    return ((murmur64(keys) >> (64 - bits)) & (num_partitions - 1)).to(
        torch.int32)


def bucket_of_np(keys: np.ndarray, num_partitions: int) -> np.ndarray:
    if num_partitions <= 1:
        return np.zeros(keys.shape, np.int32)
    h = murmur64_np(keys)
    return (h >> np.uint64(64 - int(math.log2(num_partitions)))).astype(np.int32)


# ---------------------------------------------------------------------------
# Device-side repartition (one pass)
# ---------------------------------------------------------------------------


def partition_device(keys: torch.Tensor, valid: torch.Tensor,
                     num_partitions: int):
    """Reorder rows bucket-contiguously on the device: ``(perm,
    bucket_sorted)`` with ``perm`` (int32) mapping sorted slot -> original
    row. Invalid rows keep their bucket (the join's validity masks drop
    them later). Boundaries are ``searchsorted(bucket_sorted, arange(P))``."""
    bucket = bucket_of(keys, num_partitions)
    bucket_sorted, perm = torch.sort(bucket, stable=True)
    return perm.to(torch.int32), bucket_sorted


# ---------------------------------------------------------------------------
# Host-side partitioning (pass 1 of the spill path)
# ---------------------------------------------------------------------------


def partition_host(keys: np.ndarray, valid: np.ndarray,
                   payloads: Dict[str, np.ndarray], num_partitions: int):
    """Stable partitioning on the host. Returns ``(parts_keys, parts_valid,
    parts_payloads, row_ids)`` — lists indexed by partition; ``row_ids[p]``
    maps partition rows back to the original row numbers."""
    bucket = bucket_of_np(keys, num_partitions)
    counts = np.bincount(bucket, minlength=num_partitions)
    order = np.argsort(bucket, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(counts)])
    parts_keys, parts_valid, parts_pay, row_ids = [], [], [], []
    for p in range(num_partitions):
        sel = order[bounds[p]: bounds[p + 1]]
        parts_keys.append(keys[sel])
        parts_valid.append(valid[sel])
        parts_pay.append({k: v[sel] for k, v in payloads.items()})
        row_ids.append(sel)
    return parts_keys, parts_valid, parts_pay, row_ids


# ---------------------------------------------------------------------------
# Partition-wise exact join (pass 2)
# ---------------------------------------------------------------------------


class _PairUpload:
    """One partition pair's four padded arrays on their way to ``device``.

    On a CUDA device the arrays are padded into pinned host memory and
    copied with ``non_blocking=True`` on ``copy_stream``; :meth:`tensors`
    makes the current stream wait for the copies. The device tensors are
    allocated on the current stream (which joins and frees them), and the
    copy stream first waits for that stream, so a block the allocator
    hands out again is not written while earlier work still reads it."""

    def __init__(self, arrays, pads, device, copy_stream):
        self._event = None
        host = []
        for a, pad in zip(arrays, pads):
            src = torch.from_numpy(np.ascontiguousarray(a))
            t = torch.zeros(pad, dtype=src.dtype,
                            pin_memory=copy_stream is not None)
            t[: len(a)] = src
            host.append(t)
        if copy_stream is None:
            self._dev = [t.to(device) for t in host]
            return
        self._host = host  # pinned sources outlive the copies
        self._dev = [torch.empty_like(t, device=device) for t in host]
        copy_stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(copy_stream):
            for d, t in zip(self._dev, host):
                d.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(copy_stream)

    def tensors(self):
        if self._event is not None:
            torch.cuda.current_stream(self._dev[0].device).wait_event(
                self._event)
        return self._dev


def partitioned_join_indices(
    build_keys: np.ndarray,
    build_valid: np.ndarray,
    probe_keys: np.ndarray,
    probe_valid: np.ndarray,
    num_partitions: Optional[int] = None,
    budget_bytes: Optional[int] = None,
    device=None,
    fetch=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact inner equi-join streamed partition pair by partition pair
    through ``device`` (the CUDA card by default).

    Host key arrays in; global ``(build_rows, probe_rows)`` index pair out
    (int64) — late materialization is the caller's ``take`` per column.
    Each pair is padded to pow2 buckets and joined with
    :func:`~radixjoin_tpu_torch.ops.join.join_count_and_index`; the upload
    of pair p+1 is under way while pair p computes. Rows with equal keys
    land in the same partition on both sides, so concatenating the
    per-pair outputs is the exact global join.

    ``fetch`` brings a pair's two index tensors to the host as numpy
    arrays (the engine's spill route passes one that times and counts its
    fetches); each pair's upload is traced as an ``upload`` span."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "partitioned_join_indices(): CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    kb = np.asarray(build_keys)
    kp = np.asarray(probe_keys)
    if num_partitions is None:
        num_partitions = choose_num_partitions(
            len(kb), len(kp), budget_bytes=budget_bytes, device=device)
    bparts = partition_host(kb, np.asarray(build_valid), {}, num_partitions)
    pparts = partition_host(kp, np.asarray(probe_valid), {}, num_partitions)
    pairs = [p for p in range(num_partitions)
             if len(bparts[0][p]) and len(pparts[0][p])]
    copy_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                   else None)

    if fetch is None:
        fetch = _fetch

    def upload(p):
        bk, bv, pk, pv = bparts[0][p], bparts[1][p], pparts[0][p], pparts[1][p]
        bpad = join_ops.bucket_size(len(bk))
        ppad = join_ops.bucket_size(len(pk))
        with trace.span("upload") as sp:
            staged = _PairUpload((bk, bv, pk, pv), (bpad, bpad, ppad, ppad),
                                 device, copy_stream)
            if trace.ON:
                sp.note("kind", "pair")
                sp.note("bytes", sum(t.numel() * t.element_size()
                                     for t in staged._dev))
        return staged

    out_b: List[np.ndarray] = []
    out_p: List[np.ndarray] = []
    staged = upload(pairs[0]) if pairs else None
    for i, p in enumerate(pairs):
        current = staged
        staged = upload(pairs[i + 1]) if i + 1 < len(pairs) else None
        bidx, pidx, _live, total = join_ops.join_count_and_index(
            *current.tensors())
        if total == 0:
            continue
        # live rows are exactly the first ``total`` output slots
        fb, fp = fetch([bidx[:total], pidx[:total]])
        out_b.append(bparts[3][p][fb])
        out_p.append(pparts[3][p][fp])

    if not out_b:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return (np.concatenate(out_b).astype(np.int64),
            np.concatenate(out_p).astype(np.int64))


def _fetch(tensors) -> List[np.ndarray]:
    return [t.cpu().numpy() for t in tensors]


def partitioned_join(
    build_keys: np.ndarray,
    build_valid: np.ndarray,
    build_payloads: Dict[str, np.ndarray],
    probe_keys: np.ndarray,
    probe_valid: np.ndarray,
    probe_payloads: Dict[str, np.ndarray],
    num_partitions: Optional[int] = None,
    budget_bytes: Optional[int] = None,
    device=None,
) -> Dict[str, np.ndarray]:
    """Payload-dict convenience wrapper over
    :func:`partitioned_join_indices` (``b.``/``p.``-prefixed columns out)."""
    bidx, pidx = partitioned_join_indices(
        build_keys, build_valid, probe_keys, probe_valid,
        num_partitions, budget_bytes, device,
    )
    out: Dict[str, np.ndarray] = {}
    for name, col in build_payloads.items():
        out[f"b.{name}"] = np.asarray(col)[bidx]
    for name, col in probe_payloads.items():
        out[f"p.{name}"] = np.asarray(col)[pidx]
    return out
