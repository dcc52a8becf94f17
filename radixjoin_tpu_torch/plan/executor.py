"""Executor helpers of the fused plan (port of the parts of
radixjoin_tpu/plan/executor.py that the fused whole-plan executor uses).

* late materialization (:func:`_gather_cols`) and probe-shaped compaction
  (:func:`_compact_probe_shaped`);
* the host-side strategy windows: the unique-scatter key window, the CSR
  index of a scan's key column, and the device-CSR window from a key's
  origin base column;
* upload memos for host columns, paged columns and CSR indexes.

The memos live on the port's own column objects and are keyed by
``(device, pad)``, so one process can run the same plan on the CPU and on
the card, each from its own copies, and never shares state with the JAX
package's objects.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..dtypes import DataType
from ..ops import join as join_ops
from ..ops import kernels
from .ir import Plan, ScanNode


def _gather_cols(cols, idx, live, windowed: bool = False):
    """Late materialization: ``(data[idx], valid[idx] & live)`` per column,
    in input order. ``idx`` is in bounds for every column.

    Small sources (pad <= ``WINDOW_GATHER_MAX``) and, with
    ``windowed=True``, sources gathered along a monotone stream (the CSR
    expansion's ``pidx``) ride one kernel pass for all data and validity
    planes of the call; int64 data gathers natively. Large sources on an
    arbitrary stream use plain gathers."""
    if not cols:
        return ()
    pad = cols[0][0].shape[0]
    idx = idx.to(torch.int32)
    if pad <= kernels.WINDOW_GATHER_MAX or windowed:
        k = len(cols)
        gs = join_ops.gather_expand_multi(
            [d for d, _ in cols] + [v for _, v in cols], idx,
            windowed=windowed,
        )
        return tuple((gs[i], gs[k + i] & live) for i in range(k))
    return tuple(
        (d.index_select(0, idx), v.index_select(0, idx) & live)
        for d, v in cols
    )


def _compact_probe_shaped(cols, live, out_pad: int):
    """Compact live rows to the front of an ``out_pad`` bucket (the same
    scatter-max owner recovery as the join expansion, counts in {0, 1}).
    A live row past ``out_pad`` is dropped; the caller detects that from
    the join's exact total."""
    counts = live.to(torch.int64)
    offsets = torch.cumsum(counts, 0) - counts
    total = counts.sum()
    src = join_ops._owner_recovery(offsets, live, out_pad)
    live_out = torch.arange(out_pad, device=live.device) < total
    return _gather_cols(cols, src, live_out)


def _unique_scatter_window(plan: Plan, j, battr: int, bpad: int, ppad: int):
    """Static key window (base, r_pad) for the scatter unique join, from
    host-side stats of the build scan's key column (the caller guarantees
    the build child is a scan). None when the window is too sparse for
    the dense slot table to beat the sort path."""
    build_child = plan.nodes[j.left if j.build_left else j.right]
    col_idx, _dt = build_child.output_attrs[battr]
    hcol = plan.inputs[build_child.data.base_table_id].to_host().columns[col_idx]
    rng = hcol.valid_range()
    if rng is None:
        return 0, join_ops.MIN_BUCKET  # no valid build rows -> no matches
    base, hi = rng
    r_pad = join_ops.bucket_size(hi - base + 1)
    if r_pad > (1 << 26):
        return None  # cap the slot table at 256 MiB
    if r_pad > max(1 << 20, 32 * (bpad + ppad)):
        return None  # window too sparse vs the sort cost
    return base, r_pad


def _child_csr_index(plan: Plan, child_idx: int, attr: int, bpad: int,
                     ppad: int, device):
    """``(base, counts_w, starts_w, grouped)`` on ``device`` over one
    child's key column, or None when that child is not a base scan, the
    key is not an integer, or the window is too sparse."""
    child = plan.nodes[child_idx]
    if not isinstance(child.data, ScanNode):
        return None
    col_idx, dt = child.output_attrs[attr]
    if dt not in (DataType.INT32, DataType.INT64):
        return None
    hcol = plan.inputs[child.data.base_table_id].to_host().columns[col_idx]
    rng = hcol.valid_range()
    if rng is not None:
        r = join_ops.bucket_size(rng[1] - rng[0] + 1)
        if r > max(1 << 20, 32 * (bpad + ppad)):
            return None  # window too sparse vs the sort cost
    return _csr_device(hcol, device)


def _general_csr_index(plan: Plan, j, battr: int, pattr: int, bpad: int,
                       ppad: int, device):
    """CSR index for a general join: ``(index, swapped)`` or None. Prefers
    indexing the build child; when only the probe child is a base scan the
    roles swap (an inner join is a multiset, so which side is indexed is
    pure strategy)."""
    hit = _child_csr_index(
        plan, j.left if j.build_left else j.right, battr, bpad, ppad, device
    )
    if hit is not None:
        return hit, False
    hit = _child_csr_index(
        plan, j.right if j.build_left else j.left, pattr, ppad, bpad, device
    )
    if hit is not None:
        return hit, True
    return None


def _origin_host_column(plan: Plan, node_idx: int, attr: int):
    """Provenance walk: the base HostColumn a node's output attr descends
    from (every join output column is a gather of some scan column), or
    None for non-integer origins."""
    node = plan.nodes[node_idx]
    if isinstance(node.data, ScanNode):
        col_idx, dt = node.output_attrs[attr]
        if dt not in (DataType.INT32, DataType.INT64):
            return None
        return plan.inputs[node.data.base_table_id].to_host().columns[col_idx]
    j = node.data
    left_w = len(plan.nodes[j.left].output_attrs)
    ci, _dt = node.output_attrs[attr]
    if ci < left_w:
        return _origin_host_column(plan, j.left, ci)
    return _origin_host_column(plan, j.right, ci - left_w)


def _dev_csr_window(plan: Plan, j, battr: int, pattr: int, bpad: int,
                    ppad: int):
    """Key window for the device-CSR general join (both children
    intermediate): ``(swapped, base, r_pad)`` or None. The window comes
    from the key's origin base column, so valid keys are in-window by
    construction; the smaller-padded side is preferred as the indexed
    side."""
    bchild = j.left if j.build_left else j.right
    pchild = j.right if j.build_left else j.left
    cands = sorted([
        (bpad, False, bchild, battr),
        (ppad, True, pchild, pattr),
    ])
    for _pad, swapped, child, attr in cands:
        hcol = _origin_host_column(plan, child, attr)
        if hcol is None:
            continue
        rng = hcol.valid_range()
        if rng is None:
            # all keys NULL -> empty join via window misses (still exact)
            return swapped, 0, join_ops.MIN_BUCKET
        base, hi = rng
        r_pad = join_ops.bucket_size(hi - base + 1)
        if r_pad > (1 << 26):
            continue  # cap window arrays at 256 MiB
        if r_pad > max(1 << 20, 32 * (bpad + ppad)):
            continue  # window too sparse vs the merge-sort cost
        return swapped, base, r_pad
    return None


# ---------------------------------------------------------------------------
# Upload memos (one upload per column object, device and pad)
# ---------------------------------------------------------------------------


def _memo_of(owner) -> dict:
    memo = getattr(owner, "_dev_memo", None)
    if memo is None:
        memo = {}
        object.__setattr__(owner, "_dev_memo", memo)
    return memo


def _device_column_cached(eng, hcol, pad: int, device):
    """Dense upload of a host column, memoized per (device, pad)."""
    memo = _memo_of(hcol)
    key = (torch.device(device), pad)
    if key not in memo:
        memo[key] = eng.host_column_to_device(hcol, pad, device)
    return memo[key]


def _paged_column_cached(eng, pcol, num_rows: int, pad: int, device):
    """Raw-page upload + device decode of an eager paged column, memoized
    per (device, pad); None when the column is not eligible (see
    ``engine.paged_column_to_device``)."""
    from ..storage import device_decode as dd

    if not dd.enabled():
        return None
    memo = _memo_of(pcol)
    if memo.get("ineligible"):
        return None
    key = (torch.device(device), pad)
    if key not in memo:
        dev = eng.paged_column_to_device(pcol, num_rows, pad, device)
        if dev is None:
            memo["ineligible"] = True
            return None
        memo[key] = dev
    return memo[key]


def _csr_device(hcol, device) -> Optional[tuple]:
    """A column's host-built CSR index (``HostColumn.csr_index``) uploaded
    once per device: ``(base, counts_w, starts_w, grouped)`` with ``base``
    a Python int, or None when the column has no CSR index."""
    memo = _memo_of(hcol)
    key = ("csr", torch.device(device))
    if key not in memo:
        idx = hcol.csr_index()
        memo[key] = None if idx is None else (idx[0],) + tuple(
            torch.from_numpy(a).to(device) for a in idx[1:]
        )
    return memo[key]
