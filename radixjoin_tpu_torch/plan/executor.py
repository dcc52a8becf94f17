"""The fused executor's operands and memos (port of the helpers of
radixjoin_tpu/plan/executor.py that the fused plan uses).

* the strategy knobs that shape a fused structure (:func:`strategy_knobs`)
  and its cardinality feedback (:func:`card_feedback_on`);
* late materialization (:func:`_gather_cols`) and probe-shaped compaction
  (:func:`_compact_probe_shaped`);
* the host-side strategy windows: the unique-scatter key window, the CSR
  index of a scan's key column, and the device-CSR window from a key's
  origin base column;
* upload memos for host columns, paged columns and CSR indexes, charged
  to the device's ledger (``engine.DeviceLedger``) and evicted under
  memory pressure.

The memos live on the port's own column objects and are keyed by
``(device, pad)``, so one process can run the same plan on the CPU and on
the card, each from its own copies and against its own ledger, and never
shares state with the JAX package's objects.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import torch

from .. import hardware, trace
from ..dtypes import DataType
from ..ops import join as join_ops
from ..ops import kernels
from .ir import Plan, ScanNode

# ---------------------------------------------------------------------------
# Strategy knobs (docs/CONFIG.md): read from the environment at every use
# ---------------------------------------------------------------------------


def _knob(name: str, default: str, allowed) -> str:
    """The value of a strategy knob; an unknown value raises ``ValueError``."""
    value = os.environ.get(name, default)
    if value not in allowed:
        raise ValueError(
            f"{name}={value!r}: expected one of {', '.join(allowed)}")
    return value


def _int_knob(name: str, default: int) -> int:
    value = os.environ.get(name)
    if value is None or value == "":
        return default
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"{name}={value!r}: expected an integer") from None


def unique_join_mode() -> str:
    return _knob("RJT_UNIQUE_JOIN", "auto", ("auto", "scatter", "sort"))


def csr_join_mode() -> str:
    return _knob("RJT_CSR_JOIN", "auto", ("auto", "force", "off"))


def dev_csr_mode() -> str:
    return _knob("RJT_DEV_CSR", "auto", ("auto", "force", "off"))


def card_feedback_on() -> bool:
    return _knob("RJT_CARD_FEEDBACK", "on", ("on", "off")) == "on"


def strategy_knobs() -> tuple:
    """The knobs that shape a fused structure, as a hashable value: part of
    the key a plan's cached structure is stored under, so a knob changed
    between two runs of one plan object rebuilds the structure."""
    from . import fused

    return (unique_join_mode(), csr_join_mode(), dev_csr_mode(),
            fused.big_merge_pad())


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
    owner recovery as the join expansion, counts in {0, 1}).
    A live row past ``out_pad`` is dropped; the caller detects that from
    the join's exact total."""
    counts = live.to(torch.int64)
    offsets = torch.cumsum(counts, 0) - counts
    total = counts.sum()
    src = join_ops._owner_recovery(offsets, total, out_pad)
    live_out = torch.arange(out_pad, device=live.device) < total
    return _gather_cols(cols, src, live_out)


def _unique_scatter_window(plan: Plan, j, battr: int, bpad: int, ppad: int):
    """Static key window (base, r_pad) for the scatter unique join, from
    host-side stats of the build scan's key column (the caller guarantees
    the build child is a scan). None when the window is too sparse for
    the dense slot table to beat the sort path. ``RJT_UNIQUE_JOIN=sort``
    always takes the sort path; ``scatter`` skips the sparseness test."""
    mode = unique_join_mode()
    if mode == "sort":
        return None
    build_child = plan.nodes[j.left if j.build_left else j.right]
    col_idx, _dt = build_child.output_attrs[battr]
    hcol = plan.inputs[build_child.data.base_table_id].to_host().columns[col_idx]
    rng = hcol.valid_range()
    if rng is None:
        return 0, join_ops.MIN_BUCKET  # no valid build rows -> no matches
    base, hi = rng
    r_pad = join_ops.bucket_size(hi - base + 1)
    verdict = _window_verdict(r_pad, bpad, ppad)
    if verdict == "window_cap" or (verdict == "sparse" and mode != "scatter"):
        return None
    return base, r_pad


def _child_csr_index(plan: Plan, child_idx: int, attr: int, bpad: int,
                     ppad: int, device, mode: str = "auto"):
    """``((base, counts_w, starts_w, grouped), owner)`` on ``device`` over
    one child's key column — ``owner`` is the host column whose memo (and
    ledger entry) holds the index — or None when that child is not a base
    scan, the key is not an integer, the window is too sparse (not asked
    under ``mode == "force"``) or the column has no CSR index."""
    child = plan.nodes[child_idx]
    if not isinstance(child.data, ScanNode):
        return None
    col_idx, dt = child.output_attrs[attr]
    if dt not in (DataType.INT32, DataType.INT64):
        return None
    hcol = plan.inputs[child.data.base_table_id].to_host().columns[col_idx]
    rng = hcol.valid_range()
    if rng is not None and mode != "force":
        r = join_ops.bucket_size(rng[1] - rng[0] + 1)
        if r > max(1 << 20, 32 * (bpad + ppad)):
            return None  # window too sparse vs the sort cost
    index = _csr_device(hcol, device)
    return None if index is None else (index, hcol)


def _general_csr_index(plan: Plan, j, battr: int, pattr: int, bpad: int,
                       ppad: int, device):
    """CSR index for a general join: ``(index, swapped, owner)`` or None.
    Prefers indexing the build child; when only the probe child is a base scan the
    roles swap (an inner join is a multiset, so which side is indexed is
    pure strategy). ``RJT_CSR_JOIN=off`` disables the path; ``force`` skips
    the sparseness test."""
    mode = csr_join_mode()
    if mode == "off":
        return None
    hit = _child_csr_index(
        plan, j.left if j.build_left else j.right, battr, bpad, ppad, device,
        mode,
    )
    if hit is not None:
        return hit[0], False, hit[1]
    hit = _child_csr_index(
        plan, j.right if j.build_left else j.left, pattr, ppad, bpad, device,
        mode,
    )
    if hit is not None:
        return hit[0], True, hit[1]
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
    side. ``RJT_DEV_CSR=off`` disables the path; ``force`` skips the
    economy test."""
    mode = dev_csr_mode()
    if mode == "off":
        return None
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
        verdict = _window_verdict(r_pad, bpad, ppad)
        if verdict == "window_cap" or (verdict == "sparse"
                                       and mode != "force"):
            continue
        return swapped, base, r_pad
    return None


# ---------------------------------------------------------------------------
# Why a join sorts
# ---------------------------------------------------------------------------

#: the largest key window of the dense strategies' device tables (the
#: unique-scatter slot table, the device CSR): 256 MiB of int32 slots
DENSE_WINDOW_CAP = 1 << 26


def _window_verdict(r_pad: int, bpad: int, ppad: int) -> Optional[str]:
    """Why a dense strategy would not take a key window of ``r_pad``
    slots at these pads: ``window_cap`` (over :data:`DENSE_WINDOW_CAP`),
    ``sparse`` (the window too sparse to beat a sort of both sides), or
    None (it would). The unique-scatter and device-CSR windows apply it;
    ``RJT_UNIQUE_JOIN=scatter`` and ``RJT_DEV_CSR=force`` waive
    ``sparse``."""
    if r_pad > DENSE_WINDOW_CAP:
        return "window_cap"
    if r_pad > max(1 << 20, 32 * (bpad + ppad)):
        return "sparse"
    return None


def _window_pad(hcol) -> int:
    rng = hcol.valid_range()
    if rng is None:
        return join_ops.MIN_BUCKET
    return join_ops.bucket_size(rng[1] - rng[0] + 1)


def unique_sort_reason(plan: Plan, j, battr: int, bpad: int, ppad: int):
    """``(reason, window_log2)`` of a unique-key join that took
    ``unique_sort``: why the slot table over the build key's window did not
    take it (``window_cap``, ``sparse``, or ``knob`` where only
    ``RJT_UNIQUE_JOIN=sort`` kept it off), and the log2 of that window."""
    build_child = plan.nodes[j.left if j.build_left else j.right]
    col_idx, _dt = build_child.output_attrs[battr]
    hcol = plan.inputs[build_child.data.base_table_id].to_host().columns[col_idx]
    r_pad = _window_pad(hcol)
    return (_window_verdict(r_pad, bpad, ppad) or "knob",
            r_pad.bit_length() - 1)


def merge_reason(plan: Plan, j, battr: int, pattr: int, bpad: int,
                 ppad: int, key_dtype, big: bool):
    """``(reason, window_log2)`` of a join that took ``merge``: where the
    combined pad sent it there (``big``), ``big_merge``, or ``knob`` where
    only a lowered ``RJT_BIG_MERGE`` did (window_log2 None: no window was
    asked); an FP64 key, ``key_type`` (None); otherwise the verdict on the
    narrower of the two sides' key windows, the device CSR's candidates
    (``window_cap``, ``sparse``, or ``knob`` where only ``RJT_CSR_JOIN`` /
    ``RJT_DEV_CSR`` set to ``off`` kept a dense strategy off), and the log2
    of that window."""
    from . import fused

    if big:
        by_default = bpad + ppad >= fused.BIG_MERGE_PAD
        return ("big_merge" if by_default else "knob"), None
    if key_dtype not in (DataType.INT32, DataType.INT64):
        return "key_type", None
    bchild = j.left if j.build_left else j.right
    pchild = j.right if j.build_left else j.left
    r_pad = min(_window_pad(_origin_host_column(plan, child, attr))
                for child, attr in ((bchild, battr), (pchild, pattr)))
    return (_window_verdict(r_pad, bpad, ppad) or "knob",
            r_pad.bit_length() - 1)


# ---------------------------------------------------------------------------
# Upload memos, charged to the device ledger
# ---------------------------------------------------------------------------


def _dev_col_bytes(dev) -> int:
    return (dev.data.numel() * dev.data.element_size()
            + dev.valid.numel() * dev.valid.element_size())


#: per-owner upload serialization: threads racing one column's memo miss
#: would both upload and double-charge the ledger. Striped by id(owner) —
#: a collision only costs spurious serialization.
_OWNER_LOCKS = [threading.Lock() for _ in range(64)]


def _owner_lock(owner) -> threading.Lock:
    return _OWNER_LOCKS[id(owner) % 64]


def _memo_of(owner) -> dict:
    memo = getattr(owner, "_dev_memo", None)
    if memo is None:
        with _owner_lock(owner):
            memo = getattr(owner, "_dev_memo", None)
            if memo is None:
                memo = {}
                object.__setattr__(owner, "_dev_memo", memo)
    return memo


def _memo_key_device(key) -> torch.device:
    """The device of a memo key: ``(device, pad)`` for a column upload,
    ``("csr", device)`` for a CSR index."""
    return key[1] if key[0] == "csr" else key[0]


#: the upload memos: ``memo_hits``, ``memo_misses`` (each an upload) and
#: the ``bytes`` uploaded
UPLOAD_STATS = trace.Counters("upload", ("memo_hits", "memo_misses", "bytes"))


def _cached_upload(eng, owner, key, device, make, kind: str):
    """The upload memos' shared protocol. ``make()`` uploads and returns
    ``(value, nbytes)``; the value is kept in ``owner``'s memo under ``key``
    and its bytes are charged to ``device``'s ledger. Hits and misses are
    counted (:data:`UPLOAD_STATS`), and a miss is traced as an ``upload``
    span (``kind``: ``column``, ``paged`` or ``csr``; its bytes).

    A memo hit counts only if ``touch`` confirms the ledger entry is live:
    touch token-protects it against eviction through the caller's query,
    and a False touch is the only sign that the memo is stale (an eviction
    drops the memo's references under the ledger's lock; a tensor has no
    deleted state to ask for). The miss path first PINS the owner with a
    zero-byte ``charge`` (serializing against an eviction in flight),
    re-checks the memo, and only then uploads — no double upload, no
    double charge.

    A cached upload is read later from other CUDA streams (each plan of a
    batch runs on its own), so the uploading stream is synchronized before
    the value is published."""
    ledger = eng.device_ledger(device)
    memo = _memo_of(owner)
    value = memo.get(key)  # .get: a concurrent eviction may pop the key
    # the second read: between the first and the touch another thread may
    # have evicted the entry and uploaded it again under a new value
    if value is not None and ledger.touch(owner) and memo.get(key) is value:
        UPLOAD_STATS.add("memo_hits")
        return value
    release = eng.column_cache_release(device)
    with _owner_lock(owner):
        ledger.charge(owner, 0, release)
        value = memo.get(key)
        if value is not None:
            UPLOAD_STATS.add("memo_hits")
            return value
        UPLOAD_STATS.add("memo_misses")
        with trace.span("upload") as sp:
            value, nbytes = make()
            if value is not None:
                if device.type == "cuda":
                    torch.cuda.current_stream(device).synchronize()
                memo[key] = value
                ledger.charge(owner, nbytes, release)
                UPLOAD_STATS.add("bytes", nbytes)
            if trace.ON:
                sp.note("kind", kind)
                sp.note("bytes", nbytes)
    return value


def _device_column_cached(eng, hcol, pad: int, device):
    """Dense upload of a host column, memoized per (device, pad) and
    charged to the device ledger (evicted and re-uploaded under memory
    pressure)."""
    device = hardware.norm_device(device)

    def make():
        dev = eng.host_column_to_device(hcol, pad, device)
        return dev, _dev_col_bytes(dev)

    return _cached_upload(eng, hcol, (device, pad), device, make, "column")


def _paged_column_cached(eng, pcol, num_rows: int, pad: int, device):
    """Raw-page upload + device decode of an eager paged column, memoized
    per (device, pad) and charged to the device ledger; None when the
    column is not eligible (see ``engine.paged_column_to_device``), which
    is memoized too so the alignment scan of the page headers runs once."""
    from ..storage import device_decode as dd

    if not dd.enabled():
        return None
    if _memo_of(pcol).get("ineligible"):
        return None
    device = hardware.norm_device(device)

    def make():
        dev = eng.paged_column_to_device(pcol, num_rows, pad, device)
        if dev is None:
            _memo_of(pcol)["ineligible"] = True
            return None, 0
        return dev, _dev_col_bytes(dev)

    return _cached_upload(eng, pcol, (device, pad), device, make, "paged")


def _csr_device(hcol, device) -> Optional[tuple]:
    """A column's host-built CSR index (``HostColumn.csr_index``) uploaded
    once per device and charged to the device ledger: ``(base, counts_w,
    starts_w, grouped)`` with ``base`` a Python int, or None when the
    column has no CSR index (memoized as ``(None,)``)."""
    from .. import engine as eng

    device = hardware.norm_device(device)

    def make():
        idx = hcol.csr_index()
        if idx is None:
            return (None,), 0
        arrays = tuple(torch.from_numpy(a).to(device) for a in idx[1:])
        return (idx[0],) + arrays, sum(
            a.numel() * a.element_size() for a in arrays)

    value = _cached_upload(eng, hcol, ("csr", device), device, make, "csr")
    return None if value == (None,) else value
