"""The wave executor and the executor helpers of the fused plan (port of
radixjoin_tpu/plan/executor.py).

The wave executor (:func:`run_plan`, :func:`execute_shared`) serves
``RJT_EXEC_MODE=shared`` and, in ``auto`` mode, every plan the fused
structure declines. It runs the plan in topological waves of per-join
functions whose shapes are pow2 buckets; intermediates stay on the device,
FK->PK joins are probe-shaped (no output-size choice, no sync), general
joins write into a bucket seeded by the probe pad and emit their exact
total as a device scalar. After a wave that holds a big node the wave's
totals are fetched (one sync, at most ``RJT_SHRINK_MAX_SYNCS`` a query)
and oversized intermediates shrink before the next wave; all remaining
totals come back in one fetch at the root, and only overflowed joins re-run
with exact buckets. The JAX package built it to share a handful of compiled
programs between queries; eager torch compiles nothing, so here it is the
same per-join functions the fused executor runs, in wave order.

Shared with the fused executor:

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
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import hardware
from ..dtypes import DataType
from ..ops import join as join_ops
from ..ops import kernels
from .ir import JoinNode, Plan, ScanNode

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


def general_join_mode() -> str:
    return _knob("RJT_GENERAL_JOIN", "merge", ("merge", "sort3"))


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
    if r_pad > (1 << 26):
        return None  # cap the slot table at 256 MiB
    if mode != "scatter" and r_pad > max(1 << 20, 32 * (bpad + ppad)):
        return None  # window too sparse vs the sort cost
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
        if r_pad > (1 << 26):
            continue  # cap window arrays at 256 MiB
        if mode != "force" and r_pad > max(1 << 20, 32 * (bpad + ppad)):
            continue  # window too sparse vs the merge-sort cost
        return swapped, base, r_pad
    return None


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


def _cached_upload(eng, owner, key, device, make):
    """The upload memos' shared protocol. ``make()`` uploads and returns
    ``(value, nbytes)``; the value is kept in ``owner``'s memo under ``key``
    and its bytes are charged to ``device``'s ledger.

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
    if value is not None and ledger.touch(owner):
        return value
    release = eng.column_cache_release(device)
    with _owner_lock(owner):
        ledger.charge(owner, 0, release)
        value = memo.get(key)
        if value is not None:
            return value
        value, nbytes = make()
        if value is not None:
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
            memo[key] = value
            ledger.charge(owner, nbytes, release)
    return value


def _device_column_cached(eng, hcol, pad: int, device):
    """Dense upload of a host column, memoized per (device, pad) and
    charged to the device ledger (evicted and re-uploaded under memory
    pressure)."""
    device = hardware.norm_device(device)

    def make():
        dev = eng.host_column_to_device(hcol, pad, device)
        return dev, _dev_col_bytes(dev)

    return _cached_upload(eng, hcol, (device, pad), device, make)


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

    return _cached_upload(eng, pcol, (device, pad), device, make)


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

    value = _cached_upload(eng, hcol, ("csr", device), device, make)
    return None if value == (None,) else value


# ---------------------------------------------------------------------------
# Per-join functions of the wave executor
# ---------------------------------------------------------------------------


def _join_general(kb, vb, kp, vp, bcols, pcols, out_pad: int):
    """Count + expand + gather for a duplicate-capable build side
    (three-sort formulation: build sort + two binary searches).

    ``bcols``/``pcols``: tuples of (data, valid) payload tensors. Returns
    ``(out_b, out_p, live, total)`` with outputs in the ``out_pad`` bucket."""
    perm, lo, _counts, offsets, total = join_ops.join_count_impl(
        kb, vb, kp, vp)
    bidx, pidx, live = join_ops.join_expand_impl(
        perm, lo, offsets, total, out_pad)
    return (_gather_cols(bcols, bidx, live), _gather_cols(pcols, pidx, live),
            live, total)


def _join_general_merge(kb, vb, kp, vp, bcols, pcols, out_pad: int):
    """Single-sort merge-join formulation (``join_merge_full_impl``):
    payload planes ride the sort; output rows are ordered by sorted probe
    position (a legal multiset ordering)."""
    out_b, out_p, live, total = join_ops.join_merge_full_impl(
        kb, vb, kp, vp, out_pad, bcols, pcols)
    return tuple(out_b), tuple(out_p), live, total


def _general_impl():
    """The general join without a key window: ``RJT_GENERAL_JOIN`` =
    ``merge`` (default) or ``sort3``."""
    return (_join_general_merge if general_join_mode() == "merge"
            else _join_general)


def _join_unique(kb, vb, kp, vp, bcols):
    """FK->PK fast path: probe-shaped output, no bucket choice, no sync.
    Probe payloads do not pass through: the caller ANDs ``found`` into
    their validity (:func:`_mask_cols`)."""
    bidx, found, total = join_ops.join_unique_impl(kb, vb, kp, vp)
    return _gather_cols(bcols, bidx, found), found, total


def _join_unique_scatter(kb, vb, kp, vp, base: int, bcols, r_pad: int):
    """Sort-free FK->PK fast path over a dense key-window slot table
    (``join_unique_scatter_impl``). Probe-shaped like :func:`_join_unique`."""
    bidx, found, total = join_ops.join_unique_scatter_impl(
        kb, vb, kp, vp, base, r_pad)
    return _gather_cols(bcols, bidx, found), found, total


def _join_general_csr(counts_w, starts_w, grouped, kp, vp, base: int, bcols,
                      pcols, s_pad: int):
    """Sort-free general join against a host-built CSR index of a base scan
    (``join_csr_impl``). Same contract as :func:`_join_general_merge`.

    ``pidx`` is the monotone owner stream, in bounds over the whole pad of
    the side whose keys took the probe role, so the payloads of that side
    (``pcols``) ride the blocked-window kernel; ``bidx`` jumps between
    grouped rows and takes the unwindowed route."""
    bidx, pidx, live, total = join_ops.join_csr_impl(
        counts_w, starts_w, grouped, kp, vp, base, s_pad)
    return (_gather_cols(bcols, bidx, live),
            _gather_cols(pcols, pidx, live, windowed=True), live, total)


def _join_dev_csr(kb, vb, kp, vp, base: int, bcols, pcols, r_pad: int,
                  s_pad: int):
    """General join over a CSR index built on the device
    (``join_dev_csr_impl``). Same contract and the same index streams as
    :func:`_join_general_csr`."""
    bidx, pidx, live, total = join_ops.join_dev_csr_impl(
        kb, vb, kp, vp, base, r_pad, s_pad)
    return (_gather_cols(bcols, bidx, live),
            _gather_cols(pcols, pidx, live, windowed=True), live, total)


def _mask_cols(cols, mask):
    return tuple((d, v & mask) for d, v in cols)


# Join-path observability: which function family each executed join of the
# wave executor took, counted per process.
PATH_STATS: Dict[str, int] = {}

# Host syncs and shrinks of the wave executor, counted per process:
# ``shrink_syncs`` (a wave's totals fetched mid-plan), ``totals_fetches``
# (the fetch of the remaining totals at the root, one per attempt),
# ``root_fetches``, and how nodes shrank (``shrink_slices`` for compacted
# nodes, ``shrink_compactions`` for probe-shaped ones).
SYNC_STATS: Dict[str, int] = {
    "shrink_syncs": 0, "totals_fetches": 0, "root_fetches": 0,
    "shrink_slices": 0, "shrink_compactions": 0, "redispatches": 0,
}


def _count_path(name: str) -> None:
    PATH_STATS[name] = PATH_STATS.get(name, 0) + 1


def path_stats() -> Dict[str, int]:
    """Snapshot of join-path counts: unique_scatter / unique_sort /
    general_csr[_swapped] / dev_csr[_swapped] / general_merge[why] /
    empty_type_mismatch."""
    return dict(PATH_STATS)


def sync_stats() -> Dict[str, int]:
    """Snapshot of :data:`SYNC_STATS`."""
    return dict(SYNC_STATS)


# ---------------------------------------------------------------------------
# Wave executor
# ---------------------------------------------------------------------------


class _NodeResult:
    """Device columns of one executed plan node."""

    __slots__ = ("cols", "total_dev", "pad", "compacted", "dicts", "live")

    def __init__(self, cols, total_dev, pad, compacted, dicts, live=None):
        self.cols = cols  # list[(data, valid)]
        self.total_dev = total_dev  # device scalar, or a Python int once known
        self.pad = pad
        self.compacted = compacted  # rows [0:total) are the live rows
        self.dicts = dicts  # per-col StringDict or None
        #: probe-shaped nodes only: the match mask (a row with a NULL
        #: payload is live but invalid — compaction must use this, not the
        #: per-column validity)
        self.live = live


# Shrink policy: syncing a wave's totals costs one device->host round trip
# but lets every downstream join run at live-row scale. By default a query
# syncs at most once and only for waves holding a node padded to 2^18 rows
# or more. Env overrides: RJT_SHRINK_MIN_PAD, RJT_SHRINK_MAX_SYNCS.
_SHRINK_FACTOR = 4

#: a compacted node shrinks by slicing, and a slice of a tensor is a view
#: that keeps the whole pad's storage alive: the shrunk rows are copied so
#: the big bucket is freed. False keeps the views (to measure the copy's
#: effect on peak memory).
SHRINK_COPY = True


def _shrink_policy():
    return (_int_knob("RJT_SHRINK_MIN_PAD", 1 << 18),
            _int_knob("RJT_SHRINK_MAX_SYNCS", 1))


def _shrink_node(res: _NodeResult, total: int) -> _NodeResult:
    """Shrink a node to its exact bucket once ``total`` is known: a copy of
    the leading rows for compacted nodes, a compaction for probe-shaped."""
    new_pad = join_ops.bucket_size(total)
    if res.compacted:
        if new_pad >= res.pad:
            res.total_dev = total
            return res
        SYNC_STATS["shrink_slices"] += 1
        cut = (lambda a: a[:new_pad].clone()) if SHRINK_COPY else (
            lambda a: a[:new_pad])
        cols = [(cut(d), cut(v)) for d, v in res.cols]
        return _NodeResult(cols, total, new_pad, True, res.dicts)
    if new_pad * _SHRINK_FACTOR > res.pad:
        res.total_dev = total
        return res
    SYNC_STATS["shrink_compactions"] += 1
    cols = _compact_probe_shaped(tuple(res.cols), res.live, new_pad)
    return _NodeResult(list(cols), total, new_pad, True, res.dicts)


def _levels(plan: Plan, order):
    level: Dict[int, int] = {}
    for idx in order:
        node = plan.nodes[idx]
        if isinstance(node.data, ScanNode):
            level[idx] = 0
        else:
            level[idx] = 1 + max(level[node.data.left], level[node.data.right])
    return level


def run_plan(plan: Plan, unique_joins: frozenset, device,
             max_attempts: int = 12, stats: Optional[dict] = None):
    """Execute ``plan`` on ``device`` in topological waves.

    After each wave containing a big node, its exact totals are fetched
    (one small sync) and oversized intermediates are shrunk before the
    next wave dispatches — JOB joins are highly selective, so downstream
    joins then run at live-row scale instead of the base-table pad.
    General-join overflows in a synced wave are re-dispatched immediately
    with exact buckets (their consumers have not run yet); overflows in
    never-synced (small) waves are fixed up by recomputing the affected
    ancestor chain at the end.

    **Cardinality feedback** (``RJT_CARD_FEEDBACK``, default on): a
    successful run records each join's exact bucket on the plan object
    (``plan._learned_buckets``, the store the fused executor reads and
    writes too); repeat executions of the same plan seed general joins with
    those exact buckets and compact probe-shaped outputs to their known
    size right after dispatch — all downstream work then runs at live-row
    scale with no mid-flight sync (a wave the feedback covers is not synced,
    however big: a departure from the JAX package, which syncs a big wave
    again). Stale feedback (the data changed) is
    caught by the same exact-totals overflow check and the affected subtree
    recomputes, so results stay exact.

    ``stats``, when given, receives this run's ``shrink_syncs``, fetch
    ``rounds`` and ``fetch_ms``. Returns ``(root_result, totals_by_node)``.
    """
    from .. import engine as eng

    device = hardware.norm_device(device)
    if stats is None:
        stats = {}
    stats.update(shrink_syncs=0, rounds=0, fetch_ms=0.0)
    # every knob is read here once, so that an unknown value raises whether
    # or not this plan has a join that would have asked for it
    strategy_knobs()
    general_join_mode()
    shrink_min_pad, max_syncs = _shrink_policy()

    def fetch_totals(ids):
        """The exact totals of the nodes ``ids`` as Python ints, in one
        device-to-host copy (the device scalars are stacked first)."""
        if not ids:
            return []
        t0 = time.perf_counter()
        (totals,) = eng._fetch(
            [torch.stack([results[i].total_dev for i in ids])])
        stats["fetch_ms"] += (time.perf_counter() - t0) * 1e3
        stats["rounds"] += 1
        return [int(t) for t in totals]

    buckets: Dict[int, int] = {}
    order = plan.topo_order()
    join_ids = [i for i in order if isinstance(plan.nodes[i].data, JoinNode)]
    level = _levels(plan, order)
    results: Dict[int, _NodeResult] = {}
    totals_by_node: Dict[int, int] = {}

    feedback_on = card_feedback_on()
    learned = getattr(plan, "_learned_buckets", None) if feedback_on else None
    if learned:
        for idx, (pad, was_compacted) in learned.items():
            if was_compacted:
                buckets.setdefault(idx, pad)

    for idx in order:
        if isinstance(plan.nodes[idx].data, ScanNode):
            results[idx] = _run_scan(eng, plan, idx, plan.nodes[idx], device)

    waves: Dict[int, list] = {}
    for idx in join_ids:
        waves.setdefault(level[idx], []).append(idx)
    wave_list = [waves[k] for k in sorted(waves)]

    syncs = 0
    dispatch_compacted: Dict[int, bool] = {}
    for wi, wave in enumerate(wave_list):
        for idx in wave:
            res = results[idx] = _run_join(
                eng, plan, idx, plan.nodes[idx], results, buckets,
                unique_joins, device,
            )
            dispatch_compacted.setdefault(idx, res.compacted)
            if learned and not res.compacted:
                lp, was_compacted = learned.get(idx, (None, None))
                if (
                    lp is not None
                    and not was_compacted
                    and lp * _SHRINK_FACTOR <= res.pad
                ):
                    # known-size probe-shaped output: compact immediately
                    # (no sync; a stale undersized pad is caught by the
                    # final totals check and the subtree recomputes)
                    cols = _compact_probe_shaped(
                        tuple(res.cols), res.live, lp)
                    results[idx] = _NodeResult(
                        list(cols), res.total_dev, lp, True, res.dicts)
        is_last = wi == len(wave_list) - 1
        if (
            is_last
            or syncs >= max_syncs
            or not any(results[i].pad >= shrink_min_pad for i in wave)
            # the sync exists to learn the wave's totals; a wave whose
            # totals the feedback already gave ran at its exact buckets,
            # and the final check catches feedback gone stale
            or (learned and all(i in learned for i in wave))
        ):
            continue
        syncs += 1
        stats["shrink_syncs"] += 1
        SYNC_STATS["shrink_syncs"] += 1
        for idx, t in zip(wave, fetch_totals(wave)):
            res = results[idx]
            if res.compacted and t > res.pad:
                # overflow: children are exact (earlier waves), re-dispatch
                # this node alone with its exact bucket
                buckets[idx] = join_ops.bucket_size(t)
                SYNC_STATS["redispatches"] += 1
                res = results[idx] = _run_join(
                    eng, plan, idx, plan.nodes[idx], results, buckets,
                    unique_joins, device,
                )
            totals_by_node[idx] = t
            results[idx] = _shrink_node(res, t)

    # Final fetch: the remaining totals, in one copy. The root's rows are
    # fetched afterwards at their exact count (fetch_root): on the card a
    # round trip costs microseconds, so no speculative slice of the root
    # rides along.
    for _attempt in range(max_attempts):
        fetch_ids = [i for i in join_ids if i not in totals_by_node]
        SYNC_STATS["totals_fetches"] += bool(fetch_ids)
        for i, t in zip(fetch_ids, fetch_totals(fetch_ids)):
            totals_by_node[i] = t

        # residual overflow fixup (only never-synced, i.e. small, nodes)
        bad = [
            i for i in join_ids
            if results[i].compacted and totals_by_node[i] > results[i].pad
        ]
        if not bad:
            if feedback_on:
                # exact buckets for the next execution of this plan
                # (general nodes seed their bucket; probe-shaped nodes
                # compact to this pad right after dispatch)
                plan._learned_buckets = {
                    i: (
                        join_ops.bucket_size(totals_by_node[i]),
                        (i in buckets) or dispatch_compacted.get(i, True),
                    )
                    for i in join_ids
                }
            return results[plan.root], totals_by_node
        affected = set()
        parent: Dict[int, int] = {}
        for idx in join_ids:
            j = plan.nodes[idx].data
            parent[j.left] = idx
            parent[j.right] = idx
        for b in bad:
            buckets[b] = join_ops.bucket_size(totals_by_node[b])
            n = b
            while n is not None:
                affected.add(n)
                n = parent.get(n)
        for idx in order:
            if idx in affected and isinstance(plan.nodes[idx].data, JoinNode):
                SYNC_STATS["redispatches"] += 1
                results[idx] = _run_join(
                    eng, plan, idx, plan.nodes[idx], results, buckets,
                    unique_joins, device,
                )
                totals_by_node.pop(idx, None)
    raise RuntimeError("plan did not converge to exact buckets")


def _run_scan(eng, plan: Plan, idx: int, node, device) -> _NodeResult:
    table = plan.inputs[node.data.base_table_id]
    pad = join_ops.bucket_size(table.num_rows)
    host = None
    cols, dicts = [], []
    for ci, dt in node.output_attrs:
        pcol = table.columns[ci]
        if pcol.type is not dt:
            raise TypeError(
                f"scan output attr {ci}: declared {dt}, stored {pcol.type}"
            )
        # device page decode first (raw-page upload, no host decode);
        # falls back to host decode + dense upload when ineligible
        dev = _paged_column_cached(eng, pcol, table.num_rows, pad, device)
        if dev is None:
            if host is None:
                host = table.to_host()
            dev = _device_column_cached(eng, host.columns[ci], pad, device)
        cols.append((dev.data, dev.valid))
        dicts.append(dev.dictionary)
    return _NodeResult(cols, table.num_rows, pad, True, dicts)


def _run_join(eng, plan: Plan, idx: int, node, results, buckets,
              unique_joins, device) -> _NodeResult:
    j = node.data
    left, right = results[j.left], results[j.right]
    left_w = len(plan.nodes[j.left].output_attrs)

    if j.build_left:
        build, probe = left, right
        battr, pattr = j.left_attr, j.right_attr
        bchild_id, pchild_id = j.left, j.right
    else:
        build, probe = right, left
        battr, pattr = j.right_attr, j.left_attr
        bchild_id, pchild_id = j.right, j.left

    # key normalization (types, FP64 canon, VARCHAR dictionary unification)
    bd, bv = build.cols[battr]
    pd, pv = probe.cols[pattr]
    bcol = eng.DevColumn(plan.nodes[bchild_id].output_attrs[battr][1],
                         bd, bv, build.dicts[battr])
    pcol = eng.DevColumn(plan.nodes[pchild_id].output_attrs[pattr][1],
                         pd, pv, probe.dicts[pattr])
    keys = eng.normalize_join_keys(bcol, pcol)

    # payload wiring: which child columns feed the output
    out_sources = []  # (from_build_side?, child_col_index)
    for ci, _dt in node.output_attrs:
        side_left = ci < left_w
        child_ci = ci if side_left else ci - left_w
        out_sources.append((side_left == j.build_left, child_ci))

    if keys is None:
        _count_path("empty_type_mismatch")
        pad = join_ops.bucket_size(0)
        cols, dicts = [], []
        for fb, ci in out_sources:
            src = build if fb else probe
            cols.append((
                torch.zeros(pad, dtype=src.cols[ci][0].dtype, device=device),
                torch.zeros(pad, dtype=torch.bool, device=device),
            ))
            dicts.append(src.dicts[ci])
        zero = torch.zeros((), dtype=torch.int64, device=device)
        return _NodeResult(cols, zero, pad, True, dicts)

    (kb, vb), (kp, vp) = keys

    bcols, bmap = [], {}
    pcols, pmap = [], {}
    for fb, ci in out_sources:
        if fb and ci not in bmap:
            bmap[ci] = len(bcols)
            bcols.append(build.cols[ci])
        if not fb and ci not in pmap:
            pmap[ci] = len(pcols)
            pcols.append(probe.cols[ci])
    bcols, pcols = tuple(bcols), tuple(pcols)

    int_key = bcol.dtype in (DataType.INT32, DataType.INT64)
    if idx in unique_joins and int_key and buckets.get(idx) is None:
        window = _unique_scatter_window(
            plan, j, battr, kb.shape[0], kp.shape[0])
        if window is not None:
            _count_path("unique_scatter")
            base, r_pad = window
            out_b, found, total = _join_unique_scatter(
                kb, vb, kp, vp, base, bcols, r_pad)
        else:
            _count_path("unique_sort")
            out_b, found, total = _join_unique(kb, vb, kp, vp, bcols)
        out_p = _mask_cols(pcols, found)
        pad = probe.pad
        compacted = False
        live = found
    else:
        out_pad = buckets.get(idx) or probe.pad
        csr = _general_csr_index(
            plan, j, battr, pattr, kb.shape[0], kp.shape[0], device)
        dev_win = None
        if csr is None and int_key:
            dev_win = _dev_csr_window(
                plan, j, battr, pattr, kb.shape[0], kp.shape[0])
        if csr is not None:
            (base, counts_w, starts_w, grouped), swapped, _owner = csr
            if swapped:
                # the *probe* child is the indexed scan: the build side's
                # keys take the function's probe role, so its first output
                # holds probe columns and its second, along the monotone
                # stream, build columns (inner join = multiset, order-free)
                _count_path("general_csr_swapped")
                out_p, out_b, _live, total = _join_general_csr(
                    counts_w, starts_w, grouped, kb, vb, base,
                    pcols, bcols, out_pad)
            else:
                _count_path("general_csr")
                out_b, out_p, _live, total = _join_general_csr(
                    counts_w, starts_w, grouped, kp, vp, base,
                    bcols, pcols, out_pad)
        elif dev_win is not None:
            swapped, base, r_pad = dev_win
            if swapped:
                # indexed side = probe child (the same role swap)
                _count_path("dev_csr_swapped")
                out_p, out_b, _live, total = _join_dev_csr(
                    kp, vp, kb, vb, base, pcols, bcols, r_pad, out_pad)
            else:
                _count_path("dev_csr")
                out_b, out_p, _live, total = _join_dev_csr(
                    kb, vb, kp, vp, base, bcols, pcols, r_pad, out_pad)
        else:
            # classify the fallback for path_stats: which gate failed?
            if not isinstance(plan.nodes[bchild_id].data, ScanNode):
                why = ("probe_scan"
                       if isinstance(plan.nodes[pchild_id].data, ScanNode)
                       else "no_scan")
            elif not int_key:
                why = "non_int"
            else:
                why = "sparse_window"
            _count_path(f"general_merge[{why}]")
            out_b, out_p, _live, total = _general_impl()(
                kb, vb, kp, vp, bcols, pcols, out_pad)
        pad = out_pad
        compacted = True
        live = None

    cols, dicts = [], []
    for fb, ci in out_sources:
        cols.append(out_b[bmap[ci]] if fb else out_p[pmap[ci]])
        dicts.append((build if fb else probe).dicts[ci])
    return _NodeResult(cols, total, pad, compacted, dicts, live)


# ---------------------------------------------------------------------------
# Result extraction
# ---------------------------------------------------------------------------


def fetch_root(plan: Plan, root: _NodeResult, totals_by_node: Dict[int, int]):
    """Root columns -> HostTable: exactly the live rows cross to the host,
    in one fetch."""
    from .. import engine as eng
    from ..storage.columnar import HostTable

    root_node = plan.nodes[plan.root]
    if isinstance(root_node.data, ScanNode):
        total = plan.inputs[root_node.data.base_table_id].num_rows
    else:
        total = totals_by_node[plan.root]

    # root joins are always compacted (the engine excludes the root from
    # the unique fast path) and scans are dense, so rows [0:total) are it
    SYNC_STATS["root_fetches"] += 1
    k = len(root.cols)
    fetched = eng._fetch([d[:total] for d, _ in root.cols]
                         + [v[:total] for _, v in root.cols])
    cols = [
        _np_column_to_host(dt, data, valid, d)
        for (_ci, dt), data, valid, d in zip(
            root_node.output_attrs, fetched[:k], fetched[k:], root.dicts)
    ]
    return HostTable(total, cols)


def _np_column_to_host(dt, data, valid, dictionary):
    from .. import engine as eng

    return eng._decode_host_column(dt, np.asarray(data), np.asarray(valid),
                                   dictionary)


def execute_shared(plan: Plan, unique_joins: frozenset, device):
    """Full wave execution on ``device``: returns a HostTable. Leaves the
    per-join totals on the plan as ``_last_join_totals`` and a stage
    breakdown as ``_last_exec_stats``: dispatch, fetch and decode
    milliseconds on the host clock, fetch ``rounds`` (the root's included)
    and ``shrink_syncs``."""
    stats: dict = {}
    t0 = time.perf_counter()
    root, totals = run_plan(plan, unique_joins, device, stats=stats)
    t1 = time.perf_counter()
    host = fetch_root(plan, root, totals)
    t2 = time.perf_counter()
    stats["rounds"] += 1
    stats["dispatch_ms"] = (t1 - t0) * 1e3 - stats["fetch_ms"]
    stats["decode_ms"] = (t2 - t1) * 1e3  # the root's fetch and its decode
    plan._last_join_totals = dict(totals)
    plan._last_exec_stats = stats
    return host
