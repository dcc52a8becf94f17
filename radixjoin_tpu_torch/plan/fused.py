"""Sort-free whole-plan executor (port of radixjoin_tpu/plan/fused.py).

:class:`FusedPlan` resolves, on the host, the static structure of one
query: the padded size of every scan, each join's strategy and key window,
and the device operands (scan columns, CSR indexes, dictionary remaps).
:func:`run` then evaluates the plan eagerly in torch over those operands.
The JAX version traces the same walk into one XLA program; eager torch
needs no tracing, export or ahead-of-time layer.

Joins lower exactly like the reference's fast paths:

* ``unique_scatter`` — dense key-window slot table for FK->PK joins
  (``unique_sort`` when the window is too sparse);
* ``csr`` / ``csr_swapped`` — a host-built CSR index over a base scan's
  key column, on either side;
* ``dev_csr`` / ``dev_csr_swapped`` — both children intermediate: a CSR
  index built on the device over the key's origin base-column window.
  VARCHAR keys join this way too, over a unified dictionary id space;
* ``merge`` — the single-sort merge join with sort-carried payloads, for
  FP64 keys, integer key windows too sparse for a CSR index, and general
  joins whose combined pad (build + probe) reaches ``RJT_BIG_MERGE``
  (default ``BIG_MERGE_PAD``).

Join output cardinalities are data-dependent, so every general join writes
into a static pow2 bucket; the run returns exact per-join totals, the
engine checks ``total <= bucket`` and re-runs overflowing plans with exact
buckets — results are always exact, never silently truncated.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from .. import trace
from ..dtypes import DataType
from ..ops import join as join_ops
from ..ops import keynorm
from .ir import Plan, ScanNode
from . import executor as _ex

#: joins the fused executor ran, by strategy (``join.<strategy>``)
JOIN_STATS = trace.Counters("join")

#: combined pad (build + probe) from which general joins take the merge
#: path, as in the reference (radixjoin_tpu/plan/fused.py _big_merge): the
#: default that ``RJT_BIG_MERGE`` overrides
BIG_MERGE_PAD = 1 << 23


def big_merge_pad() -> int:
    """``RJT_BIG_MERGE``: the least combined pad (build + probe) that sends
    a general join to the merge path; 0 disables the reroute."""
    return _ex._int_knob("RJT_BIG_MERGE", BIG_MERGE_PAD)


def _big_merge(bpad: int, ppad: int) -> bool:
    thr = big_merge_pad()
    return thr > 0 and (bpad + ppad) >= thr


@dataclasses.dataclass(frozen=True)
class _ScanSpec:
    pad: int
    cols: Tuple[int, ...]  # per output attr -> index into col_args


@dataclasses.dataclass(frozen=True)
class _JoinSpec:
    build_left: bool
    left: int
    right: int
    left_attr: int
    right_attr: int
    key_dtype: Optional[DataType]  # None => statically empty (type mismatch)
    out_pad: int
    # output attr -> (side 0=left/1=right, column index in that child)
    out_cols: Tuple[Tuple[int, int], ...]
    #: "empty" | "unique_scatter" | "unique_sort" | "csr" | "csr_swapped"
    #: | "dev_csr" | "dev_csr_swapped" | "merge"
    strategy: str
    r_pad: int = 0  # key window (unique_scatter / dev_csr*)
    aux_id: int = -1  # index into aux_args (scatter/csr operands)
    #: probe-shaped joins only: compact the output to this learned pad
    #: (cardinality feedback); 0 = no compaction. A stale undersized pad
    #: truncates — the engine detects ``total > compact_pad`` and retries
    #: without it.
    compact_pad: int = 0


class FusedPlan:
    """Static structure + device operands of one query on one device.

    ``learned`` (cardinality feedback from an earlier run of the same plan
    object): general joins seed exact buckets through ``buckets``;
    probe-shaped joins compact to their learned pad so downstream stages
    run at live-row scale."""

    def __init__(self, plan: Plan, buckets: Dict[int, int],
                 unique_joins: frozenset, device,
                 learned: Optional[Dict[int, Tuple[int, bool]]] = None,
                 no_compact: frozenset = frozenset()):
        from .. import engine as eng

        self.plan = plan
        self.device = torch.device(device)
        self.order = plan.topo_order()
        self.buckets = dict(buckets)
        self.scan_specs: Dict[int, _ScanSpec] = {}
        self.join_specs: Dict[int, _JoinSpec] = {}
        #: a VARCHAR join key has no joint dictionary window: the structure
        #: is incomplete and the engine takes the stepwise executor
        self.has_varchar_key = False
        #: flat device column operands [(data, valid), ...]
        self.col_args: List[Tuple] = []
        #: per-join aux operands: scatter/dev_csr -> (base,) or
        #: (base, remap_b, remap_p) for VARCHAR keys; csr -> (base, c, s, g)
        self.aux_args: List[Tuple] = []
        #: ledger owners (host / paged columns) whose memos back col_args
        #: and aux_args; re-touched on every struct-cache hit (revalidate)
        self.owners: List = []
        #: col_args id -> StringDict or None (dictionary provenance)
        self.dicts: List = []
        # node -> per-output-attr col_args id (for root dict lookup)
        self.col_sources: Dict[int, Tuple[int, ...]] = {}

        pads: Dict[int, int] = {}
        packed: Dict[Tuple[int, int, int], int] = {}

        for idx in self.order:
            node = plan.nodes[idx]
            if isinstance(node.data, ScanNode):
                table = plan.inputs[node.data.base_table_id]
                pad = join_ops.bucket_size(table.num_rows)
                pads[idx] = pad
                col_ids = []
                for col_idx, _dt in node.output_attrs:
                    key = (node.data.base_table_id, col_idx, pad)
                    if key not in packed:
                        # raw-page upload + device decode where aligned;
                        # host decode + dense upload otherwise
                        owner = table.columns[col_idx]
                        dev = _ex._paged_column_cached(
                            eng, owner, table.num_rows, pad, self.device,
                        )
                        if dev is None:
                            owner = table.to_host().columns[col_idx]
                            dev = _ex._device_column_cached(
                                eng, owner, pad, self.device,
                            )
                        packed[key] = len(self.col_args)
                        self.col_args.append((dev.data, dev.valid))
                        self.dicts.append(dev.dictionary)
                        self.owners.append(owner)
                    col_ids.append(packed[key])
                self.scan_specs[idx] = _ScanSpec(pad, tuple(col_ids))
                self.col_sources[idx] = tuple(col_ids)
                continue

            j = node.data
            left_w = len(plan.nodes[j.left].output_attrs)
            lt = plan.nodes[j.left].output_attrs[j.left_attr][1]
            rt = plan.nodes[j.right].output_attrs[j.right_attr][1]
            key_dtype = lt if lt is rt else None
            battr = j.left_attr if j.build_left else j.right_attr
            pattr = j.right_attr if j.build_left else j.left_attr
            bchild = j.left if j.build_left else j.right
            pchild = j.right if j.build_left else j.left

            strategy, r_pad, aux_id = "merge", 0, -1
            if key_dtype is None:
                strategy = "empty"
            elif key_dtype is DataType.VARCHAR:
                # dictionary ids flow through gathers unchanged, so the two
                # origin dictionaries are unified on the host and the join
                # runs as a device-CSR over unified ids
                hv = self._varchar_dev_csr(
                    bchild, battr, pchild, pattr, pads[bchild], pads[pchild],
                )
                if hv is None:
                    self.has_varchar_key = True
                    return  # the engine falls back to the stepwise executor
                swapped, aux, r_pad = hv
                strategy = "dev_csr_swapped" if swapped else "dev_csr"
                aux_id = len(self.aux_args)
                self.aux_args.append(aux)
            elif (
                idx in unique_joins
                and key_dtype in (DataType.INT32, DataType.INT64)
                and self.buckets.get(idx) is None
            ):
                window = _ex._unique_scatter_window(
                    plan, j, battr, pads[bchild], pads[pchild]
                )
                if window is not None:
                    strategy = "unique_scatter"
                    base, r_pad = window
                    aux_id = len(self.aux_args)
                    self.aux_args.append((base,))
                else:
                    strategy = "unique_sort"
            elif _big_merge(pads[bchild], pads[pchild]):
                # huge pads: the CSR paths' window and payload lookups run
                # at probe/output size, the merge join is one sort with
                # sort-carried payloads; the strategy stays "merge"
                pass
            else:
                csr = _ex._general_csr_index(
                    plan, j, battr, pattr, pads[bchild], pads[pchild],
                    self.device,
                )
                if csr is not None:
                    aux, swapped, owner = csr
                    strategy = "csr_swapped" if swapped else "csr"
                    aux_id = len(self.aux_args)
                    self.aux_args.append(aux)
                    self.owners.append(owner)
                elif key_dtype in (DataType.INT32, DataType.INT64):
                    dev_csr = _ex._dev_csr_window(
                        plan, j, battr, pattr, pads[bchild], pads[pchild],
                    )
                    if dev_csr is not None:
                        swapped, base, r_pad = dev_csr
                        strategy = "dev_csr_swapped" if swapped else "dev_csr"
                        aux_id = len(self.aux_args)
                        self.aux_args.append((base,))
                # otherwise (FP64 key, or no economic integer key window)
                # the strategy stays "merge"

            compact_pad = 0
            if strategy in ("unique_scatter", "unique_sort"):
                out_pad = pads[pchild]  # probe-shaped, cannot overflow
                if learned and idx != plan.root and idx not in no_compact:
                    lp, was_compacted = learned.get(idx, (None, None))
                    if (
                        lp is not None and not was_compacted
                        and lp * 4 <= out_pad
                    ):
                        compact_pad = lp
                        pads[idx] = lp
            else:
                out_pad = self.buckets.get(idx) or pads[pchild]
            if compact_pad == 0:
                pads[idx] = out_pad
            out_cols = tuple(
                (0, ci) if ci < left_w else (1, ci - left_w)
                for ci, _ in node.output_attrs
            )
            self.join_specs[idx] = _JoinSpec(
                j.build_left, j.left, j.right, j.left_attr, j.right_attr,
                key_dtype, out_pad, out_cols, strategy, r_pad, aux_id,
                compact_pad,
            )
            self.col_sources[idx] = tuple(
                self.col_sources[j.left][ci]
                if ci < left_w
                else self.col_sources[j.right][ci - left_w]
                for ci, _ in node.output_attrs
            )

        self.join_order = [i for i in self.order if i in self.join_specs]
        self.root_pad = pads[plan.root]

    def revalidate(self) -> bool:
        """A struct-cache hit reuses device tensors resolved on an earlier
        run. Re-touch their ledger owners under the caller's active
        reservation token, which protects them from eviction for the rest
        of this query. False means that an owner was evicted since (its
        memo is gone and this structure holds the last references to the
        old tensors): the caller rebuilds, and the rebuild re-resolves the
        memos, uploading again what was evicted.

        ``touch`` registers the caller's token atomically with the liveness
        check (an eviction pops the entry and drops the memo under the same
        ledger lock), so a True touch means the tensors are the memo's own
        and stay so until the caller's reservation is released.

        A structure served again counts one upload memo hit a cached
        upload it holds (``upload.memo_hits``); one that is not leaves the
        counting to the rebuild's memo lookups."""
        from .. import engine as eng

        ledger = eng.device_ledger(self.device)
        ok = True
        for owner in self.owners:
            ok &= ledger.touch(owner)
        if ok:
            _ex.UPLOAD_STATS.add("memo_hits", len(self.owners))
        return ok

    def strategies(self) -> Dict[int, str]:
        """Join node -> strategy chosen for it."""
        return {i: s.strategy for i, s in self.join_specs.items()}

    def _varchar_dev_csr(self, bchild, battr, pchild, pattr, bpad, ppad):
        """VARCHAR join key lowering: ``(swapped, aux, r_pad)`` or None.

        ``aux`` = (base 0, build-side remap, probe-side remap) — the remaps
        carry each side's dictionary ids onto the unified id space, whose
        size is the window. The smaller-padded side is indexed."""
        da = self.dicts[self.col_sources[bchild][battr]]
        db = self.dicts[self.col_sources[pchild][pattr]]
        if da is None or db is None:
            return None
        ra, rb, size = keynorm.joint_id_inverse(da.objects(), db.objects())
        r_pad = join_ops.bucket_size(max(size, 1))
        if r_pad > (1 << 26):
            return None
        remaps = tuple(torch.from_numpy(r).to(self.device) for r in (ra, rb))
        if self.device.type == "cuda":
            # the structure is cached on the plan and may be run from
            # another stream: publish the remaps only once they are there
            torch.cuda.current_stream(self.device).synchronize()
        return ppad < bpad, (0,) + remaps, r_pad


def _remap_ids(ids, mapping):
    """Dictionary ids -> unified ids (invalid rows carry arbitrary ids;
    they are clamped here and masked by validity in the joins)."""
    if mapping.shape[0] == 0:
        return torch.zeros_like(ids)
    return mapping[ids.clamp(0, mapping.shape[0] - 1)]


def _normalize_key(data, valid, dt: DataType):
    # FP64 keys arrive bitcast to i64 at upload; canonicalize -0.0 and NaN
    if dt is DataType.FP64:
        data, valid = keynorm.canon_f64_bits(data, valid)
    return data, valid


@dataclasses.dataclass
class NodeMark:
    """One join of a :func:`run`: its node id, its ``fused.node`` span
    (:data:`trace.OFF` while tracing is off), the CUDA events recorded on
    its stream before and after its work (None on the CPU), the bytes of
    one key and of one value of each output column."""

    node: int
    span: object
    start: Optional[torch.cuda.Event]
    end: Optional[torch.cuda.Event]
    key_bytes: int
    out_col_bytes: Tuple[int, ...]


def _timing_event(dev):
    """A timing CUDA event recorded now on ``dev``'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(dev))
    return ev


def run(structure: FusedPlan):
    """Evaluate the plan: ``(out_values, out_valid, totals, marks)`` — the
    root's columns in its pad and the exact per-join totals (int64, in
    ``structure.join_order``), all on the structure's device, and this
    run's :class:`NodeMark` of each join, in that order. Each join is
    counted by strategy (:data:`JOIN_STATS`), traced as a ``fused.node``
    span (its node id and strategy) and, on the card, bracketed by two
    timing events on its stream, for the caller to read once the totals
    have reached the host."""
    plan = structure.plan
    dev = structure.device
    timed = dev.type == "cuda"
    tables: Dict[int, List[Tuple[torch.Tensor, torch.Tensor]]] = {}
    totals = []
    marks: List[NodeMark] = []

    for idx in structure.order:
        node = plan.nodes[idx]
        if isinstance(node.data, ScanNode):
            spec = structure.scan_specs[idx]
            tables[idx] = [structure.col_args[c] for c in spec.cols]
            continue
        spec = structure.join_specs[idx]
        JOIN_STATS.add(spec.strategy)
        pchild, pattr = ((spec.right, spec.right_attr) if spec.build_left
                         else (spec.left, spec.left_attr))
        with trace.span("fused.node") as sp:
            sp.note("node", idx)
            sp.note("strategy", spec.strategy)
            start = _timing_event(dev) if timed else None
            tables[idx], total = _run_join(structure, spec, tables)
            end = _timing_event(dev) if timed else None
        marks.append(NodeMark(
            idx, sp, start, end, tables[pchild][pattr][0].element_size(),
            tuple(c[0].element_size() for c in tables[idx])))
        totals.append(total)

    root_cols = tables[plan.root]
    out_values = tuple(c[0] for c in root_cols)
    out_valid = tuple(c[1] for c in root_cols)
    totals_arr = (
        torch.stack(totals) if totals
        else torch.zeros(0, dtype=torch.int64, device=dev)
    )
    return out_values, out_valid, totals_arr, marks


def _run_join(structure: FusedPlan, spec: _JoinSpec, tables):
    """One join node of :func:`run`: ``(output columns, exact total)``."""
    aux_args = structure.aux_args
    dev = structure.device
    left, right = tables[spec.left], tables[spec.right]
    if spec.build_left:
        (kb, vb), (kp, vp) = left[spec.left_attr], right[spec.right_attr]
    else:
        (kb, vb), (kp, vp) = right[spec.right_attr], left[spec.left_attr]
    if spec.key_dtype is not None:
        kb, vb = _normalize_key(kb, vb, spec.key_dtype)
        kp, vp = _normalize_key(kp, vp, spec.key_dtype)

    #: the kernel output that is MONOTONE (cummax owner recovery):
    #: payload gathers indexed by it ride the blocked-window kernel
    monotone = None
    if spec.strategy == "empty":
        bidx = torch.zeros(spec.out_pad, dtype=torch.int32, device=dev)
        pidx = torch.zeros(spec.out_pad, dtype=torch.int32, device=dev)
        live = torch.zeros(spec.out_pad, dtype=torch.bool, device=dev)
        total = torch.zeros((), dtype=torch.int64, device=dev)
    elif spec.strategy == "unique_scatter" and spec.compact_pad:
        # the probe compacts its matches to the learned pad in the same
        # pass: the payloads are gathered at the pad, never at probe size
        (base,) = aux_args[spec.aux_id]
        pidx, bidx, live, total = join_ops.join_unique_scatter_impl(
            kb, vb, kp, vp, base, spec.r_pad, spec.compact_pad
        )
        monotone = pidx
    elif spec.strategy == "unique_scatter":
        (base,) = aux_args[spec.aux_id]
        bidx, live, total = join_ops.join_unique_scatter_impl(
            kb, vb, kp, vp, base, spec.r_pad
        )
        pidx = None
    elif spec.strategy == "unique_sort":
        bidx, live, total = join_ops.join_unique_impl(kb, vb, kp, vp)
        pidx = None
    elif spec.strategy == "csr":
        base, counts_w, starts_w, grouped = aux_args[spec.aux_id]
        bidx, pidx, live, total = join_ops.join_csr_impl(
            counts_w, starts_w, grouped, kp, vp, base, spec.out_pad
        )
        monotone = pidx
    elif spec.strategy == "csr_swapped":
        # the *probe* child is the CSR-indexed scan: the build side's
        # keys take the kernel's probe role, so its bidx addresses
        # probe rows and its pidx build rows
        base, counts_w, starts_w, grouped = aux_args[spec.aux_id]
        pidx, bidx, live, total = join_ops.join_csr_impl(
            counts_w, starts_w, grouped, kb, vb, base, spec.out_pad
        )
        monotone = bidx
    elif spec.strategy in ("dev_csr", "dev_csr_swapped"):
        aux = aux_args[spec.aux_id]
        if spec.key_dtype is DataType.VARCHAR:
            # dictionary ids -> unified id space, then join as ints
            base, rb_map, rp_map = aux
            kb = _remap_ids(kb, rb_map)
            kp = _remap_ids(kp, rp_map)
        else:
            (base,) = aux
        if spec.strategy == "dev_csr":
            bidx, pidx, live, total = join_ops.join_dev_csr_impl(
                kb, vb, kp, vp, base, spec.r_pad, spec.out_pad
            )
        else:
            # probe child is the device-indexed side (same role swap
            # as csr_swapped)
            pidx, bidx, live, total = join_ops.join_dev_csr_impl(
                kp, vp, kb, vb, base, spec.r_pad, spec.out_pad
            )
    else:  # "merge": payload planes ride the join's single sort
        need: Dict[Tuple[int, int], Tuple] = {}
        b_keys, p_keys = [], []
        for side, ci in spec.out_cols:
            key = (side, ci)
            if key in need:
                continue
            need[key] = (left if side == 0 else right)[ci]
            on_build = (side == 0) == spec.build_left
            (b_keys if on_build else p_keys).append(key)
        out_b, out_p, _live, total = join_ops.join_merge_full_impl(
            kb, vb, kp, vp, spec.out_pad,
            [need[k] for k in b_keys], [need[k] for k in p_keys],
        )
        got = dict(zip(b_keys, out_b))
        got.update(zip(p_keys, out_p))
        return [got[key] for key in spec.out_cols], total

    lidx = bidx if spec.build_left else pidx
    ridx = pidx if spec.build_left else bidx
    gathered: Dict[Tuple[int, int], Tuple] = {}
    # batch the payload gathers per index stream: every column riding
    # one stream goes through ONE _gather_cols call (one kernel pass)
    by_stream: Dict[int, list] = {}
    for side, ci in spec.out_cols:
        key = (side, ci)
        src = (left if side == 0 else right)[ci]
        idx_arr = lidx if side == 0 else ridx
        if key in gathered:
            continue
        if idx_arr is None:  # unique path: probe side passes through
            gathered[key] = (src[0], src[1] & live)
        elif key not in by_stream.setdefault(side, []):
            by_stream[side].append(key)
    for side, keys in by_stream.items():
        idx_arr = lidx if side == 0 else ridx
        cols_in = [(left if side == 0 else right)[c] for _s, c in keys]
        g = _ex._gather_cols(
            cols_in, idx_arr, live,
            windowed=monotone is not None and idx_arr is monotone,
        )
        gathered.update(zip(keys, g))
    out_cols = [gathered[key] for key in spec.out_cols]
    if spec.compact_pad and pidx is None:
        # cardinality feedback: compact the probe-shaped output to its
        # learned size, so every downstream stage runs at live-row scale
        out_cols = list(
            _ex._compact_probe_shaped(
                tuple(out_cols), live, spec.compact_pad
            )
        )
    return out_cols, total
