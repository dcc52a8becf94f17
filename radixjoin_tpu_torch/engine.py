"""Plan execution engine (port of the main path of radixjoin_tpu/engine.py).

Public surface, as the reference contract (include/plan.h:337-344):

    ctx = build_context(); result = execute(plan, ctx); destroy_context(ctx)

``build_context()`` means the CUDA card and raises without one; the CPU is
used only when a caller asks for it with ``build_context("cpu")``, and then
every kernel wrapper takes its plain PyTorch version.

Data model on the device:
  * every column is (data, valid) — ``data`` int32/int64 (FP64 is carried
    as its int64 bit pattern, which round-trips exactly), ``valid`` bool;
  * VARCHAR columns are dictionary-encoded: int32 ids on the device plus a
    host-side sorted dictionary of ``bytes``;
  * tensors are padded to pow2 buckets, padding rows have ``valid = False``.

Join semantics replicated from the reference:
  * inner equi-join, NULL keys never match (src/execute.cpp:62-83);
  * duplicate keys fan out (src/execute.cpp:232-243);
  * a key-type mismatch between the two sides yields an empty join
    (src/execute.cpp:75-83);
  * output column ``ci`` of a join reads left-child output ``ci`` when
    ``ci < left_width`` else right-child output ``ci - left_width``
    (src/execute.cpp:238-241).

``execute`` runs the fused whole-plan executor (plan/fused.py). What that
path meets but this port does not carry yet raises ``NotImplementedError``
naming its ROADMAP.md item: the host spill for inputs larger than half
the card's memory, and the stepwise fallback executor.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .dtypes import DataType
from .ops import join as join_ops
from .plan.ir import JoinNode, Plan, ScanNode
from .storage import native
from .storage import page as page_codec
from .storage.columnar import (
    Column,
    ColumnarTable,
    HostColumn,
    HostTable,
    StringDict,
    gather_varlen,
)


@dataclasses.dataclass
class DevColumn:
    """One dense device column + validity, padded to the table bucket."""

    dtype: DataType
    data: torch.Tensor
    valid: torch.Tensor
    dictionary: Optional[StringDict] = None  # sorted distinct values (VARCHAR)


class Context:
    """Engine context: the ``torch.device`` every query of it runs on."""

    def __init__(self, device: torch.device):
        self.device = device


def build_context(device=None) -> Context:
    """Context on the CUDA card by default; raises when CUDA is absent.
    ``device="cpu"`` runs the port on the CPU with the kernels' plain
    versions (the tests' oracle)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_context(): CUDA is not available; pass device='cpu' "
                "to run on the CPU"
            )
        device = "cuda"
    return Context(torch.device(device))


def destroy_context(context: Optional[Context]) -> None:
    return None


# ---------------------------------------------------------------------------
# Host <-> device column conversion
# ---------------------------------------------------------------------------


def host_column_to_device(col: HostColumn, pad: int, device) -> DevColumn:
    n = len(col.valid)
    valid = np.zeros(pad, dtype=bool)
    valid[:n] = col.valid
    dictionary = None
    if col.dtype is DataType.VARCHAR:
        res = native.dict_encode(col.heap, col.ends, col.valid)
        data = np.zeros(pad, dtype=np.int32)
        if res is not None:
            row_ids, dheap, dends = res
            data[:n] = row_ids
            dictionary = StringDict(dheap, dends)
        else:
            present = col.objects()[col.valid]
            if len(present):
                uniq, inverse = np.unique(present, return_inverse=True)
            else:
                uniq, inverse = np.empty(0, dtype=object), np.zeros(0, np.int64)
            data[:n][col.valid] = inverse.astype(np.int32)
            dictionary = StringDict.from_objects(list(uniq))
    elif col.dtype is DataType.FP64:
        data = np.zeros(pad, dtype=np.int64)
        data[:n] = col.values.view(np.int64)
    else:
        data = np.zeros(pad, dtype=col.dtype.numpy_dtype)
        data[:n] = col.values
    return DevColumn(
        col.dtype, torch.from_numpy(data).to(device),
        torch.from_numpy(valid).to(device), dictionary,
    )


def paged_column_to_device(pcol, num_rows: int, pad: int,
                           device) -> Optional[DevColumn]:
    """Upload the RAW pages and decode on the device.

    Returns None when the column is not eligible (VARCHAR — dictionary
    building is host-bound — or pages not row-aligned, e.g. the greedy
    reference-parity encoder); callers fall back to the host decode +
    dense upload. ``RJT_DEVICE_DECODE=off`` is honoured by the caller's
    upload memo (plan/executor.py)."""
    from .storage import device_decode as dd

    if pcol.type not in dd.ALIGNED_ROWS:
        return None
    if callable(pcol._pages):
        # lazily-deferred encode (harness path): the dense host arrays
        # already exist and upload directly — forcing a page encode just
        # to decode it back on the device would add work
        return None
    pages = pcol.pages
    if dd.aligned_full_pages(pages, num_rows, pcol.type) is None:
        return None
    data, valid = dd.decode_fixed_device(pages, num_rows, pcol.type, device)
    if pad > num_rows:
        data = join_ops.pad_1d(data, pad)
        valid = join_ops.pad_1d(valid, pad, False)
    return DevColumn(pcol.type, data, valid)


def _detect_unique_joins(plan: Plan) -> frozenset:
    """Join nodes whose build side is a scan column with verified-unique
    valid keys (FK->PK). The root is excluded: unique-join output is
    probe-shaped/uncompacted, and the result extraction slices the root to
    ``[:total]`` which assumes compacted rows."""
    unique = set()
    for idx, node in enumerate(plan.nodes):
        if idx == plan.root or not isinstance(node.data, JoinNode):
            continue
        j = node.data
        build_child = plan.nodes[j.left if j.build_left else j.right]
        if not isinstance(build_child.data, ScanNode):
            continue
        battr = j.left_attr if j.build_left else j.right_attr
        col_idx, dt = build_child.output_attrs[battr]
        if dt not in (DataType.INT32, DataType.INT64):
            continue
        host = plan.inputs[build_child.data.base_table_id].to_host()
        if host.columns[col_idx].is_unique_key():
            unique.add(idx)
    return frozenset(unique)


def _estimate_scan_bytes(plan: Plan) -> int:
    """Padded device footprint of all scan inputs (pow2 pad, values+valid),
    deduplicated per (table, column)."""
    seen = set()
    total = 0
    for node in plan.nodes:
        if not isinstance(node.data, ScanNode):
            continue
        pad = join_ops.bucket_size(plan.inputs[node.data.base_table_id].num_rows)
        for ci, dt in node.output_attrs:
            key = (node.data.base_table_id, ci)
            if key not in seen:
                seen.add(key)
                esize = 4 if dt in (DataType.INT32, DataType.VARCHAR) else 8
                total += pad * (esize + 1)
    return total


# ---------------------------------------------------------------------------
# Fused whole-plan execution
# ---------------------------------------------------------------------------


def _fused_attempts(plan: Plan, device: torch.device) -> HostTable:
    """Run the fused plan until every join's bucket held its exact total,
    then fetch the root's live rows and decode them on the host.

    Per attempt: build (or reuse) the structure for the current bucket
    state, run it, and fetch the per-join totals in one transfer. A
    general join whose total exceeded its bucket re-runs with the exact
    bucket; joins above an overflowed join are not trustworthy and double
    their bucket; a probe-shaped join compacted to a stale learned pad
    re-runs uncompacted. On success the exact buckets are kept on the plan
    object as cardinality feedback for its next execution."""
    from .plan import fused as fz

    buckets: dict = {}
    root_node = plan.nodes[plan.root]
    unique_joins = _detect_unique_joins(plan)
    learned = getattr(plan, "_learned_buckets", None)
    if learned:
        for i, (pad, was_compacted) in learned.items():
            if was_compacted:
                buckets.setdefault(i, pad)
    no_compact: set = set()
    for _attempt in range(len(plan.nodes) + 2):
        state_key = (
            device,
            tuple(sorted(buckets.items())),
            tuple(sorted(learned.items())) if learned else None,
            frozenset(no_compact),
        )
        cached = getattr(plan, "_fused_struct_cache", None)
        if cached is not None and cached[0] == state_key:
            structure = cached[1]
        else:
            structure = fz.FusedPlan(
                plan, buckets, unique_joins, device, learned,
                frozenset(no_compact),
            )
            plan._fused_struct_cache = (state_key, structure)
        out_values_dev, out_valid_dev, totals_dev = fz.run(structure)
        totals = totals_dev.cpu().numpy()

        # exactness: a join's total is trustworthy iff no descendant
        # general join overflowed its bucket; probe-shaped strategies
        # cannot overflow
        join_order = structure.join_order
        exact: dict = {}
        overflow = False
        for ji, node_id in enumerate(join_order):
            spec = structure.join_specs[node_id]
            probe_shaped = spec.strategy in (
                "unique_scatter", "unique_sort", "empty"
            )
            deps_ok = all(exact.get(d, True) for d in (spec.left, spec.right))
            fits = probe_shaped or int(totals[ji]) <= spec.out_pad
            if spec.compact_pad and int(totals[ji]) > spec.compact_pad:
                # stale learned pad truncated this probe-shaped output
                no_compact.add(node_id)
                fits = False
                overflow = True
            exact[node_id] = deps_ok and fits
            if probe_shaped:
                continue
            if deps_ok and not fits:
                buckets[node_id] = join_ops.bucket_size(int(totals[ji]))
                overflow = True
            elif not deps_ok:
                buckets[node_id] = max(
                    buckets.get(node_id, spec.out_pad) * 2, spec.out_pad * 2
                )
                overflow = True
            else:
                buckets[node_id] = join_ops.bucket_size(int(totals[ji]))
        if overflow:
            continue

        if isinstance(root_node.data, ScanNode):
            root_total = plan.inputs[root_node.data.base_table_id].num_rows
        else:
            root_total = int(totals[join_order.index(plan.root)])

        # per-join exact output cardinalities of this execution
        plan._last_join_totals = {
            node_id: int(totals[ji]) for ji, node_id in enumerate(join_order)
        }
        plan._learned_buckets = {
            node_id: (
                join_ops.bucket_size(int(totals[ji])),
                structure.join_specs[node_id].strategy
                not in ("unique_scatter", "unique_sort"),
            )
            for ji, node_id in enumerate(join_order)
        }

        # bounded root fetch: only the live rows cross to the host
        out_values = [v[:root_total].cpu().numpy() for v in out_values_dev]
        out_valid = [v[:root_total].cpu().numpy() for v in out_valid_dev]

        sources = structure.col_sources[plan.root]
        cols: List[HostColumn] = []
        for ko, (_ci, dt) in enumerate(root_node.output_attrs):
            values, valid = out_values[ko], out_valid[ko]
            if dt is DataType.VARCHAR:
                d = structure.dicts[sources[ko]] or StringDict.empty()
                if root_total == 0 or d.size == 0:
                    cols.append(HostColumn.varchar(
                        np.zeros(0, np.uint8),
                        np.zeros(root_total, np.int64),
                        valid,
                    ))
                else:
                    ids = np.clip(values, 0, d.size - 1)
                    starts = np.where(valid, d.starts[ids], 0)
                    lengths = np.where(valid, d.lengths[ids], 0)
                    heap, ends = gather_varlen(d.heap, starts, lengths)
                    cols.append(HostColumn.varchar(heap, ends, valid))
            elif dt is DataType.FP64:
                cols.append(HostColumn(dt, values.view(np.float64), valid))
            else:
                cols.append(HostColumn(dt, values, valid))
        return HostTable(root_total, cols)
    raise RuntimeError("fused plan did not converge to exact buckets")


def execute(plan: Plan, context: Optional[Context] = None) -> ColumnarTable:
    """Evaluate ``plan`` and encode the result as a paged ColumnarTable
    (the reference ``Contest::execute``, src/execute.cpp:316-324)."""
    if context is None:
        context = build_context()
    device = context.device
    plan.validate()
    if device.type == "cuda":
        budget = torch.cuda.get_device_properties(device).total_memory // 2
        if _estimate_scan_bytes(plan) > budget:
            raise NotImplementedError(
                "inputs exceed half the card's memory; the host-staged "
                "spill path is not ported yet (ROADMAP.md, 'Device memory "
                "and the spill path')"
            )
    return _encode_result(_fused_attempts(plan, device))


def _encode_result(host: HostTable) -> ColumnarTable:
    """HostTable -> paged ColumnarTable (the reference's final
    to_columnar step, src/execute.cpp:322-323)."""
    cols = []
    for c in host.columns:
        if c.dtype is DataType.VARCHAR:
            pages = page_codec.encode_varchar_heap(c.heap, c.ends, c.valid)
        else:
            pages = page_codec.encode_fixed(c.values, c.valid, c.dtype)
        cols.append(Column(c.dtype, pages))
    return ColumnarTable(host.num_rows, cols)
