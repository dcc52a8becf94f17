"""Distributed whole-plan execution over a process group (port of
radixjoin_tpu/parallel/dist_executor.py).

Runs an entire :class:`~radixjoin_tpu_torch.plan.ir.Plan` (the IR the
single-card engine executes, reference include/plan.h:27-149) over the
ranks of a :class:`~.mesh.Mesh`: every base table is row-sharded, every
join is the hash-partitioned all-to-all shuffle join (dist_join.py) with
skew-aware heavy-hitter broadcast, and **intermediates never leave the
devices** — a join's sharded output columns feed the next join's shuffle
directly, so the only host syncs are the capacity ladder's fetch of each
join's totals (cold), one batched check at the root (warm) and the final
result gather.

Collective: every rank calls :func:`execute_distributed` with the same plan
over the same host tables, and every rank returns the same full result.

Semantics match the single-card engine exactly (NULL keys never match,
duplicate fan-out, type mismatch => empty, NULL payloads flow through —
src/execute.cpp:62-83, :232-243). VARCHAR join keys are unified on the
host (``np.unique`` over the two sides' dictionaries) into one joint id
space and joined as int64 ids; VARCHAR payloads flow through as
dictionary ids and rehydrate at the final gather.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..dtypes import DataType
from ..ops import keynorm
from ..plan.ir import Plan, ScanNode
from ..storage.columnar import HostColumn, HostTable, StringDict, gather_varlen
from . import multihost
from .dist_join import (
    DistJoinConfig,
    _pad_to_shards,
    detect_hot_keys,
    distributed_join_deferred,
    distributed_join_device,
)
from .mesh import make_mesh


@dataclasses.dataclass
class _NodeRes:
    """One executed plan node on the ranks: per-output-attr sharded (data,
    valid) pairs, a sharded row-liveness mask, the exact row total, and
    per-attr dictionary provenance (VARCHAR)."""

    cols: List[Tuple]  # [(data, valid), ...] this rank's rows
    live: object  # this rank's bool rows, or None (scan: validity == liveness)
    total: int
    dicts: List[Optional[StringDict]]


# Distributed cardinality feedback: (plan content key, mesh, config, node
# idx) -> learned static join config + hot keys + totals from a cold run.
# A warm repeat replays every join without a sync
# (distributed_join_deferred) and checks ALL joins in one batched fetch at
# the plan root; any deviation (data changed under the same shape,
# overflow, other totals) evicts the plan's entries and reruns cold. Every
# rank learns the same state from the same fetched values, so the ranks
# take the same warm / cold decision in lockstep.
_DIST_FEEDBACK: Dict[tuple, dict] = {}


def _plan_key(plan: Plan) -> str:
    """The plan's content key: node structure, input row counts and root
    (the key of the JAX package's feedback store, which this port does not
    have; cached on the plan)."""
    key = getattr(plan, "_feedback_key", None)
    if key is None:
        desc = []
        for node in plan.nodes:
            attrs = tuple((c, int(dt)) for c, dt in node.output_attrs)
            if isinstance(node.data, ScanNode):
                desc.append(("s", node.data.base_table_id, attrs))
            else:
                j = node.data
                desc.append((
                    "j", j.build_left, j.left, j.right,
                    j.left_attr, j.right_attr, attrs,
                ))
        rows = tuple(t.num_rows for t in plan.inputs)
        blob = repr((desc, rows, plan.root)).encode()
        key = hashlib.sha1(blob).hexdigest()
        plan._feedback_key = key
    return key


def _fb_base_key(plan: Plan, mesh, config: DistJoinConfig) -> tuple:
    """Learned state replays only under the SAME mesh and join config — a
    different chunk count, Bloom size or group must miss, not replay the
    old configuration. The mesh enters by identity."""
    return (_plan_key(plan), mesh, dataclasses.astuple(config))


_FEEDBACK_CAP = 512  # FIFO-evict beyond this many (plan, join) entries


def _fb_store(key: tuple, info: dict) -> None:
    if len(_DIST_FEEDBACK) >= _FEEDBACK_CAP:
        _DIST_FEEDBACK.pop(next(iter(_DIST_FEEDBACK)))
    _DIST_FEEDBACK[key] = info


def _canon_f64_keys(bits, valid):
    """FP64 join-key canonicalization: -0.0 == +0.0, NaN never matches.
    Applied only to the key view at join time — stored FP64 columns keep
    raw bits so NaN / -0.0 *payloads* survive to the output (reference
    semantics: NULL-drop applies to keys, src/execute.cpp:62-83)."""
    return keynorm.canon_f64_bits(bits, valid)


def _shard_scan(plan: Plan, node, mesh) -> _NodeRes:
    """Row-shard one base table's projected columns over the ranks.
    VARCHAR columns become dictionary ids on the host."""
    from .. import engine as eng

    table = plan.inputs[node.data.base_table_id]
    host = table.to_host()
    ndev = mesh.size
    n = host.num_rows
    cols, dicts = [], []
    live_np = _pad_to_shards(np.ones(max(n, 1), dtype=bool), ndev, fill=False)
    if n == 0:
        live_np[:] = False

    for ci, dt in node.output_attrs:
        col = host.columns[ci]
        if col.dtype is not dt:
            raise TypeError(
                f"scan output attr {ci}: declared {dt}, stored {col.dtype}"
            )
        valid = col.valid
        if dt is DataType.VARCHAR:
            enc = eng.host_column_to_device(col, max(n, 1), "cpu")
            data = enc.data.numpy()
            dicts.append(enc.dictionary)
        elif dt is DataType.FP64:
            # raw bits; keys are canonicalized at join time
            data = col.values.view(np.int64)
            dicts.append(None)
        else:
            data = col.values
            dicts.append(None)
        data = _pad_to_shards(np.asarray(data), ndev)
        v = _pad_to_shards(valid.astype(bool), ndev, fill=False)
        if n == 0:
            v[:] = False
        cols.append((multihost.put_sharded(data, mesh),
                     multihost.put_sharded(v, mesh)))
    return _NodeRes(cols, multihost.put_sharded(live_np, mesh), n, dicts)


def _empty_res(output_attrs, mesh) -> _NodeRes:
    pad = 16
    dev = mesh.device
    cols, dicts = [], []
    for _, dt in output_attrs:
        wide = dt in (DataType.INT64, DataType.FP64)
        tdt = torch.int64 if wide else torch.int32
        cols.append((torch.zeros(pad, dtype=tdt, device=dev),
                     torch.zeros(pad, dtype=torch.bool, device=dev)))
        dicts.append(StringDict.empty() if dt is DataType.VARCHAR else None)
    return _NodeRes(cols, torch.zeros(pad, dtype=torch.bool, device=dev), 0,
                    dicts)


def _unify_varchar_keys(kb, kp, db, dp, mesh):
    """Remap both sides' dictionary ids onto one joint id space so int64
    equality == string equality. Unification is a host ``np.unique`` over
    the two (small) dictionaries; every rank uploads the lookup tables and
    remaps its own rows, so the key columns are not resharded."""
    ob = db.objects() if db is not None else np.empty(0, object)
    op = dp.objects() if dp is not None else np.empty(0, object)
    if not (len(ob) and len(op)):
        # one side has no string values at all: no id can match; rows on
        # that side are already invalid, so the raw ids are fine
        return kb, kp
    rb, rp, _ = keynorm.joint_id_inverse(ob, op)
    lut_b = multihost.put_replicated(rb.astype(np.int64), mesh)
    lut_p = multihost.put_replicated(rp.astype(np.int64), mesh)

    def remap(lut, ids):
        return lut[ids.clamp(0, lut.shape[0] - 1)]

    return remap(lut_b, kb), remap(lut_p, kp)


def _hot_key_sample(kp, vp, stride: int, mesh):
    """The JAX package's strided sample ``kp[::stride]`` of the *global*
    probe column: each rank takes its rows whose global index is 0 modulo
    ``stride``, padded to the largest rank's count (every rank computes the
    counts from the shard length alone), all-gathered and trimmed on the
    host — concatenated in rank order, it is the same sample."""
    per = kp.shape[0]

    def count(r):
        first = (-r * per) % stride
        return max(0, -(-(per - first) // stride))

    counts = [count(r) for r in range(mesh.size)]
    width = max(counts)
    first = (-mesh.rank * per) % stride
    mine = counts[mesh.rank]

    def padded(t):
        out = torch.zeros(width, dtype=t.dtype, device=t.device)
        out[:mine] = t[first::stride]
        return out

    got_k, got_v = multihost.fetch_many([padded(kp), padded(vp)], mesh)
    keep = np.concatenate([np.arange(c) + r * width
                           for r, c in enumerate(counts)])
    return got_k[keep], got_v[keep]


def _join_node(
    plan: Plan, node, left: _NodeRes, right: _NodeRes, mesh,
    config: DistJoinConfig,
    fb_key: Optional[tuple] = None,
    checks: Optional[list] = None,
) -> _NodeRes:
    j = node.data
    if left.total == 0 or right.total == 0:
        return _empty_res(node.output_attrs, mesh)

    lt = plan.nodes[j.left].output_attrs[j.left_attr][1]
    rt = plan.nodes[j.right].output_attrs[j.right_attr][1]
    if lt is not rt:
        return _empty_res(node.output_attrs, mesh)

    if j.build_left:
        build, probe = left, right
        battr, pattr = j.left_attr, j.right_attr
    else:
        build, probe = right, left
        battr, pattr = j.right_attr, j.left_attr

    def side_args(res: _NodeRes, attr: int, prefix: str):
        kd, kv = res.cols[attr]
        kv = kv if res.live is None else kv & res.live
        payloads = {}
        for i, (d, v) in enumerate(res.cols):
            payloads[f"{prefix}{i}"] = d
            payloads[f"{prefix}v{i}"] = (
                v if res.live is None else v & res.live
            )
        return kd.to(torch.int64), kv, payloads

    kb, vb, bpl = side_args(build, battr, "b")
    kp, vp, ppl = side_args(probe, pattr, "p")
    if lt is DataType.VARCHAR:
        kb, kp = _unify_varchar_keys(
            kb, kp, build.dicts[battr], probe.dicts[pattr], mesh
        )
    elif lt is DataType.FP64:
        kb, vb = _canon_f64_keys(kb, vb)
        kp, vp = _canon_f64_keys(kp, vp)

    fb = _DIST_FEEDBACK.get(fb_key) if fb_key is not None else None
    if fb is not None:
        # warm replay: no host sync — learned hot keys, capacities and
        # output bucket; the check waits for the root's batched fetch
        total = int(fb["totals"].sum())
        columns, live, totals_dev, overflow_dev = distributed_join_deferred(
            kb, vb, bpl, kp, vp, ppl, mesh,
            fb["hot_keys"], fb["hot_valid"], fb,
            expand=total > 0,  # learned-empty: checks only, no materialize
        )
        checks.append((totals_dev, overflow_dev, fb["totals"]))
        if total == 0:
            return _empty_res(node.output_attrs, mesh)
    else:
        # heavy-hitter detection samples the probe side; the keys are on
        # the devices, so subsample there (strided) and fetch the sample
        ndev = mesh.size
        pl = kp.shape[0]
        # chunked exchange: a key's rows land in a 1/chunks-sized slab
        chunks = max(1, int(config.exchange_chunks))
        cap_p = max(16, int(config.capacity_factor * pl
                            / (ndev * chunks)) + 1)
        stride = max(1, pl * ndev // config.sample_size)
        # the strided subsample under-counts population frequency by
        # `stride`; scaling the detector's capacity compensates exactly
        sample_k, sample_v = _hot_key_sample(kp, vp, stride, mesh)
        hot_keys, hot_valid = detect_hot_keys(
            sample_k, sample_v, config, ndev, max(1, cap_p // stride),
        )

        info: dict = {}
        columns, live, totals = distributed_join_device(
            kb, vb, bpl, kp, vp, ppl, mesh, hot_keys, hot_valid, config,
            info_out=info,
        )
        if fb_key is not None:
            info.update(hot_keys=hot_keys, hot_valid=hot_valid,
                        totals=np.asarray(totals))
            _fb_store(fb_key, info)
        total = int(np.sum(totals))  # host array: fetched by the ladder
        if total == 0:
            return _empty_res(node.output_attrs, mesh)

    bname = "b" if j.build_left else "p"
    rname = "p" if j.build_left else "b"
    left_w = len(left.cols)
    cols, dicts = [], []
    for ci, dt in node.output_attrs:
        if ci < left_w:
            prefix, child, cc = bname, left, ci
        else:
            prefix, child, cc = rname, right, ci - left_w
        data = columns[f"{prefix}.{prefix}{cc}"]
        valid = columns[f"{prefix}.{prefix}v{cc}"] & live
        cols.append((data, valid))
        dicts.append(child.dicts[cc])
    return _NodeRes(cols, live, total, dicts)


def execute_distributed(
    plan: Plan,
    mesh=None,
    config: Optional[DistJoinConfig] = None,
) -> HostTable:
    """Evaluate ``plan`` over the ranks; gather the root to a HostTable on
    every rank. ``mesh=None`` means :func:`~.mesh.make_mesh` (the card).
    Leaves ``plan._last_dist_stats``: the joins run, how many of them
    replayed learned state, and whether a failed check reran the plan."""
    plan.validate()
    mesh = mesh or make_mesh()
    config = config or DistJoinConfig()

    key = _fb_base_key(plan, mesh, config) if config.feedback else None
    checks: list = []
    results: Dict[int, _NodeRes] = {}
    for idx in plan.topo_order():
        node = plan.nodes[idx]
        if isinstance(node.data, ScanNode):
            results[idx] = _shard_scan(plan, node, mesh)
        else:
            results[idx] = _join_node(
                plan, node,
                results[node.data.left], results[node.data.right],
                mesh, config,
                fb_key=key + (idx,) if key is not None else None,
                checks=checks,
            )

    if checks:
        # one batched fetch checks every warm-replayed join: exact iff no
        # shuffle overflowed and every join produced the totals the replay
        # planned with (a changed dataset under the same plan shape, or
        # grown skew, fails here and reruns cold)
        fetched = multihost.fetch_many(
            [a for t, o, _ in checks for a in (t, o)], mesh)
        ok = all(
            int(np.max(fetched[2 * i + 1])) == 0
            and np.array_equal(fetched[2 * i], learned)
            for i, (_, _, learned) in enumerate(checks)
        )
        if not ok:
            for idx in plan.topo_order():
                _DIST_FEEDBACK.pop(key + (idx,), None)
            # rerun with feedback still on: every entry for this plan is
            # gone, so the rerun takes the cold path — and re-learns,
            # sparing the NEXT execution a third full cold pass
            out = execute_distributed(plan, mesh=mesh, config=config)
            plan._last_dist_stats["rerun"] = True
            return out
    plan._last_dist_stats = {
        "joins": sum(not isinstance(plan.nodes[i].data, ScanNode)
                     for i in results),
        "replayed": len(checks), "rerun": False}

    root = results[plan.root]
    root_node = plan.nodes[plan.root]
    n = root.total
    # batched gather: live mask + every root column in one transfer
    fetched_cols = multihost.fetch_many(
        ([] if root.live is None else [root.live])
        + [a for dv in root.cols for a in dv], mesh)
    if root.live is None:
        live_np = np.zeros(0, bool)  # scan root: slice below
        flat = fetched_cols
    else:
        live_np = np.asarray(fetched_cols[0])
        flat = fetched_cols[1:]
    cols: List[HostColumn] = []
    for k, (ci, dt) in enumerate(root_node.output_attrs):
        data_h, valid_h = flat[2 * k], flat[2 * k + 1]
        if root.live is None:
            values = np.asarray(data_h)[:n]
            valid = np.asarray(valid_h)[:n]
        else:
            values = np.asarray(data_h)[live_np]
            valid = np.asarray(valid_h)[live_np]
        if dt is DataType.VARCHAR:
            d = root.dicts[k] or StringDict.empty()
            if len(values) == 0 or d.size == 0:
                cols.append(HostColumn.varchar(
                    np.zeros(0, np.uint8),
                    np.zeros(len(values), np.int64),
                    valid,
                ))
            else:
                ids = np.clip(values, 0, d.size - 1)
                starts = np.where(valid, d.starts[ids], 0)
                lengths = np.where(valid, d.lengths[ids], 0)
                heap, ends = gather_varlen(d.heap, starts, lengths)
                cols.append(HostColumn.varchar(heap, ends, valid))
        elif dt is DataType.FP64:
            cols.append(HostColumn(
                dt, np.asarray(values, np.int64).view(np.float64), valid
            ))
        else:
            cols.append(HostColumn(dt, values.astype(dt.numpy_dtype), valid))
    return HostTable(n, cols)
