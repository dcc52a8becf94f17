"""Distributed hash-partitioned shuffle join over a process group (port of
radixjoin_tpu/parallel/dist_join.py).

The multi-rank form of the single-card merge join (ops/join.py), one
process per rank:

1. both sides live row-sharded over the ranks;
2. **skew absorption**: keys detected as heavy hitters bypass the shuffle —
   their build rows are replicated to every rank (all-gather of a
   capacity-bounded hot buffer) and their probe rows join locally on their
   home rank (broadcast-hot / partition-cold);
3. **radix shuffle**: the remaining rows exchange by the capacity-factor
   all-to-all (shuffle.py), so each key lands on ``hash(key) mod ndev``;
4. **local join**: every rank runs the merge join's sort and count on its
   received partition (phase A), then — after one host fetch of the
   per-rank totals, which picks one static output bucket — its expansion
   and late materialization from phase A's intermediates (phase B).

Capacity overflows are counted, summed over the ranks and read with the
totals; the ladder doubles every capacity and retries, so results are
always exact. Every rank reads the same fetched values, so every rank
takes the same retry decision and the same output bucket.

Differences from the JAX package, by design: phase A's intermediates are
plain tensors handed to phase B (no compiled-phase cache); the chunked
exchange issues every chunk's all-to-alls asynchronously before the first
chunk's join and waits on each chunk's before its join (XLA's scheduler
overlaps them in the JAX package); the expansion launches the window
gather kernels (``ops/join.py``), where the JAX package passes
``pallas=False`` under ``shard_map`` — the same values either way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import join as join_ops
from ..ops.hashing import murmur64, udiv, umod
from . import multihost
from . import shuffle as shuffle_ops
from .mesh import make_mesh


@dataclasses.dataclass
class DistJoinConfig:
    capacity_factor: float = 2.0
    hot_capacity_factor: float = 2.0
    max_hot_keys: int = 16
    hot_threshold: float = 0.25  # fraction of per-rank probe capacity
    sample_size: int = 65536
    # Build-side Bloom pre-filter: probe rows whose key hits no set bit
    # cannot match anywhere and are not shuffled (a semi-join reduction of
    # the all-to-all volume). ~8 bits per build key; 0 disables.
    bloom_max_bits: int = 1 << 18
    # >1: split the key space into this many sub-partitions by a hash digit
    # independent of the routing digit; each exchanges and joins on its
    # own, and every chunk's exchange is in flight before the first join.
    exchange_chunks: int = 1
    # Cardinality feedback (dist_executor): repeat executions of the same
    # plan replay every join without a host sync from the learned
    # capacities, hot keys and output buckets, and check them all at once
    # at the plan root (a mismatch reruns the plan cold).
    feedback: bool = True


def _pad_to_shards(arr: np.ndarray, ndev: int, fill=0):
    n = arr.shape[0]
    per = -(-max(n, 1) // ndev)
    padded = np.full((per * ndev,), fill, dtype=arr.dtype)
    padded[:n] = arr
    return padded


def _is_hot(keys: torch.Tensor, hot_keys: np.ndarray, hot_valid: np.ndarray):
    """Rows whose key is one of the valid hot keys (host values, at most
    ``max_hot_keys``: one compare a key, no upload)."""
    hot = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    np_dtype = torch.empty(0, dtype=keys.dtype).numpy().dtype
    for k, v in zip(np.asarray(hot_keys).astype(np_dtype), hot_valid):
        if v:
            hot |= keys == int(k)
    return hot


def _gather_hot(keys, valid, payloads, hot_mask, hot_cap: int, mesh):
    """Compact this rank's hot rows into ``(hot_cap,)`` (in row order) and
    all-gather them. Returns the gathered keys, valid flags and payloads and
    this rank's overflow count."""
    live = valid & hot_mask
    rank = torch.cumsum(live.to(torch.int64), 0) - 1
    in_cap = live & (rank < hot_cap)
    idx = torch.where(in_cap, rank, hot_cap)

    def compact(values):
        buf = torch.zeros(hot_cap + 1, dtype=values.dtype,
                          device=values.device)
        buf[idx] = values
        return buf[:hot_cap]

    ck = compact(keys)
    cv = compact(in_cap)
    cp = {k: compact(v) for k, v in payloads.items()}
    overflow = torch.clamp(live.sum() - hot_cap, min=0)

    gk = multihost.all_gather(ck, mesh)
    gv = multihost.all_gather(cv, mesh)
    gp = {k: multihost.all_gather(v, mesh) for k, v in cp.items()}
    return gk, gv, gp, overflow


def _bloom_member(kb, vb, kp, bits: int, mesh):
    """Global build-key membership test for the probe shard: each rank sets
    the bit of every valid local build key in a ``bits``-wide bitmap (the
    murmur64 radix both sides route by, so no false negatives), a sum over
    the ranks ORs the bitmaps, and the probe shard tests its keys."""
    mask = bits - 1
    bi = murmur64(kb) & mask
    local = torch.zeros(bits + 1, dtype=torch.int32, device=kb.device)
    # index_fill_ takes the 1 as a kernel argument; ``local[i] = 1`` would
    # copy it to the card first, a host sync on every call
    local.index_fill_(0, torch.where(vb, bi, bits), 1)
    global_bits = multihost.all_reduce_sum(local[:bits], mesh)
    pi = murmur64(kp) & mask
    return global_bits[pi] > 0


def _chunk_of(keys, ndev: int, chunks: int):
    """Sub-partition id: a hash digit independent of the routing digit
    (``% ndev``), so every key's rows land in exactly one chunk on its
    owner rank — per-chunk local joins are complete and disjoint."""
    return umod(udiv(murmur64(keys), ndev), chunks).to(torch.int32)


def _assemble(kb, vb, bpl, kp, vp, ppl, mesh, *, cap_b, cap_p, hot_cap,
              hot_keys, hot_valid, bloom_bits=0, chunks=1):
    """Per-rank exchange. Returns the (build, probe, works) groups this rank
    joins locally and the overflow count summed over the ranks; a group's
    rows may be read after its ``works`` are waited on.

    ``chunks == 1``: one group of shuffled-cold + broadcast-hot rows.
    ``chunks > 1``: one group per key-space sub-partition plus a hot group.
    The groups partition the match set exactly: the chunk id is a function
    of the key, and hot keys are excluded from every cold shuffle."""
    ndev = mesh.size
    hot_b = _is_hot(kb, hot_keys, hot_valid)
    hot_p = _is_hot(kp, hot_keys, hot_valid)
    if bloom_bits:
        # semi-join reduction: probe rows that cannot match any build key
        # (globally) die here — they neither shuffle nor join at home
        vp = vp & _bloom_member(kb, vb, kp, bloom_bits, mesh)

    groups = []
    if chunks == 1:
        rbk, rbv, rbp, overflow = shuffle_ops.shuffle(
            kb, vb, bpl, mesh, cap_b, keep=~hot_b)
        rpk, rpv, rpp, ovf_p = shuffle_ops.shuffle(
            kp, vp, ppl, mesh, cap_p, keep=~hot_p)
        overflow = overflow + ovf_p
        if len(hot_keys) > 0:
            gbk, gbv, gbp, ovf_h = _gather_hot(kb, vb, bpl, hot_b, hot_cap,
                                               mesh)
            overflow = overflow + multihost.all_reduce_sum(ovf_h, mesh)
            jk = torch.cat([rbk, gbk])
            jv = torch.cat([rbv, gbv])
            jp = {k: torch.cat([rbp[k], gbp[k]]) for k in rbp}
            # hot probe rows stay home: the local shard masked to hot
            pk = torch.cat([rpk, kp])
            pv = torch.cat([rpv, vp & hot_p])
            pp = {k: torch.cat([rpp[k], ppl[k]]) for k in rpp}
            groups.append(((jk, jv, jp), (pk, pv, pp), []))
        else:
            groups.append(((rbk, rbv, rbp), (rpk, rpv, rpp), []))
        return groups, overflow

    # one sort per side produces every chunk's send slab; the all-to-alls
    # of every chunk are issued here, before any chunk joins
    ch_b = _chunk_of(kb, ndev, chunks)
    ch_p = _chunk_of(kp, ndev, chunks)
    b_out, ovf_b = shuffle_ops.shuffle_chunked(
        kb, vb, bpl, mesh, chunks, cap_b, ch_b, keep=~hot_b)
    p_out, ovf_p = shuffle_ops.shuffle_chunked(
        kp, vp, ppl, mesh, chunks, cap_p, ch_p, keep=~hot_p)
    overflow = ovf_b + ovf_p
    for (bk_, bv_, bp_, bw), (pk_, pv_, pp_, pw) in zip(b_out, p_out):
        groups.append(((bk_, bv_, bp_), (pk_, pv_, pp_), bw + pw))
    if len(hot_keys) > 0:
        gbk, gbv, gbp, ovf_h = _gather_hot(kb, vb, bpl, hot_b, hot_cap, mesh)
        overflow = overflow + multihost.all_reduce_sum(ovf_h, mesh)
        groups.append(((gbk, gbv, gbp), (kp, vp & hot_p, ppl), []))
    return groups, overflow


def _exchange_phase(kb, vb, bpl, kp, vp, ppl, hot_keys, hot_valid, mesh, *,
                    cap_b, cap_p, hot_cap, bloom_bits, chunks):
    """Phase A: exchange, then per group the merge join's sort and count.

    Returns every intermediate the expansion needs (the received build
    keys and payloads, the probe payloads and the sort products), so phase
    B repeats neither the all-to-all nor the sort, plus this rank's match
    total and the summed overflow, each as a ``(1,)`` tensor."""
    groups, overflow = _assemble(
        kb, vb, bpl, kp, vp, ppl, mesh,
        cap_b=cap_b, cap_p=cap_p, hot_cap=hot_cap, hot_keys=hot_keys,
        hot_valid=hot_valid, bloom_bits=bloom_bits, chunks=chunks,
    )
    out_groups = []
    total_sum = None
    for (jk, jv, jp), (pk, pv, pp), works in groups:
        for work in works:  # this chunk's exchange; later ones stay in flight
            work.wait()
        ids_s, run_start, _, offsets, total = join_ops.join_merge_impl(
            jk, jv, pk, pv)
        out_groups.append(dict(jk=jk, jp=jp, pp=pp, ids_s=ids_s,
                               run_start=run_start, offsets=offsets,
                               total=total))
        total_sum = total if total_sum is None else total_sum + total
    return out_groups, total_sum.reshape(1), overflow.reshape(1)


def _expand_phase(groups, *, s_pad):
    """Phase B: expansion and late materialization at the host-chosen
    static output bucket, from phase A's intermediates. Local compute, no
    collective. Returns ``(columns, live)`` of ``s_pad`` rows."""
    if len(groups) == 1:
        # monolithic exchange: select-based fill
        g = groups[0]
        bidx, pidx, live = join_ops.join_expand_merge_impl(
            g["ids_s"], g["run_start"], g["offsets"], g["total"], s_pad)
        out = {"__build_key": torch.where(
            live, g["jk"].index_select(0, bidx), 0)}
        # keep payload dtypes: bool planes (chained validity) stay bool
        for name, values in g["jp"].items():
            out[f"b.{name}"] = torch.where(
                live, values.index_select(0, bidx), values.new_zeros(()))
        for name, values in g["pp"].items():
            out[f"p.{name}"] = torch.where(
                live, values.index_select(0, pidx), values.new_zeros(()))
        return out, live

    # chunked exchange: every group's matches are packed at the front of its
    # expansion (live = j < total), so each group scatters its rows into the
    # shared output at a running base offset (slot s_pad is the drop slot)
    g0 = groups[0]
    dev = g0["jk"].device

    def zeros(values):
        return torch.zeros(s_pad + 1, dtype=values.dtype, device=dev)

    out = {"__build_key": zeros(g0["jk"])}
    for name, values in g0["jp"].items():
        out[f"b.{name}"] = zeros(values)
    for name, values in g0["pp"].items():
        out[f"p.{name}"] = zeros(values)
    base = torch.zeros((), dtype=torch.int64, device=dev)
    iota = torch.arange(s_pad, dtype=torch.int64, device=dev)
    for g in groups:
        bidx, pidx, live = join_ops.join_expand_merge_impl(
            g["ids_s"], g["run_start"], g["offsets"], g["total"], s_pad)
        pos = torch.where(live, base + iota, s_pad)
        out["__build_key"][pos] = g["jk"].index_select(0, bidx)
        for name, values in g["jp"].items():
            out[f"b.{name}"][pos] = values.index_select(0, bidx)
        for name, values in g["pp"].items():
            out[f"p.{name}"][pos] = values.index_select(0, pidx)
        base = base + g["total"]
    return {k: v[:s_pad] for k, v in out.items()}, iota < base


def detect_hot_keys(
    probe_keys: np.ndarray,
    probe_valid: np.ndarray,
    config: DistJoinConfig,
    ndev: int,
    cap_p: int,
):
    """Host-side heavy-hitter detection by sampling the probe side.

    A key whose estimated frequency would overwhelm its owner rank's
    shuffle capacity is routed through the broadcast path instead.
    """
    valid_keys = probe_keys[probe_valid]
    n = len(valid_keys)
    if n == 0:
        return np.zeros(0, dtype=probe_keys.dtype), np.zeros(0, dtype=bool)
    if n > config.sample_size:
        rng = np.random.default_rng(0)
        sample = valid_keys[rng.integers(0, n, config.sample_size)]
        scale = n / config.sample_size
    else:
        sample, scale = valid_keys, 1.0
    threshold = max(2.0, config.hot_threshold * cap_p / scale)
    uniq, counts = np.unique(sample, return_counts=True)
    top = np.argsort(-counts)[: config.max_hot_keys]
    top = top[counts[top] >= threshold]
    hot_arr = uniq[top].astype(probe_keys.dtype)
    return hot_arr, np.ones(len(hot_arr), dtype=bool)


def shard_inputs(
    mesh,
    build_keys, build_valid, build_payloads,
    probe_keys, probe_valid, probe_payloads,
):
    """Host arrays (the same on every rank) -> this rank's row slices on
    its device, padded to a multiple of the group size."""
    ndev = mesh.size

    def put(arr, fill=0):
        return multihost.put_sharded(_pad_to_shards(arr, ndev, fill), mesh)

    return (
        put(build_keys), put(build_valid.astype(bool), False),
        {k: put(v) for k, v in build_payloads.items()},
        put(probe_keys), put(probe_valid.astype(bool), False),
        {k: put(v) for k, v in probe_payloads.items()},
    )


def distributed_join_deferred(
    kb_d, vb_d, bpl_d, kp_d, vp_d, ppl_d,
    mesh,
    hot_keys: np.ndarray,
    hot_valid: np.ndarray,
    info: dict,
    expand: bool = True,
):
    """Both phases with no host sync: capacities, hot keys and the output
    bucket come from a previous (cold) run (``info`` as
    :func:`distributed_join_device` fills ``info_out``).

    Returns ``(columns, live, totals_dev, overflow_dev)``. The caller must
    check the ``(1,)`` device tensors later (batched, once at the plan
    root): the result is exact iff every overflow count is zero AND the
    fetched totals equal the learned totals the caller planned with;
    otherwise rerun cold. ``expand=False`` skips the materialization (the
    caller needs only the checks, e.g. for a learned-empty join). Unlike
    the JAX function it takes no config: ``info`` fixes every choice."""
    groups, totals, overflow = _exchange_phase(
        kb_d, vb_d, bpl_d, kp_d, vp_d, ppl_d, hot_keys, hot_valid, mesh,
        cap_b=info["cap_b"], cap_p=info["cap_p"], hot_cap=info["hot_cap"],
        bloom_bits=info["bloom_bits"], chunks=info["chunks"])
    if not expand:
        return None, None, totals, overflow
    columns, live = _expand_phase(groups, s_pad=info["s_pad"])
    return columns, live, totals, overflow


def distributed_join_device(
    kb_d, vb_d, bpl_d, kp_d, vp_d, ppl_d,
    mesh,
    hot_keys: np.ndarray,
    hot_valid: np.ndarray,
    config: Optional[DistJoinConfig] = None,
    info_out: Optional[dict] = None,
):
    """Run the two phases on this rank's shards (collective).

    Returns ``(columns, live, totals)`` with this rank's ``s_pad`` output
    rows and ``totals`` the per-rank match counts as a host array (already
    fetched by the capacity ladder). ``info_out``, if given, receives the
    resolved static configuration (``cap_b``, ``cap_p``, ``hot_cap``,
    ``s_pad``, ``bloom_bits``, ``chunks``, ``ngroups``), so a caller can
    replay the join without a sync through
    :func:`distributed_join_deferred`."""
    config = config or DistJoinConfig()
    ndev = mesh.size
    bl = kb_d.shape[0]
    pl = kp_d.shape[0]
    hk = np.asarray(hot_keys)
    hv = np.asarray(hot_valid)

    # Bloom sizing: ~8 bits per global build key, a power of two for the
    # mask, capped so the bitmap's all-reduce stays small beside the
    # exchange
    bloom_bits = 0
    if config.bloom_max_bits:
        want = 1 << max(13, (8 * bl * ndev - 1).bit_length())
        bloom_bits = min(int(config.bloom_max_bits), want)
        bloom_bits = 1 << (bloom_bits.bit_length() - 1)

    # chunked exchange: per-chunk receive buffers start at 1/chunks of the
    # monolithic estimate (the ladder still climbs to the same worst case)
    chunks = max(1, int(config.exchange_chunks))
    # the group census of _assemble: chunks == 1 folds the hot rows into
    # the single group; chunks > 1 gives them their own group
    ngroups = (chunks + (1 if len(hk) > 0 else 0)) if chunks > 1 else 1

    # Capacity ladder: each retry doubles every receive buffer — the
    # shuffle capacities AND the hot-broadcast buffer (a skewed *build*
    # side overflows the hot buffer, which probe-side sampling cannot
    # predict) — clamped at the provably sufficient worst case (one rank
    # receives every row / every local row is hot). Only an overflow at
    # the worst case is an error.
    m = 1.0
    while True:
        cap_b = min(max(16, bl * ndev),
                    max(16, int(m * config.capacity_factor * bl
                                / (ndev * chunks)) + 1))
        cap_p = min(max(16, pl * ndev),
                    max(16, int(m * config.capacity_factor * pl
                                / (ndev * chunks)) + 1))
        hot_cap = min(
            max(16, bl),
            max(16, int(m * config.hot_capacity_factor * bl / ndev) + 1),
        )
        groups, totals, overflow = _exchange_phase(
            kb_d, vb_d, bpl_d, kp_d, vp_d, ppl_d, hk, hv, mesh,
            cap_b=cap_b, cap_p=cap_p, hot_cap=hot_cap,
            bloom_bits=bloom_bits, chunks=chunks)
        # one host transfer a step for both: every rank reads the same
        # values and takes the same decision
        totals_h, overflow_h = multihost.fetch_many([totals, overflow], mesh)
        if int(np.max(overflow_h)) == 0:
            break
        at_worst_case = (
            cap_b >= max(16, bl * ndev)
            and cap_p >= max(16, pl * ndev)
            and hot_cap >= max(16, bl)
        )
        if at_worst_case:
            raise RuntimeError(
                "shuffle overflow at worst-case capacity (engine bug)")
        del groups
        m *= 2.0

    # phase B expands from phase A's intermediates; the totals the ladder
    # fetched size the bucket (no further sync)
    s_pad = join_ops.bucket_size(int(np.max(totals_h)))
    columns, live = _expand_phase(groups, s_pad=s_pad)
    if info_out is not None:
        info_out.update(
            cap_b=cap_b, cap_p=cap_p, hot_cap=hot_cap, s_pad=s_pad,
            bloom_bits=bloom_bits, chunks=chunks, ngroups=ngroups,
        )
    return columns, live, totals_h


def distributed_join(
    build_keys: np.ndarray,
    build_valid: np.ndarray,
    build_payloads: Dict[str, np.ndarray],
    probe_keys: np.ndarray,
    probe_valid: np.ndarray,
    probe_payloads: Dict[str, np.ndarray],
    mesh=None,
    config: Optional[DistJoinConfig] = None,
    info_out: Optional[dict] = None,
):
    """Exact distributed inner join (collective: every rank passes the same
    host arrays). Returns ``(columns, live, totals)``: ``columns`` maps
    '__build_key' / 'b.*' / 'p.*' to this rank's ``(s_pad,)`` output rows,
    ``live`` flags the real ones, ``totals`` is the per-rank match count as
    a host array (already fetched). ``mesh=None`` means :func:`make_mesh`
    (the card); ``info_out`` as in :func:`distributed_join_device`, plus
    the hot keys under ``hot_keys``."""
    config = config or DistJoinConfig()
    mesh = mesh or make_mesh()
    ndev = mesh.size

    kb_d, vb_d, bpl_d, kp_d, vp_d, ppl_d = shard_inputs(
        mesh, build_keys, build_valid, build_payloads,
        probe_keys, probe_valid, probe_payloads,
    )
    pl = kp_d.shape[0]
    # the hot threshold must reflect the buffer a key actually lands in:
    # with a chunked exchange that is the 1/chunks-sized per-chunk slab
    chunks = max(1, int(config.exchange_chunks))
    cap_p = max(16, int(config.capacity_factor * pl / (ndev * chunks)) + 1)
    hot_keys, hot_valid = detect_hot_keys(
        _pad_to_shards(probe_keys, ndev),
        _pad_to_shards(probe_valid.astype(bool), ndev, fill=False),
        config, ndev, cap_p,
    )
    if info_out is not None:
        info_out["hot_keys"] = hot_keys
    return distributed_join_device(
        kb_d, vb_d, bpl_d, kp_d, vp_d, ppl_d, mesh, hot_keys, hot_valid,
        config, info_out=info_out)


def collect_to_host(columns, live, mesh) -> Dict[str, np.ndarray]:
    """Every rank's output gathered to dense host arrays in rank order,
    padding dropped, on every rank (one batched transfer)."""
    names = list(columns)
    fetched = multihost.fetch_many([live] + [columns[k] for k in names],
                                   mesh)
    live_np = fetched[0]
    return {k: v[live_np] for k, v in zip(names, fetched[1:])}
