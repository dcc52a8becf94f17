"""Single-device equi-join kernels in PyTorch (port of the main-path joins
of radixjoin_tpu/ops/join.py).

The engine lowers every join of the fused executor's main path to one of
the sort-free formulations below (plus the sort-based unique fallback):

* :func:`join_unique_scatter_impl` — FK->PK through a dense key-window
  slot table: memset + scatter + one gather, probe-shaped output;
* :func:`join_unique_impl` — the same contract through a build-side sort
  and a binary search, for key windows too sparse for a slot table;
* :func:`join_csr_impl` — general join against a CSR index (counts,
  exclusive starts, row ids grouped by key) over the key window;
* :func:`join_dev_csr_impl` — the CSR index built on the device
  (histogram + cumsum + one stable sort of the indexed side);
* :func:`join_merge_impl` / :func:`join_merge_full_impl` — the merge join:
  one sort of build ++ probe with segment scans, payload planes carried
  through the sort's permutation; for FP64 keys, key windows too sparse
  for a CSR index, and combined pads of at least 2^23 rows.

NULL-key semantics: rows with ``valid == False`` never match (inner join
drops NULL keys, reference src/execute.cpp:62-83).

Three behaviours of JAX that PyTorch does not share are made explicit:

* JAX clamps out-of-range gather indices silently; torch raises on the
  CPU and faults on the card. Every gather index here is clamped exactly
  where the JAX version relies on the clamp.
* ``mode="drop"`` scatters become a scatter into one extra sentinel slot
  that is sliced off afterwards.
* ``torch.cumsum`` of int32 widens to int64 where JAX keeps int32; every
  cumsum names its dtype. Positions are int32 (a padded bucket of 2^31
  rows would not fit the card), totals int64.

Small lookups (tables of at most ``WINDOW_GATHER_MAX`` rows) and lookups on
the monotone owner stream go through the hand-written kernels of
:mod:`.kernels`; int64 payloads gather natively (no hi/lo planes).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import kernels

MIN_BUCKET = 128


def gather_expand(src: torch.Tensor, pos: torch.Tensor,
                  windowed: bool = False) -> torch.Tensor:
    """``src[pos]`` for the expansion's lookups: the window-gather kernel
    for small ``src``, the blocked-window kernel when ``windowed`` asserts
    that ``pos`` is monotone (block-windowed), a plain gather otherwise.
    ``pos`` is int32 and already clamped to ``[0, len(src))``."""
    return gather_expand_multi([src], pos, windowed)[0]


def gather_expand_multi(tables, pos: torch.Tensor,
                        windowed: bool = False) -> List[torch.Tensor]:
    """``[t[pos] for t in tables]`` for equal-length tables sharing one
    index stream — one kernel pass serves all of them. Routing as in
    :func:`gather_expand`. The blocked-window kernel patches window misses
    itself, so no miss count reaches the host."""
    tables = list(tables)
    n0 = tables[0].shape[0]
    if any(t.shape[0] != n0 for t in tables):
        raise ValueError("gather_expand_multi: equal lengths required")
    if n0 <= kernels.WINDOW_GATHER_MAX:
        return kernels.window_gather(tables, pos)
    if windowed:
        vals, _ok = kernels.blocked_window_gather_multi(tables, pos)
        return vals
    return [t.index_select(0, pos) for t in tables]


def bucket_size(n: int, minimum: int = MIN_BUCKET) -> int:
    """Smallest power of two >= max(n, minimum)."""
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


def pad_1d(arr: torch.Tensor, size: int, fill=0) -> torch.Tensor:
    if arr.shape[0] == size:
        return arr
    if arr.shape[0] > size:
        raise ValueError("cannot pad down")
    out = torch.full((size,), fill, dtype=arr.dtype, device=arr.device)
    out[: arr.shape[0]] = arr
    return out


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _owner_recovery(offsets: torch.Tensor, emits: torch.Tensor,
                    s_pad: int) -> torch.Tensor:
    """Scatter-max owner recovery: each emitting row's id lands at its
    output start, a running max fills its run. Starts at or past ``s_pad``
    go to the sentinel slot (JAX's ``mode="drop"``). Returns the owner per
    output slot, int32, clamped to the row range (monotone)."""
    n = offsets.shape[0]
    starts = torch.where(emits & (offsets < s_pad), offsets.long(), s_pad)
    marker = torch.full((s_pad + 1,), -1, dtype=torch.int32,
                        device=offsets.device)
    marker.scatter_reduce_(0, starts, _iota(n, offsets.device), "amax")
    owner = torch.cummax(marker[:s_pad], dim=0).values
    return owner.clamp(0, n - 1)


def join_unique_impl(build_keys, build_valid, probe_keys, probe_valid):
    """FK->PK fast path: build keys are pairwise distinct among valid rows,
    so every probe row matches at most once and the output stays
    **probe-shaped** — row j of the output is probe row j, with
    ``found[j]`` False for non-matching rows.

    Returns ``(bidx, found, total)``: build row id per probe row (0 where
    not found), the match mask, and the exact match count (int64)."""
    bp = build_keys.shape[0]
    dev = build_keys.device
    # the JAX version sorts (invalid, key, iota) lexicographically with a
    # stable sort; two stable passes, minor key first, give that order
    o1 = torch.sort(build_keys, stable=True).indices
    o2 = torch.sort((~build_valid[o1]).to(torch.uint8), stable=True).indices
    perm64 = o1[o2]
    keys_sorted = build_keys[perm64]
    perm = perm64.to(torch.int32)
    nvalid = build_valid.sum()  # stays on the device: no host sync
    maxval = torch.iinfo(build_keys.dtype).max
    pos = torch.arange(bp, device=dev)
    keys_search = torch.where(pos < nvalid, keys_sorted,
                              torch.full_like(keys_sorted, maxval))
    lo = torch.searchsorted(keys_search, probe_keys, side="left")
    lo_c = lo.clamp(max=bp - 1)
    found = probe_valid & (lo < nvalid) & (keys_search[lo_c] == probe_keys)
    bidx = torch.where(found, perm[lo_c], 0)
    total = found.sum(dtype=torch.int64)
    return bidx, found, total


def join_unique_scatter_impl(build_keys, build_valid, probe_keys,
                             probe_valid, base: int, r_pad: int):
    """Sort-free FK->PK join via a dense key-range table.

    Applicable when the build side is unique and its valid keys lie in the
    static window ``[base, base + r_pad)`` (the executor derives it from
    host-side stats of the build scan). Each build row id is scattered into
    ``slots[key - base]`` and probes look up with one gather:
    memset(r_pad) + scatter(B) + gather(P). Out-of-window probe keys cannot
    match. Returns ``(bidx, found, total)`` — probe-shaped, like
    :func:`join_unique_impl`."""
    bp = build_keys.shape[0]
    dev = build_keys.device
    off_b64 = build_keys.long() - base
    # invalid rows (incl. padding) -> the sentinel slot r_pad; valid build
    # keys are in-window by construction of the caller
    off_b = torch.where(build_valid, off_b64.clamp(0, r_pad), r_pad)
    slots = torch.full((r_pad + 1,), -1, dtype=torch.int32, device=dev)
    slots[off_b] = _iota(bp, dev)
    slots = slots[:r_pad]
    off_p64 = probe_keys.long() - base
    in_window = (off_p64 >= 0) & (off_p64 < r_pad)
    off_p = off_p64.clamp(0, r_pad - 1).to(torch.int32)
    (hit,) = gather_expand_multi([slots], off_p)
    found = probe_valid & in_window & (hit >= 0)
    bidx = torch.where(found, hit, 0)
    total = found.sum(dtype=torch.int64)
    return bidx, found, total


def join_csr_impl(counts_w, starts_w, grouped, probe_keys, probe_valid,
                  base: int, s_pad: int):
    """Sort-free general join against a CSR-indexed build side over the key
    window ``[base, base + r_pad)``:

      * ``counts_w`` (r_pad,) int32 — valid build rows per key offset
      * ``starts_w`` (r_pad,) int32 — exclusive prefix sum of counts_w
      * ``grouped``  (g_pad,) int32 — build row ids grouped by key offset

    Per probe, ``count/start`` come from one shared-index lookup; the
    expansion recovers each output slot's probe row by scatter-max +
    cummax and maps within-run offsets through ``grouped``. Duplicates fan
    out; NULL keys never match; out-of-window probe keys match nothing.

    Returns ``(bidx, pidx, live, total)`` in the ``s_pad`` bucket, with an
    asymmetric dead-row contract: ``bidx`` is zeroed on dead rows, ``pidx``
    is not — it stays monotone and in bounds across the whole pad, so the
    payload gathers along it can ride the blocked-window kernel. Mask by
    ``live`` before reading ``pidx``."""
    r_pad = counts_w.shape[0]
    dev = probe_keys.device
    off_p64 = probe_keys.long() - base
    in_window = probe_valid & (off_p64 >= 0) & (off_p64 < r_pad)
    off_p = off_p64.clamp(0, r_pad - 1).to(torch.int32)
    cnt_i32, start = gather_expand_multi([counts_w, starts_w], off_p)
    cnt = torch.where(in_window, cnt_i32, 0)
    offsets = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt
    total = cnt.sum(dtype=torch.int64)
    pidx = _owner_recovery(offsets, cnt > 0, s_pad)
    j = _iota(s_pad, dev)
    # pidx is monotone (cummax): the offsets/start lookups ride one
    # blocked-window pass; gpos jumps between probes, so the grouped
    # lookup takes the unwindowed route
    offs_g, start_g = gather_expand_multi([offsets, start], pidx,
                                          windowed=True)
    gpos = (start_g + (j - offs_g)).clamp(0, grouped.shape[0] - 1)
    bidx = gather_expand(grouped, gpos)
    live = j < total
    bidx = torch.where(live, bidx, 0)
    return bidx, pidx, live, total


def join_dev_csr_impl(build_keys, build_valid, probe_keys, probe_valid,
                      base: int, r_pad: int, s_pad: int):
    """General join via a CSR index built **on the device** over the key
    window ``[base, base + r_pad)`` — for joins whose two children are both
    intermediates, with the window taken from the build key's origin base
    column. Histogram scatter-add + cumsum over the window, and ``grouped``
    from ONE stable sort of the build side's key offsets; then
    :func:`join_csr_impl`. Same semantics and dead-row contract."""
    bp = build_keys.shape[0]
    dev = build_keys.device
    off_b64 = build_keys.long() - base
    in_b = build_valid & (off_b64 >= 0) & (off_b64 < r_pad)
    off_b = torch.where(in_b, off_b64, r_pad).to(torch.int32)
    counts_w = torch.zeros(r_pad + 1, dtype=torch.int32, device=dev)
    counts_w.index_add_(0, off_b, torch.ones(bp, dtype=torch.int32, device=dev))
    counts_w = counts_w[:r_pad]
    starts_w = torch.cumsum(counts_w, 0, dtype=torch.int32) - counts_w
    # stable: in-window rows grouped by key offset at the head, in row
    # order within a key, exactly the CSR layout starts_w indexes into
    grouped = torch.sort(off_b, stable=True).indices.to(torch.int32)
    return join_csr_impl(counts_w, starts_w, grouped, probe_keys,
                         probe_valid, base, s_pad)


def _merge_order(build_keys, build_valid, probe_keys, probe_valid):
    """The merge join's sort of build ++ probe by (invalid, key, side, id):
    ``(perm, ids_s, side_s, valid_s, runkey)`` where ``perm`` is the sort
    permutation (int64), ``ids_s``/``side_s``/``valid_s`` the original row
    id (int32), side (1 = probe) and validity per sorted slot, and
    ``runkey`` one or two tensors whose change marks a new equal-key run.

    Every sorted element is unique (side and row id are part of the key),
    so the order is the JAX package's ``lax.sort`` order exactly. 32-bit
    keys pack into one int64 sort key; 64-bit keys sort two keys with two
    stable passes, minor key first."""
    bp, pp = build_keys.shape[0], probe_keys.shape[0]
    n = bp + pp
    dev = build_keys.device
    keys = torch.cat([build_keys, probe_keys])
    valid = torch.cat([build_valid, probe_valid])
    ids = torch.cat([torch.arange(bp, device=dev),
                     torch.arange(pp, device=dev)])
    invalid64 = (~valid).to(torch.int64)
    side64 = torch.cat([torch.zeros(bp, dtype=torch.int64, device=dev),
                        torch.ones(pp, dtype=torch.int64, device=dev)])
    if keys.dtype == torch.int32 and n < (1 << 29):
        # [62] invalid | [30..61] key (sign-biased) | [29] side | [0..28] id
        ukey = (keys.to(torch.int64) & 0xFFFFFFFF) ^ (1 << 31)
        packed = (invalid64 << 62) | (ukey << 30) | (side64 << 29) | ids
        packed_s, perm = torch.sort(packed)
        ids_s = (packed_s & ((1 << 29) - 1)).to(torch.int32)
        side_s = (packed_s >> 29) & 1
        valid_s = ((packed_s >> 62) & 1) == 0
        # run identity = key bits + invalid bit in one compare
        runkey = (packed_s >> 30,)
    else:
        keys64 = keys.to(torch.int64)
        maxk = torch.iinfo(keys.dtype).max
        keysat = torch.where(valid, keys64, torch.full_like(keys64, maxk))
        # [33] invalid | [32] side | [0..31] id
        packed = (invalid64 << 33) | (side64 << 32) | ids
        o1 = torch.sort(packed).indices
        o2 = torch.sort(keysat[o1], stable=True).indices
        perm = o1[o2]
        keysat_s, packed_s = keysat[perm], packed[perm]
        ids_s = (packed_s & 0xFFFFFFFF).to(torch.int32)
        side_s = (packed_s >> 32) & 1
        valid_s = ((packed_s >> 33) & 1) == 0
        # a valid key equal to the saturation value must not merge with
        # the invalid tail: the invalid bit is part of the run identity
        runkey = (keysat_s, (packed_s >> 33) & 1)
    return perm, ids_s, side_s, valid_s, runkey


def join_merge_impl(build_keys, build_valid, probe_keys, probe_valid,
                    carry: Sequence[torch.Tensor] = ()):
    """Single-sort merge join count (port of the JAX package's
    ``join_merge_impl``): ONE sort of build ++ probe by (invalid, key,
    side), builds before probes within each equal-key run, then segment
    scans. For a probe element at sorted position ``pos`` with run start
    ``rs``, its count is the builds in its run,
    ``(pos - rs) - (probes in [rs, pos))``, and its matches sit at sorted
    positions ``[rs, rs + count)``.

    ``carry``: combined-length (B+P) planes of any dtype moved into sorted
    order with the sort's permutation (one gather each); when non-empty
    the return gains a 6th element, the tuple of sorted planes.

    Returns ``(ids_sorted, run_start, counts, offsets, total)``: int32
    (B+P,) original row id, run start, matches per sorted slot (0 for
    build and invalid slots) and its exclusive prefix sum, and the int64
    total — the JAX function's dtypes."""
    perm, ids_s, side_s, valid_s, runkey = _merge_order(
        build_keys, build_valid, probe_keys, probe_valid)
    n = ids_s.shape[0]
    dev = ids_s.device
    pos = _iota(n, dev)
    is_start = pos == 0
    for rk in runkey:
        is_start = is_start | torch.cat([rk[:1], rk[:-1]]).ne(rk)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    run_start = torch.cummax(torch.where(is_start, pos, zero), 0).values
    is_probe = side_s.to(torch.int32)
    probe_excl = torch.cumsum(is_probe, 0, dtype=torch.int32) - is_probe
    # probes before each run start, broadcast across the run (monotone, so
    # a running max of start-masked values is exact)
    probe_at_start = torch.cummax(
        torch.where(is_start, probe_excl, zero), 0).values
    builds_in_run = (pos - run_start) - (probe_excl - probe_at_start)
    counts = torch.where((is_probe == 1) & valid_s, builds_in_run, zero)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    total = counts.sum(dtype=torch.int64)
    if carry:
        carried = tuple(c.index_select(0, perm) for c in carry)
        return ids_s, run_start, counts, offsets, total, carried
    return ids_s, run_start, counts, offsets, total


def _merge_owner_recovery(offsets, total, s_pad: int):
    """Owner recovery over sorted positions: ``(owner, j, live)`` with
    ``owner[j]`` the sorted slot owning output j (monotone, int32), ``j``
    the output positions and ``live = j < total``."""
    total32 = total.to(torch.int32).reshape(1)
    emits = torch.diff(offsets, append=total32) > 0
    owner = _owner_recovery(offsets, emits, s_pad)
    j = _iota(s_pad, offsets.device)
    return owner, j, j < total32


def join_expand_merge_impl(ids_sorted, run_start, offsets, total,
                           s_pad: int):
    """Expansion for the merge join: output slot j -> ``(bidx, pidx,
    live)`` in the ``s_pad`` bucket, dead rows zeroed. The owner-indexed
    lookups share the monotone ``owner`` stream in one blocked-window pass,
    and the ``bpos`` stream is block-windowed too (run starts advance no
    faster than output slots)."""
    n = offsets.shape[0]
    owner, j, live = _merge_owner_recovery(offsets, total, s_pad)
    offs_g, rs_g, pidx = gather_expand_multi(
        [offsets, run_start, ids_sorted], owner, windowed=True)
    bpos = (rs_g + (j - offs_g)).clamp(0, n - 1)
    bidx = gather_expand(ids_sorted, bpos, windowed=True)
    zero = torch.zeros((), dtype=torch.int32, device=offsets.device)
    return torch.where(live, bidx, zero), torch.where(live, pidx, zero), live


def join_merge_full_impl(build_keys, build_valid, probe_keys, probe_valid,
                         s_pad: int,
                         build_cols: Sequence[Tuple[torch.Tensor,
                                                    torch.Tensor]],
                         probe_cols: Sequence[Tuple[torch.Tensor,
                                                    torch.Tensor]]):
    """Merge join end to end: count, expansion and late materialization.
    Every payload column's data and validity plane rides the join's sort
    (``carry``), in its own dtype; after the sort everything is
    position-local: probe payloads ride the monotone ``owner`` stream with
    the expansion's own offsets/run-start lookups, build payloads the
    block-windowed ``bpos`` stream, both through the blocked-window kernel.

    Returns ``(out_build, out_probe, live, total)`` with outputs as
    ``(data, valid & live)`` in the ``s_pad`` bucket — the multiset of
    gathering by ``(bidx, pidx)``."""
    bp, pp = build_keys.shape[0], probe_keys.shape[0]
    b_planes = [p for d, v in build_cols for p in (d, v)]
    p_planes = [p for d, v in probe_cols for p in (d, v)]
    # combined-length planes: the other side's half is never read (build
    # planes only at build slots via bpos, probe planes at probe slots via
    # owner)
    carry = [torch.cat([p, p.new_zeros(pp)]) for p in b_planes] + [
        torch.cat([p.new_zeros(bp), p]) for p in p_planes]
    _ids, run_start, _c, offsets, total, *rest = join_merge_impl(
        build_keys, build_valid, probe_keys, probe_valid, carry)
    carried = rest[0] if rest else ()
    n = offsets.shape[0]
    owner, j, live = _merge_owner_recovery(offsets, total, s_pad)
    nb = len(b_planes)
    got = gather_expand_multi([offsets, run_start] + list(carried[nb:]),
                              owner, windowed=True)
    offs_g, rs_g, p_got = got[0], got[1], got[2:]
    bpos = (rs_g + (j - offs_g)).clamp(0, n - 1)
    b_got = (gather_expand_multi(list(carried[:nb]), bpos, windowed=True)
             if nb else [])

    def pairs(planes):
        return [(planes[i], planes[i + 1] & live)
                for i in range(0, len(planes), 2)]

    return pairs(b_got), pairs(p_got), live, total
