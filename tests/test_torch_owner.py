"""The owner recovery and the int32 running max of the port
(radixjoin_tpu_torch/ops/kernels.py: ``owner_recovery``, ``cummax_i32``)
against the JAX formulation they replace and against the definition.

The JAX package writes the owner recovery with XLA ops in four places
(radixjoin_tpu/ops/join.py: join_expand_impl, _merge_owner_recovery,
join_csr_impl; radixjoin_tpu/plan/executor.py: _compact_probe_shaped):
``marker.at[starts].max(iota, mode="drop")``, ``lax.cummax``, ``clip``,
with ``emits`` the rows of non-zero count. Every caller's ``offsets`` is
the exclusive prefix sum of those counts and ``total`` their sum, so the
port takes ``(offsets, total, s_pad)`` and derives ``emits[i] = offsets[i +
1] > offsets[i]`` (``offsets[n] = total``). The test builds the JAX
formulation from ``jnp`` and states the definition in numpy two ways, as
the JAX scatter-max does and as the sorted search the card does:

    owner[j] = clip(max{i : emits[i], offsets[i] <= j, offsets[i] < s_pad},
                    0, n - 1)        (an empty max is -1)
             = clip(upper_bound(offsets, min(j, total - 1)) - 1, 0, n - 1)

On the CPU the wrappers take their plain versions, so these tests hold the
plain versions to both, bit for bit. A numpy model of the CUDA kernel's
merge-path partition (``csrc/owner_recovery.cu``: the block splits, the
tiles, each thread's diagonal search and walk) is held to the definition
at tiny tile sizes, and every call site of the package is held to the
precondition; the CUDA kernels are held to the plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from radixjoin_tpu.ops import join as jjoin
from radixjoin_tpu_torch import ColumnarTable, Plan, build_context, execute
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.harness.datagen import SyntheticIMDB
from radixjoin_tpu_torch.ops import join as tjoin
from radixjoin_tpu_torch.ops import kernels
from radixjoin_tpu_torch.plan import executor as port_exec


def _emits(offsets, total):
    """The JAX package's emits: ``diff(append(offsets, total)) > 0``."""
    return np.diff(np.append(offsets.astype(np.int64), total)) > 0


def _owner_definition(offsets, total, s_pad):
    """The definition, slot by slot: as the scatter-max states it, over a
    dense (n, s_pad) mask, and as a sorted search; the two must agree."""
    n = offsets.shape[0]
    emits = _emits(offsets, total)
    j = np.arange(s_pad, dtype=np.int64)
    off = offsets.astype(np.int64)[:, None]
    ok = emits[:, None] & (off <= j[None, :]) & (off < s_pad)
    ids = np.arange(n, dtype=np.int64)[:, None]
    best = np.where(ok, ids, -1).max(axis=0) if n else np.full(s_pad, -1)
    want = np.clip(best, 0, n - 1).astype(np.int32)
    keys = np.minimum(j, total - 1)
    search = np.searchsorted(offsets.astype(np.int64), keys, side="right") - 1
    np.testing.assert_array_equal(np.clip(search, 0, n - 1), want)
    return want


def _owner_jax(offsets, total, s_pad):
    """The JAX package's formulation, built here from jnp."""
    n = offsets.shape[0]
    off = jnp.asarray(offsets)
    total32 = jnp.asarray(total, dtype=jnp.int32)
    emits = jnp.diff(jnp.append(off, total32.astype(off.dtype))) > 0
    starts = jnp.where(emits, off, s_pad)
    marker = jnp.full(s_pad + 1, -1, dtype=jnp.int32)
    marker = marker.at[starts].max(jnp.arange(n, dtype=jnp.int32),
                                   mode="drop")
    return np.asarray(jnp.clip(jax.lax.cummax(marker[:s_pad]), 0, n - 1))


def _check_owner(offsets, total, s_pad, total_dtype=torch.int64):
    want = _owner_definition(offsets, total, s_pad)
    np.testing.assert_array_equal(_owner_jax(offsets, total, s_pad), want)
    t_off = torch.from_numpy(offsets)
    t_total = torch.tensor(total, dtype=total_dtype)
    plain = kernels.owner_recovery_plain(t_off, t_total, s_pad)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(
        kernels.owner_recovery(t_off, t_total, s_pad).numpy(), want)
    return want


def _from_counts(counts, dtype):
    counts = np.asarray(counts, dtype=np.int64)
    offsets = (np.cumsum(counts) - counts).astype(dtype)
    return offsets, int(counts.sum())


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("fan_out", [3, 17])
@pytest.mark.parametrize("n", [1, 2, 64, 1027])
@pytest.mark.parametrize("pad", ["below", "at", "above"])
def test_owner_from_seeded_counts(pad, n, fan_out, dtype):
    rng = np.random.default_rng([n, fan_out])
    counts = rng.choice([0, 1, 2, fan_out], n)
    offsets, total = _from_counts(counts, dtype)
    s_pad = {"below": max(total // 2, 1), "at": max(total, 1),
             "above": kernels.OWNER_TILE + total}[pad]
    want = _check_owner(offsets, total, s_pad)
    if pad == "above" and total:
        # the dead tail carries the last emitting row
        assert (want[total:] == np.flatnonzero(counts)[-1]).all()
    assert (np.diff(want) >= 0).all()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_owner_runs_that_straddle_the_pad(dtype):
    # row 2's run starts below s_pad and ends past it; rows 3 and 4 start
    # at and past it and count for nothing
    offsets, total = _from_counts([2, 0, 5, 3, 1], dtype)
    assert total == 11
    want = _check_owner(offsets, total, 4)
    np.testing.assert_array_equal(want, [0, 0, 2, 2])
    np.testing.assert_array_equal(_check_owner(offsets, total, 7),
                                  [0, 0, 2, 2, 2, 2, 2])


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [1, 1027])
def test_owner_with_no_emitter(n, dtype):
    offsets, total = _from_counts(np.zeros(n, np.int64), dtype)
    want = _check_owner(offsets, total, 300)
    assert (want == 0).all()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [1, 1027])
def test_owner_with_every_row_emitting(n, dtype):
    offsets, total = _from_counts(np.ones(n, np.int64), dtype)
    want = _check_owner(offsets, total, total + 5)
    np.testing.assert_array_equal(want[:n], np.arange(n))
    assert (want[n:] == n - 1).all()


#: zero-count runs of 5,000 rows (longer than a kernel tile) around rows of
#: counts 1-3
@pytest.mark.parametrize("where", ["head", "middle", "tail"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_owner_with_long_zero_count_runs(where, dtype):
    rng = np.random.default_rng(["head", "middle", "tail"].index(where))
    counts = rng.integers(1, 4, 3000)
    zeros = np.zeros(5000, np.int64)
    counts = {"head": np.concatenate([zeros, counts]),
              "middle": np.concatenate([counts[:1500], zeros, counts[1500:]]),
              "tail": np.concatenate([counts, zeros])}[where]
    offsets, total = _from_counts(counts, dtype)
    for s_pad in (total - 1, total, total + 3 * kernels.OWNER_TILE):
        want = _check_owner(offsets, total, s_pad)
        assert (np.diff(want) >= 0).all()
    if where == "tail":  # the dead tail carries the row before the zeros
        assert (want[total:] == 2999).all()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_owner_with_one_row_spanning_many_tiles(dtype):
    # one row's run is three kernel tiles long, between ordinary rows
    counts = np.array([1, 0, 2, 3 * kernels.OWNER_TILE, 0, 1, 2])
    offsets, total = _from_counts(counts, dtype)
    want = _check_owner(offsets, total, total + 100)
    assert (want[3:3 + 3 * kernels.OWNER_TILE] == 3).all()
    np.testing.assert_array_equal(want[:3], [0, 2, 2])
    assert (want[total:] == 6).all()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_owner_with_a_total_of_zero(dtype):
    offsets, total = _from_counts(np.zeros(700, np.int64), dtype)
    assert total == 0
    want = _check_owner(offsets, total, 2 * kernels.OWNER_TILE + 1)
    assert (want == 0).all()


@pytest.mark.parametrize("total_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("shape", [(), (1,)])
def test_owner_takes_total_as_int32_and_int64(total_dtype, shape):
    rng = np.random.default_rng(7)
    offsets, total = _from_counts(rng.integers(0, 4, 900), np.int32)
    want = _check_owner(offsets, total, total + 10, total_dtype)
    t_total = torch.tensor(total, dtype=total_dtype).reshape(shape)
    got = kernels.owner_recovery(torch.from_numpy(offsets), t_total,
                                 total + 10)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_owner_at_a_pad_one_below_the_total(dtype):
    rng = np.random.default_rng(11)
    counts = rng.integers(0, 5, 2000)
    counts[-1] = 4  # the last row's run holds the last slot
    offsets, total = _from_counts(counts, dtype)
    want = _check_owner(offsets, total, total - 1)
    assert want[-1] == 1999


def test_owner_at_a_pad_of_one_and_of_zero():
    offsets, total = _from_counts([0, 3, 1], np.int32)
    _check_owner(offsets, total, 1)
    got = kernels.owner_recovery(torch.from_numpy(offsets),
                                 torch.tensor(total), 0)
    assert got.shape == (0,) and got.dtype == torch.int32


def test_owner_with_no_rows():
    # the clamp to [0, -1] gives -1 in the JAX formulation too
    want = _check_owner(np.zeros(0, np.int32), 0, 5)
    assert (want == -1).all()


@settings(max_examples=60, deadline=None, database=None)
@given(counts=st.lists(st.integers(0, 9), min_size=1, max_size=200),
       extra=st.integers(-50, 50), wide=st.booleans())
def test_owner_property_over_random_counts(counts, extra, wide):
    offsets, total = _from_counts(counts, np.int64 if wide else np.int32)
    _check_owner(offsets, total, max(total + extra, 1))


# ---------------------------------------------------------------------------
# a numpy model of the CUDA kernel's merge-path partition
# ---------------------------------------------------------------------------


def _probe_search(lo, hi, passes, probes):
    """The kernel's searches: the first m in [lo, hi) where ``passes`` (true
    then false) fails, by rounds of ``probes`` evenly spaced probes, each
    round narrowing to the gap after the last probe that passed."""
    while lo < hi:
        span = hi - lo
        ms = [lo + span * g // probes for g in range(probes)]
        c = sum(bool(passes(m)) for m in ms)
        if c == 0:
            hi = lo
        else:
            nlo = ms[c - 1] + 1
            if c < probes:
                hi = ms[c]
            lo = nlo
    return lo


def _merge_path_owner(offsets, total, s_pad, threads, stage, blocks):
    """``owner_merge_kernel`` of csrc/owner_recovery.cu step by step, with
    ``threads`` threads a block (probes a round), a staging buffer of
    ``stage`` slots (tiles of ``stage - 4`` merge items) and ``blocks``
    blocks: the rows that merge before some slot, the blocks' splits, each
    tile's end, the scatter of the emitting rows' ids and the max-scan from
    the tile's first row less one. Slots no block writes stay at -2."""
    off = offsets.astype(np.int64)
    n = off.shape[0]
    last = max(-1, min(total, s_pad) - 1)

    def key(b):
        return min(b, last)

    n_rows = _probe_search(0, n, lambda m: off[m] <= last, threads)
    items_all = n_rows + s_pad
    per_block = -(-items_all // blocks)
    tile = stage - 4
    out = np.full(s_pad, -2, np.int64)
    for blk in range(blocks):
        d0 = blk * per_block
        d1 = min(d0 + per_block, items_all)
        if d0 >= d1:
            continue

        def split(d):
            return _probe_search(max(0, d - s_pad), min(d, n_rows),
                                 lambda m: off[m] <= key(d - 1 - m),
                                 max(threads // 2, 1))

        a0, a1 = split(d0), split(d1)
        b1 = d1 - a1
        ta, tb, td = a0, d0 - a0, d0
        while td < d1:
            items = min(tile, d1 - td)
            if td + items == d1:
                ta1 = a1
            else:
                ta1 = ta + _probe_search(
                    max(0, items - (b1 - tb)), min(items, a1 - ta),
                    lambda m: off[ta + m] <= key(tb + items - 1 - m), threads)
            tb1 = td + items - ta1
            tb_al = tb & ~3
            staged = np.full(stage, -1, np.int64)
            for r in range(ta, ta1):
                o = off[r]
                if o <= min(last, tb1 - 1) and (r + 1 == ta1 or off[r + 1] > o):
                    assert o >= tb and staged[o - tb_al] == -1, "two writers"
                    staged[o - tb_al] = r
            run = ta - 1
            for q in range(tb1 - tb_al):
                run = max(run, staged[q])
                if tb_al + q >= tb:
                    assert out[tb_al + q] == -2, "a slot written twice"
                    out[tb_al + q] = min(max(run, 0), n - 1)
            ta, tb, td = ta1, tb1, td + items
    return out


@pytest.mark.parametrize("threads,stage,blocks", [
    (2, 8, 3),    # a tile of 4 items
    (3, 11, 5),   # a tile of 7
    (8, 68, 2),   # a tile of 64
])
@settings(max_examples=60, deadline=None, database=None)
@given(counts=st.lists(st.integers(0, 9), min_size=1, max_size=200),
       extra=st.integers(-50, 50), wide=st.booleans())
def test_merge_path_model_matches_the_definition(threads, stage, blocks,
                                                 counts, extra, wide):
    offsets, total = _from_counts(counts, np.int64 if wide else np.int32)
    s_pad = max(total + extra, 1)
    got = _merge_path_owner(offsets, total, s_pad, threads, stage, blocks)
    np.testing.assert_array_equal(got, _owner_definition(offsets, total,
                                                         s_pad))


def test_merge_path_model_on_long_runs():
    # zero-count runs and one row's run longer than many tiles of 7
    counts = np.concatenate([np.zeros(40, np.int64), [1, 90, 0, 2],
                             np.zeros(35, np.int64), [3], np.zeros(20)])
    offsets, total = _from_counts(counts, np.int32)
    for s_pad in (1, total - 1, total, total + 30):
        got = _merge_path_owner(offsets, total, s_pad, 3, 11, 4)
        np.testing.assert_array_equal(
            got, _owner_definition(offsets, total, s_pad))


# ---------------------------------------------------------------------------
# the package's call sites hold the precondition
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def imdb_tables():
    names = sorted(set(job_shapes.S1_TABLES + job_shapes.S2_TABLES))
    return SyntheticIMDB(scale=0.0004, seed=0).generate(names)


def _site_emits(site, frame_locals):
    """The emits the JAX package forms at ``site`` (the port's function of
    the same name), from the site's own values."""
    loc = frame_locals
    if site == "join_csr_impl":  # jnp.where(cnt > 0, offsets, s_pad)
        return np.asarray(jnp.asarray(loc["cnt"].numpy()) > 0)
    if site == "_compact_probe_shaped":  # jnp.where(live, offsets, out_pad)
        return loc["live"].numpy()
    # join_expand_impl, _merge_owner_recovery: diff(append(offsets, total32))
    off = jnp.asarray(loc["offsets"].numpy())
    total32 = jnp.asarray(loc["total"].numpy()).astype(jnp.int32)
    return np.asarray(jnp.diff(jnp.append(off, total32)) > 0)


def _run_shape(name, tables):
    plan = getattr(job_shapes, f"{name}_plan")(
        tables, lazy=name != "s1", plan_cls=Plan, table_cls=ColumnarTable)
    ctx = build_context("cpu")
    first = sorted(execute(plan, ctx).to_host().to_rows())
    assert first and sorted(execute(plan, ctx).to_host().to_rows()) == first


def _run_compaction(_tables):
    # the fused executor's compaction of a probe-shaped node: live rows of
    # an int32 and an int64 column to the front of a smaller bucket
    rng = np.random.default_rng(5)
    for n, frac in ((4096, 0.2), (3000, 0.0), (777, 1.0)):
        live = torch.from_numpy(rng.random(n) < frac)
        cols = ((torch.from_numpy(rng.integers(-9, 9, n).astype(np.int32)),
                 torch.ones(n, dtype=torch.bool)),
                (torch.arange(n, dtype=torch.int64),
                 torch.from_numpy(rng.random(n) < 0.5)))
        out_pad = max(int(live.sum()), 1) + 5
        got = port_exec._compact_probe_shaped(cols, live, out_pad)
        keep = live.numpy()
        k = int(keep.sum())
        for (d, v), (gd, gv) in zip(cols, got):
            np.testing.assert_array_equal(gd.numpy()[:k], d.numpy()[keep])
            np.testing.assert_array_equal(gv.numpy()[:k], v.numpy()[keep])
            assert not gv.numpy()[k:].any()


#: scenario -> (environment, what runs on the CPU (a plan twice, the
#: second time on its feedback), the sites it must reach)
_SCENARIOS = {
    "s1": ({}, lambda t: _run_shape("s1", t), {"join_csr_impl"}),
    "s2": ({}, lambda t: _run_shape("s2", t), {"join_csr_impl"}),
    "merge": ({"RJT_BIG_MERGE": "256"}, lambda t: _run_shape("s2", t),
              {"_merge_owner_recovery"}),
    "stepwise": ({"RJT_EXEC_MODE": "stepwise"},
                 lambda t: _run_shape("s2", t), {"join_expand_impl"}),
    "compaction": ({}, _run_compaction, {"_compact_probe_shaped"}),
}


@pytest.mark.parametrize("scenario", sorted(_SCENARIOS))
def test_call_sites_pass_a_prefix_sum_and_its_total(scenario, imdb_tables,
                                                    monkeypatch):
    env, run, sites = _SCENARIOS[scenario]
    for var in ("RJT_EXEC_MODE", "RJT_BIG_MERGE", "RJT_CSR_JOIN",
                "RJT_DEV_CSR", "RJT_UNIQUE_JOIN"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    real = kernels.owner_recovery
    seen = {}

    def spy(offsets, total, s_pad):
        frame = sys._getframe(2)  # the site that called _owner_recovery
        site = frame.f_code.co_name
        off = offsets.numpy()
        tot = int(total.reshape(()).item())
        counts = np.diff(np.append(off.astype(np.int64), tot))
        assert (counts >= 0).all(), site
        assert off.shape[0] == 0 or off[0] == 0, site
        np.testing.assert_array_equal(_emits(off, tot),
                                      _site_emits(site, frame.f_locals),
                                      err_msg=site)
        seen[site] = seen.get(site, 0) + 1
        return real(offsets, total, s_pad)

    monkeypatch.setattr(kernels, "owner_recovery", spy)
    run(imdb_tables)
    assert sites <= set(seen), seen


# ---------------------------------------------------------------------------
# cummax_i32
# ---------------------------------------------------------------------------


def _cummax_check(x):
    want = np.maximum.accumulate(x) if x.size else x
    np.testing.assert_array_equal(np.asarray(jax.lax.cummax(jnp.asarray(x))),
                                  want)
    t = torch.from_numpy(x)
    for got in (kernels.cummax_i32_plain(t), kernels.cummax_i32(t)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 1027, 5000])
def test_cummax_i32_matches_lax_cummax(n):
    rng = np.random.default_rng(n)
    x = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    x[: min(n, 3)] = [-(1 << 31), (1 << 31) - 1, 0][: min(n, 3)]
    _cummax_check(x)


def test_cummax_i32_of_the_merge_scans():
    # start-masked positions and start-masked exclusive counts, as
    # join_merge_impl scans them
    rng = np.random.default_rng(9)
    n = 4099
    is_start = rng.random(n) < 0.2
    is_start[0] = True
    pos = np.arange(n, dtype=np.int32)
    _cummax_check(np.where(is_start, pos, 0).astype(np.int32))
    is_probe = (rng.random(n) < 0.5).astype(np.int32)
    excl = (np.cumsum(is_probe) - is_probe).astype(np.int32)
    _cummax_check(np.where(is_start, excl, 0).astype(np.int32))


def test_wrappers_check_their_arguments():
    off = torch.zeros(4, dtype=torch.int32)
    total = torch.zeros((), dtype=torch.int64)
    with pytest.raises(TypeError):
        kernels.owner_recovery(off.float(), total, 8)
    with pytest.raises(TypeError):
        kernels.owner_recovery(off, total.float(), 8)
    with pytest.raises(TypeError):
        kernels.owner_recovery(off, torch.zeros(2, dtype=torch.int64), 8)
    with pytest.raises(TypeError):
        kernels.owner_recovery(off, torch.zeros((1, 1), dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        kernels.owner_recovery(torch.zeros(8, dtype=torch.int32)[::2], total,
                               8)
    with pytest.raises(ValueError):
        kernels.owner_recovery(off, total, -1)
    with pytest.raises(TypeError):
        kernels.cummax_i32(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(TypeError):
        kernels.cummax_i32(torch.zeros(8, dtype=torch.int32)[::2])
    # a device that is neither the CPU nor CUDA gets no silent fallback
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        kernels.owner_recovery(off.to(meta), total, 8)
    with pytest.raises(ValueError):
        kernels.owner_recovery(off.to(meta), total.to(meta), 8)
    with pytest.raises(ValueError):
        kernels.cummax_i32(off.to(meta))


def test_joins_recover_owners_and_scan_runs_through_the_wrappers(monkeypatch):
    calls = {"owner_recovery": 0, "cummax_i32": 0}

    def spy(name):
        real = getattr(kernels, name)

        def wrapped(*a):
            calls[name] += 1
            return real(*a)
        return wrapped

    for name in calls:
        monkeypatch.setattr(kernels, name, spy(name))
    rng = np.random.default_rng(3)
    bk = torch.from_numpy(rng.integers(0, 50, 300).astype(np.int32))
    pk = torch.from_numpy(rng.integers(0, 50, 400).astype(np.int32))
    bv = torch.ones(300, dtype=torch.bool)
    pv = torch.from_numpy(rng.random(400) < 0.9)
    ids, rs, _c, offs, total = tjoin.join_merge_impl(bk, bv, pk, pv)
    assert calls == {"owner_recovery": 0, "cummax_i32": 2}
    owner, _j, _live = tjoin._merge_owner_recovery(offs, total, 4096)
    assert calls["owner_recovery"] == 1
    # the JAX package's own function gives the same owners
    j_out = jjoin.join_merge_impl(jnp.asarray(bk.numpy()),
                                  jnp.asarray(bv.numpy()),
                                  jnp.asarray(pk.numpy()),
                                  jnp.asarray(pv.numpy()))
    want, _jj, _jl = jjoin._merge_owner_recovery(j_out[3], j_out[4], 4096)
    np.testing.assert_array_equal(owner.numpy(), np.asarray(want))
    np.testing.assert_array_equal(rs.numpy(), np.asarray(j_out[1]))
    perm, lo, _cnt, offsets, total = tjoin.join_count_impl(bk, bv, pk, pv)
    tjoin.join_expand_impl(perm, lo, offsets, total, 4096)
    assert calls["owner_recovery"] == 2
