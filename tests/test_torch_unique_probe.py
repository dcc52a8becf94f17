"""The probe of the slot-table unique join (``kernels.unique_probe``, the
version the CPU runs) against the JAX package: probe-shaped, against
``join_unique_scatter_impl``; compacted to a pad, against the same followed
by ``_compact_probe_shaped``'s owner recovery, every slot of the pad, dead
tail included. Then a fused run whose unique-key node compacts in the probe
against the same plan with compaction off, and through the engine with a
learned pad too small (the overflow rerun).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radixjoin_tpu.ops import join as jjoin
from radixjoin_tpu.plan import executor as jex
from radixjoin_tpu_torch import engine
from radixjoin_tpu_torch.dtypes import DataType
from radixjoin_tpu_torch.ops import join as tjoin
from radixjoin_tpu_torch.ops import kernels
from radixjoin_tpu_torch.plan import fused as fz
from radixjoin_tpu_torch.plan.ir import Plan
from radixjoin_tpu_torch.storage.columnar import (ColumnarTable, HostColumn,
                                                  HostTable, sorted_rows)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


#: case -> (key dtype, base, r_pad, build rows, probe rows, build valid
#: share, probe valid share, probe keys drawn from: "window" (inside the
#: window and 20 past each end), "below" (under base), "above" (at and past
#: base + r_pad), "hits" (only the valid build keys))
CASES = {
    "nulls": (np.int32, 37, 256, 128, 3000, 0.9, 0.6, "window"),
    "out_of_window": (np.int32, -1000, 4096, 3000, 9000, 1.0, 1.0, "window"),
    "below_base": (np.int64, 5, 512, 300, 2000, 1.0, 1.0, "below"),
    "int64_wide": (np.int64, 3 << 40, 8192, 4096, 12000, 0.95, 0.9,
                   "window"),
    "empty_build": (np.int32, 0, 128, 100, 1000, 0.0, 1.0, "window"),
    "no_match": (np.int32, 0, 1024, 500, 4000, 1.0, 1.0, "above"),
    "all_match": (np.int64, 1 << 33, 2048, 2048, 5000, 1.0, 1.0, "hits"),
}


def _case(name, seed=0):
    dtype, base, r_pad, bp, pp, bvalid, pvalid, draw = CASES[name]
    rng = np.random.default_rng(seed + len(name))
    kb = (base + rng.permutation(r_pad)[:bp]).astype(dtype)
    vb = rng.random(bp) < bvalid
    if draw == "window":
        kp = rng.integers(base - 20, base + r_pad + 20, pp)
    elif draw == "below":
        kp = rng.integers(base - 5000, base, pp)
    elif draw == "above":
        kp = rng.integers(base + r_pad, base + 3 * r_pad, pp)
    else:
        kp = rng.choice(kb[vb], pp)
    kp = kp.astype(dtype)
    vp = rng.random(pp) < pvalid
    return kb, vb, kp, vp, base, r_pad


def _jax_probe(kb, vb, kp, vp, base, r_pad):
    return jjoin.join_unique_scatter_impl(
        jnp.asarray(kb), jnp.asarray(vb), jnp.asarray(kp), jnp.asarray(vp),
        jnp.int64(base), r_pad)


def _jax_compacted(kb, vb, kp, vp, base, r_pad, pad):
    """``(pidx, bidx, live, total)``: the JAX probe, then the owner recovery
    of ``_compact_probe_shaped`` carrying each probe row's id and build row
    (both with validity everywhere, so the validity read back is ``live``)."""
    bidx, found, total = _jax_probe(kb, vb, kp, vp, base, r_pad)
    ones = jnp.ones(kp.shape[0], dtype=bool)
    iota = jnp.arange(kp.shape[0], dtype=jnp.int32)
    (pidx, live), (bidx_c, _v) = jex._compact_probe_shaped(
        ((iota, ones), (bidx, ones)), found, pad)
    return pidx, bidx_c, live, total


@pytest.mark.parametrize("case", sorted(CASES))
def test_probe_shaped_matches_jax(case):
    kb, vb, kp, vp, base, r_pad = _case(case)
    want = _jax_probe(kb, vb, kp, vp, base, r_pad)
    before = tjoin.UNIQUE_PROBE_STATS.snapshot()
    got = tjoin.join_unique_scatter_impl(_t(kb), _t(vb), _t(kp), _t(vp),
                                         base, r_pad)
    after = tjoin.UNIQUE_PROBE_STATS.snapshot()
    # the join counts its own mode, whichever executor calls it
    assert {k: after[k] - before[k] for k in after} == {
        "compacted": 0, "probe_shaped": 1}
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert got[2].dtype == torch.int64
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    total = int(got[2])
    if case in ("empty_build", "no_match", "below_base"):
        assert total == 0
    if case == "all_match":
        assert total == kp.shape[0]


#: pad -> a multiple of the case's match count ("overflow": past the pad)
PADS = {"dead_tail": 3.0, "exact": 1.0, "overflow": 0.5}


@pytest.mark.parametrize("pad_kind", sorted(PADS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_compacted_matches_jax(case, pad_kind):
    kb, vb, kp, vp, base, r_pad = _case(case)
    matches = int(_jax_probe(kb, vb, kp, vp, base, r_pad)[2])
    pad = max(1, int(matches * PADS[pad_kind]))
    want = _jax_compacted(kb, vb, kp, vp, base, r_pad, pad)
    before = tjoin.UNIQUE_PROBE_STATS.snapshot()
    got = tjoin.join_unique_scatter_impl(_t(kb), _t(vb), _t(kp), _t(vp),
                                         base, r_pad, pad)
    after = tjoin.UNIQUE_PROBE_STATS.snapshot()
    # the join counts its own mode, whichever executor calls it
    assert {k: after[k] - before[k] for k in after} == {
        "compacted": 1, "probe_shaped": 0}
    assert [g.dtype for g in got] == [torch.int32, torch.int32, torch.bool,
                                      torch.int64]
    assert [g.shape for g in got[:3]] == [(pad,)] * 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    pidx, bidx, live, total = (_np(g) for g in got)
    assert int(total) == matches
    assert np.all(np.diff(pidx) >= 0) and 0 <= pidx.min() <= pidx.max() < \
        kp.shape[0]
    assert live.sum() == min(matches, pad)
    if matches < pad:  # the dead tail repeats the last match, or row 0
        last = pidx[matches - 1] if matches else 0
        assert np.all(pidx[matches:] == last)
        assert np.all(bidx[matches:] == (bidx[matches - 1] if matches else 0))


def test_wrapper_checks():
    slots = torch.full((64,), -1, dtype=torch.int32)
    keys = torch.zeros(10, dtype=torch.int32)
    valid = torch.ones(10, dtype=torch.bool)
    with pytest.raises(TypeError):
        kernels.unique_probe(slots.long(), keys, valid, 0)
    with pytest.raises(TypeError):
        kernels.unique_probe(slots, keys.float(), valid, 0)
    with pytest.raises(TypeError):
        kernels.unique_probe(slots, keys, valid[:5], 0)
    with pytest.raises(ValueError):
        kernels.unique_probe(slots, keys[::2], valid[::2], 0)
    with pytest.raises(ValueError):
        kernels.unique_probe(slots, keys, valid, 0, compact_pad=-1)
    with pytest.raises(ValueError):
        kernels.unique_probe(slots, keys[:0], valid[:0], 0, compact_pad=8)
    bidx, found, total = kernels.unique_probe(slots, keys[:0], valid[:0], 0)
    assert bidx.shape == found.shape == (0,) and int(total) == 0
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        kernels.unique_probe(slots.to(meta), keys.to(meta), valid.to(meta), 0)


# ---------------------------------------------------------------------------
# a fused run: the compacting probe against compaction off
# ---------------------------------------------------------------------------


def _col(values, valid=None):
    values = np.ascontiguousarray(values)
    dt = DataType.INT64 if values.dtype == np.int64 else DataType.INT32
    if valid is None:
        valid = np.ones(values.shape[0], dtype=bool)
    return HostColumn(dt, values, valid)


def _input(plan, cols):
    return plan.new_input(ColumnarTable.from_host(
        HostTable(cols[0].values.shape[0], cols)))


I32, I64 = DataType.INT32, DataType.INT64


def _star(seed=5, n_fact=20_000):
    """A star of three joins: ``j1`` probes the fact against a filtered
    dimension (one key in 80: it compacts once learned), ``j2`` probes
    ``j1`` against a full dimension on an INT64 key past the int32 range
    with the build on the right (probe-shaped), the root joins a third
    dimension (not unique-key). NULL and out-of-window fact keys."""
    rng = np.random.default_rng(seed)
    plan = Plan()
    fk1 = rng.integers(-50, 4100, n_fact).astype(np.int32)
    fk2 = ((1 << 40) + rng.integers(0, 700, n_fact)).astype(np.int64)
    fk3 = rng.integers(0, 40, n_fact).astype(np.int32)
    val = rng.integers(-(1 << 31), 1 << 31, n_fact).astype(np.int32)
    fact = plan.new_scan_node(_input(plan, [
        _col(fk1, rng.random(n_fact) < 0.9), _col(fk2, rng.random(n_fact)
                                                  < 0.95),
        _col(fk3), _col(val, rng.random(n_fact) < 0.8)]),
        [(0, I32), (1, I64), (2, I32), (3, I32)])
    d1_keys = np.sort(rng.choice(4000, 50, replace=False)).astype(np.int32)
    d1 = plan.new_scan_node(_input(plan, [
        _col(d1_keys), _col(rng.integers(0, 9, 50).astype(np.int32))]),
        [(0, I32), (1, I32)])
    d2_keys = ((1 << 40) + np.arange(700)).astype(np.int64)
    d2 = plan.new_scan_node(_input(plan, [
        _col(d2_keys), _col(rng.integers(-(1 << 62), 1 << 62, 700))]),
        [(0, I64), (1, I64)])
    d3 = plan.new_scan_node(_input(plan, [
        _col(rng.integers(0, 40, 90).astype(np.int32)),
        _col(rng.integers(0, 1000, 90).astype(np.int32))]),
        [(0, I32), (1, I32)])
    # j1: d1 (build, left) x fact -> d1.attr, fact.fk2, fact.val, fact.fk1,
    # fact.val again, fact.fk3
    j1 = plan.new_join_node(True, d1, fact, 0, 0, [
        (1, I32), (3, I64), (5, I32), (2, I32), (5, I32), (4, I32)])
    # j2: j1 (probe, left) x d2 (build, right) on fk2 -> d2.attr, j1 cols
    j2 = plan.new_join_node(False, j1, d2, 1, 0, [
        (7, I64), (0, I32), (2, I32), (3, I32), (5, I32)])
    # root: d3 x j2 on fk3
    plan.root = plan.new_join_node(True, d3, j2, 0, 4, [
        (1, I32), (2, I64), (3, I32), (4, I32), (5, I32)])
    return plan, j1, j2


def test_fused_compacted_node_equals_compaction_off():
    plan, j1, j2 = _star()
    ctx = engine.build_context("cpu")
    first = sorted_rows(engine.execute(plan, ctx).to_host().to_rows())
    _on, learned, buckets = engine._feedback_state(plan)
    unique = engine._detect_unique_joins(plan)
    on = fz.FusedPlan(plan, dict(buckets), unique, "cpu", learned,
                      frozenset())
    off = fz.FusedPlan(plan, dict(buckets), unique, "cpu", learned,
                       frozenset(on.join_specs))
    assert on.strategies()[j1] == on.strategies()[j2] == "unique_scatter"
    assert on.join_specs[j1].compact_pad > 0
    assert on.join_specs[j2].compact_pad == 0
    assert off.join_specs[j1].compact_pad == 0
    before = tjoin.UNIQUE_PROBE_STATS.snapshot()
    values_on, valid_on, totals_on, _ = fz.run(on)
    after = tjoin.UNIQUE_PROBE_STATS.snapshot()
    assert after["compacted"] - before["compacted"] == 1
    assert after["probe_shaped"] - before["probe_shaped"] == 1
    values_off, valid_off, totals_off, _ = fz.run(off)
    assert torch.equal(totals_on, totals_off)
    assert 0 < int(totals_on[0]) <= on.join_specs[j1].compact_pad
    n = int(totals_on[-1])
    assert n > 0
    for a, b in zip(values_on + valid_on, values_off + valid_off):
        assert a.dtype == b.dtype
        assert torch.equal(a[:n], b[:n])
    # through the engine: the compacting run gives the first run's rows
    again = sorted_rows(engine.execute(plan, ctx).to_host().to_rows())
    assert again == first
    assert plan._fused_struct_cache[1].join_specs[j1].compact_pad > 0


def test_fused_stale_pad_reruns_exact():
    """A learned pad below the node's matches: the compacting probe drops
    the rows past it, its exact total exposes that, and the engine reruns
    without the pad."""
    plan, j1, _j2 = _star(seed=7)
    ctx = engine.build_context("cpu")
    want = sorted_rows(engine.execute(plan, ctx).to_host().to_rows())
    matches = plan._last_join_totals[j1]
    assert matches > 2
    plan._learned_buckets[j1] = (matches // 2, False)
    reruns = engine.FUSED_STATS.snapshot().get("overflow_reruns", 0)
    got = sorted_rows(engine.execute(plan, ctx).to_host().to_rows())
    assert got == want
    assert engine.FUSED_STATS.snapshot()["overflow_reruns"] == reruns + 1
