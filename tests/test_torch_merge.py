"""The port's merge join (radixjoin_tpu_torch/ops/join.py) against the JAX
package's (radixjoin_tpu/ops/join.py), on the same numpy-seeded inputs,
exactly: values AND dtypes, dead rows included.

Covers int32, int64 and FP64 keys (as their canonical int64 bits, the way
the fused executors hand FP64 keys to the join), NULL keys, all-invalid
sides, carried planes, bucket overflow, the nested-loop oracle of
tests/test_radix_and_unique.py, and whole plans routed to the merge path
in both engines through ``convert.from_reference``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radixjoin_tpu.ops import join as jjoin
from radixjoin_tpu.ops import keynorm as jkeynorm
from radixjoin_tpu_torch.ops import join as tjoin
from radixjoin_tpu_torch.ops import keynorm as tkeynorm
from radixjoin_tpu_torch.plan import fused as tfused

from test_fuzz_plans import gen_plan
from test_torch_engine import SEMANTICS, check_parity, ref_strategies

_TORCH_OF = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
             np.dtype(np.bool_): torch.bool}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    """Equal values and equal dtypes."""
    want = np.asarray(want)
    assert got.dtype == _TORCH_OF[want.dtype], (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def _keys(rng, n, kind, null_frac=0.15, invalid=False):
    """(port keys, JAX keys, valid): FP64 keys as canonical int64 bits."""
    valid = rng.random(n) >= null_frac
    if invalid:
        valid[:] = False
    if kind == "int32":
        k = rng.integers(-40, 40, n).astype(np.int32)
        k[:2] = np.iinfo(np.int32).max, np.iinfo(np.int32).min
    elif kind == "int64":
        k = (rng.integers(-40, 40, n) * (1 << 40)).astype(np.int64)
        k[:2] = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    else:
        pool = np.array([0.0, -0.0, np.nan, 1.5, -2.25, np.inf, 1e300, 3.0])
        f = pool[rng.integers(0, len(pool), n)]
        bits = f.view(np.int64)
        jk, jv = jkeynorm.canon_f64_bits(jnp.asarray(bits), jnp.asarray(valid))
        tk, tv = tkeynorm.canon_f64_bits(_t(bits), _t(valid))
        _same(tk, jk)
        _same(tv, jv)
        return tk, jk, np.array(jv)
    return _t(k), jnp.asarray(k), valid


def _sides(seed, kind, bp, pp, invalid_side=None):
    rng = np.random.default_rng(seed)
    tbk, jbk, bv = _keys(rng, bp, kind, invalid=invalid_side == "build")
    tpk, jpk, pv = _keys(rng, pp, kind, invalid=invalid_side == "probe")
    return rng, (tbk, _t(bv), tpk, _t(pv)), (jbk, jnp.asarray(bv), jpk,
                                             jnp.asarray(pv))


_KINDS = ["int32", "int64", "fp64"]
_SIDES = [None, "build", "probe"]


@pytest.mark.parametrize("invalid_side", _SIDES)
@pytest.mark.parametrize("kind", _KINDS)
def test_merge_count_matches_jax(kind, invalid_side):
    _rng, t_in, j_in = _sides(7, kind, 256, 640, invalid_side)
    want = jjoin.join_merge_impl(*j_in)
    got = tjoin.join_merge_impl(*t_in)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("kind", _KINDS)
def test_merge_count_with_carry_matches_jax(kind):
    rng, t_in, j_in = _sides(11, kind, 300, 500)
    n = 800
    planes = [np.arange(n, dtype=np.int32),
              rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)]
    want = jjoin.join_merge_impl(*j_in, tuple(jnp.asarray(p) for p in planes))
    wide = rng.integers(-(1 << 62), 1 << 62, n)
    flags = rng.random(n) < 0.5
    got = tjoin.join_merge_impl(*t_in, [_t(p) for p in planes]
                                + [_t(wide), _t(flags)])
    for g, w in zip(got[:5], want[:5]):
        _same(g, w)
    assert len(got[5]) == 4 and len(want[5]) == 2
    for g, w in zip(got[5], want[5]):
        _same(g, w)
    # planes of other dtypes move with the same permutation
    perm = np.asarray(want[5][0])
    _same(got[5][2], wide[perm])
    _same(got[5][3], flags[perm])


@pytest.mark.parametrize("s_pad", [4096, 1024])  # exact bucket, overflow
@pytest.mark.parametrize("kind", _KINDS)
def test_merge_expansion_matches_jax(kind, s_pad):
    _rng, t_in, j_in = _sides(3, kind, 512, 1024)
    ids, rs, _c, offs, total = jjoin.join_merge_impl(*j_in)
    want_owner = jjoin._merge_owner_recovery(offs, total, s_pad)
    want = jjoin.join_expand_merge_impl(ids, rs, offs, total, s_pad)
    t_ids, t_rs, _tc, t_offs, t_total = tjoin.join_merge_impl(*t_in)
    got_owner = tjoin._merge_owner_recovery(t_offs, t_total, s_pad)
    got = tjoin.join_expand_merge_impl(t_ids, t_rs, t_offs, t_total, s_pad)
    for g, w in zip(got_owner + got, want_owner + want):
        _same(g, w)


def _payloads(rng, n):
    return [
        (rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
         rng.random(n) < 0.8),
        (rng.integers(-(1 << 62), 1 << 62, n), rng.random(n) < 0.7),
    ]


@pytest.mark.parametrize("invalid_side", _SIDES)
@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("bp,pp,s_pad", [
    (256, 512, 2048),      # tables <= 4096: window-gather route
    (4096, 8192, 16384),   # blocked-window route on owner and bpos
    (4096, 8192, 4096),    # undersized bucket: total overflows s_pad
])
def test_merge_full_matches_jax(bp, pp, s_pad, kind, invalid_side):
    rng, t_in, j_in = _sides(bp + s_pad, kind, bp, pp, invalid_side)
    bcols, pcols = _payloads(rng, bp), _payloads(rng, pp)[:1]
    want = jjoin.join_merge_full_impl(
        *j_in, s_pad,
        [(jnp.asarray(d), jnp.asarray(v)) for d, v in bcols],
        [(jnp.asarray(d), jnp.asarray(v)) for d, v in pcols],
    )
    got = tjoin.join_merge_full_impl(
        *t_in, s_pad, [(_t(d), _t(v)) for d, v in bcols],
        [(_t(d), _t(v)) for d, v in pcols],
    )
    for gside, wside in zip(got[:2], want[:2]):
        assert len(gside) == len(wside)
        for (gd, gv), (wd, wv) in zip(gside, wside):
            _same(gd, wd)
            _same(gv, wv)
    _same(got[2], want[2])
    _same(got[3], want[3])


def test_merge_full_without_payloads_matches_jax():
    _rng, t_in, j_in = _sides(5, "int32", 128, 256)
    want = jjoin.join_merge_full_impl(*j_in, 512, [], [])
    got = tjoin.join_merge_full_impl(*t_in, 512, [], [])
    assert got[0] == [] and got[1] == [] and want[0] == [] and want[1] == []
    _same(got[2], want[2])
    _same(got[3], want[3])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_full_matches_nested_loop(seed):
    """The nested-loop oracle of tests/test_radix_and_unique.py
    (test_merge_full_sort_carried_matches_reference) held to the port:
    the exact multiset of projected output rows."""
    rng = np.random.default_rng(seed)
    nb, npr = 260, 700
    bk = rng.integers(0, 120, nb).astype(np.int32)
    bv = rng.random(nb) > 0.15
    pk = rng.integers(0, 160, npr).astype(np.int32)
    pv = rng.random(npr) > 0.15
    bpay32 = rng.integers(-(1 << 30), 1 << 30, nb).astype(np.int32)
    bpay_v = rng.random(nb) > 0.2
    ppay64 = rng.integers(-(1 << 60), 1 << 60, npr).astype(np.int64)
    ppay_v = rng.random(npr) > 0.2

    bpad, ppad = tjoin.bucket_size(nb), tjoin.bucket_size(npr)
    expect = []
    for i in range(nb):
        if not bv[i]:
            continue
        for j in range(npr):
            if pv[j] and pk[j] == bk[i]:
                expect.append((int(bpay32[i]) if bpay_v[i] else None,
                               int(ppay64[j]) if ppay_v[j] else None))
    expect.sort(key=repr)

    def pad(a, size):
        return tjoin.pad_1d(_t(a), size, False if a.dtype == bool else 0)

    out_b, out_p, live, total = tjoin.join_merge_full_impl(
        pad(bk, bpad), pad(bv, bpad), pad(pk, ppad), pad(pv, ppad),
        tjoin.bucket_size(max(len(expect), 1)),
        [(pad(bpay32, bpad), pad(bpay_v, bpad))],
        [(pad(ppay64, ppad), pad(ppay_v, ppad))],
    )
    assert int(total) == len(expect)
    lv = live.numpy()
    (bd, bvv), (pd, pvv) = out_b[0], out_p[0]
    got = sorted(
        ((int(bd[k]) if bvv[k] else None, int(pd[k]) if pvv[k] else None)
         for k in np.flatnonzero(lv)),
        key=repr,
    )
    assert got == expect


# ---------------------------------------------------------------------------
# Whole plans routed to the merge path in both engines
# ---------------------------------------------------------------------------

#: combined pad from which both engines take the merge path in these tests
_SMALL_MERGE_PAD = 256


@pytest.fixture
def force_merge(monkeypatch):
    # both packages read the variable; the port's constant is its default
    monkeypatch.setenv("RJT_BIG_MERGE", str(_SMALL_MERGE_PAD))
    assert tfused.big_merge_pad() == _SMALL_MERGE_PAD != tfused.BIG_MERGE_PAD


@pytest.mark.parametrize("case", [
    "multiple_same_keys", "duplicate_heavy_fanout", "three_way_join_tree",
    "null_payloads_flow_through", "build_on_right", "int64_keys",
    "output_column_duplication", "int32_extreme_keys",
])
def test_semantics_plan_on_merge_path_matches_reference(force_merge, case):
    ref_plan = SEMANTICS[case]()
    port_plan = check_parity(ref_plan)
    assert "merge" in ref_strategies(ref_plan).values()
    assert "merge" in port_plan._fused_struct_cache[1].strategies().values()


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_fuzz_plan_on_merge_path_matches_reference(force_merge, seed):
    ref_plan = gen_plan(np.random.default_rng(seed))
    check_parity(ref_plan)
