"""The owner recovery and the int32 running max of the port
(radixjoin_tpu_torch/ops/kernels.py: ``owner_recovery``, ``cummax_i32``)
against the JAX formulation they replace and against the definition.

The JAX package writes the owner recovery with XLA ops in four places
(radixjoin_tpu/ops/join.py: join_expand_impl, _merge_owner_recovery,
join_csr_impl; radixjoin_tpu/plan/executor.py: _compact_probe_shaped):
``marker.at[starts].max(iota, mode="drop")``, ``lax.cummax``, ``clip``.
The test builds that formulation from ``jnp`` and states the definition in
numpy:

    owner[j] = clip(max{i : emits[i], offsets[i] <= j, offsets[i] < s_pad},
                    0, n - 1)        (an empty max is -1)

On the CPU the wrappers take their plain versions, so these tests hold the
plain versions to both, bit for bit; the CUDA kernels are held to the plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from radixjoin_tpu.ops import join as jjoin
from radixjoin_tpu_torch.ops import join as tjoin
from radixjoin_tpu_torch.ops import kernels


def _owner_definition(offsets, emits, s_pad):
    """The definition, slot by slot, as a dense (n, s_pad) mask."""
    n = offsets.shape[0]
    j = np.arange(s_pad, dtype=np.int64)
    off = offsets.astype(np.int64)[:, None]
    ok = emits[:, None] & (off <= j[None, :]) & (off < s_pad)
    ids = np.arange(n, dtype=np.int64)[:, None]
    best = np.where(ok, ids, -1).max(axis=0) if n else np.full(s_pad, -1)
    return np.clip(best, 0, n - 1).astype(np.int32)


def _owner_jax(offsets, emits, s_pad):
    """The JAX package's formulation, built here from jnp."""
    n = offsets.shape[0]
    starts = jnp.where(jnp.asarray(emits), jnp.asarray(offsets), s_pad)
    marker = jnp.full(s_pad + 1, -1, dtype=jnp.int32)
    marker = marker.at[starts].max(jnp.arange(n, dtype=jnp.int32),
                                   mode="drop")
    return np.asarray(jnp.clip(jax.lax.cummax(marker[:s_pad]), 0, n - 1))


def _check_owner(offsets, emits, s_pad):
    want = _owner_definition(offsets, emits, s_pad)
    np.testing.assert_array_equal(_owner_jax(offsets, emits, s_pad), want)
    t_off, t_em = torch.from_numpy(offsets), torch.from_numpy(emits)
    plain = kernels.owner_recovery_plain(t_off, t_em, s_pad)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(
        kernels.owner_recovery(t_off, t_em, s_pad).numpy(), want)
    return want


def _from_counts(counts, dtype):
    counts = np.asarray(counts, dtype=np.int64)
    offsets = (np.cumsum(counts) - counts).astype(dtype)
    return offsets, counts > 0, int(counts.sum())


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("fan_out", [3, 17])
@pytest.mark.parametrize("n", [1, 2, 64, 1027])
@pytest.mark.parametrize("pad", ["below", "at", "above"])
def test_owner_from_seeded_counts(pad, n, fan_out, dtype):
    rng = np.random.default_rng([n, fan_out])
    counts = rng.choice([0, 1, 2, fan_out], n)
    offsets, emits, total = _from_counts(counts, dtype)
    s_pad = {"below": max(total // 2, 1), "at": max(total, 1),
             "above": kernels.SCAN_TILE + total}[pad]
    want = _check_owner(offsets, emits, s_pad)
    if pad == "above" and emits.any():
        # the dead tail carries the last emitting row
        assert (want[total:] == np.flatnonzero(emits)[-1]).all()
    assert (np.diff(want) >= 0).all()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_owner_runs_that_straddle_the_pad(dtype):
    # row 2's run starts below s_pad and ends past it; rows 3 and 4 start
    # at and past it and count for nothing
    offsets, emits, total = _from_counts([2, 0, 5, 3, 1], dtype)
    assert total == 11
    want = _check_owner(offsets, emits, 4)
    np.testing.assert_array_equal(want, [0, 0, 2, 2])
    np.testing.assert_array_equal(_check_owner(offsets, emits, 7),
                                  [0, 0, 2, 2, 2, 2, 2])


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [1, 1027])
def test_owner_with_no_emitter(n, dtype):
    offsets = np.zeros(n, dtype)
    want = _check_owner(offsets, np.zeros(n, bool), 300)
    assert (want == 0).all()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n", [1, 1027])
def test_owner_with_every_row_emitting(n, dtype):
    offsets, emits, total = _from_counts(np.ones(n, np.int64), dtype)
    assert emits.all()
    want = _check_owner(offsets, emits, total + 5)
    np.testing.assert_array_equal(want[:n], np.arange(n))
    assert (want[n:] == n - 1).all()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("seed", range(4))
def test_owner_with_emits_that_are_not_the_counts(seed, dtype):
    # starts need not be a prefix sum nor emits a nonzero count: repeated
    # and falling starts, starts past the pad, flags drawn on their own
    rng = np.random.default_rng(seed)
    n, s_pad = 500, 700
    offsets = rng.integers(0, 2 * s_pad, n).astype(dtype)
    offsets[::7] = offsets[0]
    emits = rng.random(n) < 0.3
    _check_owner(offsets, emits, s_pad)


def test_owner_at_a_pad_of_one_and_of_zero():
    offsets, emits, _total = _from_counts([0, 3, 1], np.int32)
    _check_owner(offsets, emits, 1)
    got = kernels.owner_recovery(torch.from_numpy(offsets),
                                 torch.from_numpy(emits), 0)
    assert got.shape == (0,) and got.dtype == torch.int32


@settings(max_examples=60, deadline=None, database=None)
@given(counts=st.lists(st.integers(0, 9), min_size=1, max_size=200),
       extra=st.integers(-50, 50), wide=st.booleans())
def test_owner_property_over_random_counts(counts, extra, wide):
    offsets, emits, total = _from_counts(counts,
                                         np.int64 if wide else np.int32)
    _check_owner(offsets, emits, max(total + extra, 1))


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
    em = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        kernels.owner_recovery(off.float(), em, 8)
    with pytest.raises(TypeError):
        kernels.owner_recovery(off, em.to(torch.int32), 8)
    with pytest.raises(TypeError):
        kernels.owner_recovery(off, em[:3], 8)
    with pytest.raises(ValueError):
        kernels.owner_recovery(torch.zeros(8, dtype=torch.int32)[::2], em, 8)
    with pytest.raises(ValueError):
        kernels.owner_recovery(off, em, -1)
    with pytest.raises(TypeError):
        kernels.cummax_i32(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(TypeError):
        kernels.cummax_i32(torch.zeros(8, dtype=torch.int32)[::2])
    # a device that is neither the CPU nor CUDA gets no silent fallback
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        kernels.owner_recovery(off.to(meta), em.to(meta), 8)
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
