"""The port's hashing, radix partitioning and two-phase sort join against
their JAX counterparts (radixjoin_tpu/ops/{hashing,radix,join}.py), on the
same numpy-seeded inputs. Every comparison is exact (tolerance 0): integer
values, bit patterns and dtypes. The JAX functions run on the CPU, their
Pallas kernels in interpret mode; the port on CPU tensors, its kernels'
plain versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radixjoin_tpu.ops import hashing as jhash
from radixjoin_tpu.ops import join as jjoin
from radixjoin_tpu.ops import radix as jradix
from radixjoin_tpu_torch.ops import hashing as thash
from radixjoin_tpu_torch.ops import join as tjoin
from radixjoin_tpu_torch.ops import radix as tradix


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _keys_with_extremes(rng, n, dtype):
    info = np.iinfo(dtype)
    keys = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    keys[:6] = [info.min, info.max, -1, 0, 1, info.min + 1]
    keys[6:40] = rng.integers(-20, 20, 34).astype(dtype)
    return keys


def ref_join(bk, bv, pk, pv):
    """Nested-loop oracle: sorted list of (build_row, probe_row)."""
    index = {}
    for i, (k, v) in enumerate(zip(bk, bv)):
        if v:
            index.setdefault(int(k), []).append(i)
    return sorted((i, j) for j, (k, v) in enumerate(zip(pk, pv)) if v
                  for i in index.get(int(k), ()))


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_murmur64_bit_equal(dtype):
    keys = _keys_with_extremes(np.random.default_rng(3), 5000, dtype)
    want = thash.murmur64_np(keys)
    np.testing.assert_array_equal(want, jhash.murmur64_np(keys))
    np.testing.assert_array_equal(
        want, np.asarray(jhash.murmur64(jnp.asarray(keys))))
    got = thash.murmur64(_t(keys))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    np.testing.assert_array_equal(
        thash.fnv1a64(_t(keys)).numpy().view(np.uint64), want)


def test_fnv1a64_np_equal():
    values = np.array([b"", b"a", b"abc", b"\xe9clair", b"x" * 300],
                      dtype=object)
    np.testing.assert_array_equal(thash.fnv1a64_np(values),
                                  jhash.fnv1a64_np(values))


@pytest.mark.parametrize("num_partitions", [1, 2, 16, 128])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_bucket_of_equal(num_partitions, dtype):
    keys = _keys_with_extremes(np.random.default_rng(5), 4000, dtype)
    want = tradix.bucket_of_np(keys, num_partitions)
    assert want.min() >= 0 and want.max() < num_partitions
    np.testing.assert_array_equal(
        want, jradix.bucket_of_np(keys, num_partitions))
    np.testing.assert_array_equal(
        want, np.asarray(jradix.bucket_of(jnp.asarray(keys), num_partitions)))
    got = tradix.bucket_of(_t(keys), num_partitions)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_choose_num_partitions_equal_over_a_grid():
    for rows in (0, 1, 10, 1 << 10, 1 << 20, 3_600_000, 1 << 27):
        for budget in (1, 512, 4096, 1 << 20, 4 << 20, 1 << 30, 1 << 36):
            for bytes_per_row in (8, 16):
                got = tradix.choose_num_partitions(
                    rows, rows // 3, bytes_per_row, budget_bytes=budget)
                want = jradix.choose_num_partitions(
                    rows, rows // 3, bytes_per_row, budget_bytes=budget)
                assert got == want, (rows, budget, bytes_per_row)
    # the default budget is an eighth of the given device's memory
    from radixjoin_tpu_torch import hardware

    eighth = hardware.detect("cpu").hbm_bytes // 8
    assert tradix.choose_num_partitions(
        1 << 30, 1 << 30, device="cpu") == tradix.choose_num_partitions(
            1 << 30, 1 << 30, budget_bytes=eighth)


# ---------------------------------------------------------------------------
# partitioning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_partitions", [1, 4, 16])
def test_partition_device_and_host_equal(num_partitions):
    rng = np.random.default_rng(9)
    n = 3000
    keys = rng.integers(-50, 400, n).astype(np.int64)
    valid = rng.random(n) > 0.1
    perm_j, sorted_j = jradix.partition_device(
        jnp.asarray(keys), jnp.asarray(valid), num_partitions)
    perm_t, sorted_t = tradix.partition_device(_t(keys), _t(valid),
                                               num_partitions)
    assert perm_t.dtype == torch.int32
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    np.testing.assert_array_equal(sorted_t.numpy(), np.asarray(sorted_j))

    pay = {"row": np.arange(n, dtype=np.int64)}
    host_j = jradix.partition_host(keys, valid, pay, num_partitions)
    host_t = tradix.partition_host(keys, valid, pay, num_partitions)
    for part_j, part_t in zip(host_j, host_t):
        assert len(part_j) == len(part_t) == num_partitions
        for a, b in zip(part_j, part_t):
            if isinstance(a, dict):
                np.testing.assert_array_equal(a["row"], b["row"])
            else:
                np.testing.assert_array_equal(a, b)


def _partitioned_case(case):
    rng = np.random.default_rng(7)
    if case == "random":
        nb, npr = 500, 3000
        return (rng.integers(0, 300, nb).astype(np.int64),
                rng.random(nb) > 0.1,
                rng.integers(0, 400, npr).astype(np.int64),
                rng.random(npr) > 0.1)
    if case == "hot_key":
        return (np.array([5, 9], dtype=np.int64), np.ones(2, bool),
                np.full(1000, 5, dtype=np.int64), np.ones(1000, bool))
    if case == "empty_build":
        return (np.zeros(0, np.int64), np.zeros(0, bool),
                np.full(1000, 5, dtype=np.int64), np.ones(1000, bool))
    if case == "empty_probe":
        return (rng.integers(0, 30, 200).astype(np.int64), np.ones(200, bool),
                np.zeros(0, np.int64), np.zeros(0, bool))
    raise AssertionError(case)


@pytest.mark.parametrize("num_partitions", [1, 4, 16])
@pytest.mark.parametrize("case", ["random", "hot_key", "empty_build",
                                  "empty_probe"])
def test_partitioned_join_indices_equal(case, num_partitions):
    bk, bv, pk, pv = _partitioned_case(case)
    want_b, want_p = jradix.partitioned_join_indices(
        bk, bv, pk, pv, num_partitions=num_partitions)
    got_b, got_p = tradix.partitioned_join_indices(
        bk, bv, pk, pv, num_partitions=num_partitions, device="cpu")
    assert got_b.dtype == got_p.dtype == np.int64
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_p, want_p)
    assert sorted(zip(got_b.tolist(), got_p.tolist())) == ref_join(
        bk, bv, pk, pv)


def test_partitioned_join_payloads_and_budget():
    bk, bv, pk, pv = _partitioned_case("random")
    kwargs = dict(budget_bytes=4096)
    want = jradix.partitioned_join(
        bk, bv, {"row": np.arange(len(bk))}, pk, pv,
        {"row": np.arange(len(pk))}, **kwargs)
    got = tradix.partitioned_join(
        bk, bv, {"row": np.arange(len(bk))}, pk, pv,
        {"row": np.arange(len(pk))}, device="cpu", **kwargs)
    assert sorted(got) == sorted(want) == ["b.row", "p.row"]
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_partitioned_join_needs_a_card_unless_asked_for_the_cpu():
    bk, bv, pk, pv = _partitioned_case("hot_key")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tradix.partitioned_join_indices(bk, bv, pk, pv, num_partitions=2)


# ---------------------------------------------------------------------------
# the two-phase sort join
# ---------------------------------------------------------------------------


def _join_case(case, dtype):
    rng = np.random.default_rng(21)
    bp, pp = 512, 8192  # the probe side is past the window-gather size
    info = np.iinfo(dtype)
    kb = rng.integers(0, 200, bp).astype(dtype)
    vb = rng.random(bp) >= 0.15
    kp = rng.integers(-10, 260, pp).astype(dtype)
    vp = rng.random(pp) >= 0.1
    if case == "all_invalid_build":
        vb[:] = False
    elif case == "max_key":
        kb[:5] = info.max
        vb[:4] = True
        vb[4] = False  # an invalid row carrying the saturation value
        kp[:7] = info.max
        vp[:6] = True
        kb[5], kp[7] = info.min, info.min
        vb[5] = vp[7] = True
    elif case == "unique_build":
        kb = rng.permutation(bp).astype(dtype)
    else:
        assert case == "duplicates"
    vb[400:] = False  # padding rows
    vp[8000:] = False
    return kb, vb, kp, vp


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", ["duplicates", "all_invalid_build",
                                  "max_key", "unique_build"])
def test_join_count_and_expand_bit_equal(case, dtype):
    kb, vb, kp, vp = _join_case(case, dtype)
    want = jjoin.join_count_impl(jnp.asarray(kb), jnp.asarray(vb),
                                 jnp.asarray(kp), jnp.asarray(vp))
    got = tjoin.join_count_impl(_t(kb), _t(vb), _t(kp), _t(vp))
    names = ("perm", "lo", "counts", "offsets", "total")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)

    total = int(got[4])
    assert total == len(ref_join(kb, vb, kp, vp))
    s_pad = tjoin.bucket_size(total)
    perm, lo, _counts, offsets, total_dev = want
    want_e = jjoin.join_expand_impl(perm, lo, offsets, total_dev, s_pad)
    got_e = tjoin.join_expand_impl(got[0], got[1], got[3], got[4], s_pad)
    for name, g, w in zip(("bidx", "pidx", "live"), got_e, want_e):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", ["duplicates", "all_invalid_build",
                                  "max_key"])
def test_join_count_and_index_bit_equal(case, dtype):
    kb, vb, kp, vp = _join_case(case, dtype)
    wb, wp, wl, wt = jjoin.join_count_and_index(
        jnp.asarray(kb), jnp.asarray(vb), jnp.asarray(kp), jnp.asarray(vp))
    gb, gp, gl, gt = tjoin.join_count_and_index(_t(kb), _t(vb), _t(kp),
                                                _t(vp))
    assert isinstance(gt, int) and gt == wt
    for g, w in ((gb, wb), (gp, wp), (gl, wl)):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    live = gl.numpy()
    assert sorted(zip(gb.numpy()[live].tolist(),
                      gp.numpy()[live].tolist())) == ref_join(kb, vb, kp, vp)


def test_gather_columns_equal():
    rng = np.random.default_rng(2)
    for n_src in (300, 6000):  # window-gather route and plain route
        data32 = rng.integers(-(1 << 31), 1 << 31, n_src).astype(np.int32)
        data64 = rng.integers(-(1 << 62), 1 << 62, n_src).astype(np.int64)
        valid = rng.random(n_src) > 0.2
        idx = rng.integers(0, n_src, 1000).astype(np.int32)
        live = rng.random(1000) > 0.3
        cols = [(data32, valid), (data64, valid)]
        want = jjoin.gather_columns(
            [(jnp.asarray(d), jnp.asarray(v)) for d, v in cols],
            jnp.asarray(idx), jnp.asarray(live))
        got = tjoin.gather_columns([(_t(d), _t(v)) for d, v in cols],
                                   _t(idx), _t(live))
        for (gd, gv), (wd, wv) in zip(got, want):
            assert gd.numpy().dtype == np.asarray(wd).dtype
            np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
            np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
