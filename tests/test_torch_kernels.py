"""The port's kernel wrappers (radixjoin_tpu_torch/ops/kernels.py) against
the JAX package's Pallas kernels, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs them.

On the CPU every wrapper takes its plain PyTorch version, so these tests
hold the plain versions to the Pallas kernels bit for bit. The CUDA
kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radixjoin_tpu.ops import pallas_kernels as pk
from radixjoin_tpu_torch.ops import kernels

I32_EXTREMES = np.array(
    [0, 255, 256, (1 << 24) - 1, 1 << 24, -1, -(1 << 31), (1 << 31) - 1],
    np.int32,
)


def _rand_i32(rng, n):
    out = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    out[: len(I32_EXTREMES)] = I32_EXTREMES[: n]
    return out


@pytest.mark.parametrize("w,n", [(100, 3001), (128, 1024), (1000, 777),
                                 (4096, 2500)])
def test_window_gather_plain_matches_pallas(w, n):
    rng = np.random.default_rng(w)
    tabs = [_rand_i32(rng, w) for _ in range(3)]
    idx = rng.integers(0, w, n).astype(np.int32)
    want = pk.window_gather([jnp.asarray(t) for t in tabs], jnp.asarray(idx))
    got = kernels.window_gather([torch.from_numpy(t) for t in tabs],
                                torch.from_numpy(idx))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_window_gather_native_widths():
    # int64 and bool planes gather natively (the TPU route split them)
    rng = np.random.default_rng(5)
    w, n = 300, 1000
    t64 = rng.integers(-(1 << 62), 1 << 62, w)
    tb = rng.random(w) < 0.5
    idx = rng.integers(0, w, n).astype(np.int32)
    g64, gb = kernels.window_gather(
        [torch.from_numpy(t64), torch.from_numpy(tb)], torch.from_numpy(idx)
    )
    np.testing.assert_array_equal(g64.numpy(), t64[idx])
    np.testing.assert_array_equal(gb.numpy(), tb[idx])


@pytest.mark.parametrize("case", ["windowed", "random", "ragged"])
def test_blocked_window_gather_plain_matches_pallas(case):
    rng = np.random.default_rng(3)
    lens = (20000, 9000)  # the shorter table reads the zero pad in-window
    tabs = [_rand_i32(rng, n) for n in lens]
    n = {"windowed": 10000, "random": 6000, "ragged": 4097}[case]
    if case == "random":
        idx = rng.integers(0, lens[1], n)
    else:
        base = np.repeat(np.arange(n), 2)[:n] // 2
        idx = np.clip(base + rng.integers(0, 700, n), 0, lens[1] - 1)
        idx[rng.integers(0, n, 20)] = rng.integers(0, lens[1], 20)  # misses
    idx = idx.astype(np.int32)
    want_vals, want_ok = pk.blocked_window_gather_multi(
        [jnp.asarray(t) for t in tabs], jnp.asarray(idx)
    )
    got_vals, got_ok = kernels.blocked_window_gather_multi(
        [torch.from_numpy(t) for t in tabs], torch.from_numpy(idx)
    )
    want_ok = np.asarray(want_ok)
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    assert 0 < want_ok.sum() and (case != "windowed" or want_ok.mean() > 0.9)
    hit = want_ok != 0
    for t, g, w_ in zip(tabs, got_vals, want_vals):
        g = g.numpy()
        # in-window rows: bit-equal to the Pallas kernel; missed rows:
        # already patched to the full gather the TPU caller would run
        np.testing.assert_array_equal(g[hit], np.asarray(w_)[hit])
        np.testing.assert_array_equal(g[~hit], t[idx[~hit]])


def test_blocked_window_past_short_table_reads_zero():
    # an in-window index past a shorter table's end reads the zero pad,
    # as on the TPU
    long_t = np.arange(1, 3001, dtype=np.int32)
    short_t = np.arange(1, 11, dtype=np.int32)
    idx = np.arange(5, 25, dtype=np.int32)
    want, want_ok = pk.blocked_window_gather_multi(
        [jnp.asarray(long_t), jnp.asarray(short_t)], jnp.asarray(idx)
    )
    got, got_ok = kernels.blocked_window_gather_multi(
        [torch.from_numpy(long_t), torch.from_numpy(short_t)],
        torch.from_numpy(idx),
    )
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def _mixed_tables(rng, lens):
    """int32, int64 and bool tables of the given lengths, each with the
    int32 planes the Pallas kernels take for it: an int64 table travels as
    its lo and hi words, a bool table as 0 / 1 (the JAX callers' split)."""
    i32 = _rand_i32(rng, lens[0])
    i64 = rng.integers(-(1 << 62), 1 << 62, lens[1])
    flag = rng.random(lens[2]) < 0.5
    planes = [i32, (i64 & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
              (i64 >> 32).astype(np.int32), flag.astype(np.int32)]
    return [i32, i64, flag], planes


def _from_planes(planes):
    """The gathered planes of :func:`_mixed_tables` back as three tables."""
    p32, lo, hi, flag = (np.asarray(p) for p in planes)
    i64 = (hi.astype(np.int64) << 32) | lo.view(np.uint32).astype(np.int64)
    return [p32, i64, flag != 0]


def test_window_gather_mixed_sizes_match_pallas():
    # one call with int32, int64 and bool tables: bit-equal (tolerance 0)
    # to the Pallas kernel over the same tables as int32 planes
    rng = np.random.default_rng(11)
    w, n = 1000, 2500
    tabs, planes = _mixed_tables(rng, (w, w, w))
    idx = rng.integers(0, w, n).astype(np.int32)
    want = _from_planes(pk.window_gather([jnp.asarray(p) for p in planes],
                                         jnp.asarray(idx)))
    got = kernels.window_gather([torch.from_numpy(t) for t in tabs],
                                torch.from_numpy(idx))
    for g, w_, t in zip(got, want, tabs):
        assert g.numpy().dtype == t.dtype
        np.testing.assert_array_equal(g.numpy(), w_)


@pytest.mark.parametrize("with_ok", [True, False])
def test_blocked_window_gather_mixed_sizes_match_pallas(with_ok):
    # mixed int32 / int64 / bool tables of different lengths in one call,
    # with and without the flags: bit-equal (tolerance 0) to the Pallas
    # kernel over the same tables as int32 planes
    rng = np.random.default_rng(12)
    lens = (20000, 9000, 20000)
    tabs, planes = _mixed_tables(rng, lens)
    n = 4097
    base = np.repeat(np.arange(n), 2)[:n] // 2
    idx = np.clip(base + rng.integers(0, 700, n), 0, lens[1] - 1)
    idx[rng.integers(0, n, 20)] = rng.integers(0, lens[1], 20)  # misses
    idx = idx.astype(np.int32)
    want_planes, want_ok = pk.blocked_window_gather_multi(
        [jnp.asarray(p) for p in planes], jnp.asarray(idx))
    want = _from_planes(want_planes)
    got, got_ok = kernels.blocked_window_gather_multi(
        [torch.from_numpy(t) for t in tabs], torch.from_numpy(idx),
        with_ok=with_ok)
    want_ok = np.asarray(want_ok)
    if with_ok:
        np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    else:
        assert got_ok is None
    hit = want_ok != 0
    assert 0 < hit.sum() < n
    for t, g, w_ in zip(tabs, got, want):
        g = g.numpy()
        assert g.dtype == t.dtype
        np.testing.assert_array_equal(g[hit], w_[hit])
        np.testing.assert_array_equal(g[~hit], t[idx[~hit]])


def test_blocked_window_gather_default_returns_the_flags():
    t = torch.arange(5000, dtype=torch.int32)
    idx = torch.arange(0, 3000, dtype=torch.int32)
    vals, ok = kernels.blocked_window_gather_multi([t], idx)
    assert ok.dtype == torch.int32 and ok.shape == idx.shape
    assert torch.equal(vals[0], idx)


def test_launch_groups_split_by_count_only():
    # any mix of element sizes rides one launch: only the number of tables
    # one launch's descriptor holds splits a call, in order
    assert kernels._launch_groups(4) == [[0, 1, 2, 3]]
    assert kernels._launch_groups(8) == [list(range(8))]
    many = kernels._launch_groups(20)
    assert [len(g) for g in many] == [kernels._MAX_TABLES,
                                      20 - kernels._MAX_TABLES]
    assert sum(many, []) == list(range(20))
    assert kernels._launch_groups(0) == []


def test_staging_plan_keeps_what_fits_and_leaves_the_rest_on_the_card():
    budget = 227 * 1024 - kernels._SMEM_RESERVE
    # 8 int64 tables of 4096 entries are 256 KiB: seven are staged, the
    # eighth is read from device memory by the same launch
    offs, used = kernels._staging_plan([8] * 8, 4096, budget)
    assert offs == [i * 32768 for i in range(7)] + [-1]
    assert used == 7 * 32768 <= budget
    # mixed sizes: every offset 16-byte aligned, nothing overlaps
    offs, used = kernels._staging_plan([4, 1, 8, 1], 100, budget)
    assert offs == [0, 400, 512, 1312] and used == 1412
    # a table that does not fit is skipped; a later, smaller one still fits
    offs, used = kernels._staging_plan([8, 8, 1], 16384, 150 * 1024)
    assert offs == [0, -1, 131072] and used == 131072 + 16384
    assert kernels._staging_plan([8], 4096, 0) == ([-1], 0)


@pytest.mark.parametrize("w,optin,fits", [
    (1 << 14, 227 * 1024, True),    # 64 KiB: the tools' small window
    (1 << 20, 227 * 1024, False),   # 4 MiB: read through L2
    (58108, 227 * 1024, True),      # the table and the copy barrier, exactly
    (58109, 227 * 1024, False),
    (2048, 48 * 1024, True),
    (1, 16, False),                 # no room beside the barrier
])
def test_resident_route_is_the_table_and_its_barrier_in_one_block(w, optin,
                                                                  fits):
    assert 4 * 58108 + kernels._SMEM_RESERVE == 227 * 1024
    assert kernels._table_fits_shared_memory(w, optin) is fits


def test_resident_maps_and_entry_points():
    # one source serves the four tool kernels: five index maps, one entry
    assert sorted(kernels._MAPS, key=kernels._MAPS.get) == [
        "full", "lane", "row", "sublane", "onehot"]
    assert "rjt_onehot_gather" not in kernels._SIGNATURES
    assert kernels.RESIDENT_SPAN == 128
    for bodies in (kernels._PALLAS_GATHER_BODIES, kernels._MK_BODIES):
        assert all(mode in kernels._MAPS for mode, _two_d in bodies.values())


def _paged_shapes():
    """(w, ro, npages) over the shapes the Pallas kernel takes; the decode's
    own two (w = 2048, three pages) keep their earlier ids."""
    for w in (128, 2048, 4096):
        for ro in (128, 1920, 3840):
            for npages in (1, 3):
                own = w == 2048 and npages == 3 and ro != 128
                yield pytest.param(w, ro, npages,
                                   id=str(ro) if own else f"{w}-{ro}-{npages}")


@pytest.mark.parametrize("w,ro,npages", list(_paged_shapes()))
def test_paged_window_gather_plain_matches_pallas(w, ro, npages):
    rng = np.random.default_rng([w, ro, npages])
    body = _rand_i32(rng, npages * w).reshape(npages, w)
    idx = rng.integers(0, w, (npages, ro)).astype(np.int32)
    want = pk.paged_window_gather(jnp.asarray(body), jnp.asarray(idx))
    got = kernels.paged_window_gather(torch.from_numpy(body),
                                      torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_vector_route_needs_aligned_rows():
    # the rule the wrapper applies before a launch: body and index start on
    # 16 bytes, w and Ro multiples of 4 (the output is a fresh allocation)
    pool = torch.zeros(4 * 2048 + 16, dtype=torch.int32)
    base = pool.data_ptr() % 16 // 4  # words to the first 16-byte boundary
    body = pool[base:base + 2 * 2048].view(2, 2048)
    idx = pool[base + 4096:base + 4096 + 2 * 1924].view(2, 1924)
    assert kernels._paged_vector_route(body, idx)
    off = pool[base + 1:base + 1 + 2 * 2048].view(2, 2048)
    assert not kernels._paged_vector_route(off, idx)
    assert not kernels._paged_vector_route(
        body, pool[base + 4097:base + 4097 + 2 * 1924].view(2, 1924))
    assert not kernels._paged_vector_route(
        pool[base:base + 2 * 2046].view(2, 2046), idx)
    assert not kernels._paged_vector_route(
        body, pool[base + 4096:base + 4096 + 2 * 1922].view(2, 1922))
    assert kernels.paged_window_gather.last_route is None  # CPU: no launch


def test_wrappers_reject_what_the_kernels_do_not_take():
    t = torch.arange(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.window_gather([t], torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        kernels.window_gather(
            [torch.zeros(kernels.WINDOW_GATHER_TABLE_MAX + 1,
                         dtype=torch.int32)],
            torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.blocked_window_gather_multi(
            [t[::2]], torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        kernels.paged_window_gather(torch.zeros((2, 8), dtype=torch.int64),
                                    torch.zeros((2, 4), dtype=torch.int32))
    # a device that is neither the CPU nor CUDA gets no silent fallback
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        kernels.window_gather([t.to(meta)], torch.zeros(4, dtype=torch.int32,
                                                        device=meta))


def test_cpu_path_counts_no_launches():
    kernels.reset_launch_counts()
    kernels.window_gather([torch.arange(8, dtype=torch.int32)],
                          torch.zeros(3, dtype=torch.int32))
    assert kernels.launch_counts() == {
        "window_gather": 0, "blocked_window_gather_multi": 0,
        "paged_window_gather": 0, "pallas_gather": 0,
        "gather_pallas_vmem": 0, "mk_gather": 0, "onehot_gather": 0,
        "owner_recovery": 0, "cummax_i32": 0, "encode_pages_aligned": 0,
        "unique_probe": 0,
    }
