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


@pytest.mark.parametrize("ro", [1920, 3840])
def test_paged_window_gather_plain_matches_pallas(ro):
    rng = np.random.default_rng(ro)
    npages = 3
    body = _rand_i32(rng, npages * 2048).reshape(npages, 2048)
    idx = rng.integers(0, 2048, (npages, ro)).astype(np.int32)
    want = pk.paged_window_gather(jnp.asarray(body), jnp.asarray(idx))
    got = kernels.paged_window_gather(torch.from_numpy(body),
                                      torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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
    }
