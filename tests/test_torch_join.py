"""The port's join kernels and materialization helpers against their JAX
counterparts (radixjoin_tpu/ops/join.py, radixjoin_tpu/plan/executor.py),
on the same numpy-seeded inputs, exactly.

Probe-shaped joins compare ``bidx``/``found``/``total`` everywhere (both
zero ``bidx`` where not found). Expanding joins compare ``live`` and
``total`` everywhere and ``bidx``/``pidx`` only where ``live``: dead rows
hold don't-care values by contract.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radixjoin_tpu.dtypes import DataType as RefDataType
from radixjoin_tpu.ops import join as jjoin
from radixjoin_tpu.plan import executor as jex
from radixjoin_tpu.storage.columnar import HostColumn as RefHostColumn
from radixjoin_tpu_torch.ops import join as tjoin
from radixjoin_tpu_torch.plan import executor as tex


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _keys(rng, n, lo, hi, null_frac=0.1, dtype=np.int32):
    keys = rng.integers(lo, hi, n).astype(dtype)
    valid = rng.random(n) >= null_frac
    return keys, valid


def _assert_expansion(got, want):
    gb, gp, gl, gt = (_np(x) for x in got)
    wb, wp, wl, wt = (_np(x) for x in want)
    assert int(gt) == int(wt)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(gb[wl], wb[wl])
    np.testing.assert_array_equal(gp[wl], wp[wl])


@pytest.mark.parametrize("r_pad,bp,pp", [(256, 128, 1000), (8192, 4096, 5000)])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_unique_scatter_matches_jax(r_pad, bp, pp, dtype):
    rng = np.random.default_rng(r_pad + bp)
    base = 37
    kb = (base + rng.permutation(r_pad)[:bp]).astype(dtype)
    vb = rng.random(bp) >= 0.1
    kp, vp = _keys(rng, pp, base - 20, base + r_pad + 20, dtype=dtype)
    want = jjoin.join_unique_scatter_impl(
        jnp.asarray(kb), jnp.asarray(vb), jnp.asarray(kp), jnp.asarray(vp),
        jnp.int64(base), r_pad,
    )
    got = tjoin.join_unique_scatter_impl(_t(kb), _t(vb), _t(kp), _t(vp),
                                         base, r_pad)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_unique_sort_matches_jax(dtype):
    rng = np.random.default_rng(11)
    bp, pp = 512, 2000
    kb = rng.choice(np.arange(-(1 << 30), 1 << 30, 997), bp,
                    replace=False).astype(dtype)
    kb[:2] = np.iinfo(dtype).max, np.iinfo(dtype).min  # extreme keys
    vb = rng.random(bp) >= 0.2
    kp = np.where(rng.random(pp) < 0.5, kb[rng.integers(0, bp, pp)],
                  rng.integers(-5, 5, pp)).astype(dtype)
    vp = rng.random(pp) >= 0.1
    want = jjoin.join_unique_impl(jnp.asarray(kb), jnp.asarray(vb),
                                  jnp.asarray(kp), jnp.asarray(vp))
    got = tjoin.join_unique_impl(_t(kb), _t(vb), _t(kp), _t(vp))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("bp,pp,s_pad", [
    (300, 1000, 4096),    # windows <= 4096: window-gather route
    (6000, 5000, 16384),  # probe pad > 4096: blocked-window route
    (6000, 5000, 2048),   # undersized bucket: total overflows s_pad
])
def test_csr_matches_jax(bp, pp, s_pad):
    rng = np.random.default_rng(bp + s_pad)
    kb, vb = _keys(rng, bp, 10, 10 + bp // 3)
    kp, vp = _keys(rng, pp, 0, 20 + bp // 3)
    base, counts_w, starts_w, grouped = RefHostColumn(
        RefDataType.INT32, kb, vb).csr_index()
    want = jjoin.join_csr_impl(
        jnp.asarray(counts_w), jnp.asarray(starts_w), jnp.asarray(grouped),
        jnp.asarray(kp), jnp.asarray(vp), jnp.int64(base), s_pad,
    )
    got = tjoin.join_csr_impl(_t(counts_w), _t(starts_w), _t(grouped),
                              _t(kp), _t(vp), base, s_pad)
    _assert_expansion(got, want)


@pytest.mark.parametrize("bp,pp,r_pad,s_pad", [
    (512, 2048, 1024, 8192),
    (8192, 4096, 4096, 16384),
])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_dev_csr_matches_jax(bp, pp, r_pad, s_pad, dtype):
    rng = np.random.default_rng(bp + pp + r_pad)
    base = 5
    kb, vb = _keys(rng, bp, base - 3, base + r_pad + 3, dtype=dtype)
    kp, vp = _keys(rng, pp, base, base + r_pad, dtype=dtype)
    want = jjoin.join_dev_csr_impl(
        jnp.asarray(kb), jnp.asarray(vb), jnp.asarray(kp), jnp.asarray(vp),
        jnp.int64(base), r_pad, s_pad,
    )
    got = tjoin.join_dev_csr_impl(_t(kb), _t(vb), _t(kp), _t(vp), base,
                                  r_pad, s_pad)
    _assert_expansion(got, want)


def _cols(rng, n):
    i32 = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    i64 = rng.integers(-(1 << 62), 1 << 62, n)
    return [(i32, rng.random(n) < 0.8), (i64, rng.random(n) < 0.7)]


@pytest.mark.parametrize("pad,windowed", [(2048, False), (16384, True),
                                          (16384, False)])
def test_gather_cols_matches_jax(pad, windowed):
    rng = np.random.default_rng(pad + windowed)
    cols = _cols(rng, pad)
    n_out = 20000
    idx = rng.integers(0, pad, n_out).astype(np.int32)
    if windowed:
        idx = np.sort(idx)  # the monotone owner stream
    live = rng.random(n_out) < 0.9
    want = jex._gather_cols(
        [(jnp.asarray(d), jnp.asarray(v)) for d, v in cols],
        jnp.asarray(idx), jnp.asarray(live), windowed=windowed,
    )
    got = tex._gather_cols([(_t(d), _t(v)) for d, v in cols], _t(idx),
                           _t(live), windowed=windowed)
    for (gd, gv), (wd, wv) in zip(got, want):
        np.testing.assert_array_equal(_np(gd), _np(wd))
        np.testing.assert_array_equal(_np(gv), _np(wv))


@pytest.mark.parametrize("n,out_pad", [(1024, 512), (8192, 2048),
                                       (1024, 128)])
def test_compact_probe_shaped_matches_jax(n, out_pad):
    rng = np.random.default_rng(n + out_pad)
    cols = _cols(rng, n)
    live = rng.random(n) < (out_pad / n) * 0.9
    if out_pad == 128:
        live[:] = True  # more live rows than the pad: truncation
    want = jex._compact_probe_shaped(
        tuple((jnp.asarray(d), jnp.asarray(v)) for d, v in cols),
        jnp.asarray(live), out_pad,
    )
    got = tex._compact_probe_shaped(
        tuple((_t(d), _t(v)) for d, v in cols), _t(live), out_pad
    )
    for (gd, gv), (wd, wv) in zip(got, want):
        np.testing.assert_array_equal(_np(gv), _np(wv))
        np.testing.assert_array_equal(_np(gd), _np(wd))
