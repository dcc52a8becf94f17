"""The port's roofline harness (radixjoin_tpu_torch/harness/roofline.py)
against the JAX package's at n = 4,096 on the CPU: every case reports the
same name, rows and least bytes, and the call each case times computes the
same values as the JAX function on the same inputs, bit for bit (integer
outputs), or as multisets where the order within equal keys is free
(``lax.sort`` is not stable).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radixjoin_tpu import hardware as ref_hardware
from radixjoin_tpu.harness import roofline as ref_roofline
from radixjoin_tpu.ops import hashing as ref_hashing
from radixjoin_tpu.ops import join as ref_join

from radixjoin_tpu_torch import hardware
from radixjoin_tpu_torch.harness import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4096
CASES = list(roofline.CASES)


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def _jax_args(case):
    return [jnp.asarray(a.numpy()) for a in case.args]


def _assert_bit_equal(got, want, what):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("name", CASES)
def test_case_reports_the_reference_accounting(name):
    got = roofline.CASES[name](N, hardware.detect("cpu"), 1, device="cpu")
    want = ref_roofline.CASES[name](N, ref_hardware.CHIPS["cpu"], 1)
    assert (got.kernel, got.rows, got.min_bytes) == (
        want.kernel, want.rows, want.min_bytes)
    assert got.ms > 0 and got.rows_per_s > 0


def _reference_values(name, case):
    args = _jax_args(case)
    if name == "sort":
        return jax.lax.sort(tuple(args), num_keys=1)
    if name == "hash":
        return (ref_hashing.murmur64(*args),)
    if name == "join_merge":
        return ref_join.join_merge_impl(*args)
    if name == "join_count":
        return ref_join.join_count_impl(*args)
    if name == "join_expand":
        perm, lo, offsets, total = args
        s_pad = ref_join.bucket_size(int(total))
        return ref_join.join_expand_impl(perm, lo, offsets, total, s_pad)
    if name == "gather":
        vals, valid, idx, live = args
        return ref_join.gather_columns([(vals, valid)], idx, live)[0]
    assert name == "fused_join"
    bk, bv, pk, pv, bpay, ppay = args
    perm, lo, _c, offsets, total = ref_join.join_count_impl(bk, bv, pk, pv)
    s_pad = ref_join.bucket_size(int(total))
    bidx, pidx, live = ref_join.join_expand_impl(perm, lo, offsets, total,
                                                 s_pad)
    return bpay[bidx], ppay[pidx], live


@pytest.mark.parametrize("name", CASES)
def test_case_computes_the_reference_values(name):
    make = getattr(roofline, "case_" + name)
    case = make(N, "cpu")
    got = case.fn(*case.args)
    want = _reference_values(name, case)
    if name == "gather":
        got = got[0]
    if name == "hash":
        # the port keeps the uint64 hash as its int64 bit pattern
        _assert_bit_equal(got.numpy().view(np.uint64), want[0], "hash")
        return
    if name == "sort":
        keys, ids = (_np(x) for x in got)
        want_keys, want_ids = (np.asarray(x) for x in want)
        _assert_bit_equal(keys, want_keys, "sorted keys")
        assert ids.dtype == want_ids.dtype
        assert sorted(zip(keys.tolist(), ids.tolist())) == sorted(
            zip(want_keys.tolist(), want_ids.tolist()))
        return
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_bit_equal(g, w, f"{name} output {i}")


def test_without_a_card_it_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "radixjoin_tpu_torch.harness.roofline",
         "--size", "4096"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA card" in proc.stderr
