"""The in-kernel gather experiments of the port (radixjoin_tpu_torch/tools)
against the JAX package's tool kernels (tools/expt_pallas.py,
tools/expt_primitives.py, tools/expt_gather2.py).

The tool scripts call ``pl.pallas_call`` without ``interpret=``; here it is
patched to interpret mode so the Pallas kernels run on the CPU. Each body
runs on inputs made from ``numpy.random.default_rng(seed)`` through the
tool's own jitted ``run`` and through the port's wrapper (its plain
version on the CPU), bit for bit. Every case of the port's three tools
also builds and runs one step on the CPU at a small size.
"""

import functools
import inspect
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from radixjoin_tpu_torch.ops import kernels
from radixjoin_tpu_torch.tools import expt_gather2 as t_gather2
from radixjoin_tpu_torch.tools import expt_pallas as t_pallas
from radixjoin_tpu_torch.tools import expt_primitives as t_primitives

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import expt_gather2 as j_gather2  # noqa: E402
import expt_pallas as j_pallas  # noqa: E402
import expt_primitives as j_primitives  # noqa: E402

N = 8192


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _run_of(step):
    return inspect.getclosurevars(step).nonlocals["run"]


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


# body -> (JAX case, table shape)
_PALLAS_BODIES = {
    "take": (j_pallas.case_pallas_take, (1024,)),
    "take_unique": (j_pallas.case_pallas_take_unique, (1024,)),
    "ta_lanes": (j_pallas.case_pallas_ta_lanes, (8, 128)),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("body", sorted(_PALLAS_BODIES))
def test_pallas_gather_matches_tool_kernel(interpret, body, seed):
    case, shape = _PALLAS_BODIES[body]
    rng = np.random.default_rng(seed)
    w = int(np.prod(shape))
    table = rng.integers(-(1 << 31), 1 << 31, w).astype(np.int32)
    table = table.reshape(shape)
    idx = rng.integers(0, w, N).astype(np.int32)
    step, _carry, _rows = case(N, w)
    want = _run_of(step)(jnp.asarray(table), jnp.asarray(idx))
    got = kernels.pallas_gather(torch.from_numpy(table),
                                torch.from_numpy(idx), body=body)
    _same(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_onehot_gather_matches_tool_kernel(interpret, seed):
    rng = np.random.default_rng(seed)
    w = 2048
    # exact below 2^24 in magnitude; indices outside [0, w) read 0
    table = rng.integers(-(1 << 24) + 1, 1 << 24, w).astype(np.int32)
    idx = rng.integers(-3, w + 3, N).astype(np.int32)
    step, _carry, _rows = j_pallas.case_pallas_onehot_mxu(N, w)
    want = _run_of(step)(jnp.asarray(table), jnp.asarray(idx))
    got = kernels.onehot_gather(torch.from_numpy(table),
                                torch.from_numpy(idx))
    _same(got, want)
    np.testing.assert_array_equal(
        got.numpy(), np.where((idx >= 0) & (idx < w),
                              table[np.clip(idx, 0, w - 1)], 0))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("w", [1024, 2048])
def test_gather_pallas_vmem_matches_tool_kernel(interpret, w, seed):
    rng = np.random.default_rng(seed)
    table = rng.integers(-(1 << 31), 1 << 31, w).astype(np.int32)
    idx = rng.integers(0, w, N).astype(np.int32)
    step, _carry, _rows, _nbytes = j_primitives.case_gather_pallas_vmem(N, w)
    want = _run_of(step)(jnp.asarray(table), jnp.asarray(idx))
    got = kernels.gather_pallas_vmem(torch.from_numpy(table),
                                     torch.from_numpy(idx))
    _same(got, want)


# body -> (JAX input maker, w)
_MK_BODIES = {
    "rows": (j_gather2.build_rows, 2048),
    "lanes": (j_gather2.build_lanes, 1024),
    "2level": (j_gather2.build_2level, 2048),
    "sub": (j_gather2.build_sub, 1024),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("body", sorted(_MK_BODIES))
def test_mk_gather_matches_tool_kernel(interpret, body, seed):
    build, w = _MK_BODIES[body]
    rng = np.random.default_rng(seed)
    rows = 8 if body in ("lanes", "sub") else w // 128
    table = rng.integers(-(1 << 31), 1 << 31, rows * 128).astype(np.int32)
    table = table.reshape(rows, 128)
    idx = rng.integers(0, w, N).astype(np.int32)
    with jax.enable_x64(False):
        run, _t2, _idx = build(N, w, 2048)
        want = np.asarray(run(jnp.asarray(table), jnp.asarray(idx)))
    got = kernels.mk_gather(torch.from_numpy(table), torch.from_numpy(idx),
                            body=body)
    _same(got, want)


@pytest.mark.parametrize("name", ["pallas_take", "pallas_ta_lanes",
                                  "pallas_onehot_mxu"])
def test_tool_inputs_match_the_jax_tool(interpret, name):
    """The port's tool cases make the JAX tool's inputs, and their kernel
    step gives the JAX kernel's output on them."""
    j_step, j_carry, j_rows = j_pallas.CASES[name](N, 1024)
    step, carry, rows = t_pallas.CASES[name](N, 1024, "cpu")
    assert rows == j_rows
    for a, b in zip(carry, j_carry):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = _run_of(j_step)(*j_carry)
    body = {"pallas_take": "take", "pallas_ta_lanes": "ta_lanes"}.get(name)
    got = (kernels.onehot_gather(*carry) if body is None
           else kernels.pallas_gather(*carry, body=body))
    _same(got, want)


def test_sublane_body_reads_each_block_head():
    """The ``sub`` body: output i reads row ``idx[b0 + i % 128] & 7`` of
    column 0, with ``b0`` the start of i's block."""
    t2 = torch.arange(8 * 128, dtype=torch.int32).reshape(8, 128)
    idx = torch.arange(512, dtype=torch.int32).flip(0).contiguous()
    got = kernels.mk_gather(t2, idx, body="sub", blk=256)
    i = np.arange(512)
    heads = idx.numpy()[(i // 256) * 256 + i % 128]
    np.testing.assert_array_equal(got.numpy(), (heads & 7) * 128)


def test_resident_wrappers_reject_what_the_kernels_do_not_take():
    t = torch.zeros(1024, dtype=torch.int32)
    idx = torch.zeros(2048, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.pallas_gather(t, idx[:1000])  # n not a multiple of blk
    with pytest.raises(ValueError):
        kernels.pallas_gather(t, idx, body="ta_lanes")  # needs (w/128, 128)
    with pytest.raises(ValueError):
        kernels.mk_gather(t.view(8, 128), idx, body="nope")
    with pytest.raises(ValueError):
        kernels.mk_gather(t[:512].view(4, 128), idx, body="sub")
    with pytest.raises(TypeError):
        kernels.gather_pallas_vmem(t.long(), idx)
    with pytest.raises(TypeError):
        kernels.onehot_gather(t.view(8, 128), idx)
    with pytest.raises(ValueError):
        kernels.gather_pallas_vmem(t, idx, blk=1000)  # not a multiple of 128


_TOOL_CASES = (
    [("pallas", k) for k in t_pallas.CASES]
    + [("primitives", k) for k in t_primitives.CASES]
    + [("gather2", name) for name, _b, _w in t_gather2.RUNS]
)


@pytest.mark.parametrize("tool,name", _TOOL_CASES)
def test_tool_case_runs_one_step_on_cpu(tool, name):
    if tool == "gather2":
        build, w = {n: (b, w) for n, b, w in t_gather2.RUNS}[name]
        run, table, idx = build(N, min(w, 4096), 2048, "cpu")
        out = run(table, idx)
        assert out.shape == (N,) and out.dtype == torch.int32
        return
    n = 1 << 16 if name == "sort_u32_packed_seg" else N
    cases = t_pallas.CASES if tool == "pallas" else t_primitives.CASES
    step, carry, *_ = cases[name](n, 4096, "cpu")
    out = step(carry)
    assert [(x.shape, x.dtype) for x in out] == [
        (x.shape, x.dtype) for x in carry]
