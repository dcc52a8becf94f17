"""Tests that need the CUDA card: the hand-written kernels against their
plain PyTorch versions, and the smoke plans through ``execute`` on the card
against the port on the CPU. Skipped where torch.cuda.is_available() is
false. This file imports neither jax nor radixjoin_tpu, so it also runs on
a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import radixjoin_tpu_torch as rt
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.harness.datagen import SyntheticIMDB
from radixjoin_tpu_torch.ops import kernels


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    dev = cuda_device
    kernels.reset_launch_counts()
    tabs = [torch.randint(-(1 << 31), 1 << 31, (4096,), generator=gen,
                          device=dev, dtype=torch.int32),
            torch.randint(-(1 << 62), 1 << 62, (4096,), generator=gen,
                          device=dev, dtype=torch.int64),
            torch.rand(4096, generator=gen, device=dev) < 0.5]
    idx = torch.randint(0, 4096, (100_003,), generator=gen, device=dev,
                        dtype=torch.int32)
    for g, w in zip(kernels.window_gather(tabs, idx),
                    kernels.window_gather_plain(tabs, idx)):
        assert torch.equal(g, w)
    big = [torch.randint(-(1 << 31), 1 << 31, (300_000,), generator=gen,
                         device=dev, dtype=torch.int32),
           torch.randint(-(1 << 62), 1 << 62, (200_000,), generator=gen,
                         device=dev, dtype=torch.int64)]
    mono = torch.sort(torch.randint(0, 200_000, (500_001,), generator=gen,
                                    device=dev, dtype=torch.int32)).values
    mono[::997] = 0  # misses
    got, ok = kernels.blocked_window_gather_multi(big, mono)
    want, want_ok = kernels.blocked_window_gather_multi_plain(big, mono)
    assert torch.equal(ok, want_ok)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    body = torch.randint(-(1 << 31), 1 << 31, (50, 2048), generator=gen,
                         device=dev, dtype=torch.int32)
    pidx = torch.randint(0, 2048, (50, 1920), generator=gen, device=dev,
                         dtype=torch.int32)
    assert torch.equal(kernels.paged_window_gather(body, pidx),
                       kernels.paged_window_gather_plain(body, pidx))
    torch.cuda.synchronize()
    assert all(v > 0 for v in kernels.launch_counts().values())


def _columns(result):
    host = result.to_host()
    return [c.objects() if c.dtype.is_varchar
            else np.where(c.valid, c.values, 0) for c in host.columns] + [
        c.valid for c in host.columns]


def _sorted_rows(cols):
    keyed = [np.unique(c, return_inverse=True)[1] if c.dtype == object else c
             for c in cols]
    order = np.lexsort(keyed[::-1])
    return [c[order] for c in cols]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lazy", [("s1", False), ("s2", True)])
def test_job_shape_on_card_matches_cpu(cuda_device, shape, lazy):
    tables = SyntheticIMDB(scale=0.002, seed=0).generate(
        sorted(set(job_shapes.S1_TABLES + job_shapes.S2_TABLES)))
    build = getattr(job_shapes, f"{shape}_plan")
    on_card, on_cpu = build(tables, lazy=lazy), build(tables, lazy=lazy)
    kernels.reset_launch_counts()
    got = rt.execute(on_card, rt.build_context())
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    want = rt.execute(on_cpu, rt.build_context("cpu"))
    assert on_card._last_join_totals == on_cpu._last_join_totals
    assert got.num_rows == want.num_rows
    for a, b in zip(_sorted_rows(_columns(got)), _sorted_rows(_columns(want))):
        np.testing.assert_array_equal(a, b)
    assert launched["window_gather"] > 0
    assert launched["blocked_window_gather_multi"] > 0
    assert (launched["paged_window_gather"] > 0) == (not lazy)
