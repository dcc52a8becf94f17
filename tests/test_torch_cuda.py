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
from radixjoin_tpu_torch.plan import fused


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
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("window_gather",
                                       "blocked_window_gather_multi",
                                       "paged_window_gather"))


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


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["smem", "l2"])
def test_cuda_resident_gathers_match_plain(cuda_device, route):
    """Each resident-gather body against its plain version. The wrapper
    picks the route from the table's size alone: 1K- and 16K-entry tables
    fit a block's shared memory, a 2^20-entry one (4 MiB) is read through
    L2."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    dev = cuda_device
    n = 1 << 20

    def inputs(w):
        t = torch.randint(-(1 << 31), 1 << 31, (w,), generator=gen,
                          device=dev, dtype=torch.int32)
        i = torch.randint(0, w, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        return t, i

    kernels.reset_launch_counts()
    for w in ((1024, 1 << 14) if route == "smem" else (1 << 20,)):
        t, i = inputs(w)
        for body in ("take", "take_unique"):
            assert torch.equal(kernels.pallas_gather(t, i, body=body),
                               kernels.pallas_gather_plain(t, i, body))
            assert kernels.pallas_gather.last_route == route
        assert torch.equal(
            kernels.pallas_gather(t.view(-1, 128), i, body="ta_lanes"),
            kernels.pallas_gather_plain(t.view(-1, 128), i, "ta_lanes"))
        assert kernels.pallas_gather.last_route == route
        assert torch.equal(kernels.gather_pallas_vmem(t, i),
                           kernels.gather_pallas_vmem_plain(t, i))
        assert kernels.gather_pallas_vmem.last_route == route
        for body in ("rows", "lanes", "2level", "sub"):
            assert torch.equal(
                kernels.mk_gather(t.view(-1, 128), i, body=body),
                kernels.mk_gather_plain(t.view(-1, 128), i, body))
            assert kernels.mk_gather.last_route == route
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("pallas_gather", "gather_pallas_vmem",
                                       "mk_gather"))


@pytest.mark.cuda
def test_cuda_onehot_gather_matches_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    n, w = (1 << 20) + 5, 2048
    table = torch.randint(-(1 << 24) + 1, 1 << 24, (w,), generator=gen,
                          device=cuda_device, dtype=torch.int32)
    idx = torch.randint(-2, w + 2, (n,), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    kernels.reset_launch_counts()
    got = kernels.onehot_gather(table, idx)
    assert torch.equal(got, kernels.onehot_gather_plain(table, idx))
    inside = (idx >= 0) & (idx < w)
    assert torch.equal(got[inside], table[idx[inside].long()])
    assert int(got[~inside].abs().sum()) == 0
    torch.cuda.synchronize()
    assert kernels.launch_counts()["onehot_gather"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["s3", "f64"])
def test_merge_plan_on_card_matches_cpu(cuda_device, shape, monkeypatch):
    if shape == "s3":
        # at this scale the root's combined pad is far below 2^23
        monkeypatch.setattr(fused, "BIG_MERGE_PAD", 1 << 12)
        tables = SyntheticIMDB(scale=0.002, seed=0).generate(
            list(job_shapes.S3_TABLES))
        build = job_shapes.s3_plan
    else:
        tables = job_shapes.f64_tables(50_000)
        build = job_shapes.f64_plan
    on_card, on_cpu = build(tables), build(tables)
    kernels.reset_launch_counts()
    got = rt.execute(on_card, rt.build_context())
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    want = rt.execute(on_cpu, rt.build_context("cpu"))
    assert "merge" in on_card._fused_struct_cache[1].strategies().values()
    assert on_card._last_join_totals == on_cpu._last_join_totals
    assert got.num_rows == want.num_rows
    for a, b in zip(_sorted_rows(_columns(got)), _sorted_rows(_columns(want))):
        np.testing.assert_array_equal(a, b)
    assert launched["blocked_window_gather_multi"] > 0
