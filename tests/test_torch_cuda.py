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


def _rand(gen, dev, n, dtype):
    if dtype == torch.bool:
        return torch.rand(n, generator=gen, device=dev) < 0.5
    top = 1 << (31 if dtype == torch.int32 else 62)
    return torch.randint(-top, top, (n,), generator=gen, device=dev,
                         dtype=dtype)


def _assert_equal_lists(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 1025, (1 << 20) + 3])
def test_window_gather_mixed_sizes_one_launch(cuda_device, n):
    """int32, int64 and bool tables in one call: one launch, bit-equal to
    the plain version, for ragged lengths, and for table and index views
    that are not 16-byte aligned."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    w = 4096
    pools = [_rand(gen, cuda_device, w + 8, d)
             for d in (torch.int32, torch.int64, torch.bool, torch.int32)]
    idx = torch.randint(0, w, (n + 4,), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    for tabs, i in (([p[:w] for p in pools[:3]], idx[:n]),
                    ([pools[0][1:w + 1], pools[1][1:w + 1],
                      pools[2][3:w + 3], pools[3][2:w + 2]], idx[1:n + 1])):
        kernels.reset_launch_counts()
        got = kernels.window_gather(tabs, i)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["window_gather"] == 1
        _assert_equal_lists(got, kernels.window_gather_plain(tabs, i))


@pytest.mark.cuda
def test_window_gather_past_the_shared_memory_budget(cuda_device):
    """Tables that do not fit a block's shared memory are read from device
    memory by the same launch; more tables than one launch's descriptor
    holds take a second one."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    n = (1 << 20) + 1
    for w, count, launches in ((4096, 8, 1),
                               (kernels.WINDOW_GATHER_TABLE_MAX, 3, 1),
                               (4096, 20, 2)):
        tabs = [_rand(gen, cuda_device, w, torch.int64) for _ in range(count)]
        tabs.append(_rand(gen, cuda_device, w, torch.bool))
        if count == 20:
            tabs.pop()
        idx = torch.randint(0, w, (n,), generator=gen, device=cuda_device,
                            dtype=torch.int32)
        offs, _used = kernels._staging_plan(
            [t.element_size() for t in tabs[:kernels._MAX_TABLES]], w,
            kernels._device_limits(cuda_device)[1] - kernels._SMEM_RESERVE)
        assert -1 in offs  # some table of the first launch is not staged
        kernels.reset_launch_counts()
        got = kernels.window_gather(tabs, idx)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["window_gather"] == launches
        _assert_equal_lists(got, kernels.window_gather_plain(tabs, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 1025, (1 << 21) + 3])
@pytest.mark.parametrize("with_ok", [True, False])
def test_blocked_window_gather_mixed_sizes_one_launch(cuda_device, n,
                                                      with_ok):
    """Mixed element sizes and lengths in one call: one launch, bit-equal
    to the plain version with and without the flags, for ragged lengths,
    unaligned views, misses and indices past the shorter table's end."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    dev = cuda_device
    src = 1 << 20
    pools = [_rand(gen, dev, src + 8, torch.int32),
             _rand(gen, dev, src + 8, torch.int64),
             _rand(gen, dev, src // 2 + 8, torch.int32),
             _rand(gen, dev, src + 8, torch.bool)]
    mono = torch.sort(torch.randint(0, src, (n + 4,), generator=gen,
                                    device=dev, dtype=torch.int32)).values
    mono[::997] = 0  # misses
    for tabs, idx in (([pools[0][:src], pools[1][:src],
                        pools[2][:src // 2], pools[3][:src]], mono[:n]),
                      ([pools[0][1:src + 1], pools[1][1:src + 1],
                        pools[2][3:src // 2 + 3], pools[3][5:src + 5]],
                       mono[1:n + 1])):
        kernels.reset_launch_counts()
        got, ok = kernels.blocked_window_gather_multi(tabs, idx,
                                                      with_ok=with_ok)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["blocked_window_gather_multi"] == 1
        want, want_ok = kernels.blocked_window_gather_multi_plain(tabs, idx)
        _assert_equal_lists(got, want)
        if with_ok:
            assert torch.equal(ok, want_ok)
        else:
            assert ok is None


@pytest.mark.cuda
def test_blocked_window_gather_more_tables_than_one_launch(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    src, n = 1 << 18, (1 << 20) + 5
    tabs = [_rand(gen, cuda_device, src, d)
            for d in (torch.int64, torch.bool) * 10]
    idx = torch.sort(torch.randint(0, src, (n,), generator=gen,
                                   device=cuda_device,
                                   dtype=torch.int32)).values
    kernels.reset_launch_counts()
    got, ok = kernels.blocked_window_gather_multi(tabs, idx)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["blocked_window_gather_multi"] == 2
    want, want_ok = kernels.blocked_window_gather_multi_plain(tabs, idx)
    _assert_equal_lists(got, want)
    assert torch.equal(ok, want_ok)


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


# wrapper, body -> the table is 2-D (w / 128, 128)
_RESIDENT_BODIES = [("pallas_gather", "take", False),
                    ("pallas_gather", "take_unique", False),
                    ("pallas_gather", "ta_lanes", True),
                    ("gather_pallas_vmem", None, False),
                    ("mk_gather", "rows", True),
                    ("mk_gather", "lanes", True),
                    ("mk_gather", "2level", True),
                    ("mk_gather", "sub", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["smem", "l2"])
@pytest.mark.parametrize("wrapper,body,two_d", _RESIDENT_BODIES)
def test_cuda_resident_gather_unaligned_views_one_launch(cuda_device, route,
                                                         wrapper, body,
                                                         two_d):
    """Every index map on both routes: one launch a call, bit-equal to the
    plain version for aligned inputs, for an index view that is not 8-byte
    aligned, for a table view that is not 16-byte aligned (on the shared
    memory route it is staged by the plain loop), for indices outside the
    table (clamped), and for a single tile (n = blk)."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    dev = cuda_device
    w = 1 << 14 if route == "smem" else 1 << 20
    blk, n = 2048, 1 << 20
    pool = torch.randint(-(1 << 31), 1 << 31, (w + 8,), generator=gen,
                         device=dev, dtype=torch.int32)
    ipool = torch.randint(-5, w + 5, (n + 8,), generator=gen, device=dev,
                          dtype=torch.int32)
    fn = getattr(kernels, wrapper)
    plain = getattr(kernels, wrapper + "_plain")
    kwargs = {} if body is None else {"body": body}
    for table, idx in ((pool[:w], ipool[:n]), (pool[:w], ipool[1:n + 1]),
                       (pool[1:w + 1], ipool[:n]),
                       (pool[3:w + 3], ipool[3:n + 3]),
                       (pool[:w], ipool[5:blk + 5])):
        table = table.view(-1, 128) if two_d else table
        kernels.reset_launch_counts()
        got = fn(table, idx, blk=blk, **kwargs)
        torch.cuda.synchronize()
        assert fn.last_route == route
        assert kernels.launch_counts()[wrapper] == 1
        want = (plain(table, idx, blk=blk) if body is None
                else plain(table, idx, body, blk))
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("w,offset", [(2048, 0), (2047, 0), (2048, 1),
                                      (2047, 3), (1, 0), (40000, 0)])
def test_cuda_onehot_gather_edges(cuda_device, w, offset):
    """Indices below 0 and at or above ``w`` read 0; a table length that is
    no multiple of 4 and a table view at an odd offset; table values over
    the whole stated domain, rounded through float32; ragged ``n``; one
    launch a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    dev = cuda_device
    top = (1 << 31) - 64
    pool = torch.randint(-top, top, (w + 8,), generator=gen, device=dev,
                         dtype=torch.int32)
    table = pool[offset:offset + w]
    edge = torch.tensor([top - 1, -(1 << 31), (1 << 24) + 1, top - 65],
                        dtype=torch.int32, device=dev)[:w]
    table[:edge.shape[0]] = edge
    for n in (1, 127, 128, (1 << 20) + 5):
        idx = torch.randint(-3, w + 3, (n + 1,), generator=gen, device=dev,
                            dtype=torch.int32)
        idx[:2] = torch.tensor([-(1 << 31), (1 << 31) - 1], device=dev)
        for i in (idx[:n], idx[1:]):
            kernels.reset_launch_counts()
            got = kernels.onehot_gather(table, i)
            torch.cuda.synchronize()
            assert kernels.launch_counts()["onehot_gather"] == 1
            inside = (i >= 0) & (i < w)
            rounded = table.to(torch.float32).to(torch.int64).to(torch.int32)
            want = torch.where(inside, rounded[i.clamp(0, w - 1).long()],
                               torch.zeros((), dtype=torch.int32, device=dev))
            assert torch.equal(got, want)
            if n <= 1 << 14:
                assert torch.equal(got, kernels.onehot_gather_plain(table, i))


@pytest.mark.cuda
def test_cuda_onehot_gather_rejects_a_table_past_shared_memory(cuda_device):
    table = torch.zeros(1 << 20, dtype=torch.int32, device=cuda_device)
    idx = torch.zeros(128, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        kernels.onehot_gather(table, idx)


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
        monkeypatch.setenv("RJT_BIG_MERGE", str(1 << 12))
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


# ---------------------------------------------------------------------------
# memory ledger, spill, stepwise and batch on the card
# ---------------------------------------------------------------------------


def _assert_same_rows(got, want):
    assert got.num_rows == want.num_rows
    for a, b in zip(_sorted_rows(_columns(got)), _sorted_rows(_columns(want))):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def job_plans(cuda_device):
    """S1 (eager pages), S2, S3 and F1 at a small scale, with their fused
    results on the card, and the engine's caches and tallies reset."""
    from radixjoin_tpu_torch import engine

    tables = SyntheticIMDB(scale=0.002, seed=0).generate(sorted(
        set(job_shapes.S1_TABLES + job_shapes.S2_TABLES)))
    tables.update(job_shapes.f64_tables(20_000))
    plans = {"s1": job_shapes.s1_plan(tables, lazy=False),
             "s2": job_shapes.s2_plan(tables, lazy=True),
             "s3": job_shapes.s3_plan(tables, lazy=True),
             "f64": job_shapes.f64_plan(tables, lazy=True)}
    ctx = rt.build_context()
    fused_results = {n: rt.execute(p, ctx) for n, p in plans.items()}
    engine.clear_device_caches()
    engine.reset_engine_stats()
    yield plans, fused_results, ctx
    engine.clear_device_caches()
    engine.reset_engine_stats()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["s1", "f64"])
def test_stepwise_on_card_equals_fused(job_plans, shape, monkeypatch):
    plans, fused_results, ctx = job_plans
    monkeypatch.setenv("RJT_EXEC_MODE", "stepwise")
    kernels.reset_launch_counts()
    got = rt.execute(plans[shape], ctx)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    _assert_same_rows(got, fused_results[shape])
    assert launched["blocked_window_gather_multi"] > 0
    assert (launched["paged_window_gather"] > 0) == (shape == "s1")


@pytest.mark.cuda
def test_spill_on_card_equals_fused(job_plans, monkeypatch):
    from radixjoin_tpu_torch import engine

    plans, fused_results, ctx = job_plans
    budget = engine._estimate_scan_bytes(plans["s2"]) // 4
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", str(budget))
    kernels.reset_launch_counts()
    got = rt.execute(plans["s2"], ctx)
    torch.cuda.synchronize()
    _assert_same_rows(got, fused_results["s2"])
    assert engine.engine_stats()["admission_host_spills"] == 1
    assert max(plans["s2"]._last_spill_partitions.values()) > 1
    assert kernels.launch_counts()["blocked_window_gather_multi"] > 0


@pytest.mark.cuda
def test_eviction_returns_device_memory_to_baseline(job_plans, monkeypatch):
    from radixjoin_tpu_torch import engine

    plans, fused_results, ctx = job_plans
    ledger = engine.device_ledger(ctx.device)
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated()
    rt.execute(plans["s1"], ctx)
    s1_pinned = ledger.pinned_bytes()
    assert s1_pinned > 0
    budget = max(engine._estimate_query_bytes(plans[n])
                 for n in ("s1", "s3")) + s1_pinned // 2
    monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", str(budget))
    evictions = ledger.stats["evictions"]
    for shape in ("s1", "s3", "s1"):
        _assert_same_rows(rt.execute(plans[shape], ctx), fused_results[shape])
        assert ledger.pinned_bytes() <= budget
    assert ledger.stats["evictions"] > evictions
    assert engine.engine_stats()["admission_host_spills"] == 0
    engine.clear_device_caches()
    torch.cuda.synchronize()
    assert ledger.pinned_bytes() == 0
    assert abs(torch.cuda.memory_allocated() - baseline) <= 1 << 20


@pytest.mark.cuda
@pytest.mark.parametrize("tight", [False, True])
def test_batch_on_card_equals_serial(job_plans, tight, monkeypatch):
    from radixjoin_tpu_torch import engine

    plans, fused_results, ctx = job_plans
    names = list(plans) + list(plans)
    if tight:
        top = max(engine._estimate_query_bytes(p) for p in plans.values())
        monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", str(top + top // 4))
    for _run in range(2):  # cold, then on warm caches and feedback
        results = rt.execute_many([plans[n] for n in names], ctx)
        torch.cuda.synchronize()
        for name, got in zip(names, results):
            _assert_same_rows(got, fused_results[name])
    stats = engine.engine_stats()
    assert all(stats[k] == 0 for k in engine.ENGINE_STATS)
    assert not engine.device_ledger(ctx.device)._reservations


@pytest.mark.cuda
def test_out_of_memory_on_card_retries_once(job_plans, monkeypatch):
    from radixjoin_tpu_torch import engine

    plans, fused_results, ctx = job_plans
    run = fused.run
    calls = []

    def failing(structure):
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("injected: out of memory")
        return run(structure)

    monkeypatch.setattr(fused, "run", failing)
    _assert_same_rows(rt.execute(plans["s1"], ctx), fused_results["s1"])
    stats = engine.engine_stats()
    assert stats["oom_retries"] == 1 and stats["oom_host_spills"] == 0


@pytest.mark.cuda
def test_partitioned_join_on_card_equals_cpu(cuda_device):
    from radixjoin_tpu_torch.ops import radix

    rng = np.random.default_rng(7)
    nb, npr = 20_000, 150_000
    bk = rng.integers(0, 9000, nb).astype(np.int64)
    bv = rng.random(nb) > 0.1
    pk = rng.integers(0, 12000, npr).astype(np.int32).astype(np.int64)
    pv = rng.random(npr) > 0.1
    for num_partitions in (1, 8):
        got = radix.partitioned_join_indices(
            bk, bv, pk, pv, num_partitions=num_partitions)
        want = radix.partitioned_join_indices(
            bk, bv, pk, pv, num_partitions=num_partitions, device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    keys = torch.from_numpy(bk).to(cuda_device)
    np.testing.assert_array_equal(
        radix.bucket_of(keys, 16).cpu().numpy(), radix.bucket_of_np(bk, 16))


# ---------------------------------------------------------------------------
# the wave executor and the SQL entry point on the card
# ---------------------------------------------------------------------------


def _random_plan(rng):
    """A left-deep plan over 3 or 4 generated tables: a key column of a
    type drawn per plan (INT32, INT64, FP64 or VARCHAR; duplicates, NULLs)
    and an INT64 payload each, joined on the key with random build sides."""
    from radixjoin_tpu_torch.dtypes import DataType
    from radixjoin_tpu_torch.plan.ir import Plan
    from radixjoin_tpu_torch.storage.columnar import (ColumnarTable,
                                                      HostColumn, HostTable)

    kind = [DataType.INT32, DataType.INT64, DataType.FP64,
            DataType.VARCHAR][int(rng.integers(0, 4))]
    plan = Plan()
    scans = []
    for _t in range(int(rng.integers(3, 5))):
        n = int(rng.integers(50, 3000))
        keys = rng.integers(0, int(rng.integers(20, 400)), n)
        valid = rng.random(n) >= 0.1
        if kind is DataType.VARCHAR:
            words = np.array([b"k%d" % k for k in keys], dtype=object)
            key_col = HostColumn(kind, words, valid)
        elif kind is DataType.FP64:
            key_col = HostColumn(kind, keys * 0.5, valid)
        else:
            key_col = HostColumn(kind, keys.astype(kind.numpy_dtype), valid)
        payload = HostColumn(DataType.INT64,
                             rng.integers(-(1 << 40), 1 << 40, n),
                             rng.random(n) >= 0.2)
        table = ColumnarTable.from_host(HostTable(n, [key_col, payload]),
                                        lazy=bool(rng.integers(0, 2)))
        scans.append(plan.new_scan_node(
            plan.new_input(table), [(0, kind), (1, DataType.INT64)]))
    node, width = scans[0], 2
    for scan in scans[1:]:
        # the left key, the left payloads, the right payload
        attrs = [(0, kind)] + [(c, DataType.INT64) for c in range(1, width)]
        attrs.append((width + 1, DataType.INT64))
        node = plan.new_join_node(bool(rng.integers(0, 2)), node, scan, 0, 0,
                                  attrs)
        width = len(attrs)
    plan.root = node
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["s1", "s2", "s3", "f64"])
def test_shared_mode_on_card_equals_fused_and_cpu(job_plans, shape,
                                                  monkeypatch):
    """The wave executor on the card: cold and warm equal to the fused
    result and to the wave executor on the CPU, per-join totals included;
    the warm run makes no shrink sync and no host sync beyond its
    fetches."""
    import warnings

    from radixjoin_tpu_torch import engine
    from radixjoin_tpu_torch.plan import executor as wave

    plans, fused_results, ctx = job_plans
    plan = plans[shape]
    fused_totals = dict(plan._last_join_totals)
    plan._fused_struct_cache = None
    del plan._learned_buckets
    monkeypatch.setenv("RJT_EXEC_MODE", "shared")
    monkeypatch.setenv("RJT_SHRINK_MIN_PAD", "2048")
    kernels.reset_launch_counts()
    cold = rt.execute(plan, ctx)
    assert plan._last_exec_stats["shrink_syncs"] <= 1
    fetched = []
    fetch = engine._fetch
    monkeypatch.setattr(engine, "_fetch",
                        lambda ts: fetched.append(len(ts)) or fetch(ts))
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            warm = rt.execute(plan, ctx)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in seen if "synchroniz" in str(w.message)]
    print(f"{shape}: {len(syncs)} host syncs for {sum(fetched)} fetched "
          f"tensors in {len(fetched)} rounds")
    assert len(syncs) <= sum(fetched)
    assert plan._last_exec_stats["shrink_syncs"] == 0
    assert plan._last_exec_stats["rounds"] == len(fetched) == 2
    launched = kernels.launch_counts()
    for got in (cold, warm):
        _assert_same_rows(got, fused_results[shape])
    assert plan._last_join_totals == fused_totals
    assert getattr(plan, "_fused_struct_cache", None) is None
    assert launched["blocked_window_gather_multi"] > 0
    # F1 is one merge join: its lookups all ride the blocked-window kernel
    assert (launched["window_gather"] > 0) == (shape != "f64")
    assert (launched["paged_window_gather"] > 0) == (shape == "s1")
    paths = wave.path_stats()
    assert sum(paths.values()) > 0
    # the CPU route runs the same plan object (its own uploads and ledger)
    on_cpu = rt.execute(plan, rt.build_context("cpu"))
    _assert_same_rows(on_cpu, warm)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_shared_mode_on_card_random_plans(cuda_device, seed, monkeypatch):
    rng = np.random.default_rng(7000 + seed)
    plan = _random_plan(rng)
    cpu = rt.build_context("cpu")
    monkeypatch.setenv("RJT_EXEC_MODE", "fused")
    want = rt.execute(plan, cpu)
    fused_totals = dict(plan._last_join_totals)
    monkeypatch.setenv("RJT_EXEC_MODE", "shared")
    del plan._learned_buckets
    ctx = rt.build_context()
    for _run in ("cold", "warm"):
        got = rt.execute(plan, ctx)
        _assert_same_rows(got, want)
        assert plan._last_join_totals == fused_totals
    _assert_same_rows(rt.execute(plan, cpu), want)


@pytest.mark.cuda
@pytest.mark.parametrize("eager", ["off", "on"])
def test_query_documents_through_the_harness_on_card(cuda_device, eager,
                                                     tmp_path, monkeypatch):
    """SQL text and EXPLAIN document to a verified result on the card:
    every query document through ``JobHarness``, checked by
    ``verify_result`` against the row oracle and sqlite, in ``auto`` and in
    ``shared`` mode; with eager pages the scans decode on the card."""
    from radixjoin_tpu_torch.harness import datagen, oracle
    from radixjoin_tpu_torch.harness import run as harness_run

    monkeypatch.setenv("RJT_EAGER_PAGES", eager)
    docs = job_shapes.QUERY_DOCUMENTS
    path = job_shapes.write_query_documents(str(tmp_path))
    tables = datagen.SyntheticIMDB(
        scale=0.004, seed=0, queries=[docs[n][0] for n in docs]).generate()
    sqlite = oracle.SqliteOracle(tables)
    harness = harness_run.JobHarness(
        path, harness_run.TableSource(host_tables=tables))
    assert harness.context.device.type == "cuda"
    kernels.reset_launch_counts()
    for mode in ("auto", "shared"):
        monkeypatch.setenv("RJT_EXEC_MODE", mode)
        for name in docs:
            result, _ms, correct, detail = harness.run_query(
                name, verify=True, sqlite_oracle=sqlite)
            assert correct, (name, mode, detail)
            assert result.num_rows > 0, name
    launched = kernels.launch_counts()
    assert launched["window_gather"] > 0
    assert launched["blocked_window_gather_multi"] > 0
    assert (launched["paged_window_gather"] > 0) == (eager == "on")
    harness.close()


@pytest.mark.cuda
def test_declined_plan_on_card_goes_to_the_wave_executor(cuda_device,
                                                         tmp_path,
                                                         monkeypatch):
    from radixjoin_tpu_torch.harness import datagen, oracle
    from radixjoin_tpu_torch.harness import run as harness_run
    from radixjoin_tpu_torch.plan import executor as wave

    docs = job_shapes.QUERY_DOCUMENTS
    path = job_shapes.write_query_documents(str(tmp_path))
    tables = datagen.SyntheticIMDB(
        scale=0.004, seed=0, queries=[docs[n][0] for n in docs]).generate()
    harness = harness_run.JobHarness(
        path, harness_run.TableSource(host_tables=tables))
    monkeypatch.setattr(fused.FusedPlan, "_varchar_dev_csr",
                        lambda self, *a: None)
    calls = []
    run = wave.execute_shared
    monkeypatch.setattr(wave, "execute_shared",
                        lambda *a: calls.append(1) or run(*a))
    parsed, plan = harness.build_plan(job_shapes.VARCHAR_KEY_QUERY)
    result = rt.execute(plan, harness.context)
    assert calls == [1] and result.num_rows > 0
    correct, detail = harness_run.verify_result(
        parsed, plan, result, oracle.SqliteOracle(tables))
    assert correct, detail


@pytest.mark.cuda
@pytest.mark.parametrize("knob,value", [
    ("RJT_CSR_JOIN", "off"), ("RJT_DEV_CSR", "off"),
    ("RJT_UNIQUE_JOIN", "sort"), ("RJT_BIG_MERGE", "4096"),
    ("RJT_CARD_FEEDBACK", "off"), ("RJT_GENERAL_JOIN", "sort3"),
])
@pytest.mark.parametrize("mode", ["fused", "shared"])
def test_knobs_on_card_keep_the_rows(job_plans, knob, value, mode,
                                     monkeypatch):
    plans, fused_results, ctx = job_plans
    monkeypatch.setenv("RJT_EXEC_MODE", mode)
    monkeypatch.setenv(knob, value)
    for shape in ("s1", "s2", "f64"):
        for _run in ("cold", "warm"):
            _assert_same_rows(rt.execute(plans[shape], ctx),
                              fused_results[shape])
