"""The pinned fetch pool (``radixjoin_tpu_torch/pinned_pool.py``) and the
engine's fetches through it (``engine._fetch``, ``engine._PendingFetch``).

On the CPU the pool's allocator is injected (plain CPU tensors): the size
classes, the bound's arithmetic, a block's return only after the last
array over it dies, the capacity turning copies away, threads sharing one
pool, and whole plans executed on the CPU with the pool engaged. The
``cuda`` tests fetch into real pinned blocks on the card. This file
imports neither jax nor radixjoin_tpu, so it also runs on a machine with
the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_pinned_fetch.py
"""

import gc
import sys
import threading

import numpy as np
import pytest
import torch

import radixjoin_tpu_torch as rt
from radixjoin_tpu_torch import engine, pinned_pool, trace
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.harness.datagen import SyntheticIMDB

MIB = 1 << 20


def _cpu_alloc(made):
    def alloc(nbytes):
        block = torch.empty(nbytes, dtype=torch.uint8)
        made.append(block)
        return block
    return alloc


def _pool(capacity, made=None):
    stats = trace.Counters("test_fetch_pool", engine.FETCH_STATS)
    return pinned_pool.PinnedPool(capacity, stats,
                                  _cpu_alloc([] if made is None else made))


def _source(dtype, n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(n, generator=gen) < 0.5
    if dtype == torch.uint8:
        return torch.randint(0, 256, (n // 8192, 8192), generator=gen,
                             dtype=torch.uint8)
    top = 1 << (31 if dtype == torch.int32 else 62)
    return torch.randint(-top, top, (n,), generator=gen, dtype=dtype)


@pytest.mark.parametrize("nbytes,size", [
    (0, 1), (1, 1), (3, 4), (2 * MIB, 2 * MIB), (2 * MIB + 1, 4 * MIB),
    (32 * MIB, 32 * MIB), (339_185_664, 512 * MIB),   # an S2 root column
    (154_451_968, 256 * MIB)])                        # an S3 root column
def test_size_class(nbytes, size):
    assert pinned_pool.size_class(nbytes) == size


@pytest.mark.parametrize("mem_kib,bound", [
    (96 * MIB, 12 << 30),          # 96 GiB: an eighth
    (128 * MIB, 16 << 30),         # 128 GiB: an eighth is the ceiling
    (2048 * MIB, 16 << 30),        # 2 TiB: the ceiling
    (8 * MIB, 1 << 30),            # 8 GiB: an eighth
    (None, 0)])                    # no MemTotal line: no pool
def test_bound_bytes(tmp_path, mem_kib, bound):
    lines = ["MemFree:        1234 kB"]
    if mem_kib is not None:
        lines.insert(0, f"MemTotal:       {mem_kib} kB")
    path = tmp_path / "meminfo"
    path.write_text("\n".join(lines) + "\n")
    assert pinned_pool.bound_bytes(str(path)) == bound


def test_bound_bytes_without_the_file(tmp_path):
    assert pinned_pool.bound_bytes(str(tmp_path / "absent")) == 0


def test_bound_bytes_reads_this_host():
    bound = pinned_pool.bound_bytes()
    assert 0 <= bound <= pinned_pool.CEILING_BYTES


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.int64,
                                   torch.bool])
def test_copy_lands_the_bytes(dtype):
    pool = _pool(64 * MIB)
    src = _source(dtype, 3 * MIB)
    out = pool.copy(src, None)
    assert pinned_pool.pooled(out)
    assert out.dtype == src.numpy().dtype and out.shape == tuple(src.shape)
    assert out.tobytes() == src.numpy().tobytes()
    assert pool._stats["pinned_arrays"] == 1
    assert pool._stats["pinned_bytes"] == src.nbytes


@pytest.mark.parametrize("keep", ["array", "view", "from_numpy", "column"])
def test_block_returns_only_after_the_last_view(keep):
    made = []
    pool = _pool(64 * MIB, made)
    src = _source(torch.uint8, 4 * MIB, seed=1)
    out = pool.copy(src, None)
    if keep == "view":
        held = out[7:9].view(np.int32)
    elif keep == "from_numpy":
        held = torch.from_numpy(out)[3]
    elif keep == "column":
        held = rt.Column(rt.DataType.INT32, out)
    else:
        held = out
    del out
    gc.collect()
    assert pool.free_blocks() == 0
    # a second copy of the same class while the first is held: a new block
    other = pool.copy(_source(torch.uint8, 4 * MIB, seed=2), None)
    assert len(made) == 2
    assert not np.shares_memory(other, np.asarray(made[0]))
    want = src.numpy().copy()
    got = held.pages if keep == "column" else held
    want = {"array": want, "view": want[7:9].view(np.int32),
            "from_numpy": want[3], "column": want}[keep]
    np.testing.assert_array_equal(np.asarray(got), want)
    del held, got, other
    gc.collect()
    assert pool.free_blocks() == 2
    # both come back and serve the next copies: no new block
    again = [pool.copy(_source(torch.uint8, 4 * MIB, seed=3), None)
             for _ in range(2)]
    assert len(made) == 2 and pool._stats["pool_allocs"] == 2
    assert pool.made_bytes == 8 * MIB
    del again


def test_capacity_turns_copies_away():
    made = []
    pool = _pool(8 * MIB, made)
    src = _source(torch.int64, MIB)             # 8 MiB, one whole class
    first = pool.copy(src, None)
    assert pool.copy(src, None) is None         # past the capacity
    assert pool._stats["pageable_fallbacks"] == 1
    assert pool.copy(_source(torch.int32, 16), None) is None  # any class
    assert pool._stats["pageable_fallbacks"] == 2
    assert pool.made_bytes == 8 * MIB and len(made) == 1
    del first
    second = pool.copy(src, None)               # the block came back
    np.testing.assert_array_equal(second, src.numpy())
    assert len(made) == 1 and pool._stats["pool_bytes"] == 8 * MIB


def test_block_waits_for_its_last_copy():
    class Event:
        waited = 0

        def synchronize(self):
            Event.waited += 1

    pool = _pool(8 * MIB)
    out = pool.copy(_source(torch.int32, 16), Event())
    del out
    assert Event.waited == 0
    pool.copy(_source(torch.int32, 16), None)
    assert Event.waited == 1


def test_threads_share_one_pool():
    """More threads than cores copy, check and drop arrays through a pool
    smaller than their demand: no array is ever overwritten while held,
    and the pool never passes its capacity."""
    made = []
    pool = _pool(12 * MIB, made)
    errors = []

    def worker(seed):
        for i in range(60):
            src = torch.full((MIB,), seed * 1000 + i, dtype=torch.int32)
            out = pool.copy(src, None)
            if out is None:
                continue
            for _ in range(3):
                if not (out == seed * 1000 + i).all():
                    errors.append((seed, i))
            del out

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert pool.made_bytes <= 12 * MIB and len(made) <= 3
    assert pool.free_blocks() == len(made)


# -- the engine's fetches through the pool, on the CPU ------------------------


class _NoEvent:
    """What ``torch.cuda.Event`` gives the engine in the CPU tests: a CPU
    copy is done when it returns."""

    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def cpu_pool(monkeypatch):
    """The engine's fetch pool over CPU blocks for CPU tensors of at least
    4 KiB, with a bound of 128 MiB; yields the blocks made."""
    made = []
    pool = pinned_pool.PinnedPool(128 * MIB, engine.FETCH_STATS,
                                  _cpu_alloc(made))
    monkeypatch.setattr(engine, "_FETCH_POOL", pool)
    monkeypatch.setattr(pinned_pool, "eligible",
                        lambda t: t.nbytes >= 4096)
    monkeypatch.setattr(engine.torch.cuda, "Event", _NoEvent)
    yield made


@pytest.fixture(scope="module")
def job_tables():
    return SyntheticIMDB(scale=0.002, seed=0).generate(
        sorted(set(job_shapes.S1_TABLES + job_shapes.S2_TABLES)))


def _page_arrays(result):
    return [c.pages for c in result.columns]


def test_fetch_through_the_pool_matches_cpu(cpu_pool):
    tensors = [_source(torch.uint8, 6 * 8192), _source(torch.int32, 100),
               _source(torch.int64, 4096), _source(torch.bool, 5000)]
    before = engine.FETCH_STATS.snapshot()
    out = engine._fetch(tensors)
    after = engine.FETCH_STATS.snapshot()
    assert [pinned_pool.pooled(a) for a in out] == [True, False, True, True]
    for a, t in zip(out, tensors):
        assert a.dtype == t.numpy().dtype and a.tobytes() == t.numpy().tobytes()
    assert after["pinned_arrays"] - before["pinned_arrays"] == 3
    assert after["rounds"] - before["rounds"] == 1


def _assert_disjoint(arrays):
    for i, a in enumerate(arrays):
        for b in arrays[i + 1:]:
            assert not np.shares_memory(a, b)


def _assert_pages_equal(result, want):
    got = _page_arrays(result)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shapes", [("s2", "s3"), ("s3", "s1")])
def test_held_results_stay_byte_exact(cpu_pool, job_tables, shapes):
    """Results of two plans in turns, every one held: a plan's root
    columns of pages land in pool blocks of one size class, so a block
    handed out while a held result views it would be overwritten by
    another column's pages."""
    plans = {s: getattr(job_shapes, f"{s}_plan")(job_tables, lazy=True)
             for s in shapes}
    ctx = rt.build_context("cpu")
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pinned_pool, "eligible", lambda t: False)
        for s in shapes:
            want[s] = [p.copy() for p in _page_arrays(rt.execute(
                getattr(job_shapes, f"{s}_plan")(job_tables, lazy=True),
                ctx))]
    before = engine.FETCH_STATS.snapshot()
    held = [(s, rt.execute(plans[s], ctx)) for _ in range(3) for s in shapes]
    after = engine.FETCH_STATS.snapshot()
    assert after["pinned_arrays"] > before["pinned_arrays"]
    assert after["pageable_fallbacks"] == before["pageable_fallbacks"]
    pooled = [a for _s, r in held for a in _page_arrays(r)
              if pinned_pool.pooled(a)]
    assert pooled
    _assert_disjoint(pooled)
    del pooled
    for s, result in held:
        _assert_pages_equal(result, want[s])
    made = len(cpu_pool)
    del held, result
    gc.collect()
    assert engine._FETCH_POOL.free_blocks() == made
    # a warm repeat takes blocks that came back: no new one
    for s in shapes:
        _assert_pages_equal(rt.execute(plans[s], ctx), want[s])
    assert len(cpu_pool) == made
    assert engine.FETCH_STATS["pool_allocs"] == after["pool_allocs"]


def test_results_stay_correct_at_the_bound(cpu_pool, job_tables,
                                           monkeypatch):
    """A pool whose bound holds one block: the fetches past it take the
    pageable way, counted, and the results are the same."""
    monkeypatch.setattr(engine, "_FETCH_POOL", pinned_pool.PinnedPool(
        2 * MIB, engine.FETCH_STATS, _cpu_alloc([])))
    ctx = rt.build_context("cpu")
    plan = job_shapes.s2_plan(job_tables, lazy=True)
    before = engine.FETCH_STATS.snapshot()
    held = [rt.execute(plan, ctx) for _ in range(3)]
    after = engine.FETCH_STATS.snapshot()
    assert after["pinned_arrays"] > before["pinned_arrays"]
    assert after["pageable_fallbacks"] > before["pageable_fallbacks"]
    assert engine._FETCH_POOL.made_bytes <= 2 * MIB
    want = _page_arrays(held[0])
    for result in held[1:]:
        _assert_pages_equal(result, want)


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.fixture
def fresh_pool(cuda_device, monkeypatch):
    """A new fetch pool on the card, with the bound the engine computes."""
    monkeypatch.setattr(engine, "_FETCH_POOL", None)
    yield
    gc.collect()


def _cuda_source(dev, dtype, n):
    gen = torch.Generator(device=dev).manual_seed(n)
    if dtype == torch.bool:
        return torch.rand(n, generator=gen, device=dev) < 0.5
    if dtype == torch.uint8:
        return torch.randint(0, 256, (n // 8192, 8192), generator=gen,
                             device=dev, dtype=torch.uint8)
    top = 1 << (31 if dtype == torch.int32 else 62)
    return torch.randint(-top, top, (n,), generator=gen, device=dev,
                         dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.int64,
                                   torch.bool])
@pytest.mark.parametrize("above", [False, True])
def test_cuda_fetch_matches_cpu(cuda_device, fresh_pool, dtype, above):
    itemsize = torch.empty(0, dtype=dtype).element_size()
    n = (pinned_pool.MIN_BYTES + (3 << 20 if above else -8192)) // itemsize
    tensors = [_cuda_source(cuda_device, dtype, n),
               _cuda_source(cuda_device, torch.int32, 1000)]
    before = engine.FETCH_STATS.snapshot()
    out = engine._fetch(tensors)
    after = engine.FETCH_STATS.snapshot()
    assert [pinned_pool.pooled(a) for a in out] == [above, False]
    assert after["pinned_arrays"] - before["pinned_arrays"] == int(above)
    for a, t in zip(out, tensors):
        want = t.cpu().numpy()
        assert a.dtype == want.dtype and a.shape == want.shape
        assert a.tobytes() == want.tobytes()


def _big_tables(shape):
    # roots of about 11.9 M (S2) and 9.1 M (S3) rows: every fixed-width
    # root column is 46-50 MB of pages, over the pool's size
    scale = {"s2": 0.15, "s3": 0.25}[shape]
    tables = job_shapes.S2_TABLES if shape == "s2" else job_shapes.S3_TABLES
    return SyntheticIMDB(scale=scale, seed=0).generate(sorted(tables))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["s2", "s3"])
def test_cuda_held_results_match_cpu(fresh_pool, shape):
    """A joingraph-shaped plan executed three times with every result
    held: each root column lands in a pool block of its own, and all
    three equal the port's result on the CPU byte for byte; then a batch
    of two (``execute_many``, the pending fetch) draws from the same pool."""
    tables = _big_tables(shape)
    build = getattr(job_shapes, f"{shape}_plan")
    plan = build(tables, lazy=True)
    want = _page_arrays(rt.execute(build(tables, lazy=True),
                                   rt.build_context("cpu")))
    assert all(w.nbytes >= pinned_pool.MIN_BYTES for w in want)
    ctx = rt.build_context()
    before = engine.FETCH_STATS.snapshot()
    held = [rt.execute(plan, ctx) for _ in range(3)]
    held += rt.execute_many([build(tables, lazy=True) for _ in range(2)], ctx)
    after = engine.FETCH_STATS.snapshot()
    assert after["pinned_arrays"] - before["pinned_arrays"] == 5 * len(want)
    assert after["pageable_fallbacks"] == before["pageable_fallbacks"]
    pages = [a for r in held for a in _page_arrays(r)]
    assert all(pinned_pool.pooled(a) for a in pages)
    _assert_disjoint(pages)
    for result in held:
        _assert_pages_equal(result, want)


@pytest.mark.cuda
def test_cuda_fallback_at_the_bound(fresh_pool, monkeypatch):
    """The bound lowered to one root column's block: the other columns
    take the pageable way, counted, and the results stay correct."""
    tables = _big_tables("s3")
    plan = job_shapes.s3_plan(tables, lazy=True)
    want = _page_arrays(rt.execute(job_shapes.s3_plan(tables, lazy=True),
                                   rt.build_context("cpu")))
    monkeypatch.setattr(pinned_pool, "CEILING_BYTES",
                        pinned_pool.size_class(want[0].nbytes))
    ctx = rt.build_context()
    before = engine.FETCH_STATS.snapshot()
    held = [rt.execute(plan, ctx) for _ in range(2)]
    after = engine.FETCH_STATS.snapshot()
    assert engine._FETCH_POOL.made_bytes <= pinned_pool.CEILING_BYTES
    assert after["pinned_arrays"] - before["pinned_arrays"] == 1
    assert (after["pageable_fallbacks"] - before["pageable_fallbacks"]
            == 2 * len(want) - 1)
    for result in held:
        _assert_pages_equal(result, want)


@pytest.mark.cuda
def test_cuda_warm_repeat_makes_no_block(fresh_pool):
    tables = _big_tables("s2")
    plan = job_shapes.s2_plan(tables, lazy=True)
    ctx = rt.build_context()
    first = rt.execute(plan, ctx)
    del first
    gc.collect()
    before = engine.FETCH_STATS.snapshot()
    for _ in range(3):
        rt.execute(plan, ctx)
    after = engine.FETCH_STATS.snapshot()
    assert after["pinned_arrays"] > before["pinned_arrays"]
    assert after["pool_allocs"] == before["pool_allocs"]
    assert after["pool_bytes"] == before["pool_bytes"]
