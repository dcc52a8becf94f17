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
from radixjoin_tpu_torch.dtypes import DataType
from radixjoin_tpu_torch.harness import job_shapes
from radixjoin_tpu_torch.harness.datagen import SyntheticIMDB
from radixjoin_tpu_torch.ops import kernels
from radixjoin_tpu_torch.plan import fused
from radixjoin_tpu_torch.storage import device_decode as dd


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


def _pages(cuda_device, npages):
    """A page count, or "2 x grid + 1": more than twice the blocks the
    kernel's 256-thread blocks can hold at once (8 an SM at most), so that
    every block's ring of page slots turns over more than once."""
    if npages != "2 x grid + 1":
        return npages
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    return 2 * 8 * sms + 1


def _paged_inputs(dev, npages, w, ro, lo=0, hi=None):
    gen = torch.Generator(device=dev).manual_seed(npages * 7 + ro + w)
    body = _rand(gen, dev, npages * w, torch.int32).view(npages, w)
    idx = torch.randint(lo, w if hi is None else hi, (npages, ro),
                        generator=gen, device=dev, dtype=torch.int32)
    return body, idx


def _one_word_off(t):
    """A copy of ``t`` that starts 4 bytes past a 16-byte boundary."""
    pool = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = pool[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("w", [2048, 12288])
@pytest.mark.parametrize("ro", [128, 1920, 3840, 1924])
@pytest.mark.parametrize("npages", [1, 131, 1900, "2 x grid + 1"])
def test_cuda_paged_window_gather_matches_plain(cuda_device, npages, ro, w):
    npages = _pages(cuda_device, npages)
    body, idx = _paged_inputs(cuda_device, npages, w, ro)
    kernels.reset_launch_counts()
    got = kernels.paged_window_gather(body, idx)
    torch.cuda.synchronize()
    assert kernels.paged_window_gather.last_route == "vector"
    assert kernels.launch_counts()["paged_window_gather"] == 1
    assert torch.equal(got, kernels.paged_window_gather_plain(body, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("npages", [1, 131, "2 x grid + 1"])
def test_cuda_paged_window_gather_both_routes(cuda_device, npages):
    npages = _pages(cuda_device, npages)
    body, idx = _paged_inputs(cuda_device, npages, 2048, 1920)
    want = kernels.paged_window_gather_plain(body, idx)
    off_body, off_idx = _one_word_off(body), _one_word_off(idx)
    for b, i, route in ((body, idx, "vector"), (off_body, idx, "scalar"),
                        (body, off_idx, "scalar"),
                        (off_body, off_idx, "scalar")):
        got = kernels.paged_window_gather(b, i)
        torch.cuda.synchronize()
        assert kernels.paged_window_gather.last_route == route
        assert torch.equal(got, want)
    # a width and a row count that are no multiples of 4
    b, i = body[:, :2046].contiguous(), idx[:, :1922].clamp(max=2045)
    got = kernels.paged_window_gather(b, i.contiguous())
    torch.cuda.synchronize()
    assert kernels.paged_window_gather.last_route == "scalar"
    assert torch.equal(got, kernels.paged_window_gather_plain(b, i))


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_paged_window_gather_clamps_indices(cuda_device, aligned):
    w = 2048
    body, idx = _paged_inputs(cuda_device, 300, w, 1920, lo=-5, hi=w + 5)
    idx[0, :4] = torch.tensor([-(2 ** 31), 2 ** 31 - 1, -1, w],
                              dtype=torch.int32, device=cuda_device)
    if not aligned:
        body, idx = _one_word_off(body), _one_word_off(idx)
    got = kernels.paged_window_gather(body, idx)
    torch.cuda.synchronize()
    assert kernels.paged_window_gather.last_route == (
        "vector" if aligned else "scalar")
    assert torch.equal(got, kernels.paged_window_gather_plain(body, idx))
    assert torch.equal(got[0, :4], torch.stack(
        [body[0, 0], body[0, w - 1], body[0, 0], body[0, w - 1]]))


@pytest.mark.cuda
def test_cuda_paged_window_gather_widths_across_threads(cuda_device):
    # the shared-memory opt-in is a setting of the whole process: a narrow
    # page launched from another thread must not lower it under a wide one
    import threading

    inputs = {w: _paged_inputs(cuda_device, 400, w, 1920)
              for w in (12288, 8192, 2048)}
    errors = []

    def run(widths):
        try:
            for w in widths:
                body, idx = inputs[w]
                got = kernels.paged_window_gather(body, idx)
                torch.cuda.synchronize()
                assert torch.equal(
                    got, kernels.paged_window_gather_plain(body, idx))
        except Exception as exc:  # handed to the test's thread
            errors.append(exc)

    for widths in ((12288,), (8192, 2048), (12288, 8192, 12288)):
        t = threading.Thread(target=run, args=(widths,))
        t.start()
        t.join()
    assert not errors, errors


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [DataType.INT32, DataType.INT64,
                                   DataType.FP64])
def test_cuda_device_decode_matches_cpu(cuda_device, dtype):
    rng = np.random.default_rng(int(dtype))
    r = dd.ALIGNED_ROWS[dtype]
    n = 300 * r + 77  # full pages and a remainder page
    if dtype is DataType.FP64:
        vals = rng.normal(size=n) * 1e6
        vals[:3] = [-0.0, np.nan, np.inf]
    else:
        npdt = np.int32 if dtype is DataType.INT32 else np.int64
        info = np.iinfo(npdt)
        vals = rng.integers(info.min, info.max, n, endpoint=True).astype(npdt)
    valid = rng.random(n) >= 0.25
    valid[:r], valid[r:2 * r] = False, True  # an all-NULL, an all-valid page
    pages = dd.encode_fixed_aligned(vals, valid, dtype)
    kernels.reset_launch_counts()
    data, dvalid = dd.decode_fixed_device(pages, n, dtype, cuda_device)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_window_gather"] == 1
    want, want_valid = dd.decode_fixed_device(pages, n, dtype, "cpu")
    assert data.dtype == want.dtype
    assert torch.equal(data.cpu(), want)
    assert torch.equal(dvalid.cpu(), want_valid)


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


# ---------------------------------------------------------------------------
# the distributed layer: a one-rank NCCL group on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl_meshes(cuda_device):
    """A one-rank NCCL group on the card (``multihost.init`` with no device
    takes the card and NCCL) and a gloo group over the same rank for the
    CPU route; both left at teardown."""
    import socket

    import torch.distributed as dist

    from radixjoin_tpu_torch.parallel import make_mesh, multihost

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    multihost.init(f"localhost:{port}", 1, 0)
    try:
        on_card = make_mesh()
        on_cpu = make_mesh(group=dist.new_group(backend="gloo"),
                           device="cpu")
        assert on_card.backend == "nccl" and on_card.device.type == "cuda"
        yield on_card, on_cpu
    finally:
        dist.destroy_process_group()


def _dist_case_inputs(n_build, n_probe, seed):
    rng = np.random.default_rng(seed)
    bk = rng.integers(0, n_build, n_build).astype(np.int64)
    pk = rng.integers(0, 2 * n_build, n_probe).astype(np.int64)
    pk[rng.random(n_probe) < 0.3] = 7  # a hot key
    return (bk, rng.random(n_build) > 0.05,
            {"x": rng.integers(0, 1 << 30, n_build).astype(np.int32),
             "f": rng.random(n_build) > 0.5},
            pk, rng.random(n_probe) > 0.05,
            {"y": np.arange(n_probe, dtype=np.int64)})


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("sizes", [(300, 1000), (20_000, 200_000)])
def test_dist_join_on_card_equals_cpu_route(nccl_meshes, sizes, chunks):
    """distributed_join over NCCL on the card and over gloo on the CPU:
    the same rows in the same order, totals and info; the expansion
    launched the window gather (tables of at most 4096 entries) or the
    blocked-window gather (larger ones)."""
    from radixjoin_tpu_torch.parallel import DistJoinConfig, distributed_join
    from radixjoin_tpu_torch.parallel.dist_join import collect_to_host

    on_card, on_cpu = nccl_meshes
    args = _dist_case_inputs(*sizes, seed=sizes[0])
    config = DistJoinConfig(exchange_chunks=chunks)
    out = []
    kernels.reset_launch_counts()
    for mesh in (on_card, on_cpu):
        info = {}
        columns, live, totals = distributed_join(*args, mesh=mesh,
                                                 config=config, info_out=info)
        out.append((collect_to_host(columns, live, mesh), totals, info))
    torch.cuda.synchronize()
    (rows_g, tot_g, info_g), (rows_c, tot_c, info_c) = out
    np.testing.assert_array_equal(tot_g, tot_c)
    assert {k: v for k, v in info_g.items() if k != "hot_keys"} == {
        k: v for k, v in info_c.items() if k != "hot_keys"}
    for k in rows_c:
        assert rows_g[k].dtype == rows_c[k].dtype
        np.testing.assert_array_equal(rows_g[k], rows_c[k])
    counts = kernels.launch_counts()
    small = sum(sizes) <= kernels.WINDOW_GATHER_MAX
    assert counts["window_gather" if small
                  else "blocked_window_gather_multi"] > 0


@pytest.mark.cuda
def test_execute_distributed_on_card_equals_cpu_route(nccl_meshes):
    """Tiny S1 and F1 through execute_distributed cold and warm on the card
    (NCCL) and on the CPU (gloo): the same rows in the same order; the
    expansion's gather kernels launched on the card."""
    from radixjoin_tpu_torch.parallel import dist_executor, multihost
    from radixjoin_tpu_torch.tools.multihost_worker import table_columns

    on_card, on_cpu = nccl_meshes
    tables = SyntheticIMDB(scale=0.002, seed=0).generate(
        list(job_shapes.S1_TABLES))
    tables.update(job_shapes.f64_tables(20_000))
    kernels.reset_launch_counts()
    for build, lazy in ((job_shapes.s1_plan, False),
                        (job_shapes.f64_plan, True)):
        want = dist_executor.execute_distributed(build(tables, lazy=lazy),
                                                 mesh=on_cpu)
        plan = build(tables, lazy=lazy)
        for run in ("cold", "warm"):
            before = multihost.collective_stats()["host_syncs"]
            got = dist_executor.execute_distributed(plan, mesh=on_card)
            syncs = multihost.collective_stats()["host_syncs"] - before
            assert got.num_rows == want.num_rows > 0
            for (gv, gx), (wv, wx) in zip(table_columns(got),
                                          table_columns(want)):
                np.testing.assert_array_equal(gv, wv)
                if gx.dtype == np.float64:  # by bit pattern (NaN, -0.0)
                    gx, wx = gx.view(np.int64), wx.view(np.int64)
                np.testing.assert_array_equal(gx, wx)
            if run == "warm":
                assert syncs == 2  # the root's check and its gather
    counts = kernels.launch_counts()
    assert counts["window_gather"] > 0
    assert counts["blocked_window_gather_multi"] > 0


@pytest.mark.cuda
def test_make_mesh_without_a_group_raises(cuda_device):
    import torch.distributed as dist

    from radixjoin_tpu_torch.parallel import make_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="multihost.init"):
        make_mesh()


# ---------------------------------------------------------------------------
# the tools: the bench, the fuzz campaign, the roofline and scaling benches
# ---------------------------------------------------------------------------


def _repo():
    import os

    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.cuda
def test_bench_on_card_over_the_query_documents(cuda_device):
    """``python -m radixjoin_tpu_torch.bench`` at sf0.01 over the built-in
    documents: one JSON line, backend cuda, no degradation, every bonus
    stage reported (device ms for every query)."""
    import json
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "RJT_"))}
    env.update(BENCH_PLANS="builtin", BENCH_SCALE="0.01", BENCH_REPEAT="1")
    proc = subprocess.run([sys.executable, "-m", "radixjoin_tpu_torch.bench"],
                          cwd=_repo(), env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = proc.stdout.splitlines()
    out = json.loads(line)
    detail = out["detail"]
    assert out["metric"] == "job5_synthetic_sf0.01_total_ms"
    assert detail["backend"] == "cuda" and detail["result_rows"] > 0
    assert not any(v for k, v in detail["degradations"].items()
                   if k != "queries")
    assert detail["device_ms"]["queries_measured"] == 5
    assert detail["batch_wall_ms"] > 0 and "secondary" not in detail


@pytest.mark.cuda
def test_fuzz_campaign_on_card_in_every_mode(cuda_device):
    """16 seeds in all six modes on the card (the distributed ones on a
    one-rank NCCL group the campaign opens and leaves), each held to the
    row oracle; the main path's gather kernels launched."""
    import torch.distributed as dist

    from radixjoin_tpu_torch.tools import fuzz_campaign

    kernels.reset_launch_counts()
    stats = fuzz_campaign.run_campaign(16, 0, fuzz_campaign.MODES)
    assert stats["failures"] == 0
    assert stats["runs"] == {"auto": 16, "shared": 16, "stepwise": 16,
                             "spill": 16, "dist": 32, "dist_chunked": 32}
    assert not dist.is_initialized()
    counts = kernels.launch_counts()
    assert counts["window_gather"] > 0


@pytest.mark.cuda
def test_roofline_on_card(cuda_device):
    from radixjoin_tpu_torch.harness import roofline

    kernels.reset_launch_counts()
    results = roofline.run(1 << 20, reps=2)
    assert [m.kernel for m in results] == [
        "sort_kv[i32]", "murmur64", "join_merge[int32]", "join_count[int32]",
        "join_expand", "gather_payload[i64]", "fused_join_e2e"]
    assert all(m.ms > 0 and m.pct_roofline > 0 for m in results)
    assert all(m.mode in ("graph", "eager") for m in results)
    # the expansion rides the blocked-window kernel on the owner stream
    assert kernels.launch_counts()["blocked_window_gather_multi"] > 0


@pytest.mark.cuda
def test_scaling_bench_one_nccl_rank(cuda_device, tmp_path):
    import json
    import subprocess
    import sys

    from radixjoin_tpu_torch.tools import scaling_bench

    out = tmp_path / "scaling.json"
    proc = subprocess.run(
        [sys.executable, "-m", "radixjoin_tpu_torch.tools.scaling_bench",
         "--ndev", "1", "--rows", "65536", "--breakdown", "--json", str(out)],
        cwd=_repo(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (res,) = json.loads(out.read_text())
    bk, bv, _bpl, pk, pv, _ppl = scaling_bench.make_join_data(1, 65536, 0.2)
    assert res["out_rows"] == int((pv & np.isin(pk, bk[bv])).sum())
    assert res["backend"] == "nccl" and res["device"] == "cuda:0"
    assert res["phase_exchange_ms"] > 0 and res["bytes_sent_per_dev"] > 0
