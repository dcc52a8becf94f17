"""The result page encode on the device (``kernels.encode_pages_aligned``)
and the fused route that takes it.

``encode_pages_aligned_plain`` (the version the CPU runs) must be bit-equal
to ``encode_fixed_aligned`` of both packages; on ``build_context("cpu")``
the job shapes' fixed-width result columns come back as row-aligned pages,
materialised, that decode to the oracle's rows and that a later plan
decodes on the device. The kernel itself is held to the plain version on
the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from radixjoin_tpu.dtypes import DataType as RefDataType
from radixjoin_tpu.storage import device_decode as ref_dd

import radixjoin_tpu_torch as port
from radixjoin_tpu_torch import engine, trace
from radixjoin_tpu_torch.dtypes import PAGE_SIZE, DataType
from radixjoin_tpu_torch.harness import job_shapes, oracle
from radixjoin_tpu_torch.harness.datagen import SyntheticIMDB
from radixjoin_tpu_torch.ops import kernels
from radixjoin_tpu_torch.plan.ir import Plan
from radixjoin_tpu_torch.storage import device_decode as dd
from radixjoin_tpu_torch.storage.columnar import ColumnarTable

FIXED = [DataType.INT32, DataType.INT64, DataType.FP64]
SCALE = 0.0004
NAMES = sorted(set(job_shapes.S1_TABLES + job_shapes.S2_TABLES))
SHAPES = ("s1", "s2", "s3", "f1")


def _column(rng, dtype, n, null_frac):
    """(numpy values, numpy validity, the values as the card keeps them)."""
    if dtype is DataType.FP64:
        vals = rng.normal(size=n) * 1e6
        vals[:4] = [-0.0, np.nan, np.inf, -np.inf][:n]
        held = torch.from_numpy(vals.view(np.int64).copy())
    else:
        npdt = np.int32 if dtype is DataType.INT32 else np.int64
        info = np.iinfo(npdt)
        vals = rng.integers(info.min, info.max, n, endpoint=True).astype(npdt)
        held = torch.from_numpy(vals.copy())
    valid = rng.random(n) >= null_frac
    return vals, valid, held


def _padded(t, pad, fill):
    return torch.cat([t, torch.full((pad,), fill, dtype=t.dtype)])


# ---------------------------------------------------------------------------
# the plain version against both packages' encoders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", FIXED, ids=lambda d: d.name)
@pytest.mark.parametrize("rows", ["0", "1", "R-1", "R", "R+1", "2R+7",
                                  "5000"])
@pytest.mark.parametrize("null_frac", [0.0, 0.3, 1.0])
def test_plain_is_bit_equal_to_both_encoders(dtype, rows, null_frac):
    r = dd.ALIGNED_ROWS[dtype]
    n = eval(rows.replace("R", str(r)))  # noqa: S307 (the ids above)
    rng = np.random.default_rng(n + int(10 * null_frac))
    vals, valid, held = _column(rng, dtype, n, null_frac)
    # padded past n with values and valid rows that must not be encoded
    (got,) = kernels.encode_pages_aligned(
        [_padded(held, 9, -1)], [_padded(torch.from_numpy(valid), 9, True)],
        n, [dtype])
    assert got.dtype == torch.uint8 and got.shape == (-(-n // r), PAGE_SIZE)
    want = dd.encode_fixed_aligned(vals, valid, dtype)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), ref_dd.encode_fixed_aligned(vals, valid,
                                                 RefDataType(int(dtype))))
    if n:
        assert dd.aligned_full_pages(got.numpy(), n, dtype) == n // r


def test_plain_encodes_mixed_columns_in_one_call():
    rng = np.random.default_rng(3)
    n = 2 * 1920 + 5
    cols = [_column(rng, dt, n, 0.25) for dt in FIXED * 6]  # 18 columns
    got = kernels.encode_pages_aligned([c[2] for c in cols],
                                       [torch.from_numpy(c[1]) for c in cols],
                                       n, FIXED * 6)
    assert len(got) == 18
    for pages, (vals, valid, _held), dt in zip(got, cols, FIXED * 6):
        np.testing.assert_array_equal(
            pages.numpy(), dd.encode_fixed_aligned(vals, valid, dt))


def test_wrapper_checks_its_arguments():
    v32 = torch.zeros(10, dtype=torch.int32)
    ok = torch.ones(10, dtype=torch.bool)
    enc = kernels.encode_pages_aligned
    with pytest.raises(TypeError):  # INT64 wants int64 values
        enc([v32], [ok], 10, [DataType.INT64])
    with pytest.raises(TypeError):  # FP64 arrives as its int64 bits
        enc([torch.zeros(10, dtype=torch.float64)], [ok], 10,
            [DataType.FP64])
    with pytest.raises(TypeError):
        enc([v32], [ok], 10, [DataType.VARCHAR])
    with pytest.raises(TypeError):
        enc([v32], [ok.to(torch.uint8)], 10, [DataType.INT32])
    with pytest.raises(ValueError):
        enc([v32], [ok], 11, [DataType.INT32])
    with pytest.raises(ValueError):
        enc([v32], [ok, ok], 10, [DataType.INT32])
    with pytest.raises(ValueError):
        enc([], [], 0, [])
    meta = torch.device("meta")
    with pytest.raises(ValueError):  # no silent fallback off the CPU
        enc([v32.to(meta)], [ok.to(meta)], 10, [DataType.INT32])


def test_least_bytes_reads_each_row_once_and_writes_each_page():
    values = [torch.zeros(100, dtype=torch.int32),
              torch.zeros(100, dtype=torch.int64)]
    valids = [torch.zeros(100, dtype=torch.bool)] * 2
    for n, pages32, pages64 in ((0, 0, 0), (1, 1, 1), (100, 1, 1)):
        assert kernels.least_bytes(
            "encode_pages_aligned", values, valids, n,
            [DataType.INT32, DataType.INT64]) == (
            5 * n + 9 * n + (pages32 + pages64) * PAGE_SIZE)


# ---------------------------------------------------------------------------
# the fused route on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tables():
    out = SyntheticIMDB(scale=SCALE, seed=0).generate(NAMES)
    out.update(job_shapes.f64_tables(n=3000, seed=1))
    return out


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for knob in ("RJT_EXEC_MODE", "RJT_HBM_BUDGET_BYTES"):
        monkeypatch.delenv(knob, raising=False)
    engine.clear_device_caches()
    yield
    if trace.ON:
        trace.stop()
    engine.clear_device_caches()


def _plan(tables, shape):
    build = job_shapes.f64_plan if shape == "f1" else getattr(
        job_shapes, f"{shape}_plan")
    return build(tables, lazy=shape != "s1")


def _fixed(plan):
    return [dt for _ci, dt in plan.nodes[plan.root].output_attrs
            if dt is not DataType.VARCHAR]


def _assert_aligned_result(result, plan):
    """Every column materialised; every fixed-width one row-aligned; the
    rows the oracle gives."""
    assert [c.type for c in result.columns] == [
        dt for _ci, dt in plan.nodes[plan.root].output_attrs]
    for col in result.columns:
        assert not callable(col._pages)
        assert isinstance(col.pages, np.ndarray)
        if col.type is not DataType.VARCHAR:
            assert dd.aligned_full_pages(
                col.pages, result.num_rows, col.type) == (
                result.num_rows // dd.ALIGNED_ROWS[col.type])
    ok, msg = oracle.rows_equal(result.to_host().to_rows(),
                                oracle.execute_plan_rows(plan))
    assert ok, msg


@pytest.mark.parametrize("shape", SHAPES)
def test_execute_returns_aligned_pages_of_the_oracles_rows(tables, shape):
    plan, ctx = _plan(tables, shape), port.build_context("cpu")
    for _ in range(2):  # cold, then warm on the learned buckets
        before = engine.ENCODE_STATS.snapshot()
        result = port.execute(plan, ctx)
        after = engine.ENCODE_STATS.snapshot()
        assert result.num_rows > 0
        _assert_aligned_result(result, plan)
        assert (after["on_card_columns"] - before["on_card_columns"]
                == len(_fixed(plan)))
        assert after["on_card_pages"] - before["on_card_pages"] == sum(
            -(-result.num_rows // dd.ALIGNED_ROWS[dt]) for dt in _fixed(plan))


def test_execute_many_returns_aligned_pages_of_the_oracles_rows(tables):
    plans = [_plan(tables, shape) for shape in SHAPES]
    ctx = port.build_context("cpu")
    for _ in range(2):
        before = engine.ENCODE_STATS.snapshot()["on_card_columns"]
        results = port.execute_many(plans, ctx)
        assert engine.ENCODE_STATS.snapshot()["on_card_columns"] - before == (
            sum(len(_fixed(p)) for p in plans))
        for result, plan in zip(results, plans):
            _assert_aligned_result(result, plan)


def test_on_card_columns_are_traced_with_their_pages(tables):
    plan, ctx = _plan(tables, "s1"), port.build_context("cpu")
    port.execute(plan, ctx)
    trace.start()
    result = port.execute(plan, ctx)
    log = trace.stop()
    spans = [sp for sp in log.spans if sp.name == "encode.column"]
    on_card = [sp for sp in spans if sp.attrs.get("on_card")]
    assert [sp.attrs["dtype"] for sp in on_card] == [
        dt.name for dt in _fixed(plan)]
    assert all(sp.attrs["rows"] == result.num_rows for sp in on_card)
    assert [sp.attrs["pages"] for sp in on_card] == [
        len(c.pages) for c in result.columns
        if c.type is not DataType.VARCHAR]
    # the host encodes the VARCHAR column alone, inside ``encode``
    (encode,) = [sp for sp in log.spans if sp.name == "encode"]
    assert [sp.attrs["dtype"] for sp in spans if sp.parent == encode.id] == [
        "VARCHAR"]
    (req,) = log.requests
    assert req.counters["encode.on_card_columns"] == len(on_card)
    assert req.counters["encode.on_card_pages"] == sum(
        sp.attrs["pages"] for sp in on_card)
    assert req.counters["fetch.rounds"] == 2


def test_the_root_fetch_brings_pages_not_values(tables):
    plan, ctx = _plan(tables, "s2"), port.build_context("cpu")
    port.execute(plan, ctx)
    trace.start()
    result = port.execute(plan, ctx)
    log = trace.stop()
    (root,) = [sp for sp in log.spans
               if sp.name == "fetch" and sp.attrs["kind"] == "root"]
    assert root.attrs["bytes"] == sum(c.pages.nbytes for c in result.columns)
    assert not [sp for sp in log.spans if sp.name == "decode.column"]


def test_a_result_fed_back_takes_the_device_decode(tables, monkeypatch):
    ctx = port.build_context("cpu")
    first = port.execute(_plan(tables, "s2"), ctx)  # movie, keyword, person
    decoded = []
    real = dd.decode_fixed_device

    def spy(pages, num_rows, dtype, device):
        decoded.append((id(pages), num_rows))
        return real(pages, num_rows, dtype, device)

    monkeypatch.setattr(dd, "decode_fixed_device", spy)
    plan = Plan()
    plan.new_input(first)
    plan.new_input(ColumnarTable.from_host(tables["title"]))
    res = plan.new_scan_node(0, [(0, DataType.INT32), (2, DataType.INT32)])
    title = plan.new_scan_node(1, [(0, DataType.INT32), (4, DataType.INT32)])
    plan.root = plan.new_join_node(True, title, res, 0, 0, [
        (0, DataType.INT32), (1, DataType.INT32), (3, DataType.INT32)])
    again = port.execute(plan, ctx)
    fed = {id(first.columns[0].pages), id(first.columns[2].pages)}
    assert fed <= {p for p, _n in decoded}
    assert all(n == first.num_rows for p, n in decoded if p in fed)
    _assert_aligned_result(again, plan)


@pytest.mark.parametrize("mode", ["shared", "stepwise", "spill"])
def test_other_routes_encode_on_the_host_and_keep_the_rows(tables, mode,
                                                           monkeypatch):
    plan, ctx = _plan(tables, "s1"), port.build_context("cpu")
    want = port.execute(plan, ctx).to_host().to_rows()
    if mode == "spill":
        monkeypatch.setenv("RJT_HBM_BUDGET_BYTES", "4096")
    else:
        monkeypatch.setenv("RJT_EXEC_MODE", mode)
    before = engine.ENCODE_STATS.snapshot()
    result = port.execute(plan, ctx)
    assert engine.ENCODE_STATS.snapshot() == before
    for col in result.columns:
        assert isinstance(col.pages, np.ndarray)
    ok, msg = oracle.rows_equal(result.to_host().to_rows(), want)
    assert ok, msg
