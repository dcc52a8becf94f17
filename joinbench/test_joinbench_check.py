"""The comparison that decides ``correct``: the benchmark's page reader
against the port's codec, the reference against the port on every plan,
and ``correct`` coming out false for each fault a cell can have and for
the control (the reference in the program's place with NULLs written as
values), through whole runs on the CPU at a small scale. The faults are
planted in the program's output, decoded and encoded again by the port's
own codec; the harness reads it with its own reader."""

import numpy as np
import pytest
import torch

import radixjoin_tpu_torch as rjt
from radixjoin_tpu_torch import DataType
from radixjoin_tpu_torch.storage import page as port_pages

from joinbench import control, digest, pagefmt, run
from joinbench.schema import gather_varlen

ROOT = run.ROOT
CONFIGS = ["job5_imdb_sf1", "joingraph_imdb_sf1"]


def _load(config):
    cell = {"job5_imdb_sf1": "job5_sf1.resident_small_roots",
            "joingraph_imdb_sf1": "joingraph_sf1.resident"}[config]
    return run.Cell(ROOT, cell)


@pytest.mark.parametrize("n", [0, 1, 7, 5000, 70000])
def test_page_reader_reads_the_port_codec(n):
    rng = np.random.default_rng(n)
    valid = rng.random(n) > 0.3
    for type_name, values in (
            ("INT32", rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)),
            ("INT64", rng.integers(-2 ** 62, 2 ** 62, n)),
            ("FP64", rng.random(n))):
        want = np.where(valid, values, 0)
        want = want.view(np.int64) if type_name == "FP64" else want
        pages = port_pages.encode_fixed(values, valid, DataType[type_name])
        codes, got_valid = pagefmt.read_fixed(pages, n, type_name, "cpu")
        assert np.array_equal(got_valid.numpy(), valid)
        assert np.array_equal(codes.numpy(), want.astype(np.int64))
    lengths = rng.integers(0, 40, n)
    lengths[rng.random(n) < 0.001] = 9000  # long-string pages
    strings = [bytes(rng.integers(32, 127, k).astype(np.uint8)) for k in lengths]
    objs = np.empty(n, object)
    objs[:] = strings
    kept = [s if v else b"" for s, v in zip(strings, valid)]
    heap = torch.from_numpy(np.frombuffer(b"".join(kept), np.uint8).copy())
    ends = torch.from_numpy(np.cumsum([len(s) for s in kept]).astype(np.int64))
    want = digest.string_codes(heap, ends, torch.from_numpy(valid))
    codes, got_valid = pagefmt.read_varchar(
        port_pages.encode_varchar(objs, valid), n, "cpu")
    assert np.array_equal(got_valid.numpy(), valid)
    assert torch.equal(codes, want)


def test_string_codes_tell_strings_apart():
    strings = [b"", b"a", b"b", b"ab", b"ba", b"abc", b"a" * 300, b"a" * 301]
    heap = torch.from_numpy(np.frombuffer(b"".join(strings), np.uint8).copy())
    ends = torch.tensor(np.cumsum([len(s) for s in strings]))
    codes = digest.string_codes(heap, ends,
                                torch.ones(len(strings), dtype=torch.bool))
    assert len(set(codes.tolist())) == len(strings)


def test_page_reader_refuses_a_broken_stream():
    values = np.arange(100, dtype=np.int32)
    pages = port_pages.encode_fixed(values, np.ones(100, bool), DataType.INT32)
    with pytest.raises(pagefmt.PageError):
        pagefmt.read_fixed(pages, 99, "INT32", "cpu")
    pages[0, 2] = 7  # the non-null count no longer matches the bitmap
    with pytest.raises(pagefmt.PageError):
        pagefmt.read_fixed(pages, 100, "INT32", "cpu")


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_agrees_with_the_port(config):
    cell = _load(config)
    tables = cell.config.generate(11, scale=0.003)
    ctx = rjt.build_context("cpu")
    for name, plan in cell.config.build_plans(tables).items():
        result = rjt.execute(plan, ctx)
        rel, columns = cell.reference.result(name, tables, "cpu")
        assert result.num_rows > 0, name
        assert digest.digest(*pagefmt.read_columns(result, "cpu")) == \
            digest.digest(*rel.out(columns)), name


def _rows(table):
    """A result's columns as (type name, values or (heap, ends), valid),
    by the port's decode (the faults are planted in the program's output)."""
    out = []
    for col in table.to_host().columns:
        if col.dtype is DataType.VARCHAR:
            out.append(("VARCHAR", (col.heap, col.ends), col.valid))
        else:
            out.append((col.dtype.name, col.values, col.valid))
    return out


def _take(columns, rows):
    out = []
    for type_name, values, valid in columns:
        if type_name == "VARCHAR":
            heap, ends = values
            starts = ends - np.diff(ends, prepend=0)
            values = gather_varlen(heap, starts[rows], (ends - starts)[rows])
        else:
            values = values[rows]
        out.append((type_name, values, valid[rows]))
    return out


def _drop_last(columns):
    n = len(columns[0][2])
    return _take(columns, np.arange(max(n - 1, 0)))


def _half(columns):
    n = len(columns[0][2])
    return _take(columns, np.arange(n // 2))


def _change_value(columns):
    out = list(columns)
    for j, (type_name, values, valid) in enumerate(out):
        if type_name != "VARCHAR" and valid.any():
            values = values.copy()
            values[np.flatnonzero(valid)[0]] += 1
            out[j] = (type_name, values, valid)
            return out
    return out


def _faulty_execute(damage):
    """``execute`` with its answer altered where it is produced."""
    original = rjt.execute

    def execute(plan, context=None):
        columns = damage(_rows(original(plan, context)))
        return control.paged(columns, len(columns[0][2]))

    return execute


def _stale_execute():
    """``execute`` that hands back its first answer, whatever the plan."""
    original = rjt.execute
    first = []

    def execute(plan, context=None):
        if not first:
            first.append(original(plan, context))
        return first[0]

    return execute


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_rows",
                                   "row_dropped", "value_changed",
                                   "null_as_value"])
@pytest.mark.parametrize("cell", ["joingraph_sf1.resident",
                                  "job5_sf1.resident_small_roots"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    execute = (_stale_execute() if fault == "state_unchanged" else
               _faulty_execute({"half_the_rows": _half, "row_dropped": _drop_last,
                                "value_changed": _change_value,
                                "null_as_value": control.null_as_value}[fault]))
    monkeypatch.setattr(rjt, "execute", execute)
    # at scale 0.03 q1a's results hold NULLs (test_the_control_is_not_correct)
    out = run.run_cell(ROOT, cell, 1, 0.5, False, device="cpu",
                       scale=0.03 if cell.startswith("job5") else 0.001)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", ["joingraph_sf1.resident",
                                  "job5_sf1.resident_small_roots"])
def test_the_control_is_not_correct(monkeypatch, cell):
    """The reference in the program's place, NULLs written as values."""
    cell_cls, undo = control.reference_in_place(run.Cell, "cpu")
    monkeypatch.setattr(run, "Cell", cell_cls)
    try:
        for seed in (1, 2, 3):
            # q1a's production_year is the job5 documents' one nullable
            # output column; from scale 0.03 every seed's q1a holds a NULL,
            # with a window long enough to reach every sampled request
            job5 = cell.startswith("job5")
            out = run.run_cell(ROOT, cell, seed, 3.0 if job5 else 0.5, False,
                               device="cpu", scale=0.03 if job5 else 0.001)
            assert out["correct"] is False, (seed, out["checks"])
            assert out["checks"]["results_wrong"]["value"] > 0
    finally:
        undo()


def test_the_reference_in_place_undamaged_is_correct(monkeypatch):
    """Without the damage the same substitution passes: the control fails
    for the NULLs alone."""
    cell_cls, undo = control.reference_in_place(run.Cell, "cpu",
                                                damage=lambda cols: cols)
    monkeypatch.setattr(run, "Cell", cell_cls)
    try:
        out = run.run_cell(ROOT, "joingraph_sf1.resident", 4, 0.5, False,
                           device="cpu", scale=0.001)
        assert out["correct"] is True, out["checks"]
    finally:
        undo()
