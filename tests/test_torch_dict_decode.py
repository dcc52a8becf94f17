"""The root decode of dictionary VARCHAR columns (``StringDict.decode``,
``native.dict_decode``): equal, bytes and dtypes, to the JAX package's
``device_column_to_host`` on a device column of the same ids, validity and
dictionary, to the strings the ids name and to the NumPy composition the
engine decoded with before (the whole dictionary's starts and lengths
indexed by the ids), on the native path and on the NumPy fallback; no
whole-dictionary pass on the route's decode; the counters and the span note
that say it engaged.

Everything runs on the CPU (``build_context("cpu")``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import radixjoin_tpu_torch as port
from radixjoin_tpu import engine as ref_engine
from radixjoin_tpu.dtypes import DataType as RefDataType
from radixjoin_tpu.storage import columnar as ref_columnar
from radixjoin_tpu_torch import engine, trace
from radixjoin_tpu_torch.dtypes import DataType
from radixjoin_tpu_torch.storage import native
from radixjoin_tpu_torch.storage.columnar import (
    DECODE_STATS,
    HostColumn,
    StringDict,
    gather_varlen,
)

from joinbench.configs import job5_imdb_sf1 as job5

I32_MIN, I32_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


def _reference(d: StringDict, ids, valid):
    """The JAX package's root decode of a device column holding ``ids``
    (int32, as every device column's ids are) and ``valid`` over ``d``."""
    assert ids.min(initial=0) >= I32_MIN and ids.max(initial=0) <= I32_MAX
    col = ref_engine.DevColumn(
        RefDataType.VARCHAR, jnp.asarray(ids.astype(np.int32)),
        jnp.asarray(valid), ref_columnar.StringDict(d.heap, d.ends))
    out = ref_engine.device_column_to_host(col, len(valid))
    assert out.dtype is RefDataType.VARCHAR
    return out.heap, out.ends


def _before(d: StringDict, ids, valid):
    """The engine's decode until the native pass: ``starts`` and
    ``lengths`` of the whole dictionary, indexed by the clipped ids."""
    n = len(valid)
    if n == 0 or d.size == 0:
        return np.zeros(0, np.uint8), np.zeros(n, np.int64)
    ids = np.clip(ids, 0, d.size - 1)
    starts = np.where(valid, d.starts[ids], 0)
    lengths = np.where(valid, d.lengths[ids], 0)
    return gather_varlen(d.heap, starts, lengths)


def _random_dict(rng, size, lo=4, hi=19):
    lens = rng.integers(lo, hi, size)
    ends = np.cumsum(lens).astype(np.int64)
    heap = rng.integers(0, 256, int(ends[-1]) if size else 0).astype(np.uint8)
    return StringDict(heap, ends)


def _case_edges(rng):
    d = _random_dict(rng, 1000)
    ids = np.array([0, 999, -1, -7, 1000, 5000, I32_MIN, I32_MAX, 1, 998],
                   np.int64)
    return d, ids, np.ones(len(ids), bool)


def _case_zero_length(rng):
    # empty entries first, between, and last
    d = StringDict.from_objects([b"", b"a", b"", b"bcd", b"", b"", b"e", b""])
    ids = rng.integers(-2, 10, 5000)
    return d, ids, rng.random(5000) < 0.8


def _case_parts(rng):
    # enough rows for the native decode to cut them into four parts on
    # threads of their own: empty entries, ids out of range, a stretch of
    # invalid rows that leaves the second part empty, a row count that
    # does not divide evenly
    d = _random_dict(rng, 1 << 20, lo=0)
    n = 300_001
    valid = rng.random(n) < 0.9
    valid[75_000:150_000] = False
    return d, rng.integers(-10, (1 << 20) + 10, n), valid


CASES = {
    "n0": lambda rng: (_random_dict(rng, 10), np.zeros(0, np.int64),
                       np.zeros(0, bool)),
    "empty_dict": lambda rng: (StringDict.empty(), rng.integers(-3, 3, 50),
                               rng.random(50) < 0.5),
    "empty_dict_n0": lambda rng: (StringDict.empty(), np.zeros(0, np.int64),
                                  np.zeros(0, bool)),
    "all_invalid": lambda rng: (_random_dict(rng, 100),
                                rng.integers(0, 100, 300), np.zeros(300, bool)),
    "edges": _case_edges,
    "zero_length": _case_zero_length,
    "one_entry": lambda rng: (StringDict.from_objects([b"only"]),
                              rng.integers(-5, 5, 200), rng.random(200) < 0.7),
    "4x100k": lambda rng: (StringDict.from_objects(
        [b"distributors", b"production companies", b"special effects",
         b"miscellaneous"]),
        rng.integers(0, 4, 100_000), rng.random(100_000) < 0.9),
    "2^20x1000": lambda rng: (_random_dict(rng, 1 << 20),
                              rng.integers(0, 1 << 20, 1000),
                              rng.random(1000) < 0.9),
    "parts": _case_parts,
}


@functools.lru_cache(maxsize=None)
def _case(name):
    rng = np.random.default_rng(sorted(CASES).index(name))
    d, ids, valid = CASES[name](rng)
    return d, ids, valid, d.objects()


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_equals_the_named_strings_and_the_old_composition(
        case, id_dtype, path, monkeypatch):
    d, ids, valid, objects = _case(case)
    ids = ids.astype(id_dtype) if id_dtype is np.int64 else np.clip(
        ids, I32_MIN, I32_MAX).astype(np.int32)
    want_heap, want_ends = _reference(d, ids, valid)
    old_heap, old_ends = _before(d, ids, valid)
    if path == "numpy":
        monkeypatch.setattr(native, "lib", lambda: None)
    else:
        assert native.lib() is not None
    before = DECODE_STATS.snapshot()
    heap, ends = d.decode(ids, valid)
    after = DECODE_STATS.snapshot()

    # bit for bit, dtypes included, what the JAX package decodes, and what
    # the engine produced before
    assert heap.dtype == want_heap.dtype == old_heap.dtype == np.uint8
    assert ends.dtype == want_ends.dtype == old_ends.dtype == np.int64
    np.testing.assert_array_equal(heap, want_heap)
    np.testing.assert_array_equal(ends, want_ends)
    np.testing.assert_array_equal(heap, old_heap)
    np.testing.assert_array_equal(ends, old_ends)
    # and the strings: the clipped id's entry, empty where invalid
    got = HostColumn.varchar(heap, ends, valid).objects()
    n = len(valid)
    lengths = np.diff(ends, prepend=0)
    assert not lengths[~valid].any()
    if d.size:
        named = objects[np.clip(ids, 0, d.size - 1)]
        want = np.where(valid, named, None)
        assert list(np.where(valid, got, None)) == list(want)
    else:
        assert not lengths.any() and len(heap) == 0
    # counted once, its rows, a fallback only on the NumPy path (a column
    # with no rows or no dictionary is decoded before either)
    assert after["varchar_columns"] - before["varchar_columns"] == 1
    assert after["varchar_rows"] - before["varchar_rows"] == n
    assert after["numpy_fallbacks"] - before["numpy_fallbacks"] == (
        path == "numpy" and n > 0 and d.size > 0)


@pytest.mark.parametrize("case", ["n0", "empty_dict", "empty_dict_n0"])
def test_wrapper_decodes_no_rows_and_no_dictionary(case):
    """``StringDict.decode`` answers these before the native passes; the
    passes give the same answer on their own."""
    d, ids, valid, _objects = _case(case)
    heap, ends = native.dict_decode(d.heap, d.ends, ids, valid)
    want_heap, want_ends = _reference(d, ids, valid)
    assert heap.dtype == np.uint8 and ends.dtype == np.int64
    np.testing.assert_array_equal(heap, want_heap)
    np.testing.assert_array_equal(ends, want_ends)


def test_wrapper_refuses_ids_of_another_length():
    d = _random_dict(np.random.default_rng(0), 10)
    with pytest.raises(ValueError):
        native.dict_decode(d.heap, d.ends, np.zeros(3, np.int32),
                           np.ones(4, bool))


# ---------------------------------------------------------------------------
# the route's decode makes no whole-dictionary pass
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def job5_plans():
    tables = job5.generate(1, scale=0.001)
    return job5.build_plans(tables, ["q1a"])


@pytest.fixture
def no_dictionary_pass(monkeypatch):
    """``StringDict.starts`` / ``lengths``, each a pass over the whole
    dictionary, raise."""
    def whole_dictionary(_self):
        raise AssertionError("a pass over the whole dictionary")

    monkeypatch.setattr(StringDict, "starts", property(whole_dictionary))
    monkeypatch.setattr(StringDict, "lengths", property(whole_dictionary))


def test_decode_values_reads_no_whole_dictionary(no_dictionary_pass):
    d = _random_dict(np.random.default_rng(3), 5000)
    ids = np.random.default_rng(4).integers(0, 5000, 700).astype(np.int32)
    valid = np.random.default_rng(5).random(700) < 0.9
    col = engine._decode_values(DataType.VARCHAR, ids, valid, d)
    assert col.dtype is DataType.VARCHAR and col.valid is valid
    assert list(col.objects()[valid]) == list(d.objects()[ids[valid]])
    # the witness: the composition decoded with before trips the fixture
    with pytest.raises(AssertionError, match="whole dictionary"):
        _before(d, ids, valid)


def test_fused_execute_decodes_its_varchar_root_per_row(job5_plans,
                                                        no_dictionary_pass):
    """One fused execute of JOB 1a (the contest's document: its root has
    two VARCHAR columns, ``MIN(mc.note)`` and ``MIN(t.title)``'s) reads
    no whole dictionary, and the ``decode`` counters count the root's
    VARCHAR columns and their rows."""
    plan, ctx = job5_plans["q1a"], port.build_context("cpu")
    trace.start()
    try:
        result = port.execute(plan, ctx)
    finally:
        log = trace.stop()
    assert any(sp.name == "fused.attempt" for sp in log.spans)
    attrs = plan.nodes[plan.root].output_attrs
    varchar = sum(dt is DataType.VARCHAR for _ci, dt in attrs)
    assert varchar == 2 and result.num_rows > 0
    assert log.counters["decode.varchar_columns"] == varchar
    assert log.counters["decode.varchar_rows"] == varchar * result.num_rows
    assert "decode.numpy_fallbacks" not in log.counters
    (req,) = log.requests
    assert req.counters["decode.varchar_columns"] == varchar


# ---------------------------------------------------------------------------
# tracing: the span's dictionary size, the group in the registry
# ---------------------------------------------------------------------------


def test_decode_column_span_notes_the_dictionary_size(job5_plans):
    plan, ctx = job5_plans["q1a"], port.build_context("cpu")
    port.execute(plan, ctx)  # warm
    trace.start()
    try:
        port.execute(plan, ctx)
    finally:
        log = trace.stop()
    spans = [sp for sp in log.spans if sp.name == "decode.column"]
    assert len(spans) == 2
    fused = plan._fused_struct_cache[1]
    sources = fused.col_sources[plan.root]
    sizes = sorted(fused.dicts[sources[ko]].size
                   for ko, (_ci, dt) in enumerate(
                       plan.nodes[plan.root].output_attrs)
                   if dt is DataType.VARCHAR)
    assert sorted(sp.attrs["dict_size"] for sp in spans) == sizes
    assert all(sp.attrs["dtype"] == "VARCHAR" for sp in spans)
    assert min(sizes) > 0
    # a fixed-width column's decode carries no dictionary size
    trace.start()
    try:
        engine._decode_host_column(DataType.INT32, np.arange(3, dtype=np.int32),
                                   np.ones(3, bool), None)
        engine._decode_host_column(DataType.VARCHAR, np.zeros(2, np.int32),
                                   np.ones(2, bool), None)
    finally:
        log = trace.stop()
    fixed, empty = [sp.attrs for sp in log.spans if sp.name == "decode.column"]
    assert "dict_size" not in fixed and empty["dict_size"] == 0


def test_decode_group_is_in_the_registry():
    assert DECODE_STATS.group == "decode"
    assert sorted(DECODE_STATS) == ["numpy_fallbacks", "varchar_columns",
                                    "varchar_rows"]
    trace.start()
    try:
        StringDict.from_objects([b"x", b"yz"]).decode(
            np.array([1, 0, 1], np.int32), np.array([True, False, True]))
    finally:
        log = trace.stop()
    assert log.counters["decode.varchar_columns"] == 1
    assert log.counters["decode.varchar_rows"] == 3
