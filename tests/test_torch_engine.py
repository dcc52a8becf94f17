"""``execute`` of the port against the JAX package's, on plans carried over
with ``convert.from_reference``: equal row multisets
(harness/oracle.py::rows_equal), equal per-join totals and equal join
strategies. The reference runs on the CPU with its Pallas kernels in
interpret mode; the port on the CPU with its kernels' plain versions.

Covers the semantics cases of tests/test_join_semantics.py (rebuilt here),
inputs that arrive as eager aligned pages (device page decode in both
engines), and plans whose reference takes the merge join.
"""


import numpy as np
import pytest

import radixjoin_tpu as ref
from radixjoin_tpu.harness.oracle import rows_equal

import radixjoin_tpu_torch as port
from radixjoin_tpu_torch import convert


def port_rows(result):
    """Rows of a port result with NULL as None and NaN as a marker, so
    radixjoin_tpu's multiset comparison reads them."""
    return [
        tuple(None if v is port.NULL
              else b"\x00NaN" if isinstance(v, float) and v != v else v
              for v in r)
        for r in result.to_host().to_rows()
    ]


def ref_rows(result):
    return [
        tuple(b"\x00NaN" if isinstance(v, float) and v != v else v
              for v in r)
        for r in result.to_host().to_rows()
    ]


def ref_strategies(ref_plan):
    cached = getattr(ref_plan, "_fused_struct_cache", None)
    if cached is None:
        return {}
    return {i: s.strategy for i, s in cached[1].join_specs.items()}


def check_parity(ref_plan, repeat: bool = True):
    """Run ``ref_plan`` in both engines and hold the port to the reference:
    equal row multisets, equal per-join totals, equal join strategies.
    With ``repeat`` the port runs the plan a second time, on the
    cardinality feedback of the first run. Returns the port plan."""
    port_plan = convert.from_reference(ref_plan)
    ref_result = ref.execute(ref_plan, ref.build_context())
    strategies = ref_strategies(ref_plan)
    want = ref_rows(ref_result)
    for _run in range(2 if repeat else 1):
        result = port.execute(port_plan, port.build_context("cpu"))
        ok, msg = rows_equal(port_rows(result), want)
        assert ok, msg
        assert result.num_rows == ref_result.num_rows
        assert [int(c.type) for c in result.columns] == [
            int(c.type) for c in ref_result.columns
        ]
        assert port_plan._last_join_totals == getattr(
            ref_plan, "_last_join_totals", {})
        got = port_plan._fused_struct_cache[1].strategies()
        assert got == strategies
    return port_plan


def assert_same_tables(ref_tables, port_tables):
    """Column-for-column equality of two name -> HostTable dicts."""
    assert sorted(ref_tables) == sorted(port_tables)
    for name, a in ref_tables.items():
        b = port_tables[name]
        assert a.num_rows == b.num_rows, name
        for ca, cb in zip(a.columns, b.columns):
            assert int(ca.dtype) == int(cb.dtype), name
            np.testing.assert_array_equal(ca.valid, cb.valid)
            if int(ca.dtype) == 3:  # VARCHAR
                np.testing.assert_array_equal(ca.heap, cb.heap)
                np.testing.assert_array_equal(ca.ends, cb.ends)
            else:
                np.testing.assert_array_equal(ca.values, cb.values)


# ---------------------------------------------------------------------------
# The semantics cases of tests/test_join_semantics.py, as reference plans
# ---------------------------------------------------------------------------

I32 = ref.DataType.INT32
I64 = ref.DataType.INT64
F64 = ref.DataType.FP64
VC = ref.DataType.VARCHAR
NULL = ref.NULL
_KV = [(1, "xxx"), (1, "yyy"), (NULL, "zzz"), (2, "uuu"), (3, "vvv")]


def _input(rows, types, lazy=False):
    from radixjoin_tpu.storage.columnar import HostTable

    return ref.ColumnarTable.from_host(HostTable.from_rows(rows, types),
                                       lazy=lazy)


def _two_scan_join(left, right, ltypes, rtypes, lscan, rscan, join,
                   lazy=False):
    plan = ref.Plan()
    plan.new_scan_node(plan.new_input(_input(left, ltypes, lazy)), lscan)
    plan.new_scan_node(plan.new_input(_input(right, rtypes, lazy)), rscan)
    plan.root = plan.new_join_node(*join)
    return plan


def _simple(left, right, dt=I32, build_left=True):
    return _two_scan_join(
        [(v,) for v in left], [(v,) for v in right], [dt], [dt],
        [(0, dt)], [(0, dt)], (build_left, 0, 1, 0, 0, [(0, dt), (1, dt)]),
    )


def _three_way():
    plan = ref.Plan()
    plan.new_scan_node(plan.new_input(_input(
        [(1, "a"), (2, "b"), (3, "c")], [I32, VC])), [(0, I32), (1, VC)])
    plan.new_scan_node(plan.new_input(_input(
        [(1, 100), (2, 200), (3, 100), (9, 300)], [I32, I32])),
        [(0, I32), (1, I32)])
    plan.new_scan_node(plan.new_input(_input(
        [(100, "t100"), (200, "t200")], [I32, VC])), [(0, I32), (1, VC)])
    plan.new_join_node(True, 0, 1, 0, 0, [(1, VC), (3, I32)])
    plan.root = plan.new_join_node(False, 3, 2, 1, 0, [(0, VC), (3, VC)])
    return plan


def _scan_only():
    plan = ref.Plan()
    plan.root = plan.new_scan_node(plan.new_input(_input(
        [(1, "a"), (NULL, "b")], [I32, VC])), [(1, VC), (0, I32)])
    return plan


SEMANTICS = {
    "empty_join": lambda: _simple([], []),
    "one_line_join": lambda: _simple([1], [1]),
    "simple_join": lambda: _simple([1, 2, 3], [1, 2, 3]),
    "empty_result": lambda: _simple([1, 2, 3], [4, 5, 6]),
    "multiple_same_keys": lambda: _simple([1, 1, 2, 3], [1, 1, 2, 3]),
    "null_keys_do_not_match": lambda: _simple([1, 1, NULL, 2, 3],
                                              [1, 1, NULL, 2, 3]),
    "projection_reorder": lambda: _two_scan_join(
        _KV, _KV, [I32, VC], [I32, VC], [(0, I32)], [(1, VC), (0, I32)],
        (True, 0, 1, 0, 1, [(0, I32), (2, I32), (1, VC)])),
    "build_on_right": lambda: _two_scan_join(
        _KV, _KV, [I32, VC], [I32, VC], [(0, I32)], [(1, VC), (0, I32)],
        (False, 0, 1, 0, 1, [(0, I32), (2, I32), (1, VC)])),
    "int64_keys": lambda: _simple([2**40, 2**40 + 1, NULL],
                                  [2**40, 2**40 + 2, NULL], I64),
    "int32_extreme_keys": lambda: _simple([2**31 - 1, -(2**31), NULL, 0],
                                          [2**31 - 1, -(2**31), NULL, 1]),
    "fp64_keys_zero_and_nan": lambda: _simple(
        [0.0, float("nan"), 1.5], [-0.0, float("nan"), 1.5], F64),
    "varchar_join_keys": lambda: _two_scan_join(
        [(1, "apple"), (2, "pear"), (3, NULL), (4, "fig")],
        [(10, "apple"), (20, "apple"), (30, "plum"), (40, NULL)],
        [I32, VC], [I32, VC], [(1, VC), (0, I32)], [(0, I32), (1, VC)],
        (True, 0, 1, 0, 1, [(1, I32), (2, I32), (0, VC)])),
    "type_mismatch_join_is_empty": lambda: _two_scan_join(
        [(1,), (2,)], [(1,), (2,)], [I32], [I64], [(0, I32)], [(0, I64)],
        (True, 0, 1, 0, 0, [(0, I32), (1, I64)])),
    "three_way_join_tree": _three_way,
    "duplicate_heavy_fanout": lambda: _simple([7] * 500, [7] * 500 + [8]),
    "output_column_duplication": lambda: _two_scan_join(
        [(5,)], [(5,)], [I32], [I32], [(0, I32)], [(0, I32)],
        (True, 0, 1, 0, 0, [(0, I32), (0, I32), (1, I32)])),
    "null_payloads_flow_through": lambda: _two_scan_join(
        [(1, NULL), (2, "x")], [(1, 11), (2, NULL)], [I32, VC], [I32, I64],
        [(0, I32), (1, VC)], [(0, I32), (1, I64)],
        (True, 0, 1, 0, 0, [(1, VC), (3, I64), (0, I32)])),
    "scan_only_plan": _scan_only,
    "varchar_join_keys_fuse": lambda: _two_scan_join(
        [[b"apple", 1], [b"pear", 2], [None, 3], [b"apple", 4],
         [b"quince", 5]],
        [[b"apple", 10], [b"plum", 11], [None, 12], [b"pear", 13],
         [b"apple", 14]],
        [VC, I64], [VC, I64], [(0, VC), (1, I64)], [(0, VC), (1, I64)],
        (True, 0, 1, 0, 0, [(1, I64), (0, VC), (3, I64)])),
}


@pytest.mark.parametrize("case", sorted(SEMANTICS))
def test_semantics_case_matches_reference(case):
    check_parity(SEMANTICS[case]())


def test_malformed_plans_raise_value_error():
    good = _simple([1, 2], [1, 2])
    bad_root = convert.from_reference(good)
    bad_root.root = 99
    bad_scan = convert.from_reference(good)
    bad_scan.nodes[0].output_attrs = [(7, port.DataType.INT32)]
    bad_key = convert.from_reference(good)
    import dataclasses

    bad_key.nodes[2].data = dataclasses.replace(bad_key.nodes[2].data,
                                                left_attr=5)
    for plan in (bad_root, bad_scan, bad_key):
        with pytest.raises(ValueError):
            port.execute(plan, port.build_context("cpu"))


def test_build_context_needs_cuda_unless_asked_for_cpu():
    import torch

    if torch.cuda.is_available():
        assert port.build_context().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            port.build_context()
    assert port.build_context("cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# Inputs as eager aligned pages: the device page decode in both engines
# ---------------------------------------------------------------------------


def _paged_plan(rng, lazy):
    """INT32 (>= 1920 rows, one full aligned page + remainder) and INT64
    (>= 960 rows) key and payload columns with NULLs."""
    n_a, n_b = 2500, 2100
    a_key = rng.integers(0, 700, n_a)
    a_val = rng.integers(-(1 << 40), 1 << 40, n_a)
    b_key = rng.integers(0, 700, n_b)
    b_val = rng.integers(-(1 << 31), 1 << 31, n_b)
    rows_a = [(int(k) if rng.random() > 0.05 else NULL,
               int(v) if rng.random() > 0.1 else NULL)
              for k, v in zip(a_key, a_val)]
    rows_b = [(int(k) if rng.random() > 0.05 else NULL,
               int(v) if rng.random() > 0.1 else NULL)
              for k, v in zip(b_key, b_val)]
    return _two_scan_join(
        rows_a, rows_b, [I32, I64], [I32, I32], [(0, I32), (1, I64)],
        [(1, I32), (0, I32)], (True, 0, 1, 0, 1,
                               [(1, I64), (2, I32), (3, I32)]), lazy=lazy,
    )


@pytest.mark.parametrize("decode", ["device", "host"])
def test_eager_pages_decode_on_device(decode, monkeypatch):
    from radixjoin_tpu_torch.ops import kernels

    if decode == "host":
        monkeypatch.setenv("RJT_DEVICE_DECODE", "off")
    rng = np.random.default_rng(42)
    ref_plan = _paged_plan(rng, lazy=False)
    calls = []
    plain = kernels.paged_window_gather_plain
    monkeypatch.setattr(kernels, "paged_window_gather_plain",
                        lambda b, i: calls.append(i.shape) or plain(b, i))
    port_plan = check_parity(ref_plan)
    assert port_plan is not None
    # one paged gather per eagerly paged column with a full aligned page:
    # three INT32 columns (one 1920-row page each) and the INT64 column
    # (two 960-row pages, 2 x 960 words a page), decoded once and then
    # served from the upload memo on the repeat run
    want = [(1, 1920)] * 3 + [(2, 1920)] if decode == "device" else []
    assert sorted(tuple(c) for c in calls) == want
