"""The port's host layers against the JAX package's: the copied page codec,
aligned encoder and column statistics give identical bytes and values, the
device page decode gives the reference's columns, and the package runs
with jax and radixjoin_tpu unimportable."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from radixjoin_tpu.dtypes import DataType as RefDataType
from radixjoin_tpu.storage import device_decode as ref_dd
from radixjoin_tpu.storage import page as ref_page
from radixjoin_tpu.storage.columnar import HostColumn as RefHostColumn
from radixjoin_tpu_torch.dtypes import DataType
from radixjoin_tpu_torch.storage import device_decode as dd
from radixjoin_tpu_torch.storage import page
from radixjoin_tpu_torch.storage.columnar import HostColumn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXED = [(DataType.INT32, np.int32), (DataType.INT64, np.int64),
         (DataType.FP64, np.float64)]


def _column(rng, npdt, n, null_frac=0.25):
    if npdt is np.float64:
        vals = rng.normal(size=n) * 1e6
        vals[:3] = [-0.0, np.nan, np.inf][: n]
    else:
        info = np.iinfo(npdt)
        vals = rng.integers(info.min, info.max, n, endpoint=True).astype(npdt)
    valid = rng.random(n) >= null_frac
    return vals, valid


@pytest.mark.parametrize("dtype,npdt", FIXED)
@pytest.mark.parametrize("n", [0, 1, 959, 1920, 4801])
def test_fixed_pages_byte_identical(dtype, npdt, n):
    rng = np.random.default_rng(n)
    vals, valid = _column(rng, npdt, n)
    rdt = RefDataType(int(dtype))
    for enc, ref_enc in ((page.encode_fixed, ref_page.encode_fixed),
                         (dd.encode_fixed_aligned,
                          ref_dd.encode_fixed_aligned)):
        pages = enc(vals, valid, dtype)
        np.testing.assert_array_equal(pages, ref_enc(vals, valid, rdt))
        got_v, got_valid = page.decode_fixed(pages, n, dtype)
        np.testing.assert_array_equal(got_valid, valid)
        np.testing.assert_array_equal(got_v[valid], vals[valid])


def test_varchar_pages_byte_identical():
    rng = np.random.default_rng(9)
    vocab = [b"", b"a", b"\xe9clair", b"x" * 300, b"y" * 9000]  # long strings
    values = np.array([vocab[i] for i in rng.integers(0, 5, 700)], object)
    valid = rng.random(700) >= 0.2
    hc = HostColumn(DataType.VARCHAR, values.copy(), valid)
    rc = RefHostColumn(RefDataType.VARCHAR, values.copy(), valid)
    pages = page.encode_varchar_heap(hc.heap, hc.ends, hc.valid)
    np.testing.assert_array_equal(
        pages, ref_page.encode_varchar_heap(rc.heap, rc.ends, rc.valid))
    heap, ends, v2 = page.decode_varchar_heap(pages, 700)
    np.testing.assert_array_equal(v2, valid)
    np.testing.assert_array_equal(ends, hc.ends)
    np.testing.assert_array_equal(heap, hc.heap)


@pytest.mark.parametrize("seed", range(3))
def test_column_statistics_match(seed):
    rng = np.random.default_rng(seed)
    n = 5000
    vals = rng.integers(-50, 3000, n).astype(np.int32)
    if seed == 1:
        vals = np.arange(n, dtype=np.int32)  # sorted unique: PK layout
    valid = rng.random(n) >= 0.1
    hc = HostColumn(DataType.INT32, vals, valid)
    rc = RefHostColumn(RefDataType.INT32, vals, valid)
    assert hc.valid_range() == rc.valid_range()
    assert hc.is_unique_key() == rc.is_unique_key()
    for a, b in zip(hc.csr_index(), rc.csr_index()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype,npdt", FIXED)
def test_device_decode_matches_reference(dtype, npdt):
    rng = np.random.default_rng(7)
    n = 2 * dd.ALIGNED_ROWS[dtype] + 123  # two full pages + remainder
    vals, valid = _column(rng, npdt, n)
    pages = dd.encode_fixed_aligned(vals, valid, dtype)
    assert dd.aligned_full_pages(pages, n, dtype) == 2
    data, dvalid = dd.decode_fixed_device(pages, n, dtype, "cpu")
    ref_data, ref_valid = ref_dd.decode_fixed_device(
        pages, n, RefDataType(int(dtype)))
    np.testing.assert_array_equal(dvalid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(data.numpy(), np.asarray(ref_data))
    assert data.dtype == (torch.int32 if dtype is DataType.INT32
                          else torch.int64)


def _port_sources():
    pkg = os.path.join(REPO, "radixjoin_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_port_imports_neither_jax_nor_reference():
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "radixjoin_tpu"), (
                    f"{path} imports {name}")


_BLOCKED_RUN = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["radixjoin_tpu"] = None
import radixjoin_tpu_torch as rt
for m in pkgutil.walk_packages(rt.__path__, "radixjoin_tpu_torch."):
    importlib.import_module(m.name)
from radixjoin_tpu_torch.storage.columnar import HostTable, sorted_rows
I32 = rt.DataType.INT32
def inp(rows):
    return rt.ColumnarTable.from_host(HostTable.from_rows(rows, [I32]))
plan = rt.Plan()
plan.new_scan_node(plan.new_input(inp([(1,), (1,), (2,), (3,)])), [(0, I32)])
plan.new_scan_node(plan.new_input(inp([(1,), (2,), (9,)])), [(0, I32)])
plan.root = plan.new_join_node(True, 0, 1, 0, 0, [(0, I32), (1, I32)])
res = rt.execute(plan, rt.build_context("cpu"))
assert "jax" not in [k for k, v in sys.modules.items() if v is not None]
print(sorted_rows(res.to_host().to_rows()))
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[(1, 1), (1, 1), (2, 2)]"
