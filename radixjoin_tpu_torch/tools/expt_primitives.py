"""Primitive-level experiments on the card (counterpart of the JAX
package's tools/expt_primitives.py): the two operations that dominate the
join kernels, a random one-element gather and a multi-operand sort, in
candidate formulations.

  gather_1d          plain gather: out = table[idx]
  gather_row128      table as (W/128, 128): gather rows idx >> 7, then
                     select the lane with a one-hot reduction
  gather_row128_ta   same rows, lane select with a gather along the row
  gather_pallas_vmem table resident on chip (:func:`kernels.gather_pallas_vmem`:
                     shared memory where it fits, else read through L2)
  sort_5op           sort of (u8, i32, u8) keys carrying (i32, u8) — the
                     merge join's sort before packing
  sort_1op_i64       the same information packed into ONE int64 key
  sort_2op_i32       key sort carrying one int32 payload
  scatter_1d         plain scatter: table[idx] = vals

Same slope methodology as harness/devtime.py.

Run: python -m radixjoin_tpu_torch.tools.expt_primitives [--size N] [--window W]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import hardware
from ..harness.devtime import (_chain, _default_device, _slope, _t,
                               card_line, require_card)
from ..ops import kernels


def fmt(name, n, ms, nbytes, note=""):
    gbps = nbytes / (ms * 1e-3) / 1e9 if ms > 0 else float("inf")
    rps = n / (ms * 1e-3) / 1e9 if ms > 0 else float("inf")
    print(f"{name:<22} {ms:>9.3f} ms  {rps:>8.3f}G rows/s  {gbps:>8.1f} GB/s"
          f"  {note}", flush=True)


def _table_idx(n, w, device, sort_idx=False):
    rng = np.random.default_rng(0)
    table = rng.integers(0, 1 << 30, w).astype(np.int32)
    idx = rng.integers(0, w, n)
    if sort_idx:
        idx = np.sort(idx)
    return table, _t(idx.astype(np.int32), device)


def case_gather_1d(n, w, device=None):
    device = _default_device(device)
    table, idx = _table_idx(n, w, device)
    table = _t(table, device)

    def step(c):
        table, idx = c
        out = table.index_select(0, idx)
        return _chain(table, out[0]), idx

    return step, (table, idx), n, n * 8 + w * 4


def case_gather_row128(n, w, device=None):
    device = _default_device(device)
    table, idx = _table_idx(n, w, device)
    table = _t(table.reshape(w // 128, 128), device)
    lane_iota = torch.arange(128, dtype=torch.int32, device=device)

    def step(c):
        table, idx = c
        rows = table.index_select(0, idx >> 7)        # (n, 128) row gather
        onehot = (idx[:, None] & 127) == lane_iota    # (n, 128) bool
        out = torch.where(onehot, rows, 0).sum(dim=1, dtype=torch.int32)
        return _chain(table, out[0]), idx

    return step, (table, idx), n, n * 8 + w * 4


def case_gather_row128_ta(n, w, device=None):
    device = _default_device(device)
    table, idx = _table_idx(n, w, device)
    table = _t(table.reshape(w // 128, 128), device)

    def step(c):
        table, idx = c
        rows = table.index_select(0, idx >> 7)
        out = rows.gather(1, (idx[:, None] & 127).long())[:, 0]
        return _chain(table, out[0]), idx

    return step, (table, idx), n, n * 8 + w * 4


def case_gather_pallas_vmem(n, w, device=None):
    """Table resident on chip; probes in blocks of 4096."""
    device = _default_device(device)
    assert w * 4 <= 8 * 1024 * 1024, "table must fit the TPU's VMEM budget"
    table, idx = _table_idx(n, w, device)
    table = _t(table, device)

    def step(c):
        table, idx = c
        out = kernels.gather_pallas_vmem(table, idx, blk=4096)
        return _chain(table, out[0]), idx

    return step, (table, idx), n, n * 8 + w * 4


def case_gather_sorted(n, w, device=None):
    """Gather with monotone indices (the expansion's access pattern)."""
    device = _default_device(device)
    table, idx = _table_idx(n, w, device, sort_idx=True)
    table = _t(table, device)

    def step(c):
        table, idx = c
        out = table.index_select(0, idx)
        return _chain(table, out[0]), idx

    return step, (table, idx), n, n * 8 + w * 4


def _gather_w(w):
    def case(n, _w, device=None):
        return case_gather_1d(n, w, device)

    return case


def case_sort_5op(n, w, device=None):
    """Sort by (invalid, key, side) carrying (id, valid): three stable
    passes, minor key first, then the two carried planes."""
    device = _default_device(device)
    rng = np.random.default_rng(0)
    keys = _t(rng.integers(0, w, n).astype(np.int32), device)
    inval = torch.zeros(n, dtype=torch.uint8, device=device)
    side = _t(rng.integers(0, 2, n).astype(np.uint8), device)
    ids = torch.arange(n, dtype=torch.int32, device=device)
    valid = torch.ones(n, dtype=torch.uint8, device=device)

    def step(c):
        inval, keys, side, ids, valid = c
        perm = torch.sort(side, stable=True).indices
        perm = perm[torch.sort(keys[perm], stable=True).indices]
        perm = perm[torch.sort(inval[perm], stable=True).indices]
        b, d = keys[perm], ids[perm]
        _a, _cc, _e = inval[perm], side[perm], valid[perm]
        return _chain(inval, b[0] + d[0]), keys, side, ids, valid

    return step, (inval, keys, side, ids, valid), n, n * 14 * 2


def case_sort_1op_i64(n, w, device=None):
    """(key | side | id) packed in one int64."""
    device = _default_device(device)
    rng = np.random.default_rng(0)
    keys = _t(rng.integers(0, w, n).astype(np.int64), device)
    side = _t(rng.integers(0, 2, n).astype(np.int64), device)
    ids = torch.arange(n, dtype=torch.int64, device=device)

    def step(c):
        keys, side, ids = c
        packed = (keys << 31) | (side << 30) | ids
        s = torch.sort(packed).values
        return _chain(keys, s[0]), side, ids

    return step, (keys, side, ids), n, n * 16


def case_sort_2op_i32(n, w, device=None):
    """Key sort carrying one int32 payload (the dev_csr grouped sort)."""
    device = _default_device(device)
    rng = np.random.default_rng(0)
    keys = _t(rng.integers(0, w, n).astype(np.int32), device)
    ids = torch.arange(n, dtype=torch.int32, device=device)

    def step(c):
        keys, ids = c
        a, perm = torch.sort(keys, stable=True)
        b = ids.index_select(0, perm)
        return _chain(keys, a[0] + b[0]), ids

    return step, (keys, ids), n, n * 16


def case_scatter_1d(n, w, device=None):
    device = _default_device(device)
    rng = np.random.default_rng(0)
    idx = _t(rng.integers(0, w, n).astype(np.int64), device)
    vals = _t(rng.integers(0, 1 << 30, n).astype(np.int32), device)

    def step(c):
        idx, vals = c
        table = torch.zeros(w, dtype=torch.int32, device=device)
        table.scatter_(0, idx, vals)
        return _chain(idx, table[0]), vals

    return step, (idx, vals), n, n * 8 + w * 4


CASES = {
    "gather_1d": case_gather_1d,
    "gather_sorted": case_gather_sorted,
    "gather_w8k": _gather_w(1 << 13),
    "gather_w64k": _gather_w(1 << 16),
    "gather_w16m": _gather_w(1 << 24),
    "gather_row128": case_gather_row128,
    "gather_row128_ta": case_gather_row128_ta,
    "gather_pallas_vmem": case_gather_pallas_vmem,
    "sort_5op": case_sort_5op,
    "sort_1op_i64": case_sort_1op_i64,
    "sort_2op_i32": case_sort_2op_i32,
    "scatter_1d": case_scatter_1d,
}

#: the cases that run a kernel of this tool, and its wrapper
KERNEL_CASES = {"gather_pallas_vmem": kernels.gather_pallas_vmem}


def main(argv=None):
    """Runs the cases, printing one line each; a case that raises prints
    FAILED and the rest go on. Returns the names of the failed cases."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=1 << 24)
    ap.add_argument("--window", type=int, default=1 << 20)
    ap.add_argument("--cases", type=str, default=None)
    ap.add_argument("--k-lo", type=int, default=2)
    ap.add_argument("--k-hi", type=int, default=6)
    args = ap.parse_args(argv)

    device = require_card()
    spec = hardware.detect(device)
    print(f"chip {spec.name} ({torch.cuda.get_device_name(device)}; "
          f"{card_line()}) HBM {spec.hbm_gbps:.0f} GB/s  "
          f"n={args.size:,} window={args.window:,}", flush=True)
    failed = []
    for name in (args.cases.split(",") if args.cases else list(CASES)):
        try:
            step, carry, rows, nbytes = CASES[name](args.size, args.window,
                                                    device)
            ms, mode = _slope(step, carry, args.k_lo, args.k_hi, 3)
            route = getattr(KERNEL_CASES.get(name), "last_route", None)
            fmt(name, rows, ms, nbytes,
                mode + (f" route={route}" if route else ""))
            del step, carry
        except Exception as e:  # noqa: BLE001 - experiment: report, go on
            failed.append(name)
            print(f"{name:<22} FAILED: {type(e).__name__}: {e}", flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
