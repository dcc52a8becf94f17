"""In-kernel gather and primitive experiments on the card (counterpart of
the JAX package's tools/expt_pallas.py).

  P1: gathers from a table held on chip — take / take_unique /
      take_along_axis over lanes (:func:`kernels.pallas_gather`) and the
      TPU tool's one-hot product, which on this card is a gather from
      shared memory too (:func:`kernels.onehot_gather`)
  P2: tensor-core matrix product rates (int8, bf16): what a one-hot
      product would run at
  P3: compare throughput (one-hot construction cost)
  P4: segmented sort vs one flat sort
  P5: cummax and cumsum throughput
  P6: scatter into a small window vs a large one

Same slope methodology as harness/devtime.py.

Run: python -m radixjoin_tpu_torch.tools.expt_pallas [--cases a,b,c]
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


def fmt(name, n, ms, note=""):
    rps = n / (ms * 1e-3) / 1e9 if ms > 0 else float("inf")
    print(f"{name:<26} {ms:>9.3f} ms  {rps:>8.3f}G rows/s  {note}", flush=True)


# --- P1: in-kernel gathers ---------------------------------------------------


def _resident_case(body, n, w, blk=2048, table_2d=False, device=None):
    """Inputs made as the JAX tool makes them (seed 0: table, then
    indices); the step gathers through :func:`kernels.pallas_gather`."""
    device = _default_device(device)
    rng = np.random.default_rng(0)
    table = rng.integers(0, 1 << 30, w).astype(np.int32)
    if table_2d:
        table = table.reshape(w // 128, 128)
    table = _t(table, device)
    idx = _t(rng.integers(0, w, n).astype(np.int32), device)

    def step(c):
        table, idx = c
        out = kernels.pallas_gather(table, idx, body=body, blk=blk)
        return _chain(table, out[0]), idx

    return step, (table, idx), n


def case_pallas_take(n, w, device=None):
    return _resident_case("take", n, min(w, 1 << 20), device=device)


def case_pallas_take_unique(n, w, device=None):
    return _resident_case("take_unique", n, min(w, 1 << 20), device=device)


def case_pallas_ta_lanes(n, w, device=None):
    """take_along_axis over lanes: an (8, 128) table, each index selects a
    lane of row 0."""
    return _resident_case("ta_lanes", n, 1024, table_2d=True, device=device)


def case_pallas_onehot_mxu(n, w, device=None):
    """The counterpart of the TPU tool's one-hot product over a 2048-entry
    table, ``int32(float32(table))[idx]`` (``table[idx]`` for values below
    2^24; 0 for an index outside the table). The TPU forms the one-hot
    matrix because its matrix unit is its fast dynamic gather; on this
    card the kernel forms no product: each block rounds the table through
    float32 into shared memory and gathers from there. ``mxu_int8``,
    ``mxu_bf16`` and ``vpu_compare`` price the product itself."""
    device = _default_device(device)
    w = 2048
    rng = np.random.default_rng(0)
    table = _t(rng.integers(0, 1 << 20, w).astype(np.int32), device)
    idx = _t(rng.integers(0, w, n).astype(np.int32), device)

    def step(c):
        table, idx = c
        out = kernels.onehot_gather(table, idx)
        return _chain(table, out[0]), idx

    return step, (table, idx), n


# --- P2/P3: raw matrix-product / compare rates -------------------------------


def case_mxu_int8(n, w, device=None):
    """(2048,2048) int8 @ (2048,128) int8 -> int32; rows = 2048."""
    device = _default_device(device)
    rng = np.random.default_rng(0)
    a = _t(rng.integers(0, 2, (2048, 2048)).astype(np.int8), device)
    b = _t(rng.integers(-128, 127, (2048, 128)).astype(np.int8), device)

    def step(c):
        a, b = c
        if a.is_cuda:
            o = torch._int_mm(a, b)
        else:
            o = a.to(torch.int32) @ b.to(torch.int32)
        return _chain(a, o[0, 0].to(torch.int8)), b

    return step, (a, b), 2048


def case_mxu_bf16(n, w, device=None):
    device = _default_device(device)
    rng = np.random.default_rng(0)
    a = _t(rng.integers(0, 2, (2048, 2048)).astype(np.float32),
           device).to(torch.bfloat16)
    b = _t(rng.integers(-128, 127, (2048, 128)).astype(np.float32),
           device).to(torch.bfloat16)

    def step(c):
        a, b = c
        o = torch.matmul(a, b)
        return _chain(a, o[0, 0]), b

    return step, (a, b), 2048


def case_vpu_compare(n, w, device=None):
    """All-pairs equality of an (n/128, 1) vs (1, 128) pair: n compares."""
    device = _default_device(device)
    n0 = n // 128
    rng = np.random.default_rng(0)
    a = _t(rng.integers(0, 1 << 20, n0).astype(np.int32), device)
    b = _t(rng.integers(0, 1 << 20, 128).astype(np.int32), device)

    def step(c):
        a, b = c
        m = (a[:, None] == b[None, :]).to(torch.int32)
        return _chain(a, m.sum()), b

    return step, (a, b), n


# --- P4: segmented sort ------------------------------------------------------


def _seg_sort_case(n, segs, device):
    device = _default_device(device)
    rng = np.random.default_rng(0)
    keys = _t(rng.integers(0, 1 << 31, n).astype(np.int32)
              .reshape(segs, n // segs), device)
    ids = torch.arange(n // segs, dtype=torch.int32,
                       device=device).expand(segs, n // segs)

    def step(c):
        keys, ids = c
        ks, perm = torch.sort(keys, dim=1, stable=True)
        vs = ids.gather(1, perm)
        return _chain(keys, ks[0, 0] + vs[0, 0]), ids

    return step, (keys, ids), n


def case_sort_seg128(n, w, device=None):
    """(128, n/128) batched sort along the last axis."""
    return _seg_sort_case(n, 128, device)


def case_sort_seg4096(n, w, device=None):
    return _seg_sort_case(n, 4096, device)


def case_sort_u32_packed_seg(n, w, device=None):
    """Segment-local sort of (digit:8 | local_id:16) packed keys in
    64K-row segments. The values stay below 2^24, so they sort as int32
    (torch's sort has no uint32)."""
    device = _default_device(device)
    rng = np.random.default_rng(0)
    segs = n // 65536
    digit = rng.integers(0, 256, n).astype(np.int32)
    local = np.tile(np.arange(65536, dtype=np.int32), segs)
    packed = _t(((digit << 16) | local).reshape(segs, 65536), device)

    def step(c):
        (p,) = c
        s = torch.sort(p, dim=1).values
        return (_chain(p, s[0, 0]),)

    return step, (packed,), n


# --- P5: scans ---------------------------------------------------------------


def case_cummax(n, w, device=None):
    device = _default_device(device)
    rng = np.random.default_rng(0)
    x = _t(rng.integers(0, 1 << 30, n).astype(np.int32), device)

    def step(c):
        (x,) = c
        y = torch.cummax(x, 0).values
        return (_chain(x, y[-1]),)

    return step, (x,), n


def case_cumsum(n, w, device=None):
    device = _default_device(device)
    rng = np.random.default_rng(0)
    x = _t(rng.integers(0, 4, n).astype(np.int32), device)

    def step(c):
        (x,) = c
        y = torch.cumsum(x, 0, dtype=torch.int32)
        return (_chain(x, y[-1]),)

    return step, (x,), n


# --- P6: scatter into a small vs a large window -----------------------------


def _scatter_case(w):
    def case(n, _w, device=None):
        device = _default_device(device)
        rng = np.random.default_rng(0)
        idx = _t(rng.integers(0, w, n).astype(np.int64), device)
        vals = _t(rng.integers(0, 1 << 30, n).astype(np.int32), device)

        def step(c):
            idx, vals = c
            t = torch.zeros(w, dtype=torch.int32, device=device)
            t.scatter_(0, idx, vals)
            return _chain(idx, t[0]), vals

        return step, (idx, vals), n

    return case


CASES = {
    "pallas_take": case_pallas_take,
    "pallas_take_unique": case_pallas_take_unique,
    "pallas_ta_lanes": case_pallas_ta_lanes,
    "pallas_onehot_mxu": case_pallas_onehot_mxu,
    "mxu_int8": case_mxu_int8,
    "mxu_bf16": case_mxu_bf16,
    "vpu_compare": case_vpu_compare,
    "sort_seg128": case_sort_seg128,
    "sort_seg4096": case_sort_seg4096,
    "sort_u32_packed_seg": case_sort_u32_packed_seg,
    "cummax": case_cummax,
    "cumsum": case_cumsum,
    "scatter_w64k": _scatter_case(1 << 16),
    "scatter_w1m": _scatter_case(1 << 20),
    "scatter_w16m": _scatter_case(1 << 24),
}

#: the cases that run a kernel of this tool, and its wrapper
KERNEL_CASES = {
    "pallas_take": kernels.pallas_gather,
    "pallas_take_unique": kernels.pallas_gather,
    "pallas_ta_lanes": kernels.pallas_gather,
    "pallas_onehot_mxu": kernels.onehot_gather,
}


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
            step, carry, rows = CASES[name](args.size, args.window, device)
            ms, mode = _slope(step, carry, args.k_lo, args.k_hi, 3)
            wrapper = KERNEL_CASES.get(name)
            route = getattr(wrapper, "last_route", None)
            fmt(name, rows, ms, f"{mode}" + (f" route={route}" if route
                                             else ""))
            del step, carry
        except Exception as e:  # noqa: BLE001 - experiment: report, go on
            failed.append(name)
            print(f"{name:<26} FAILED: {type(e).__name__}: "
                  f"{str(e).splitlines()[0][:140]}", flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
