"""Gather forms from a table held on chip, on the card (counterpart of the
JAX package's tools/expt_gather2.py), all through
:func:`kernels.mk_gather` over the table seen as t2 = (w / 128, 128):

  g_rows   t2[idx >> 7, 0]                      — row gather
  g_lanes  t2[0, idx & 127]                     — lane gather
  g_2level t2[idx >> 7, idx & 127] = table[idx] — the full gather
  g_sub    t2[idx[b0 + i % 128] & 7, 0]         — sublane gather

Reported as rows/s over n probe elements, by the slope methodology of
harness/devtime.py, with the route each case took (shared memory or L2).

Run: python -m radixjoin_tpu_torch.tools.expt_gather2
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import hardware
from ..harness.devtime import (_chain, _default_device, _slope, _t,
                               card_line, require_card)
from ..ops import kernels


def _mk(n, w, body, blk, table_shape, device=None):
    """``(run, table, idx)``: inputs made as the JAX tool makes them (seed
    0: table values below 2^20, then indices in ``[0, w)``)."""
    device = _default_device(device)
    rng = np.random.default_rng(0)
    table = _t(rng.integers(0, 1 << 20, w).astype(np.int32)
               .reshape(table_shape), device)
    idx = _t(rng.integers(0, w, n).astype(np.int32), device)

    def run(table, idx):
        return kernels.mk_gather(table, idx, body=body, blk=blk)

    return run, table, idx


def build_rows(n, w, blk, device=None):
    return _mk(n, w, "rows", blk, (w // 128, 128), device)


def build_lanes(n, w, blk, device=None):
    return _mk(n, w, "lanes", blk, (8, 128), device)


def build_2level(n, w, blk, device=None):
    return _mk(n, w, "2level", blk, (w // 128, 128), device)


def build_sub(n, w, blk, device=None):
    return _mk(n, w, "sub", blk, (8, 128), device)


def measure(name, build, n, w, blk=2048, reps=3, device=None):
    """Per-call ms of ``build``'s gather by the two-point slope; prints one
    line and returns ``(ms, timing mode, route)``."""
    run, table, idx = build(n, w, blk, device)

    def step(c):
        table, idx = c
        out = run(table, idx)
        return _chain(table, out[0]), idx

    ms, mode = _slope(step, (table, idx), 2, 6, reps)
    route = kernels.mk_gather.last_route
    print(f"{name:<12} {ms:>9.3f} ms  "
          f"{n / (ms * 1e-3) / 1e9:>7.3f}G rows/s  {mode} route={route}",
          flush=True)
    return ms, mode, route


#: the JAX tool's runs: (name, input maker, w)
RUNS = [
    ("g_lanes", build_lanes, 1 << 10),
    ("g_rows", build_rows, 1 << 20),
    ("g_2level", build_2level, 1 << 20),
    ("g_2level_64k", build_2level, 1 << 16),
    ("g_sub", build_sub, 1 << 10),
]


def main(n: int = 1 << 24):
    """Runs every entry of :data:`RUNS`, printing one line each; a run that
    raises prints FAILED and the rest go on. Returns the names of the
    failed runs."""
    device = require_card()
    spec = hardware.detect(device)
    print(f"chip {spec.name} ({torch.cuda.get_device_name(device)}; "
          f"{card_line()}) HBM {spec.hbm_gbps:.0f} GB/s  n={n:,}",
          flush=True)
    failed = []
    for name, build, w in RUNS:
        try:
            measure(name, build, n, w, device=device)
        except Exception as e:  # noqa: BLE001 - experiment: report, go on
            failed.append(name)
            print(f"{name:<12} FAILED: {type(e).__name__}: "
                  f"{str(e).splitlines()[0][:160]}", flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
