"""Per-operator roofline harness (port of radixjoin_tpu/harness/roofline.py;
imports torch and numpy only).

Every hot join operator is timed and reported in rows/s and effective GB/s
against the card's device-memory rate
(:func:`radixjoin_tpu_torch.hardware.detect`). Join operators do no
matrix products, so they live on the memory-bound side of the roofline:
the speed of light is ``hbm_gbps``. For each case:

  * ``rows_per_s``   — probe-side (or output) rows per second;
  * ``eff_gbps``     — *least* bytes moved / time: the bytes a perfect
    implementation must touch (each input element read once, each output
    written once). Sort-based operators make several passes, so their
    ``pct_roofline`` shows the multiple they pay;
  * ``pct_roofline`` — eff_gbps / the card's GB/s.

Each case's data comes from ``default_rng(0)`` as in the JAX harness, and
its ``min_bytes`` is the JAX harness's formula; both differ from the cases
of ``harness/devtime.py``, which is why the case functions here are their own.
Where the JAX harness ``jax.jit``-s a ``join_ops`` function, this one calls
the port's ``ops/join.py`` (and ``ops/hashing.murmur64``) directly.

On the card a call's time is devtime's device time: the two-point slope of
K calls captured in one CUDA graph (``mode`` "graph"), or of an eager loop
between CUDA events when the call cannot be captured ("eager"), the median
of ``reps`` slopes; neither the launch nor the host's fence is in it. On
the CPU (tests only) it is the median of ``reps`` calls on the host clock
after one warm-up ("host").

``join_expand`` and ``fused_join`` launch the blocked-window gather kernel
(``ops/kernels.py``) on the monotone owner stream; the other cases are
sorts, scans and library gathers.

Run (the CUDA card unless ``--platform cpu``)::

    python -m radixjoin_tpu_torch.harness.roofline [--size N] [--reps R] \
        [--cases a,b] [--json PATH] [--platform cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import hardware
from ..ops import hashing
from ..ops import join as join_ops
from . import devtime


@dataclasses.dataclass
class Measurement:
    kernel: str
    rows: int
    ms: float
    rows_per_s: float
    min_bytes: int
    eff_gbps: float
    pct_roofline: float
    #: how ``ms`` was taken: "graph", "eager" (card) or "host" (CPU)
    mode: str = "graph"

    def row(self) -> str:
        return (
            f"{self.kernel:<28} {self.rows:>12,} {self.ms:>9.3f} "
            f"{self.rows_per_s/1e9:>8.3f}G {self.eff_gbps:>8.1f} "
            f"{self.pct_roofline*100:>6.1f}% {self.mode:>6}"
        )


@dataclasses.dataclass
class Case:
    """One operator call ready to time: ``fn(*args)`` and its accounting."""

    name: str
    rows: int
    min_bytes: int
    fn: Callable
    args: tuple


def _time(case: Case, device: torch.device, reps: int = 5):
    """``(ms of one call, mode)``: devtime's slope on the card, the median
    of ``reps`` host-clock calls after a warm-up on the CPU."""
    if device.type == "cuda":
        def step(carry):
            case.fn(*carry)
            return carry

        return devtime._slope(step, case.args, 2, 10, reps)
    case.fn(*case.args)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        case.fn(*case.args)
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3, "host"


def _measure(case: Case, ms: float, mode: str, spec) -> Measurement:
    eff = case.min_bytes / (ms * 1e-3) / 1e9
    return Measurement(case.name, case.rows, ms, case.rows / (ms * 1e-3),
                       case.min_bytes, eff, eff / spec.hbm_gbps, mode)


def _put(array: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(array).to(device)


def _join_sides(n: int, device, dtype=np.int32):
    """The JAX harness's build (n/4 keys) and probe (n keys) sides from
    ``default_rng(0)``, all rows valid."""
    rng = np.random.default_rng(0)
    b = n // 4
    bk = _put(rng.integers(0, b, b).astype(dtype), device)
    pk = _put(rng.integers(0, b, n).astype(dtype), device)
    bv = torch.ones(b, dtype=torch.bool, device=device)
    pv = torch.ones(n, dtype=torch.bool, device=device)
    return rng, b, bk, bv, pk, pv


# ---------------------------------------------------------------------------
# operator cases: each ``case_*`` builds the inputs and the call; each
# ``bench_*`` times it
# ---------------------------------------------------------------------------


def case_join_count(n: int, device, dtype=np.int32) -> Case:
    """Sort build + double searchsorted: the count phase of the two-phase
    join."""
    _rng, b, bk, bv, pk, pv = _join_sides(n, device, dtype)
    esize = np.dtype(dtype).itemsize
    # least: read both key arrays, write lo/counts/offsets (int64)
    min_bytes = (b + n) * (esize + 1) + n * 8 * 2
    return Case(f"join_count[{np.dtype(dtype).name}]", n, min_bytes,
                join_ops.join_count_impl, (bk, bv, pk, pv))


def case_join_expand(n: int, device) -> Case:
    """Duplicate-run expansion (scatter-max + running max + gathers)."""
    _rng, _b, bk, bv, pk, pv = _join_sides(n, device)
    perm, lo, _c, offsets, total = join_ops.join_count_impl(bk, bv, pk, pv)
    out_rows = int(total)
    s_pad = join_ops.bucket_size(out_rows)
    min_bytes = n * 8 * 2 + out_rows * 4 * 2  # offsets/lo in, bidx/pidx out
    return Case("join_expand", out_rows, min_bytes,
                lambda *a: join_ops.join_expand_impl(*a, s_pad=s_pad),
                (perm, lo, offsets, total))


def case_gather(n: int, device) -> Case:
    """Late materialization: payload gather at join-output indices."""
    rng = np.random.default_rng(0)
    vals = _put(rng.integers(0, 1 << 30, n).astype(np.int64), device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    idx = _put(rng.integers(0, n, n).astype(np.int32), device)
    live = torch.ones(n, dtype=torch.bool, device=device)
    min_bytes = n * (8 + 1 + 4) + n * (8 + 1)
    return Case("gather_payload[i64]", n, min_bytes,
                lambda v, m, i, l: join_ops.gather_columns([(v, m)], i, l),
                (vals, valid, idx, live))


def case_hash(n: int, device) -> Case:
    """64-bit avalanche hash of a key column (partitioning front end)."""
    rng = np.random.default_rng(0)
    keys = _put(rng.integers(0, 1 << 31, n).astype(np.int64), device)
    return Case("murmur64", n, n * 8 * 2, hashing.murmur64, (keys,))


def _sort_kv(keys: torch.Tensor, iota: torch.Tensor):
    order = torch.sort(keys, stable=True)
    return order.values, iota.index_select(0, order.indices)


def case_sort(n: int, device) -> Case:
    """Key-value sort throughput: the primitive under count and partition."""
    rng = np.random.default_rng(0)
    keys = _put(rng.integers(0, 1 << 31, n).astype(np.int32), device)
    iota = torch.arange(n, dtype=torch.int32, device=device)
    return Case("sort_kv[i32]", n, n * 4 * 4, _sort_kv, (keys, iota))


def case_fused_join(n: int, device) -> Case:
    """One whole join: count + expand + two payload columns."""
    rng, b, bk, bv, pk, pv = _join_sides(n, device)
    bpay = _put(rng.integers(0, 1 << 30, b).astype(np.int64), device)
    ppay = _put(rng.integers(0, 1 << 30, n).astype(np.int64), device)
    total = join_ops.join_count_impl(bk, bv, pk, pv)[4]
    out_rows = int(total)
    s_pad = join_ops.bucket_size(out_rows)

    def fused(bk, bv, pk, pv, bpay, ppay):
        perm, lo, _c, offsets, total = join_ops.join_count_impl(bk, bv, pk, pv)
        bidx, pidx, live = join_ops.join_expand_impl(perm, lo, offsets,
                                                     total, s_pad)
        return bpay[bidx], ppay[pidx], live

    min_bytes = (b + n) * (4 + 1 + 8) + out_rows * (8 + 8 + 1)
    return Case("fused_join_e2e", out_rows, min_bytes, fused,
                (bk, bv, pk, pv, bpay, ppay))


def case_join_merge(n: int, device, dtype=np.int32) -> Case:
    """Single-sort merge-join count (the general join of the main path)."""
    _rng, b, bk, bv, pk, pv = _join_sides(n, device, dtype)
    esize = np.dtype(dtype).itemsize
    min_bytes = (b + n) * (esize + 1) + n * 8 * 2
    return Case(f"join_merge[{np.dtype(dtype).name}]", n, min_bytes,
                join_ops.join_merge_impl, (bk, bv, pk, pv))


def _bench(make: Callable) -> Callable:
    def bench(n: int, spec, reps: int, device=None, **kw) -> Measurement:
        device = hardware.norm_device(device or "cuda")
        case = make(n, device, **kw)
        return _measure(case, *_time(case, device, reps), spec)

    bench.__name__ = make.__name__.replace("case_", "bench_")
    bench.__doc__ = make.__doc__
    return bench


bench_join_count = _bench(case_join_count)
bench_join_expand = _bench(case_join_expand)
bench_gather = _bench(case_gather)
bench_hash = _bench(case_hash)
bench_sort = _bench(case_sort)
bench_fused_join = _bench(case_fused_join)
bench_join_merge = _bench(case_join_merge)

CASES: Dict[str, Callable] = {
    "sort": bench_sort,
    "hash": bench_hash,
    "join_merge": bench_join_merge,
    "join_count": bench_join_count,
    "join_expand": bench_join_expand,
    "gather": bench_gather,
    "fused_join": bench_fused_join,
}


def run(
    size: int = 1 << 22,
    reps: int = 5,
    cases: Optional[List[str]] = None,
    spec: Optional[hardware.ChipSpec] = None,
    device=None,
) -> List[Measurement]:
    """Every case (or those named) at ``size`` probe rows on ``device``
    (None: the card, which must exist; ``"cpu"`` on request)."""
    spec = spec or hardware.detect(device)
    return [CASES[name](size, spec, reps, device=device)
            for name in cases or list(CASES)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=1 << 22, help="probe rows")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cases", type=str, default=None, help="comma list")
    ap.add_argument("--json", type=str, default=None, help="write JSON here")
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                    help="the CUDA card (default; fails without one) or the "
                         "CPU (a dry run: its times are the CPU's)")
    args = ap.parse_args(argv)

    if args.platform == "cuda" and not torch.cuda.is_available():
        print("roofline: no CUDA card (torch.cuda.is_available() is false); "
              "pass --platform cpu for a dry run on the CPU", file=sys.stderr)
        return 2
    device = "cpu" if args.platform == "cpu" else None
    spec = hardware.detect(device)
    where = (torch.cuda.get_device_name(0) if device is None else "cpu")
    print(f"device: {where} ({spec.name}), HBM {spec.hbm_gbps:.0f} GB/s")
    cases = args.cases.split(",") if args.cases else None
    results = run(args.size, args.reps, cases, spec, device)
    print(f"{'kernel':<28} {'rows':>12} {'ms':>9} {'rows/s':>9} "
          f"{'GB/s':>8} {'%roof':>7} {'mode':>6}")
    for m in results:
        print(m.row())
    if args.json:
        with open(args.json, "w") as f:
            json.dump([dataclasses.asdict(m) for m in results], f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
