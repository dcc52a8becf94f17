"""Device-time microbenchmark of the port's join kernels (counterpart of
radixjoin_tpu/harness/devtime.py).

Each case returns a ``step`` that maps a carry of tensors to the next
carry, plus the rows it processes and its algorithmic minimum traffic.
The per-iteration device time is the *slope*
``(t(K_hi) - t(K_lo)) / (K_hi - K_lo)`` of running ``step`` K times, which
cancels every constant cost (launch of the first kernel, the final
synchronize, event overhead).

On the card the K-iteration loop is captured once in a CUDA graph and
replayed between two CUDA events, so the host's per-launch cost — which
is not constant per iteration for a step of many small kernels — is out
of the measurement as well. A step that cannot be captured (it would
synchronize with the host) is timed as an eager loop between the same
events; each measurement names its mode. On the CPU (tests only) the loop
is timed with ``time.perf_counter``.

Each ``step`` computes its outputs and a scalar from them (the JAX
package's data-dependence glue, :func:`_chain`, which there keeps XLA from
dropping or reordering the work). In PyTorch one stream orders the kernels
and nothing is dropped, so :func:`_chain` costs nothing here and the time
is the step's own. ``min_bytes`` is the algorithmic minimum traffic
(each input element read once, each output written once), so
``pct_roofline`` charges sort-based kernels for their extra passes; speed
of light is the card's HBM bandwidth (:mod:`radixjoin_tpu_torch.hardware`).

Run: ``python -m radixjoin_tpu_torch.harness.devtime [--size N] [--json PATH]``
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import hardware
from ..ops import join as join_ops
from ..ops import kernels


@dataclasses.dataclass
class Measurement:
    kernel: str
    rows: int
    device_ms: float
    rows_per_s: float
    min_bytes: int
    eff_gbps: float
    pct_roofline: float
    #: False when a single-mode measurement landed inside the constant
    #: floor's noise band: the derived throughput must not be quoted
    reliable: bool = True
    #: "graph" (CUDA graph replay), "eager" (launch loop between CUDA
    #: events), "single" (one call minus the floor) or "host" (CPU clock)
    mode: str = "graph"

    def row(self) -> str:
        tail = "" if self.reliable else "  SUB-FLOOR (use slope mode)"
        return (
            f"{self.kernel:<26} {self.rows:>12,} {self.device_ms:>9.3f} "
            f"{self.rows_per_s/1e9:>8.3f}G {self.eff_gbps:>8.1f} "
            f"{self.pct_roofline*100:>6.1f}% {self.mode:>6}{tail}"
        )


def _device_of(carry) -> torch.device:
    for x in carry:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _loop(step, carry, k):
    c = carry
    for _ in range(k):
        c = step(c)
    return c


def _event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _graph_runner(step, carry, k):
    """Capture ``k`` iterations of ``step`` in one CUDA graph; returns its
    replay and keeps the graph's outputs alive with it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as CUDA asks
        _loop(step, carry, 1)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _loop(step, carry, k)

    def replay():
        graph.replay()

    replay.keep = (graph, out)
    return replay


def _slope(step, carry, k_lo: int, k_hi: int, reps: int):
    """``(per-iteration ms, mode)`` by the two-point slope."""
    dev = _device_of(carry)
    if dev.type != "cuda":
        def host_ms(k):
            t0 = time.perf_counter()
            _loop(step, carry, k)
            return (time.perf_counter() - t0) * 1e3

        host_ms(k_lo)
        host_ms(k_hi)
        samples = [(host_ms(k_hi) - host_ms(k_lo)) / (k_hi - k_lo)
                   for _ in range(reps)]
        return float(statistics.median(samples)), "host"
    try:
        runners = [_graph_runner(step, carry, k) for k in (k_lo, k_hi)]
        mode = "graph"
    except RuntimeError:
        # the step synchronizes with the host somewhere: no capture
        torch.cuda.synchronize()
        runners = [lambda k=k: _loop(step, carry, k) for k in (k_lo, k_hi)]
        mode = "eager"
    for run in runners:  # settle: first replays, allocator growth
        run()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t_lo = _event_ms(runners[0])
        t_hi = _event_ms(runners[1])
        samples.append((t_hi - t_lo) / (k_hi - k_lo))
    del runners
    return float(statistics.median(samples)), mode


def slope_time_ms(step: Callable, carry, k_lo: int = 2, k_hi: int = 10,
                  reps: int = 3) -> float:
    """Per-iteration device ms of ``step`` via the two-point slope."""
    return _slope(step, carry, k_lo, k_hi, reps)[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_floor_ms(reps: int = 7, device=None) -> float:
    """Constant per-call cost: launch + synchronize of a trivial op on the
    host clock. Subtracted by :func:`single_time_ms`."""
    device = _default_device(device)
    tiny = torch.arange(8, dtype=torch.int32, device=device)

    def once():
        t0 = time.perf_counter()
        out = tiny ^ 1
        _sync(device)
        del out
        return time.perf_counter() - t0

    once()
    return float(np.median([once() for _ in range(reps)]) * 1e3)


def single_time_ms(step, carry, reps: int = 5,
                   floor_ms: Optional[float] = None):
    """Time of ONE ``step`` call: host clock through a full synchronize
    minus the measured constant floor. Returns ``(ms, reliable)``;
    ``reliable`` is False when the net time is under 25% of the floor."""
    device = _device_of(carry)
    if floor_ms is None:
        floor_ms = measure_floor_ms(device=device)

    def once():
        t0 = time.perf_counter()
        step(carry)
        _sync(device)
        return time.perf_counter() - t0

    once()
    once()
    raw_ms = float(np.median([once() for _ in range(reps)]) * 1e3)
    net = raw_ms - floor_ms
    return max(net, 1e-3), net >= 0.25 * floor_ms


def _chain(arr, scalar):
    """Returns ``arr``: the counterpart of the JAX package's data-dependence
    glue. The step has already launched the work that computes ``scalar``
    on the current stream, which orders it before the next iteration; no
    extra pass over ``arr`` is needed."""
    del scalar
    return arr


def _consume(*arrays):
    """Scalar that depends on every element of every array (one read pass
    per array — charged in min_bytes by the cases that use it on arrays
    not already reduced inside the kernel)."""
    total = None
    for a in arrays:
        s = (a.to(torch.int64) & 0xFF).sum()
        total = s if total is None else total + s
    return total


def _measure(name, rows, ms, min_bytes, spec, reliable=True,
             mode="graph") -> Measurement:
    eff = min_bytes / (ms * 1e-3) / 1e9 if ms > 0 else float("inf")
    return Measurement(
        name, rows, ms, rows / (ms * 1e-3) if ms > 0 else float("inf"),
        min_bytes, eff, eff / spec.hbm_gbps, reliable, mode,
    )


def _default_device(device=None) -> torch.device:
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device)


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _inputs(n: int, device, dtype=np.int32, dup: int = 4, seed: int = 0):
    """Standard join workload: build = n/dup rows, probe = n rows, keys
    uniform over the build id range (every probe matches ~1 build row)."""
    rng = np.random.default_rng(seed)
    b = n // dup
    bk = rng.permutation(b).astype(dtype)  # unique build keys
    pk = rng.integers(0, b, n).astype(dtype)
    return (b, _t(bk, device), torch.ones(b, dtype=torch.bool, device=device),
            _t(pk, device), torch.ones(n, dtype=torch.bool, device=device))


def _dup_inputs(n: int, device, dtype=np.int32, dup: int = 4, seed: int = 0):
    """Duplicate-capable build side: keys uniform over b/2 distinct values
    (~2 builds per key, fan-out 2). Also returns the host keys."""
    rng = np.random.default_rng(seed)
    b = n // dup
    bk = rng.integers(0, b // 2, b).astype(dtype)
    pk = rng.integers(0, b // 2, n).astype(dtype)
    return (b, _t(bk, device), torch.ones(b, dtype=torch.bool, device=device),
            _t(pk, device), torch.ones(n, dtype=torch.bool, device=device),
            bk, pk)


def _exact_out_pad(bk_np, pk_np) -> int:
    """Exact fan-out of the synthetic workload, host-side — the bucket a
    production run learns through cardinality feedback."""
    counts = np.bincount(bk_np, minlength=int(pk_np.max()) + 1)
    return join_ops.bucket_size(int(counts[pk_np].sum()))


def _rand_i32(rng, lo, hi, n, device):
    return _t(rng.integers(lo, hi, n).astype(np.int32), device)


# ---------------------------------------------------------------------------
# Cases. Each takes (n, device=None) and returns
# (step, carry, rows, min_bytes).
# ---------------------------------------------------------------------------


def case_copy(n: int, device=None):
    """Bandwidth baseline: one read + one write pass of int32 (one
    elementwise kernel; XLA fuses the JAX case's ``x ^ (x >> 1)`` into one
    pass, which torch would run as two)."""
    device = _default_device(device)
    x = torch.arange(n, dtype=torch.int32, device=device)

    def step(c):
        (x,) = c
        y = ~x
        return (_chain(y, y[0]),)

    return step, (x,), n, n * 4 * 2


def case_gather(n: int, device=None):
    device = _default_device(device)
    rng = np.random.default_rng(0)
    vals = _rand_i32(rng, 0, 1 << 30, n, device)
    idx = _rand_i32(rng, 0, n, n, device)

    def step(c):
        vals, idx = c
        out = vals.index_select(0, idx)
        return _chain(vals, out[0]), idx

    return step, (vals, idx), n, n * 4 * 3


def case_scatter_add(n: int, device=None):
    """Histogram scatter-add over a 2^20 window (the dev_csr build step)."""
    device = _default_device(device)
    rng = np.random.default_rng(0)
    w = 1 << 20
    idx = _rand_i32(rng, 0, w, n, device)
    ones = torch.ones(n, dtype=torch.int32, device=device)

    def step(c):
        (idx,) = c
        hist = torch.zeros(w, dtype=torch.int32, device=device)
        hist.index_add_(0, idx, ones)
        return (_chain(idx, hist[0]),)

    return step, (idx,), n, n * 4 + w * 4


def case_sort_kv(n: int, device=None):
    device = _default_device(device)
    rng = np.random.default_rng(0)
    keys = _rand_i32(rng, 0, 1 << 31, n, device)
    iota = torch.arange(n, dtype=torch.int32, device=device)

    def step(c):
        keys, iota = c
        ks, perm = torch.sort(keys, stable=True)
        vs = iota.index_select(0, perm)
        return _chain(keys, ks[0] + vs[0]), iota

    return step, (keys, iota), n, n * 4 * 4


def case_join_merge(n: int, device=None):
    """General join, count phase (single sort + segment scans)."""
    device = _default_device(device)
    b, bk, bv, pk, pv, _bk, _pk = _dup_inputs(n, device)

    def step(c):
        bk, bv, pk, pv = c
        ids_s, run_start, _counts, offsets, total = join_ops.join_merge_impl(
            bk, bv, pk, pv)
        s = total + _consume(ids_s, run_start, offsets)
        return _chain(bk, s), bv, pk, pv

    min_bytes = (b + n) * (4 + 1) + n * 8 * 2
    return step, (bk, bv, pk, pv), n, min_bytes


def case_join_merge_e2e(n: int, device=None):
    """General join end to end through the merge path: one sort carrying
    one build and one probe payload column, at the exact learned bucket."""
    device = _default_device(device)
    b, bk, bv, pk, pv, bk_np, pk_np = _dup_inputs(n, device)
    rng = np.random.default_rng(1)
    bpay = _rand_i32(rng, 0, 1 << 30, b, device)
    ppay = _rand_i32(rng, 0, 1 << 30, n, device)
    s_pad = _exact_out_pad(bk_np, pk_np)

    def step(c):
        bk, bv, pk, pv, bpay, ppay = c
        out_b, out_p, live, total = join_ops.join_merge_full_impl(
            bk, bv, pk, pv, s_pad, [(bpay, bv)], [(ppay, pv)])
        s = total + _consume(out_b[0][0], out_p[0][0], live)
        return _chain(bk, s), bv, pk, pv, bpay, ppay

    out_rows = 2 * n  # expected fan-out
    min_bytes = (b + n) * (4 + 1 + 4) + out_rows * (4 + 4 + 1)
    return step, (bk, bv, pk, pv, bpay, ppay), out_rows, min_bytes


def case_sort_carry(n: int, k: int, device=None):
    """Marginal cost of one carried int32 plane: the packed-int64 sort of
    join_merge_impl at combined size 1.25n with k planes moved by its
    permutation."""
    device = _default_device(device)
    rng = np.random.default_rng(0)
    m = n + n // 4  # combined (build + probe) size at dup=4
    packed = _t(rng.integers(0, 1 << 62, m).astype(np.int64), device)
    planes = [_rand_i32(rng, 0, 1 << 30, m, device) for _ in range(k)]

    def step(c):
        packed, *planes = c
        s, perm = torch.sort(packed)
        moved = tuple(p.index_select(0, perm) for p in planes)
        return (_chain(packed, _consume(s)),) + moved

    min_bytes = m * (8 + 4 * k) * 2
    return step, (packed, *planes), m, min_bytes


def _starts(n: int, device):
    rng = np.random.default_rng(0)
    s_pad = 2 * n
    gaps = rng.integers(1, 4, n)
    starts = np.minimum((np.cumsum(gaps) - gaps[0]).astype(np.int32), s_pad)
    return rng, s_pad, _t(starts, device)


def case_scatter_max_starts(n: int, device=None):
    """The owner-recovery scatter in isolation (production shape of
    ops/join.py::_owner_recovery): n sorted starts scatter-max their index
    into a 2n+1 marker, then a cummax fills the runs."""
    device = _default_device(device)
    _rng, s_pad, starts = _starts(n, device)
    iota = torch.arange(n, dtype=torch.int32, device=device)

    def step(c):
        (starts,) = c
        marker = torch.full((s_pad + 1,), -1, dtype=torch.int32,
                            device=device)
        marker.scatter_reduce_(0, starts.long(), iota, "amax")
        owner = torch.cummax(marker[:s_pad], 0).values
        return (_chain(starts, _consume(owner)),)

    min_bytes = n * 4 + s_pad * 4 * 3  # scatter write + cummax r/w
    return step, (starts,), s_pad, min_bytes


def case_scatter_max_sorted(n: int, device=None):
    """scatter_max_starts under its JAX name: XLA takes a sorted-indices
    hint there; torch's scatter has none, so this is the same operation
    (kept so that the two case lists line up)."""
    return case_scatter_max_starts(n, device)


def case_gather_sorted(n: int, device=None):
    """Random-valued gather whose indices are sorted (monotone)."""
    device = _default_device(device)
    rng = np.random.default_rng(0)
    vals = _rand_i32(rng, 0, 1 << 30, n, device)
    idx = _t(np.sort(rng.integers(0, n, n)).astype(np.int32), device)

    def step(c):
        vals, idx = c
        out = vals.index_select(0, idx)
        return _chain(vals, out[0]), idx

    return step, (vals, idx), n, n * 4 * 3


def case_cummax(n: int, device=None):
    """cummax of int32 alone (the scan half of owner recovery)."""
    device = _default_device(device)
    rng = np.random.default_rng(0)
    x = _rand_i32(rng, -1, 1 << 30, n, device)

    def step(c):
        (x,) = c
        y = torch.cummax(x, 0).values
        return (_chain(x, _consume(y)),)

    return step, (x,), n, n * 4 * 2


def case_unique_scatter_dim(n: int, b: int = 1024, device=None):
    """Dimension-table FK->PK join end to end: a ``b``-key unique build
    side probed by n rows, payload materialized. The lookups ride the
    window-gather kernel (window <= WINDOW_GATHER_MAX)."""
    device = _default_device(device)
    rng = np.random.default_rng(0)
    bk = _t(rng.permutation(b).astype(np.int32), device)
    bv = torch.ones(b, dtype=torch.bool, device=device)
    pk = _rand_i32(rng, 0, b, n, device)
    pv = torch.ones(n, dtype=torch.bool, device=device)
    bpay = _rand_i32(rng, 0, 1 << 30, b, device)
    r_pad = join_ops.bucket_size(b)

    def step(c):
        bk, bv, pk, pv, bpay = c
        bidx, found, total = join_ops.join_unique_scatter_impl(
            bk, bv, pk, pv, 0, r_pad)
        (ob,) = join_ops.gather_expand_multi([bpay], bidx)
        s = total + _consume(ob, found)
        return _chain(bk, s), bv, pk, pv, bpay

    # read pk+pv, write payload out + found; build side negligible
    min_bytes = n * (4 + 1) + n * (4 + 1) + 3 * r_pad * 4
    return step, (bk, bv, pk, pv, bpay), n, min_bytes


def case_join_dev_csr(n: int, device=None):
    """Device-built CSR general join over a dense window, end to end."""
    device = _default_device(device)
    b, bk, bv, pk, pv, bk_np, pk_np = _dup_inputs(n, device)
    rng = np.random.default_rng(1)
    bpay = _rand_i32(rng, 0, 1 << 30, b, device)
    ppay = _rand_i32(rng, 0, 1 << 30, n, device)
    r_pad = join_ops.bucket_size(max(b // 2, 128))
    s_pad = _exact_out_pad(bk_np, pk_np)

    def step(c):
        bk, bv, pk, pv, bpay, ppay = c
        bidx, pidx, live, total = join_ops.join_dev_csr_impl(
            bk, bv, pk, pv, 0, r_pad, s_pad)
        # production shape (fused.run): build payloads by bidx (random),
        # probe payloads by the monotone pidx (blocked-window)
        (ob,) = join_ops.gather_expand_multi([bpay], bidx)
        (op,) = join_ops.gather_expand_multi([ppay], pidx, windowed=True)
        s = total + _consume(ob, op, live)
        return _chain(bk, s), bv, pk, pv, bpay, ppay

    out_rows = 2 * n
    min_bytes = (b + n) * (4 + 1 + 4) + out_rows * (4 + 4 + 1)
    return step, (bk, bv, pk, pv, bpay, ppay), out_rows, min_bytes


def case_unique_scatter(n: int, device=None):
    """FK->PK scatter-table join end to end (probe-shaped output)."""
    device = _default_device(device)
    b, bk, bv, pk, pv = _inputs(n, device)
    rng = np.random.default_rng(1)
    bpay = _rand_i32(rng, 0, 1 << 30, b, device)
    r_pad = join_ops.bucket_size(b)

    def step(c):
        bk, bv, pk, pv, bpay = c
        bidx, found, total = join_ops.join_unique_scatter_impl(
            bk, bv, pk, pv, 0, r_pad)
        ob = bpay.index_select(0, bidx)
        s = total + _consume(ob, found)
        return _chain(bk, s), bv, pk, pv, bpay

    min_bytes = (b + n) * (4 + 1) + b * 4 + n * (4 + 1) + r_pad * 4
    return step, (bk, bv, pk, pv, bpay), n, min_bytes


def case_join_csr(n: int, device=None):
    """Host-pregrouped CSR join end to end (build side = base scan)."""
    device = _default_device(device)
    b, _bk, _bv, pk, pv, bk_np, pk_np = _dup_inputs(n, device)
    rng = np.random.default_rng(1)
    bpay = _rand_i32(rng, 0, 1 << 30, b, device)
    ppay = _rand_i32(rng, 0, 1 << 30, n, device)
    # host-side CSR build (as HostColumn.csr_index)
    w = join_ops.bucket_size(b // 2)
    counts_np = np.bincount(bk_np, minlength=w).astype(np.int32)
    counts_w = _t(counts_np, device)
    starts_w = _t((np.cumsum(counts_np) - counts_np).astype(np.int32), device)
    grouped_np = np.zeros(join_ops.bucket_size(b), np.int32)
    grouped_np[:b] = np.argsort(bk_np, kind="stable")
    grouped = _t(grouped_np, device)
    s_pad = _exact_out_pad(bk_np, pk_np)

    def step(c):
        counts_w, starts_w, grouped, pk, pv, bpay, ppay = c
        bidx, pidx, live, total = join_ops.join_csr_impl(
            counts_w, starts_w, grouped, pk, pv, 0, s_pad)
        (ob,) = join_ops.gather_expand_multi([bpay], bidx)
        (op,) = join_ops.gather_expand_multi([ppay], pidx, windowed=True)
        s = total + _consume(ob, op, live)
        return counts_w, starts_w, _chain(grouped, s), pk, pv, bpay, ppay

    out_rows = 2 * n
    min_bytes = n * (4 + 1) + w * 8 + b * 4 + out_rows * (4 + 4 + 1)
    return (step, (counts_w, starts_w, grouped, pk, pv, bpay, ppay),
            out_rows, min_bytes)


def case_fill_starts(n: int, device=None):
    """The rejected expansion design of the JAX package, kept measurable:
    an int64 packed scatter-max at sorted starts + int64 cummax as a
    segmented value broadcast."""
    device = _default_device(device)
    rng, s_pad, starts = _starts(n, device)
    values = _rand_i32(rng, -(1 << 30), 1 << 30, n, device)
    rank1 = torch.arange(1, n + 1, dtype=torch.int64, device=device)

    def step(c):
        starts, values = c
        packed = (rank1 << 32) | (values.to(torch.int64) & 0xFFFFFFFF)
        marker = torch.full((s_pad + 1,), -1, dtype=torch.int64,
                            device=device)
        marker.scatter_reduce_(0, starts.long(), packed, "amax")
        filled = torch.cummax(marker[:s_pad], 0).values
        rank = (filled >> 32).to(torch.int32) - 1
        val = (filled & 0xFFFFFFFF).to(torch.int32)
        return _chain(starts, _consume(rank, val)), values

    min_bytes = n * 8 + s_pad * 8 * 2  # scatter write + cummax read/write
    return step, (starts, values), s_pad, min_bytes


def _case_window_gather(n: int, w: int, device=None):
    device = _default_device(device)
    rng = np.random.default_rng(0)
    tab = _rand_i32(rng, -(1 << 31), 1 << 31, w, device)
    idx = _rand_i32(rng, 0, w, n, device)

    def step(c):
        tab, idx = c
        (out,) = kernels.window_gather([tab], idx)
        return _chain(tab, _consume(out)), idx

    return step, (tab, idx), n, n * 4 * 2 + w * 4


def case_bwg_windowed(n: int, device=None):
    """blocked_window_gather_multi on expansion-shaped (block-windowed)
    indices over a source as large as the index stream."""
    device = _default_device(device)
    rng = np.random.default_rng(0)
    s = n
    src = _rand_i32(rng, -(1 << 31), 1 << 31, s, device)
    base = np.minimum(np.arange(n) // 2, s - 600).astype(np.int32)
    idx = _t(np.minimum(base + rng.integers(0, 500, n), s - 1)
             .astype(np.int32), device)

    def step(c):
        src, idx = c
        (vals,), ok = kernels.blocked_window_gather_multi([src], idx)
        return _chain(src, _consume(vals, ok)), idx

    return step, (src, idx), n, n * 4 * 3


def case_xla_gather_win(n: int, w: int, device=None):
    """Plain gather (``index_select``) from the same small window — the
    routing baseline of the window-gather kernel (the JAX name is kept)."""
    device = _default_device(device)
    rng = np.random.default_rng(0)
    tab = _rand_i32(rng, -(1 << 31), 1 << 31, w, device)
    idx = _rand_i32(rng, 0, w, n, device)

    def step(c):
        tab, idx = c
        out = tab.index_select(0, idx)
        return _chain(tab, _consume(out)), idx

    return step, (tab, idx), n, n * 4 * 2 + w * 4


CASES: Dict[str, Callable] = {
    "copy": case_copy,
    "gather": case_gather,
    "scatter_add": case_scatter_add,
    "sort_kv": case_sort_kv,
    "sort_carry0": lambda n, device=None: case_sort_carry(n, 0, device),
    "sort_carry2": lambda n, device=None: case_sort_carry(n, 2, device),
    "sort_carry4": lambda n, device=None: case_sort_carry(n, 4, device),
    "scatter_max_starts": case_scatter_max_starts,
    "scatter_max_sorted": case_scatter_max_sorted,
    "gather_sorted": case_gather_sorted,
    "cummax": case_cummax,
    "join_merge": case_join_merge,
    "join_merge_e2e": case_join_merge_e2e,
    "join_dev_csr": case_join_dev_csr,
    "join_csr": case_join_csr,
    "unique_scatter": case_unique_scatter,
    "unique_scatter_dim1k":
        lambda n, device=None: case_unique_scatter_dim(n, 1 << 10, device),
    "unique_scatter_dim4k":
        lambda n, device=None: case_unique_scatter_dim(n, 1 << 12, device),
    "fill_starts": case_fill_starts,
    "kpass_gather_1k": lambda n, device=None: _case_window_gather(n, 1 << 10, device),
    "kpass_gather_2k": lambda n, device=None: _case_window_gather(n, 1 << 11, device),
    "kpass_gather_4k": lambda n, device=None: _case_window_gather(n, 1 << 12, device),
    "kpass_gather_8k": lambda n, device=None: _case_window_gather(n, 1 << 13, device),
    "kpass_gather_16k": lambda n, device=None: _case_window_gather(n, 1 << 14, device),
    "bwg_windowed": case_bwg_windowed,
    "xla_gather_4k": lambda n, device=None: case_xla_gather_win(n, 1 << 12, device),
    "xla_gather_32k": lambda n, device=None: case_xla_gather_win(n, 1 << 15, device),
}


def run(
    size: int = 1 << 24,
    reps: int = 3,
    cases: Optional[List[str]] = None,
    spec: Optional[hardware.ChipSpec] = None,
    k_lo: int = 2,
    k_hi: int = 10,
    device=None,
) -> List[Measurement]:
    device = _default_device(device)
    spec = spec or hardware.detect(device)
    out = []
    for name in cases or list(CASES):
        step, carry, rows, min_bytes = CASES[name](size, device)
        ms, mode = _slope(step, carry, k_lo, k_hi, reps)
        out.append(_measure(name, rows, ms, min_bytes, spec, mode=mode))
        del step, carry
    return out


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "nvidia-smi not available"


def require_card() -> torch.device:
    """The measurement entry points time the card and nothing else."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card (torch.cuda.is_available() is "
                         "false): device time cannot be measured")
    return torch.device("cuda")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=1 << 24, help="probe rows")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--k-lo", type=int, default=2)
    ap.add_argument("--k-hi", type=int, default=10)
    ap.add_argument("--cases", type=str, default=None, help="comma list")
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument(
        "--mode", choices=("slope", "single"), default="slope",
        help="slope: two-point slope of a K-iteration loop (exact); "
             "single: one call on the host clock minus the measured floor",
    )
    args = ap.parse_args(argv)

    device = require_card()
    spec = hardware.detect(device)
    floor = measure_floor_ms(device=device) if args.mode == "single" else None
    print(
        f"chip: {spec.name}  HBM {spec.hbm_gbps:.0f} GB/s  (device "
        f"{torch.cuda.get_device_name(device)}; {card_line()})  "
        f"n={args.size:,}  mode={args.mode}"
        + (f"  floor={floor:.3f}ms" if floor is not None else "")
    )
    names = args.cases.split(",") if args.cases else list(CASES)
    results = []
    print(f"{'kernel':<26} {'rows':>12} {'dev_ms':>9} {'rows/s':>9} "
          f"{'GB/s':>8} {'%roof':>7} {'timing':>6}")
    for name in names:
        step, carry, rows, min_bytes = CASES[name](args.size, device)
        reliable, mode = True, "single"
        if args.mode == "single":
            ms, reliable = single_time_ms(step, carry, max(args.reps, 5),
                                          floor)
        else:
            ms, mode = _slope(step, carry, args.k_lo, args.k_hi, args.reps)
        m = _measure(name, rows, ms, min_bytes, spec, reliable, mode)
        results.append(m)
        print(m.row(), flush=True)
        del step, carry
    if args.json:
        doc = {
            "methodology": (
                "single call on the host clock minus the measured floor"
                if args.mode == "single"
                else "two-point slope of a K-iteration loop between CUDA "
                     "events (graph replay where capturable)"
            ),
            "chip": spec.name,
            "device": torch.cuda.get_device_name(device),
            "card": card_line(),
            "hbm_gbps": spec.hbm_gbps,
            "size": args.size,
            "k": [args.k_lo, args.k_hi],
            "floor_ms": floor,
            "results": [dataclasses.asdict(m) for m in results],
        }
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2)


if __name__ == "__main__":
    main()
