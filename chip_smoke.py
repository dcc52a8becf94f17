"""Smoke run of radixjoin_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py [--scale 0.1] [--seed 0]

Phases (any failure exits non-zero; the last line of standard output is
``{"ok": true, "device": {...}}`` only when every phase passed):

1. Environment and build: the card's name and power limit, the torch and
   CUDA versions, and the build of the CUDA kernels from
   ``radixjoin_tpu_torch/csrc`` with nvcc for sm_90a, one nvcc per source,
   all at once (seconds, ptxas' register and shared-memory report).
2. Kernel checks: each kernel against its plain PyTorch version on the card,
   on the same inputs, bit-equal, with the median time of warm runs of
   both: the join kernels at main-path shapes, the gather-experiment
   kernels at the tools' default shapes (n = 2^24, window 2^20, one-hot
   window 2048), with the route (shared memory or L2) each case took.
3. Main path: the synthetic IMDB at ``--scale`` (default 0.1, the
   repository bench's scale) and ``--seed``, three JOB-shaped plans
   (radixjoin_tpu_torch/harness/job_shapes.py) — S1 from eager pages
   (device page decode), S2 lazily (dense upload), S3 with a combined pad
   of 2^23 at the root (the merge join) — and F1, a join on FP64 keys
   (merge join). Each runs cold and warm through ``execute`` on the card,
   with the kernels' launch counters set to 0 just before and read just
   after, then once through ``build_context("cpu")``, where the plain
   versions serve as the oracle. Checked: equal per-join totals, equal
   row multisets, the root cardinality against a numpy count over the
   base tables, the join strategies covered (merge included), and a
   launch count above 0 for every kernel of the path.
4. Device-time path: with the counters set to 0 just before, every case
   of ``harness/devtime.py`` at ``--devtime-size`` rows (default 2^22),
   printed with its ms and share of the HBM figure, then the kernel cases
   of the three gather-experiment tools (``radixjoin_tpu_torch/tools``)
   at their default shapes; the counters are read just after, and every
   kernel of the path must have launched.

Before the last line it prints one JSON object with a record per kernel:
``{"kernels": [{"name", "route", "source", "replaces", "launches",
"max_abs_err", "ms", "plain_ms"}, ...]}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def _log(msg: str) -> None:
    print(msg, flush=True)


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _timed(torch, fn, runs: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``runs`` warm calls, each bracketed by CUDA
    events and a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _flat(x) -> list:
    """A kernel's outputs (tensor, list, or (list, tensor)) as one list."""
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _flat(e)]
    return [x]


def _max_abs_err(torch, got, want) -> float:
    if got.dtype == torch.bool:
        got, want = got.to(torch.int8), want.to(torch.int8)
    if got.shape != want.shape:
        return float("inf")
    if got.numel() == 0:
        return 0.0
    return float((got.double() - want.double()).abs().max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(torch, kernels, dev, seed: int):
    """Run every kernel case; returns {kernel name: record} with the
    representative case's times and the worst error over all cases."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand_table(n, dtype):
        lo, hi = (-(2 ** 31), 2 ** 31) if dtype == torch.int32 else (-(2 ** 62), 2 ** 62)
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=dtype)

    records = {}

    def case(name, label, fn_kernel, fn_plain, representative):
        got, want = _flat(fn_kernel()), _flat(fn_plain())
        torch.cuda.synchronize()
        route = getattr(getattr(kernels, name), "last_route", None)
        if route:
            label = f"{label} route={route}"
        err = max(_max_abs_err(torch, g, w) for g, w in zip(got, want))
        if len(got) != len(want) or err != 0.0:
            _fail(f"{name} [{label}] disagrees with its plain version "
                  f"(max abs err {err})")
        ms = _timed(torch, fn_kernel)
        plain_ms = _timed(torch, fn_plain)
        _log(f"kernel {name} [{label}]: bit-equal, kernel {ms:.4f} ms, "
             f"plain {plain_ms:.4f} ms")
        rec = records.setdefault(name, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if representative:
            rec.update(ms=ms, plain_ms=plain_ms, shape=label)

    n = 4 << 20
    for w in (128, 4096):
        for k in (1, 8):
            for dtype in (torch.int32, torch.int64):
                tabs = [rand_table(w, dtype) for _ in range(k)]
                idx = torch.randint(0, w, (n,), generator=gen, device=dev,
                                    dtype=torch.int32)
                label = f"W={w} K={k} {str(dtype)[6:]} N={n}"
                case("window_gather", label,
                     lambda t=tabs, i=idx: kernels.window_gather(t, i),
                     lambda t=tabs, i=idx: kernels.window_gather_plain(t, i),
                     representative=(w == 4096 and k == 8
                                     and dtype == torch.int64))

    n = 8 << 20
    src_len = 4 << 20
    tabs = [rand_table(src_len, torch.int32), rand_table(src_len, torch.int64),
            rand_table(src_len // 2, torch.int32),
            torch.rand(src_len, generator=gen, device=dev) < 0.5]
    mono = torch.sort(torch.randint(0, src_len // 2, (n,), generator=gen,
                                    device=dev, dtype=torch.int32)).values
    miss = mono.clone()
    pick = torch.randint(0, n, (n // 100,), generator=gen, device=dev)
    miss[pick] = torch.randint(0, src_len // 2, (n // 100,), generator=gen,
                               device=dev, dtype=torch.int32)
    for label, idx in (("monotone fan-out", mono), ("1% random misses", miss)):
        case("blocked_window_gather_multi",
             f"{label} N={n} tables<={src_len}",
             lambda i=idx: kernels.blocked_window_gather_multi(tabs, i),
             lambda i=idx: kernels.blocked_window_gather_multi_plain(tabs, i),
             representative=(idx is mono))

    # the decode's own index shapes: word db + rank for INT32 rows (1920 a
    # page), words 2 + 2*rank and 3 + 2*rank for INT64 rows (960 a page),
    # rank the in-page exclusive count of valid rows
    npages = 1900
    body = rand_table(npages * 2048, torch.int32).view(npages, 2048)
    for label, rows in (("INT32 R=1920", 1920), ("INT64 2x960 words", 960)):
        bits = (torch.rand((npages, rows), generator=gen, device=dev) < 0.8)
        bits = bits.to(torch.int32)
        rank = torch.cumsum(bits, dim=1, dtype=torch.int32) - bits
        idx = (1 + rank if rows == 1920 else
               torch.cat([2 + 2 * rank, 3 + 2 * rank], dim=1)).contiguous()
        case("paged_window_gather", f"{npages} pages {label}",
             lambda i=idx: kernels.paged_window_gather(body, i),
             lambda i=idx: kernels.paged_window_gather_plain(body, i),
             representative=(rows == 1920))

    # the gather-experiment kernels at the tools' default shapes
    n = 1 << 24

    def tool_inputs(w, shape=None, hi=2 ** 31):
        table = torch.randint(-hi, hi, (w,), generator=gen, device=dev,
                              dtype=torch.int32)
        idx = torch.randint(0, w, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        return (table if shape is None else table.view(shape)), idx

    for body, w, shape in (("take", 1 << 20, None),
                           ("take_unique", 1 << 20, None),
                           ("take", 1 << 14, None),
                           ("ta_lanes", 1024, (8, 128))):
        t, i = tool_inputs(w, shape)
        case("pallas_gather", f"{body} w={w} n={n}",
             lambda t=t, i=i, b=body: kernels.pallas_gather(t, i, body=b),
             lambda t=t, i=i, b=body: kernels.pallas_gather_plain(t, i, b),
             representative=(body == "take" and w == 1 << 20))
    # values below 2^24 in magnitude: the one-hot product's exact range
    t, i = tool_inputs(2048, hi=2 ** 24)
    case("onehot_gather", f"w=2048 n={n}",
         lambda: kernels.onehot_gather(t, i),
         lambda: kernels.onehot_gather_plain(t, i), representative=True)
    for w in (1 << 20, 1 << 14):
        t, i = tool_inputs(w)
        case("gather_pallas_vmem", f"w={w} n={n} blk=4096",
             lambda t=t, i=i: kernels.gather_pallas_vmem(t, i),
             lambda t=t, i=i: kernels.gather_pallas_vmem_plain(t, i),
             representative=(w == 1 << 20))
    for body, w in (("rows", 1 << 20), ("lanes", 1024), ("2level", 1 << 20),
                    ("2level", 1 << 16), ("2level", 1 << 14), ("sub", 1024)):
        t, i = tool_inputs(w, shape=(-1, 128))
        case("mk_gather", f"{body} w={w} n={n}",
             lambda t=t, i=i, b=body: kernels.mk_gather(t, i, body=b),
             lambda t=t, i=i, b=body: kernels.mk_gather_plain(t, i, b),
             representative=(body == "2level" and w == 1 << 20))
    return records


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def _result_columns(np, table):
    """Decoded result columns as (valid, value) arrays, NULL values zeroed;
    VARCHAR as bytes objects (b"" where NULL)."""
    host = table.to_host()
    cols = []
    for c in host.columns:
        vals = c.objects() if c.dtype.is_varchar else np.where(c.valid, c.values, 0)
        cols.append((c.valid, vals))
    return host.num_rows, cols


def _same_rows(np, a, b) -> bool:
    """Row multisets equal: every column coded to integers (VARCHAR via a
    joint np.unique), rows sorted with np.lexsort, compared column-wise."""
    na, ca = _result_columns(np, a)
    nb, cb = _result_columns(np, b)
    if na != nb or len(ca) != len(cb):
        return False
    keys_a, keys_b = [], []
    for (va, xa), (vb, xb) in zip(ca, cb):
        if xa.dtype == object:
            _, inv = np.unique(np.concatenate([xa, xb]), return_inverse=True)
            xa, xb = inv[:na], inv[na:]
        keys_a += [va, xa]
        keys_b += [vb, xb]
    oa = np.lexsort(keys_a[::-1])
    ob = np.lexsort(keys_b[::-1])
    return all(np.array_equal(x[oa], y[ob]) for x, y in zip(keys_a, keys_b))


def _expected_root_rows(np, tables, name):
    """Root cardinality from numpy counts over the base tables: every FK in
    these unfiltered plans matches, so the root is the per-key product of
    the two sides' row counts."""
    if name == "S3":
        ci, rt = tables["cast_info"], tables["role_type"]
        role, ids = ci.columns[6], ci.columns[0]
        ok = (role.valid & ids.valid
              & np.isin(role.values, rt.columns[0].values[rt.columns[0].valid]))
        per_id = np.bincount(ids.values[ok]).astype(np.int64)
        return int((per_id * per_id).sum())
    if name == "F1":
        keys = []
        for t in (tables["f64_left"], tables["f64_right"]):
            k = t.columns[0]
            keys.append(k.values[k.valid] + 0.0)  # -0.0 joins 0.0
        u, ca = np.unique(keys[0], return_counts=True)
        ub, cb = np.unique(keys[1], return_counts=True)
        _common, ia, ib = np.intersect1d(u, ub, return_indices=True)
        return int((ca[ia].astype(np.int64) * cb[ib]).sum())

    def per_movie(table, col):
        t = tables[table]
        return np.bincount(t.columns[col].values[t.columns[col].valid],
                           minlength=tables["title"].num_rows + 2)
    if name == "S1":
        a, b = per_movie("movie_info_idx", 1), per_movie("movie_companies", 1)
    else:
        a, b = per_movie("cast_info", 2), per_movie("movie_keyword", 1)
    n = min(len(a), len(b))
    return int((a[:n].astype(np.int64) * b[:n]).sum())


def run_main_path(torch, np, rt, kernels, args):
    from radixjoin_tpu_torch.harness import job_shapes
    from radixjoin_tpu_torch.harness.datagen import SyntheticIMDB

    t0 = time.perf_counter()
    names = sorted(set(job_shapes.S1_TABLES + job_shapes.S2_TABLES
                       + job_shapes.S3_TABLES) | {"title"})
    tables = SyntheticIMDB(scale=args.scale, seed=args.seed).generate(names)
    _log(f"datagen scale={args.scale} seed={args.seed}: "
         f"{time.perf_counter() - t0:.2f} s, rows "
         + ", ".join(f"{n}={tables[n].num_rows}" for n in names))
    tables.update(job_shapes.f64_tables(seed=args.seed))

    shapes = (("S1", job_shapes.s1_plan, False),
              ("S2", job_shapes.s2_plan, True),
              ("S3", job_shapes.s3_plan, True),
              ("F1", job_shapes.f64_plan, True))
    plans = {}
    for name, build, lazy in shapes:
        t1 = time.perf_counter()
        plans[name] = build(tables, lazy=lazy)
        _log(f"{name}: plan built ({'lazy' if lazy else 'eager pages'}) in "
             f"{time.perf_counter() - t1:.2f} s")

    ctx = rt.build_context()
    torch.cuda.reset_peak_memory_stats()
    results = {}
    kernels.reset_launch_counts()
    for name, _build, _lazy in shapes:
        for run in ("cold", "warm"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = rt.execute(plans[name], ctx)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            results[(name, run)] = (res, dict(plans[name]._last_join_totals))
            _log(f"{name} {run}: {ms:.1f} ms wall (execute incl. page "
                 f"encode of the result), {res.num_rows} rows")
    launches = kernels.launch_counts()
    _log(f"main path peak device memory: "
         f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
         f"(torch.cuda.max_memory_allocated)")
    _log(f"main path kernel launches: {json.dumps(launches)}")

    strategies = set()
    cpu = rt.build_context("cpu")
    for name, build, lazy in shapes:
        plan_strategies = set(
            plans[name]._fused_struct_cache[1].strategies().values())
        if name in ("S3", "F1") and "merge" not in plan_strategies:
            _fail(f"{name} did not take the merge join: {plan_strategies}")
        strategies |= plan_strategies
        t1 = time.perf_counter()
        oracle_plan = build(tables, lazy=lazy)
        oracle = rt.execute(oracle_plan, cpu)
        _log(f"{name} cpu oracle: {(time.perf_counter() - t1) * 1e3:.1f} ms")
        expected = _expected_root_rows(np, tables, name)
        for run in ("cold", "warm"):
            res, totals = results[(name, run)]
            if totals != oracle_plan._last_join_totals:
                _fail(f"{name} {run}: per-join totals {totals} != cpu "
                      f"{oracle_plan._last_join_totals}")
            if not _same_rows(np, res, oracle):
                _fail(f"{name} {run}: rows differ from the cpu oracle")
        if oracle.num_rows != expected:
            _fail(f"{name}: {oracle.num_rows} rows, numpy count {expected}")
        _log(f"{name}: cold and warm equal the cpu oracle in rows and "
             f"per-join totals {oracle_plan._last_join_totals}; root rows "
             f"{expected} match the numpy count")

    _log(f"strategies: {sorted(strategies)}")
    need = ({"unique_scatter"}, {"csr", "csr_swapped"},
            {"dev_csr", "dev_csr_swapped"}, {"merge"})
    if not all(strategies & s for s in need):
        _fail(f"strategies {sorted(strategies)} miss one of {need}")
    if not all(launches[k] > 0 for k in MAIN_PATH_KERNELS):
        _fail(f"a kernel of the path was not launched: {launches}")
    for name, _build, _lazy in shapes:
        profile_warm(torch, rt, plans[name], ctx, name)
    return launches


#: kernels the engine's main path launches (S1-S3, F1)
MAIN_PATH_KERNELS = ("window_gather", "blocked_window_gather_multi",
                     "paged_window_gather")
#: kernels the device-time path launches (devtime cases, the three tools)
DEVTIME_PATH_KERNELS = ("window_gather", "blocked_window_gather_multi",
                        "pallas_gather", "gather_pallas_vmem", "mk_gather",
                        "onehot_gather")


# ---------------------------------------------------------------------------
# phase 4: the device-time microbenchmark path
# ---------------------------------------------------------------------------


def run_devtime_path(torch, kernels, args):
    """Every devtime case at ``args.devtime_size`` rows, then the kernel
    cases of the three gather-experiment tools at their default shapes,
    counted. Returns the launch counts of this path."""
    from radixjoin_tpu_torch import hardware
    from radixjoin_tpu_torch.harness import devtime
    from radixjoin_tpu_torch.tools import (expt_gather2, expt_pallas,
                                           expt_primitives)

    dev = torch.device("cuda")
    spec = hardware.detect(dev)
    _log(f"devtime: {spec.name}, HBM {spec.hbm_gbps:.0f} GB/s (published), "
         f"{spec.sm_count} SMs, L2 {spec.l2_bytes / 2**20:.0f} MiB, "
         f"shared memory per block {spec.smem_per_block_bytes} B; "
         f"n = {args.devtime_size:,}")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    _log(f"{'kernel':<26} {'rows':>12} {'dev_ms':>9} {'rows/s':>9} "
         f"{'GB/s':>8} {'%roof':>7} {'timing':>6}")
    for m in devtime.run(args.devtime_size, device=dev, spec=spec):
        _log(m.row())
    _log(f"devtime: all {len(devtime.CASES)} cases in "
         f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    failed = (
        expt_pallas.main(["--cases", ",".join(expt_pallas.KERNEL_CASES)])
        + expt_primitives.main(["--cases",
                                ",".join(expt_primitives.KERNEL_CASES)])
        + expt_gather2.main())
    if failed:
        _fail(f"tool cases failed: {failed}")
    _log(f"tools: kernel cases in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    _log(f"device-time path kernel launches: {json.dumps(launches)}")
    if not all(launches[k] > 0 for k in DEVTIME_PATH_KERNELS):
        _fail(f"a kernel of the device-time path was not launched: "
              f"{launches}")
    return launches


def profile_warm(torch, rt, plan, ctx, name: str) -> None:
    """Where a warm run's time goes: the fused run with its fetches and
    root decode, the result page encode, and the device's busy time from
    torch.profiler (device-side kernel and copy time summed), hence its
    idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from radixjoin_tpu_torch import engine

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = engine._fused_attempts(plan, ctx.device)
    t1 = time.perf_counter()
    engine._encode_result(host)
    t2 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t3 = time.perf_counter()
        rt.execute(plan, ctx)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    # device-side events only (kernels and copies): the CPU operators that
    # launched them carry the same device time and would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    wall_ms = (t4 - t3) * 1e3
    _log(f"{name} warm breakdown: fused run + fetch + root decode "
         f"{(t1 - t0) * 1e3:.1f} ms, result page encode "
         f"{(t2 - t1) * 1e3:.1f} ms")
    if not events:
        _log(f"{name} warm profile: device time not measured (the "
             f"profiler reported none)")
        return
    _log(f"{name} warm profile: execute {wall_ms:.1f} ms wall under the "
         f"profiler, device busy {busy_ms:.3f} ms, idle share "
         f"{1 - busy_ms / wall_ms:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        _log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
             f"{e.key[:90]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devtime-size", type=int, default=1 << 22)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke needs a card")
    import numpy as np

    import radixjoin_tpu_torch as rt
    from radixjoin_tpu_torch.ops import kernels

    # phase 1: environment and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _log(f"card: {smi}")
    _log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
         f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    kernels.build()
    _log(f"kernel build: {kernels.BUILD_INFO['seconds']:.1f} s -> "
         f"{', '.join(kernels.BUILD_INFO['paths'])}")
    for line in str(kernels.BUILD_INFO["log"]).splitlines():
        if "Used" in line or "Compiling entry" in line:
            _log(f"  ptxas: {line.strip()}")

    # phase 2: kernels against their plain versions
    dev = torch.device("cuda")
    records = check_kernels(torch, kernels, dev, args.seed)

    # phase 3: the main path, counted
    launches = run_main_path(torch, np, rt, kernels, args)
    # phase 4: the device-time path, counted
    dt_launches = run_devtime_path(torch, kernels, args)

    meta = {
        "window_gather": ("csrc/window_gather.cu",
                          "radixjoin_tpu/ops/pallas_kernels.py:164"),
        "blocked_window_gather_multi": (
            "csrc/blocked_window_gather.cu",
            "radixjoin_tpu/ops/pallas_kernels.py:340"),
        "paged_window_gather": ("csrc/paged_window_gather.cu",
                                "radixjoin_tpu/ops/pallas_kernels.py:231"),
        "pallas_gather": ("csrc/resident_gather.cu",
                          "tools/expt_pallas.py:39"),
        "onehot_gather": ("csrc/onehot_gather.cu",
                          "tools/expt_pallas.py:108"),
        "gather_pallas_vmem": ("csrc/resident_gather.cu",
                               "tools/expt_primitives.py:94"),
        "mk_gather": ("csrc/resident_gather.cu", "tools/expt_gather2.py:52"),
    }
    out = []
    for name, (src, replaces) in meta.items():
        rec = records[name]
        counted = launches if name in MAIN_PATH_KERNELS else dt_launches
        out.append({
            "name": name, "route": "cuda",
            "source": f"radixjoin_tpu_torch/{src}", "replaces": replaces,
            "launches": counted[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
        })
        _log(f"{name}: ms and plain_ms below are at {rec['shape']}")
    _log(f"card: {smi}")
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
