"""Benchmark: the JOB suite on the synthetic IMDB, one CUDA card (port of
the JAX package's ``bench.py``; imports torch and numpy only).

    python -m radixjoin_tpu_torch.bench

The protocol is the reference's (tests/read_sql.cpp:1251-1333): per-query
timing covers ``execute()`` only (plan construction and base-table
filtering excluded); the metric is the suite total, best of
``BENCH_REPEAT`` passes a query. The suite runs on the literal-aware
synthetic IMDB (``harness/datagen.py``, seed 0, cached in the gitignored
``.bench_cache/``) at ``BENCH_SCALE``. Every query is warmed by two
executes first: the first learns the cardinality feedback, the second runs
in the steady state.

Query files: ``BENCH_PLANS`` names them and has no default, since the JOB
suite's ``plans.json`` and ``.sql`` files are not in the repository: a path
to a ``plans.json`` (its ``.sql`` files in ``BENCH_SQL_DIR``, by default
the document's ``sql_directory``, as the harness reads it), or
``builtin``, which writes the JOB-shaped documents of
``harness/job_shapes.py`` into a temporary directory and runs those.
Without it, or with a path that does not exist, the bench exits non-zero.

After the timed passes, bonus stages that each report in ``detail`` (and
only log a failure, leaving the headline intact):

* ``device_ms``: each query's device busy time in a warm run under
  ``torch.profiler`` (kernels and copies) and its idle share; on the card
  only (``BENCH_DEVICE_MS=off`` skips it);
* ``batch_wall_ms``: the suite as one ``execute_many`` batch, best of 2
  (``BENCH_BATCH=off`` skips it);
* ``secondary``: one warm serial pass at ``BENCH_SECONDARY_SCALE``
  (default 0.01; "" skips it; skipped under ``BENCH_QUERIES``).

Env knobs: ``BENCH_PLATFORM`` (``cuda``, the default: the bench fails
without a card; ``cpu`` on request), ``BENCH_SCALE`` (0.1),
``BENCH_REPEAT`` (2), ``BENCH_QUERIES`` (comma list), ``BENCH_PLANS``,
``BENCH_SQL_DIR``, ``BENCH_SECONDARY_SCALE``, ``BENCH_BATCH``,
``BENCH_DEVICE_MS``, ``BENCH_DEADLINE_S`` (3300: the watchdog
then emits what was measured, flagged partial, and exits 3, or 0 when only
a bonus stage was left), ``BENCH_RSS_PROFILE=1`` (host memory snapshots
a phase on stderr).

Prints exactly one JSON line on stdout; the metric's name counts the
queries that ran (``job5_synthetic_sf0.1_total_ms`` for the built-in
documents). ``detail.launches`` holds each hand kernel's launches in the
warm-up and the timed passes (``ops/kernels.launch_counts()``, set to 0
before the warm-up). ``vs_baseline`` is null unless all 113 JOB queries
ran: the 914,223 ms baseline is the reference's 113-query total.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_TOTAL_MS = 914_223.0  # BASELINE.md: JOB 113-query total, 7995WX
BASELINE_QUERIES = 113
DEFAULT_SCALE = "0.1"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _rss_gb() -> float:
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmRSS"):
                    return int(ln.split()[1]) / (1 << 20)
    except OSError:
        pass
    return -1.0


def _mem_snapshot(tag: str) -> None:
    """Attribute host-RSS growth: Python-heap bytes (tracemalloc) against
    anonymous RSS (smaps_rollup). Python-side retention (results,
    feedback) shows in both; native growth (torch's pinned host pool, the
    page codec) only in anon. Opt-in: BENCH_RSS_PROFILE=1."""
    if os.environ.get("BENCH_RSS_PROFILE") != "1":
        return
    import gc
    import tracemalloc

    gc.collect()
    anon = rss = -1
    try:
        with open("/proc/self/smaps_rollup") as f:
            for ln in f:
                if ln.startswith("Anonymous:"):
                    anon = int(ln.split()[1]) >> 10  # MB
                elif ln.startswith("Rss:"):
                    rss = int(ln.split()[1]) >> 10
    except OSError:
        pass
    if not tracemalloc.is_tracing():
        tracemalloc.start(10)
        log(f"bench[mem] {tag}: rss={rss}MB anon={anon}MB "
            f"(tracemalloc now on)")
        return
    cur, peak = tracemalloc.get_traced_memory()
    top = tracemalloc.take_snapshot().statistics("lineno")[:5]
    log(f"bench[mem] {tag}: rss={rss}MB anon={anon}MB "
        f"pyheap={cur >> 20}MB (peak {peak >> 20}MB) "
        f"native~={max(0, anon - (cur >> 10) // 1024)}MB")
    for st in top:
        log(f"bench[mem]   {st}")


_partial = {"per_query": {}, "stage": "init", "result_rows": 0,
            "backend": "unknown", "stage_totals": {}}


def _emit(total_ms, scale, n_queries, partial=False):
    scaled_baseline = BASELINE_TOTAL_MS * scale
    detail = {
        "queries": n_queries,
        "result_rows": int(_partial["result_rows"]),
        "scaled_baseline_ms": round(scaled_baseline, 1),
        "backend": _partial["backend"],
        "slowest": sorted(
            _partial["per_query"].items(), key=lambda kv: -kv[1]
        )[:5],
    }
    if "batch_wall_ms" in _partial:
        detail["batch_wall_ms"] = _partial["batch_wall_ms"]
    if "phase_times" in _partial:
        detail["warmup_phase_s"] = _partial["phase_times"]
    if "secondary" in _partial:
        detail["secondary"] = _partial["secondary"]
    if _partial["stage_totals"]:
        # suite-wide stage split (best pass): dispatch vs result fetch vs
        # host decode
        detail["stage_split_ms"] = {
            k: round(v, 1) for k, v in _partial["stage_totals"].items()
        }
    if "device_ms" in _partial:
        detail["device_ms"] = _partial["device_ms"]
    if "launches" in _partial:
        detail["launches"] = _partial["launches"]
    # degradation tallies: the headline is the PRIMARY-pass snapshot (taken
    # right after the timed passes); the later stages tally into the
    # process-wide stats, reported apart when they differ
    try:
        from radixjoin_tpu_torch.engine import engine_stats

        now = engine_stats()
        snap = _partial.get("degradations_primary")
        detail["degradations"] = snap if snap is not None else now
        if snap is not None and snap != now:
            detail["degradations_process"] = now
    except Exception:  # noqa: BLE001 - emit must never fail
        pass
    if partial:
        detail["partial"] = f"watchdog fired during {_partial['stage']}"
    full_suite = n_queries == BASELINE_QUERIES
    print(json.dumps({
        "metric": f"job{n_queries}_synthetic_sf{scale}_total_ms",
        "value": round(total_ms, 2),
        "unit": "ms",
        "vs_baseline": (round(scaled_baseline / total_ms, 3)
                        if full_suite and total_ms else None),
        "detail": detail,
    }), flush=True)


def _arm_watchdog(scale, n_queries):
    """If the suite cannot finish inside BENCH_DEADLINE_S (default 55 min),
    emit whatever was measured as an explicitly partial result instead of
    hanging until the caller kills the process with nothing recorded."""
    import threading

    deadline = float(os.environ.get("BENCH_DEADLINE_S", "3300"))

    def fire():
        timed = {
            k: v for k, v in _partial["per_query"].items() if v is not None
        }
        log(f"bench: WATCHDOG after {deadline:.0f}s in stage "
            f"'{_partial['stage']}' ({len(timed)}/{n_queries} queries timed)")
        total = sum(timed.values())
        if _partial["stage"] in ("batch", "secondary", "device-ms"):
            # the headline serial protocol finished; only a bonus stage
            # stalled: emit the full result without that stage's detail
            _partial.pop("batch_wall_ms", None)
            if _partial["stage"] == "secondary":
                _partial.pop("secondary", None)
            if _partial["stage"] == "device-ms":
                _partial.pop("device_ms", None)
            _emit(total, scale, len(timed))
            os._exit(0)
        _emit(total if timed else 0.0, scale, len(timed), partial=True)
        os._exit(3)

    t = threading.Timer(deadline, fire)
    t.daemon = True
    t.start()
    return t


def _device():
    """The engine's device: the card, or the CPU under BENCH_PLATFORM=cpu.
    Without a card the bench fails; it never falls back to the CPU."""
    import torch

    platform = os.environ.get("BENCH_PLATFORM", "cuda")
    if platform == "cpu":
        return "cpu"
    if platform != "cuda":
        raise SystemExit(f"bench: BENCH_PLATFORM={platform!r}: cuda or cpu")
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA card (torch.cuda.is_available() is "
                         "false); set BENCH_PLATFORM=cpu to run on the CPU")
    return None


def _query_files(tmp_dirs):
    """``(plans.json, sql dir)`` of the suite: BENCH_PLANS / BENCH_SQL_DIR,
    or the built-in documents written to a temporary directory under
    BENCH_PLANS=builtin."""
    plans = os.environ.get("BENCH_PLANS")
    sql_dir = os.environ.get("BENCH_SQL_DIR")
    if plans == "builtin":
        from radixjoin_tpu_torch.harness import job_shapes

        tmp = tempfile.TemporaryDirectory(prefix="rjt_bench_documents_")
        tmp_dirs.append(tmp)
        plans = job_shapes.write_query_documents(tmp.name)
    elif not plans:
        raise SystemExit(
            "bench: BENCH_PLANS is not set: name the JOB suite's plans.json "
            "(its .sql files in BENCH_SQL_DIR), or BENCH_PLANS=builtin for "
            "the JOB-shaped documents of harness/job_shapes.py")
    if not os.path.exists(plans):
        raise SystemExit(f"bench: query files not found ({plans!r})")
    if not sql_dir:
        from radixjoin_tpu_torch.harness.run import _sql_directory

        with open(plans) as f:
            sql_dir = _sql_directory(json.load(f), plans)
    if not os.path.exists(sql_dir):
        raise SystemExit(f"bench: query files not found ({sql_dir!r})")
    return plans, sql_dir


def _device_ms_stage(names, plans, context, execute) -> dict:
    """Each query's device busy time (device-side kernel and copy time
    from torch.profiler) in one warm run, and its idle share."""
    from radixjoin_tpu_torch.harness import kernel_timing

    dev_ms, idle = {}, {}
    for name in names:
        prof = kernel_timing.profile_busy(
            lambda: execute(plans[name], context))
        if prof["busy_ms"] is not None:
            dev_ms[name] = prof["busy_ms"]
            idle[name] = round(prof["idle_share"], 3)
    return {
        "total_ms": round(sum(dev_ms.values()), 3),
        "queries_measured": len(dev_ms),
        "slowest": sorted(((n, round(v, 3)) for n, v in dev_ms.items()),
                          key=lambda kv: -kv[1])[:5],
        "idle_share": idle,
    }


def _secondary_pass(scale: float, names, sql_dir, plans_path,
                    device) -> dict:
    """One warm serial pass at a secondary scale: two warm executes a
    query, then one timed pass; the summary for ``detail.secondary``."""
    from radixjoin_tpu_torch import engine as _eng
    from radixjoin_tpu_torch.harness import datagen
    from radixjoin_tpu_torch.harness.run import JobHarness, TableSource

    stats_before = _eng.engine_stats()
    t0 = time.perf_counter()
    queries = datagen.load_job_queries(sql_dir, names)
    tables = datagen.generate_cached(
        scale, 0, queries, cache_dir=os.path.join(REPO, ".bench_cache")
    )
    harness = JobHarness(plans_path, TableSource(host_tables=tables), sql_dir,
                         device=device)
    try:
        plans = {n: harness.build_plan(n)[1] for n in names}
        log(f"bench: secondary sf{scale} setup "
            f"{time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        for _ in range(2):
            for name in names:
                _eng.execute(plans[name], harness.context)
        warm_s = time.perf_counter() - t0
        per = {}
        for name in names:
            t0 = time.perf_counter()
            _eng.execute(plans[name], harness.context)
            per[name] = (time.perf_counter() - t0) * 1e3
    finally:
        harness.close()
    total = sum(per.values())
    scaled_baseline = BASELINE_TOTAL_MS * scale
    out = {
        "scale": scale,
        "total_ms": round(total, 2),
        "vs_baseline": (round(scaled_baseline / total, 3)
                        if len(names) == BASELINE_QUERIES and total
                        else None),
        "warmup_s": round(warm_s, 1),
    }
    # the counters that moved during this stage belong to it
    after = _eng.engine_stats()
    delta = {k: after[k] - stats_before.get(k, 0)
             for k in after if isinstance(after[k], int)}
    if any(delta.values()):
        out["degradations"] = {k: v for k, v in delta.items() if v}
        out["degradations"]["queries"] = {
            k: [q for q in after["queries"].get(k, [])
                if q not in stats_before.get("queries", {}).get(k, [])]
            for k, v in delta.items() if v
        }
    return out


def main():
    scale = float(os.environ.get("BENCH_SCALE", DEFAULT_SCALE))
    repeat = int(os.environ.get("BENCH_REPEAT", "2"))
    device = _device()
    tmp_dirs = []
    plans_path, sql_dir = _query_files(tmp_dirs)

    import torch

    from radixjoin_tpu_torch import engine as _eng
    from radixjoin_tpu_torch.harness import datagen
    from radixjoin_tpu_torch.harness.run import JobHarness, TableSource
    from radixjoin_tpu_torch.ops import kernels

    with open(plans_path) as f:
        names_all = json.load(f)["names"]
    names = names_all
    if os.environ.get("BENCH_QUERIES"):
        names = [n for n in os.environ["BENCH_QUERIES"].split(",") if n]

    _arm_watchdog(scale, len(names))
    _partial["backend"] = "cpu" if device == "cpu" else "cuda"
    where = "cpu" if device == "cpu" else torch.cuda.get_device_name(0)
    log(f"bench: device {where}, scale {scale}, {len(names)} queries from "
        f"{plans_path}")
    _partial["stage"] = "datagen"
    t0 = time.perf_counter()
    queries = datagen.load_job_queries(sql_dir, names_all)
    tables = datagen.generate_cached(
        scale, 0, queries, cache_dir=os.path.join(REPO, ".bench_cache")
    )
    log(f"bench: synthetic IMDB generated in {time.perf_counter()-t0:.1f}s "
        f"({sum(t.num_rows for t in tables.values())} rows)")
    _mem_snapshot("datagen")

    harness = JobHarness(plans_path, TableSource(host_tables=tables), sql_dir,
                         device=device)
    context = harness.context
    execute = _eng.execute

    # plans are built once (filter evaluation and page encode are the
    # harness's, outside the timing, like the reference's CSV/plan phase)
    plans = {}
    _partial["stage"] = "plan build"
    t0 = time.perf_counter()
    for name in names:
        plans[name] = harness.build_plan(name)[1]
    log(f"bench: {len(names)} plans built in {time.perf_counter()-t0:.1f}s")

    # warm-up: exec1 learns the cardinality feedback, exec2 runs the steady
    # state; each phase logs its time and slowest plans
    kernels.reset_launch_counts()
    phase_times = {}

    def _run_phase(tag, fn):
        _partial["stage"] = tag
        t_p = time.perf_counter()
        times = {}
        for name in names:
            t0 = time.perf_counter()
            try:
                fn(name)
            except Exception as e:  # noqa: BLE001 - the pass reports
                log(f"bench: {tag}[{name}] failed: "
                    f"{type(e).__name__}: {str(e)[:150]}")
            times[name] = time.perf_counter() - t0
        dt = time.perf_counter() - t_p
        phase_times[tag] = round(dt, 1)
        slow = sorted(times.items(), key=lambda kv: -kv[1])[:5]
        log(f"bench: {tag} took {dt:.1f}s; rss={_rss_gb():.1f}GB; "
            f"slowest: " + ", ".join(f"{n}={s:.1f}s" for n, s in slow))
        _mem_snapshot(tag)

    def warm1(name):
        _partial["result_rows"] += execute(plans[name], context).num_rows

    _run_phase("warmup-exec1", warm1)
    _run_phase("warmup-exec2", lambda name: execute(plans[name], context))
    _partial["phase_times"] = phase_times

    per_query = _partial["per_query"]
    for it in range(max(1, repeat)):
        _partial["stage"] = f"pass {it}"
        t_iter = time.perf_counter()
        stage_totals: dict = {}
        for name in names:
            t0 = time.perf_counter()
            execute(plans[name], context)
            dt = (time.perf_counter() - t0) * 1e3
            prev = per_query.get(name)
            per_query[name] = dt if prev is None else min(prev, dt)
            for k, v in (getattr(plans[name], "_last_exec_stats", None)
                         or {}).items():
                if isinstance(v, (int, float)):
                    stage_totals[k] = stage_totals.get(k, 0.0) + v
        if not _partial["stage_totals"] or (
            sum(v for k, v in stage_totals.items() if k.endswith("_ms"))
            < sum(v for k, v in _partial["stage_totals"].items()
                  if k.endswith("_ms"))
        ):
            _partial["stage_totals"] = stage_totals
        log(f"bench: pass {it} took {time.perf_counter()-t_iter:.1f}s; "
            f"rss={_rss_gb():.1f}GB")
        _mem_snapshot(f"pass {it}")
    log("bench: best ms a query: " + json.dumps(
        {n: round(v, 2) for n, v in per_query.items()}))

    # the degradation tallies and kernel launches of the warm-up and the
    # timed passes, before the bonus stages run more queries (see _emit)
    _partial["degradations_primary"] = _eng.engine_stats()
    _partial["launches"] = kernels.launch_counts()

    if (os.environ.get("BENCH_DEVICE_MS", "on") != "off"
            and _partial["backend"] == "cuda"):
        _partial["stage"] = "device-ms"
        try:
            _partial["device_ms"] = _device_ms_stage(names, plans, context,
                                                     execute)
            log(f"bench: device-ms {json.dumps(_partial['device_ms'])}")
        except Exception as e:  # noqa: BLE001 - bonus measurement
            log(f"bench: device-ms stage failed ({type(e).__name__}: "
                f"{str(e)[:160]})")

    # the same suite as ONE execute_many() batch; reported in detail only
    # (the headline stays the serial per-query protocol)
    if os.environ.get("BENCH_BATCH", "on") != "off":
        _partial["stage"] = "batch"
        batch_best = None
        try:
            for _ in range(2):
                t0 = time.perf_counter()
                _eng.execute_many([plans[n] for n in names], context)
                dt = (time.perf_counter() - t0) * 1e3
                batch_best = dt if batch_best is None else min(batch_best, dt)
            _partial["batch_wall_ms"] = round(batch_best, 2)
            log(f"bench: batch wall-clock {batch_best:.1f} ms")
        except Exception as e:  # noqa: BLE001 - bonus measurement
            log(f"bench: batch stage failed ({type(e).__name__}: "
                f"{str(e)[:200]}), reporting serial result only")

    sec = os.environ.get("BENCH_SECONDARY_SCALE", "0.01")
    if sec and float(sec) != scale and not os.environ.get("BENCH_QUERIES"):
        _partial["stage"] = "secondary"
        try:
            _partial["secondary"] = _secondary_pass(
                float(sec), names, sql_dir, plans_path, device)
            log(f"bench: secondary {_partial['secondary']}")
        except Exception as e:  # noqa: BLE001 - bonus measurement
            log(f"bench: secondary pass failed ({type(e).__name__}: "
                f"{str(e)[:200]}); primary result unaffected")

    _partial["stage"] = "done"
    from radixjoin_tpu_torch.plan import executor as _ex

    fused_paths: dict = {}
    for plan in plans.values():
        cached = getattr(plan, "_fused_struct_cache", None)
        for strategy in (cached[1].strategies().values() if cached else ()):
            fused_paths[strategy] = fused_paths.get(strategy, 0) + 1
    log(f"bench: join paths wave={_ex.path_stats()} fused={fused_paths}")
    for name, _ in sorted(per_query.items(), key=lambda kv: -kv[1])[:3]:
        st = getattr(plans[name], "_last_exec_stats", None)
        if st:
            log(f"bench: {name} stage breakdown {st}")
    harness.close()
    _emit(sum(per_query.values()), scale, len(names))


def _main_guarded():
    try:
        main()
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001
        # never die without a metric line: whatever was timed so far is
        # the result (flagged partial unless the serial passes finished)
        import traceback

        traceback.print_exc(file=sys.stderr)
        timed = {k: v for k, v in _partial["per_query"].items()
                 if v is not None}
        log(f"bench: CRASH in stage '{_partial['stage']}' with "
            f"{len(timed)} queries timed: {type(e).__name__}")
        complete = _partial["stage"] in (
            "batch", "secondary", "device-ms", "done"
        )
        _emit(sum(timed.values()),
              float(os.environ.get("BENCH_SCALE", DEFAULT_SCALE)),
              len(timed), partial=not complete)
        sys.exit(0 if complete else 4)


if __name__ == "__main__":
    _main_guarded()
