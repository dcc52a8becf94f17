"""The benchmark of radixjoin_tpu_torch: one cell of ``BENCHMARK.json`` per
run, on the CUDA card.

    python3 joinbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(``python3 -m joinbench.run`` from the repository root does the same.) A
run makes the cell's tables from the seed, builds the plans its traffic
mix names, and hands them to the mix's driver
(``joinbench/drivers/<driver>.py``), which warms them up and then drives
``radixjoin_tpu_torch.execute`` on the card until ``--seconds`` have
passed (``closed_loop``: one client, round after round over the plans,
each round in a new seeded order). With ``--trace 1`` the window runs
under the profiler with the benchmark's own wrappers around the port's
layer entry points, and the line carries the per-layer metrics
(``joinbench/metrics/<metric>.py``); with ``--trace 0`` the end-to-end
ones (``joinbench/end_to_end/<metric>.py``).

After the window the plain reference of the configuration
(``joinbench/reference/<config>.py``) works out every plan's result from
the same generated tables; every request's row count and a seeded sample
of whole results, read back by the benchmark's own page reader, are held
to it. The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error and
the line's last key.

Everything a cell needs is found by name: its configuration's file from
``BENCHMARK.json``, ``joinbench/reference/<config>.py``,
``joinbench/traffic/<mix>.json`` and the driver it names, and a reader
file for each metric. A cell, a mix, a driver or a metric is added as
files and entries alone.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from joinbench.stats import Window, percentile  # noqa: E402

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "radixjoin_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (from /proc; since this module
    was imported where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tag(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


class Cell:
    """One entry of ``workloads`` with everything it names: its
    configuration's file and reference, its traffic mix and the mix's
    driver, and the readers of its metrics."""

    def __init__(self, root: str, name: str):
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            manifest = json.load(f)
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(have {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        tag = _tag(self.config_entry["name"])
        self.config = load_module(os.path.join(root, self.config_entry["file"]),
                                  f"joinbench_config_{tag}")
        self.dir = os.path.join(root, "joinbench")
        self.reference = load_module(
            os.path.join(self.dir, "reference",
                         f"{self.config_entry['name']}.py"),
            f"joinbench_reference_{tag}")
        with open(os.path.join(self.dir, "traffic",
                               f"{self.entry['traffic']}.json")) as f:
            self.traffic = json.load(f)
        if self.traffic["inputs"] not in ("resident", "fresh"):
            raise ValueError(f"inputs {self.traffic['inputs']!r}: "
                             "resident or fresh")
        self.driver = load_module(
            os.path.join(self.dir, "drivers", f"{self.traffic['driver']}.py"),
            f"joinbench_driver_{_tag(self.traffic['driver'])}")
        # the mix's plans, all of the configuration's where it names none
        self.plan_names = list(self.traffic.get(
            "plans", self.config.CONFIG["plans"]))
        unknown = set(self.plan_names) - set(self.config.CONFIG["plans"])
        if unknown:
            raise ValueError(f"{self.entry['traffic']} names plans "
                             f"{sorted(unknown)} that {tag} lacks")
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])]
        self.chips = int(self.entry["chips"])


def fresh_copy(plan):
    """A new Plan of the same shape over new ColumnarTable objects that
    share the inputs' page bytes (no copy of them): the port's memos kept
    on plan, table and column objects all miss."""
    from radixjoin_tpu_torch import Column, ColumnarTable, Plan, PlanNode

    new = Plan()
    new.nodes = [PlanNode(n.data, list(n.output_attrs)) for n in plan.nodes]
    new.root = plan.root
    new.inputs = [ColumnarTable(t.num_rows,
                                [Column(c.type, c.pages) for c in t.columns])
                  for t in plan.inputs]
    return new


class Session:
    """What a traffic driver (``joinbench/drivers/<driver>.py``) drives: the
    cell's plans over one context, a seeded generator for the order of
    requests, and the record of every timed request. ``call`` is one timed
    request; ``warm`` one untimed execution."""

    def __init__(self, rjt, ctx, plans, fresh, keep, rng, tracer=None):
        self.rjt, self.ctx, self.plans, self.fresh = rjt, ctx, plans, fresh
        self.names = list(plans)
        self.rng = rng
        self.tracer = tracer
        self.keep = keep  # name -> indices of the runs compared whole
        self.times_ms, self.counts, self.kept, self.errors = [], [], [], []
        self.by_plan, self.last = {}, {}
        self.runs = {n: 0 for n in self.names}
        self.failed = 0
        self.deadline = None

    def plan(self, name: str):
        """The plan object a request of ``name`` hands to ``execute``."""
        return fresh_copy(self.plans[name]) if self.fresh else self.plans[name]

    def warm(self, name: str):
        self.rjt.execute(self.plan(name), self.ctx)

    def over(self) -> bool:
        """True once the window's seconds have passed."""
        return time.perf_counter() >= self.deadline

    def call(self, name: str) -> None:
        plan = self.plan(name)
        if self.tracer is not None:
            plan._last_exec_stats = None
            self.tracer.begin(name)
        t = time.perf_counter()
        try:
            result = self.rjt.execute(plan, self.ctx)
            ok = True
        except Exception:  # a failed request is counted, and the loop goes on
            result, ok = None, False
            if len(self.errors) < 3:
                self.errors.append(traceback.format_exc())
        self.times_ms.append((time.perf_counter() - t) * 1e3)
        if self.tracer is not None:
            self.tracer.end(ok, getattr(plan, "_last_exec_stats", None))
        if not ok:
            self.failed += 1
            return
        self.counts.append((name, result.num_rows))
        self.by_plan.setdefault(name, []).append(self.times_ms[-1])
        entry = (name, self.runs[name], result)
        if self.runs[name] in self.keep[name]:
            self.kept.append(entry)
        else:
            self.last[name] = entry
        self.runs[name] += 1


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", scale=None):
    """One run of a cell; returns the result line's object. ``device`` and
    ``scale`` are for the tests on the CPU (``"cpu"``, a small scale):
    the command line always runs the card at the configuration's scale."""
    import torch

    import radixjoin_tpu_torch as rjt

    cell = Cell(root, workload)
    seed_u = int(seed) % (1 << 64)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.init()
        torch.zeros(1, device="cuda")
    split = {"process_and_cuda_s": process_age_s()}

    # -- set-up: data, plans, warm-up ------------------------------------------
    t = time.perf_counter()
    kwargs = {} if scale is None else {"scale": scale}
    tables = cell.config.generate(seed_u, **kwargs)
    split["data_s"] = time.perf_counter() - t
    t = time.perf_counter()
    plans = cell.config.build_plans(tables, cell.plan_names)
    split["plans_s"] = time.perf_counter() - t
    ctx = rjt.build_context(None if on_card else "cpu")

    # the results compared whole: a seeded sample of each plan's first
    # executions, as large as the configuration says
    sample = cell.config.CONFIG["check_sample"]
    rng = np.random.default_rng([seed_u, 1])
    keep = {n: set(rng.choice(sample["among_first"], sample["per_plan"],
                              replace=False).tolist()) for n in plans}
    session = Session(rjt, ctx, plans, cell.traffic["inputs"] == "fresh", keep,
                      np.random.default_rng([seed_u, 2]))
    split.update(cell.driver.warm_up(session, cell.traffic))

    if trace:
        from joinbench.trace import Tracer

        session.tracer = Tracer(device)
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    setup_s = process_age_s()
    split["setup_s"] = setup_s
    log("set-up split (s): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))

    # -- the window ----------------------------------------------------------------
    if session.tracer is not None:
        session.tracer.start()
    w0 = time.perf_counter()
    session.deadline = w0 + seconds
    cell.driver.window(session, cell.traffic)
    window_s = time.perf_counter() - w0
    # a plan whose sampled runs the window did not reach: its last result
    sampled = {name for name, _i, _r in session.kept}
    kept = session.kept + [v for n, v in session.last.items()
                           if n not in sampled]
    session.last = None
    card = torch.cuda.get_device_name(0) if on_card else "cpu"
    record = session.tracer.stop(card) if session.tracer is not None else None
    peak = window_peak = 0
    if on_card:
        window_peak = torch.cuda.max_memory_allocated()
        peak = max(setup_peak, window_peak)
    for e in session.errors:
        log(e)

    times_ms, failed = session.times_ms, session.failed
    attempted = len(times_ms)
    window = Window(times_ms=times_ms, window_s=window_s, setup_s=setup_s,
                    peak_bytes=window_peak)
    extra = {}
    if trace:
        from joinbench.trace import breakdown

        readers, record_of = "metrics", record
        extra = {"busy_s": record.busy_s(), "window_s": record.window_s}
        trace_breakdown = breakdown(record)
    else:
        readers, record_of = "end_to_end", window
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        reader = load_module(os.path.join(cell.dir, readers, f"{m['name']}.py"),
                             f"joinbench_{readers}_{_tag(m['name'])}")
        value = reader.read(record_of)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"window {window_s:.3f} s, {attempted} requests, {failed} failed; "
        f"p50 {percentile(times_ms, 50):.3f} ms, p95 "
        f"{percentile(times_ms, 95):.3f} ms, {attempted / window_s:.4f} "
        f"queries/s, window peak {window_peak / 2 ** 30:.3f} GiB")

    for name, ms in session.by_plan.items():
        log(f"  {name}: {len(ms)} requests, p50 {percentile(ms, 50):.3f} ms, "
            f"min {min(ms):.3f}, max {max(ms):.3f}")

    # -- the check: the program's state freed, then the reference --------------
    counts, names = session.counts, session.names
    del plans, ctx, record, record_of, session
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = check(cell, tables, counts, kept, failed, names, device)
    log(f"the check took {time.perf_counter() - t:.3f} s")
    correct = all(c["value"] <= c["limit"] if c["kind"] == "most"
                  else c["value"] >= c["limit"] for c in checks.values())
    for key, c in checks.items():
        log(f"check {key} = {c['value']} "
            f"({'at most' if c['kind'] == 'most' else 'at least'} {c['limit']})")
    out = {
        "correct": bool(correct),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": card,
                   "count": cell.chips, "memory_peak_bytes": int(peak),
                   **extra},
        "setup_split_s": split,
    }
    if trace:
        out["breakdown"] = trace_breakdown
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    return out


def check(cell, tables, counts, kept, failed, names, device) -> dict:
    """The numbers compared, each with its limit: requests that failed,
    requests whose row count differs from the reference's, sampled results
    whose row multiset differs from the reference's, and how many results
    were compared (at least one of every plan)."""
    from joinbench import digest, pagefmt

    expected = {}
    for name in names:
        rel, columns = cell.reference.result(name, tables, device)
        expected[name] = digest.digest(*rel.out(columns))
        log(f"  {name}: the reference's result has {expected[name][0]} rows")
        del rel
    wrong_counts = sum(1 for name, rows in counts if rows != expected[name][0])
    wrong = 0
    for name, index, result in kept:
        try:
            got = digest.digest(*pagefmt.read_columns(result, device))
        except pagefmt.PageError as err:
            log(f"{name} #{index}: unreadable result: {err}")
            got = None
        if got != expected[name]:
            wrong += 1
            log(f"{name} #{index}: result digest {got}, reference "
                f"{expected[name]}")
    checked_plans = len({name for name, _i, _r in kept})
    return {
        "requests_failed": {"value": failed, "limit": 0, "kind": "most"},
        "row_counts_wrong": {"value": wrong_counts, "limit": 0, "kind": "most"},
        "results_wrong": {"value": wrong, "limit": 0, "kind": "most"},
        "plans_checked": {"value": checked_plans, "limit": len(names),
                          "kind": "least"},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    cell = Cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    # the engine's cardinality feedback store, kept for this process only
    feedback = os.path.join(tempfile.gettempdir(),
                            f"joinbench-feedback-{os.getpid()}.json")
    os.environ["RJT_FEEDBACK_PATH"] = feedback
    try:
        out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                       bool(args.trace))
    finally:
        for path in (feedback, f"{feedback}.tmp.{os.getpid()}"):
            if os.path.exists(path):
                os.remove(path)
    # after the window, the readers and the check: nothing of JAX may have
    # come in on the way
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}; no result")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
