"""Benchmark / correctness harness (the reference's ``./build/run``; own
copy of radixjoin_tpu/harness/run.py on the port's engine).

Loads ``plans.json`` (query names + PostgreSQL EXPLAIN JSONs +
sql_directory), builds each query's Plan via the SQL frontend + EXPLAIN
converter, executes it on the engine, optionally verifies against the
oracles, and reports per-query wall-clock exactly like the reference
harness (tests/read_sql.cpp:1251-1333): timing covers ``execute()`` only.

Data sources: a directory of IMDB-format CSVs, or a synthetic IMDB generated
at a given scale (see harness/datagen.py). Where the benchmark's own
``plans.json`` is not at hand, ``harness/job_shapes.py::write_query_documents``
writes a small set of JOB-shaped query documents in the same layout.

CLI (runs on the CUDA card unless ``--platform cpu``):
    python -m radixjoin_tpu_torch.harness.run plans.json [query ...] \
        [--data-dir imdb/ | --scale 0.001] [--verify] [--repeat N] \
        [--batch | --distributed [--dist-chunks N] [--dist-bloom-bits B] \
        [--dist-feedback on|off]] [--profile DIR] [--platform cpu|cuda]

``--distributed`` runs every plan through the distributed executor
(``parallel/dist_executor.py``). Started by a launcher that sets ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``, the harness joins that
process group (every rank runs the same queries); without them it opens a
one-rank group: NCCL on the card, gloo with ``--platform cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import time
from typing import Dict, List, Optional

from ..engine import build_context, destroy_context, execute, execute_many
from ..sql import ParsedSQL, catalog, plan_from_explain
from ..sql.frontend import TableEntity
from ..storage import ingest
from ..storage.columnar import ColumnarTable, HostTable
from . import datagen, oracle


class TableSource:
    """Provides pre-filtered paged base tables to the plan converter."""

    def __init__(
        self,
        host_tables: Optional[Dict[str, HostTable]] = None,
        csv_dir: Optional[str] = None,
    ):
        if (host_tables is None) == (csv_dir is None):
            raise ValueError("exactly one of host_tables / csv_dir required")
        self.host_tables = host_tables
        self.csv_dir = csv_dir
        self._unfiltered_cache: Dict[str, ColumnarTable] = {}

    def table(self, name: str) -> HostTable:
        if self.host_tables is not None:
            return self.host_tables[name]
        types = catalog.column_types(name)
        path = f"{self.csv_dir}/{name}.csv"
        table = ingest._table_cache.get(path)
        if table is None:
            table = ingest.parse_csv(path, types)
            ingest._table_cache[path] = table
        return table

    def provider(self, entity: TableEntity, attributes, filt) -> ColumnarTable:
        name = entity.table
        # lazy=True (default): the engine computes on the HostTable memo,
        # so the page encode of plan inputs is deferred until something
        # actually reads the bytes — at scale 1.0 (~60M rows) eager
        # per-query encodes would dominate the harness's wall-clock.
        #
        # RJT_EAGER_PAGES=on (measurement configuration): inputs are
        # eagerly encoded to row-aligned pages at plan build (untimed,
        # like the reference's CSV load) AND the host twin is dropped —
        # the engine's timed region then starts from raw pages exactly
        # like the reference contract (include/plan.h:342): fixed-width
        # columns upload raw pages + decode on the device
        # (storage/device_decode.py, the paged-window kernel), VARCHAR
        # host-decodes.
        eager = os.environ.get("RJT_EAGER_PAGES", "off") == "on"
        if filt is None:
            cached = self._unfiltered_cache.get(name)
            if cached is None:
                cached = ColumnarTable.from_host(
                    self.table(name), lazy=not eager)
                self._unfiltered_cache[name] = cached
            out = cached.copy()
        else:
            filtered = ingest.filter_table(self.table(name), filt)
            out = ColumnarTable.from_host(filtered, lazy=not eager)
        if eager:
            out._host = None  # force the pages->device path
        return out


class JobHarness:
    """The queries of one ``plans.json`` over one table source, on one
    engine context (``device=None``: the CUDA card; ``"cpu"`` on request)."""

    def __init__(self, plans_path: str, source: TableSource,
                 sql_dir: Optional[str] = None, device=None):
        with open(plans_path) as f:
            doc = json.load(f)
        self.names: List[str] = doc["names"]
        self.plans = dict(zip(self.names, doc["plans"]))
        self.sql_dir = sql_dir or _sql_directory(doc, plans_path)
        self.source = source
        self.context = build_context(device)

    distributed = False  # set by main's --distributed flag
    dist_config = None  # optional DistJoinConfig (the --dist-* flags)
    _mesh = None
    _owns_group = False

    def close(self):
        if self._owns_group:
            import torch.distributed as dist

            dist.destroy_process_group()
            self._owns_group = False
            self._mesh = None
        destroy_context(self.context)

    def dist_mesh(self):
        """The mesh ``run_query`` runs distributed plans over: the group a
        launcher's environment names, else a one-rank group on this
        context's device (joined once; left again by :meth:`close`)."""
        if self._mesh is None:
            import torch.distributed as dist

            from ..parallel import make_mesh, multihost

            device = self.context.device
            device = None if device.type == "cuda" else device
            if not dist.is_initialized():
                env = os.environ
                if all(k in env for k in ("RANK", "WORLD_SIZE",
                                          "MASTER_ADDR", "MASTER_PORT")):
                    address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
                    multihost.init(address, int(env["WORLD_SIZE"]),
                                   int(env["RANK"]), device=device)
                else:
                    multihost.init(f"localhost:{_free_port()}", 1, 0,
                                   device=device)
                self._owns_group = True
            self._mesh = make_mesh(device=device)
        return self._mesh

    def sql(self, name: str) -> str:
        with open(f"{self.sql_dir}/{name}.sql") as f:
            return f.read()

    def build_plan(self, name: str):
        parsed = ParsedSQL(self.sql(name), name)
        plan = plan_from_explain(
            self.plans[name]["Plan"], parsed, self.source.provider
        )
        plan._name = name  # degradation tallies name the query
        return parsed, plan

    def run_query(self, name: str, verify: bool = False, sqlite_oracle=None):
        parsed, plan = self.build_plan(name)
        if self.distributed:
            from ..parallel.dist_executor import execute_distributed

            mesh = self.dist_mesh()
            t0 = time.perf_counter()
            host = execute_distributed(plan, mesh=mesh,
                                       config=self.dist_config)
            result = ColumnarTable.from_host(host)  # paged, like execute()
            runtime_ms = (time.perf_counter() - t0) * 1e3
        else:
            t0 = time.perf_counter()
            result = execute(plan, self.context)
            runtime_ms = (time.perf_counter() - t0) * 1e3
        correct = None
        detail = None
        if verify:
            correct, detail = verify_result(parsed, plan, result, sqlite_oracle)
        return result, runtime_ms, correct, detail


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sql_directory(doc: dict, plans_path: str) -> str:
    """The document's ``sql_directory``; a relative one is taken from the
    directory of ``plans.json``, so a written set of query documents runs
    from any working directory."""
    sql_dir = doc.get("sql_directory", "job")
    if not os.path.isabs(sql_dir):
        sql_dir = os.path.join(os.path.dirname(os.path.abspath(plans_path)),
                               sql_dir)
    return sql_dir


def verify_result(parsed, plan, result, sqlite_oracle=None):
    """Dual-oracle check of one query result (row-semantics interpreter,
    then sqlite on the rewritten SQL). Shared by the per-query and
    --batch paths so both verify identical semantics."""
    actual = result.to_host().to_rows()
    expected = oracle.execute_plan_rows(plan)
    correct, detail = oracle.rows_equal(actual, expected)
    if correct and sqlite_oracle is not None:
        sql_rows = sqlite_oracle.query(parsed.executed_sql())
        correct, detail = oracle.rows_equal(actual, sql_rows)
        if not correct:
            detail = f"sqlite oracle mismatch: {detail}"
    return correct, detail


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("plans", help="path to plans.json")
    parser.add_argument("queries", nargs="*", help="subset of query names")
    parser.add_argument("--data-dir", help="directory of IMDB CSVs")
    parser.add_argument("--sql-dir", help="directory of JOB .sql files")
    parser.add_argument("--scale", type=float, default=None,
                        help="generate synthetic IMDB at this scale instead")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--verify", action="store_true",
                        help="check results against the row + sqlite oracles")
    parser.add_argument("--repeat", type=int, default=1,
                        help="re-run each query N times, report the minimum")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="capture a torch.profiler trace of the query "
                             "loop into DIR/trace.json (view with Perfetto or "
                             "chrome://tracing; stands in for the reference's "
                             "perf+flamegraph wrapper, benchmark.sh:12-29)")
    parser.add_argument("--output-runtime", metavar="FILE", default=None,
                        help="write the suite total in microseconds to FILE "
                             "when every verified query is correct (the "
                             "reference's BENCHMARK_RUNTIME.txt protocol, "
                             "tests/read_sql.cpp:1319-1323)")
    parser.add_argument("--batch", action="store_true",
                        help="throughput mode: run the selected queries "
                             "as one execute_many() batch (overlapped "
                             "dispatch + host transfers) and report the "
                             "batch wall-clock instead of per-query times")
    parser.add_argument("--distributed", action="store_true",
                        help="execute every plan over the ranks of a process "
                             "group (parallel/dist_executor.py) instead of "
                             "the single-card engine: the launcher's group "
                             "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) "
                             "or a one-rank group on this device")
    parser.add_argument("--dist-chunks", type=int, default=None,
                        metavar="N",
                        help="with --distributed: split the exchange into N "
                             "overlappable key-space chunks "
                             "(DistJoinConfig.exchange_chunks)")
    parser.add_argument("--dist-bloom-bits", type=int, default=None,
                        metavar="BITS",
                        help="with --distributed: cap the build-side Bloom "
                             "semi-join bitmap (0 disables; default 2^18)")
    parser.add_argument("--dist-feedback", choices=["on", "off"],
                        default=None,
                        help="with --distributed: cardinality feedback "
                             "(replay of repeat executions without a host "
                             "sync a join; default on)")
    parser.add_argument("--platform", choices=["cpu", "cuda"],
                        default="cuda",
                        help="the device the engine runs on: the CUDA card "
                             "(default; fails without one) or the CPU, where "
                             "every kernel takes its plain PyTorch version")
    args = parser.parse_args(argv)
    if args.batch and args.distributed:
        parser.error("--batch and --distributed are mutually exclusive "
                     "(the batch path runs the single-card fused engine)")

    with open(args.plans) as f:
        doc = json.load(f)
    sql_dir = args.sql_dir or _sql_directory(doc, args.plans)
    names = args.queries or doc["names"]

    if args.data_dir:
        source = TableSource(csv_dir=args.data_dir)
    else:
        scale = args.scale if args.scale is not None else 0.001
        queries = datagen.load_job_queries(sql_dir, doc["names"])
        gen = datagen.SyntheticIMDB(scale=scale, seed=args.seed, queries=queries)
        print(f"generating synthetic IMDB at scale {scale} ...", flush=True)
        source = TableSource(host_tables=gen.generate())

    sqlite_oracle = None
    if args.verify and source.host_tables is not None:
        print("loading sqlite oracle ...", flush=True)
        sqlite_oracle = oracle.SqliteOracle(source.host_tables)

    harness = JobHarness(args.plans, source, sql_dir,
                         device="cpu" if args.platform == "cpu" else None)
    harness.distributed = args.distributed
    if (args.dist_chunks is not None or args.dist_bloom_bits is not None
            or args.dist_feedback is not None):
        from ..parallel import DistJoinConfig

        overrides = {}
        if args.dist_chunks is not None:
            overrides["exchange_chunks"] = args.dist_chunks
        if args.dist_bloom_bits is not None:
            overrides["bloom_max_bits"] = args.dist_bloom_bits
        if args.dist_feedback is not None:
            overrides["feedback"] = args.dist_feedback == "on"
        harness.dist_config = DistJoinConfig(**overrides)

    profile_ctx = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if args.platform == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profile_ctx = profile(activities=activities)
        profile_ctx.__enter__()

    total_ms = 0.0
    all_ok = True
    try:
        if args.batch:
            built = [harness.build_plan(name) for name in names]
            plans = [p for _, p in built]
            best = None
            for _ in range(max(1, args.repeat)):
                t0 = time.perf_counter()
                results = execute_many(plans, harness.context)
                dt = (time.perf_counter() - t0) * 1e3
                best = dt if best is None else min(best, dt)
            total_ms = best
            for name, (parsed, plan), result in zip(names, built, results):
                status = ""
                if args.verify:
                    correct, detail = verify_result(
                        parsed, plan, result, sqlite_oracle
                    )
                    status = f"  Result correct: {bool(correct)}"
                    if not correct:
                        all_ok = False
                        status += f"  ({detail})"
                print(f"Query {name:>4}: rows={result.num_rows}{status}")
            print(f"Batch wall-clock: {total_ms:.2f} ms "
                  f"over {len(names)} queries")
        for name in ([] if args.batch else names):
            best = None
            correct, detail = True, ""
            for _ in range(max(1, args.repeat)):
                result, runtime_ms, rep_ok, rep_detail = harness.run_query(
                    name, verify=args.verify, sqlite_oracle=sqlite_oracle
                )
                best = runtime_ms if best is None else min(best, runtime_ms)
                if args.verify and not rep_ok:
                    # EVERY repeat must verify (repeats exercise the warm
                    # paths, such as the cardinality feedback; a cold
                    # failure must not be masked by a passing warm run)
                    correct, detail = False, rep_detail
            total_ms += best
            status = ""
            if args.verify:
                status = f"  Result correct: {bool(correct)}"
                if not correct:
                    all_ok = False
                    status += f"  ({detail})"
            print(f"Query {name:>4}: {best:10.2f} ms  rows={result.num_rows}{status}")
    finally:
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)
            os.makedirs(args.profile, exist_ok=True)
            trace = os.path.join(args.profile, "trace.json")
            profile_ctx.export_chrome_trace(trace)
            print(f"profiler trace written to {trace}")
        harness.close()  # leaves a process group it joined, also on error
    print(f"Total: {total_ms:.2f} ms over {len(names)} queries")
    if args.output_runtime and (not args.verify or all_ok):
        with open(args.output_runtime, "w") as f:
            f.write(f"{int(total_ms * 1000)}\n")
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
