"""One rank of a distributed-join cluster (port of the JAX package's
``tools/multihost_worker.py``; imports torch and numpy only).

Launch it N times, once per rank, with one free localhost port::

    python -m radixjoin_tpu_torch.tools.multihost_worker --pid 0 \
        --nprocs 2 --port 29541 --device cpu --out rank0.pkl

Every rank builds the same plans from a seeded generator (the
replicated-input contract of ``parallel/multihost.py``), runs them through
``execute_distributed`` cold and then warm (the learned replay), and checks
each result against the row oracle, so a collective that misroutes rows on
ANY rank fails that rank. The scenarios, each under every
``--dist-chunks`` value (0 meaning the monolithic exchange):

* ``two_join``: a three-join plan with an FP64 payload, NULL keys, a mildly
  skewed FK and a VARCHAR join key (the unified-dictionary path);
* ``skew``: the heavy hitter takes 70% of the probe side (the hot-key
  broadcast path carries most of the join);
* ``empty``: the last join matches nothing (learned-empty replay).

``--join-cases`` also runs the eight join cases of :func:`join_cases`
through ``distributed_join``. Each rank pickles what it gathered (rows in
order, totals, ``info``, hot keys, host syncs) to ``--out`` and prints one
``OK`` line. The device is the card unless ``--device cpu``; the backend
follows the device (NCCL on the card, gloo on the CPU) unless
``--backend`` names one.

``--scenario bench_join`` runs instead a timed distributed shuffle join of
``--bench-rows`` global probe rows (:func:`bench_join`): two warm-up runs,
then ``--repeats`` fenced runs; rank 0 writes the best-of, mean and sigma
as JSON to ``--out`` (the other ranks write ``OK``).
"""

from __future__ import annotations

import argparse
import pickle
import sys
import time

import numpy as np

SCENARIOS = ("two_join", "skew", "empty")


def build_scenario(scenario: str, DataType, Plan, ColumnarTable, HostTable):
    """The scenario's plan, built with the given plan and table classes (so
    the same plan can be built for another engine with the same plan IR).
    Every call draws the same tables from ``default_rng(42)``."""
    rng = np.random.default_rng(42)

    def int_col(n, lo, hi, null_frac):
        vals = rng.integers(lo, hi, n)
        nulls = rng.random(n) < null_frac
        return [None if nz else int(v) for v, nz in zip(vals, nulls)]

    n_a, n_b, n_c = 3000, 800, 1200
    # table a: fact side with a skewed FK (heavy hitter key 7)
    fk = rng.integers(0, 600, n_a)
    fk[rng.random(n_a) < (0.70 if scenario == "skew" else 0.30)] = 7
    rows_a = [
        [None if rng.random() < 0.03 else int(k), float(i) / 3.0, i]
        for i, k in enumerate(fk)
    ]
    rows_b = [
        [int(k), f"name_{k}".encode()] for k in rng.permutation(900)[:n_b]
    ]
    rows_c = [[v, i] for i, v in enumerate(int_col(n_c, 0, 50, 0.05))]

    I32, I64 = DataType.INT32, DataType.INT64
    F64, VC = DataType.FP64, DataType.VARCHAR
    ta = HostTable.from_rows(rows_a, [I64, F64, I64])
    tb = HostTable.from_rows(rows_b, [I64, VC])
    tc = HostTable.from_rows(rows_c, [I32, I64])

    plan = Plan()
    sa = plan.new_scan_node(plan.new_input(ColumnarTable.from_host(ta)),
                            [(0, I64), (1, F64), (2, I64)])
    sb = plan.new_scan_node(plan.new_input(ColumnarTable.from_host(tb)),
                            [(0, I64), (1, VC)])
    j1 = plan.new_join_node(True, sb, sa, 0, 0,
                            [(1, VC), (2, I64), (3, F64), (4, I64)])
    sc = plan.new_scan_node(plan.new_input(ColumnarTable.from_host(tc)),
                            [(0, I32), (1, I64)])
    # a's row id (INT64 payload of j1) against c's INT64 column: sparse
    # matches exercise the near-empty path
    j2 = plan.new_join_node(False, j1, sc, 3, 1,
                            [(0, VC), (1, I64), (2, F64), (4, I32)])
    # table d: a VARCHAR join key (the unified-dictionary path); the empty
    # scenario's keys match nothing
    d_prefix = "gone" if scenario == "empty" else "name"
    rows_d = [[f"{d_prefix}_{k}".encode(), int(k)] for k in range(0, 900, 3)]
    td = HostTable.from_rows(rows_d, [VC, I32])
    sd = plan.new_scan_node(plan.new_input(ColumnarTable.from_host(td)),
                            [(0, VC), (1, I32)])
    plan.root = plan.new_join_node(True, j2, sd, 0, 0,
                                   [(0, VC), (3, I32), (5, I32), (2, F64)])
    return plan


def join_cases():
    """The eight join cases of the JAX package's distributed-join tests:
    ``{name: (bk, bv, bp, pk, pv, pp, [config overrides, ...])}``, host
    arrays from seeded generators."""
    cases = {}

    rng = np.random.default_rng(0)
    nb, np_ = 2000, 5000
    bk = rng.integers(0, 1500, nb).astype(np.int64)
    bv = rng.random(nb) > 0.05
    pk = rng.integers(0, 3000, np_).astype(np.int64)
    pv = rng.random(np_) > 0.05
    cases["basic"] = (
        bk, bv, {"payload": rng.integers(0, 100, nb).astype(np.int32)},
        pk, pv, {"rowid": np.arange(np_, dtype=np.int32)}, [{}])

    pk = np.arange(100, dtype=np.int64)
    cases["empty_sides"] = (
        np.zeros(0, np.int64), np.zeros(0, bool), {},
        pk, np.ones(100, bool), {"r": pk.astype(np.int32)}, [{}])

    rng = np.random.default_rng(1)
    nb, np_ = 500, 20000
    bk = np.arange(nb).astype(np.int64)
    pk = rng.integers(0, nb, np_).astype(np.int64)
    pk[rng.random(np_) < 0.6] = 7
    cases["skewed_hot_key"] = (
        bk, np.ones(nb, bool), {"b": (bk * 10).astype(np.int64)},
        pk, np.ones(np_, bool), {"p": np.arange(np_, dtype=np.int64)}, [{}])

    cases["duplicate_build_keys"] = (
        np.array([5, 5, 5, 9], np.int64), np.ones(4, bool),
        {"b": np.arange(4, dtype=np.int32)},
        np.array([5, 9, 9, 11], np.int64), np.ones(4, bool),
        {"p": np.arange(4, dtype=np.int32)}, [{}])

    rng = np.random.default_rng(7)
    nb, np_ = 400, 300
    pk = np.where(rng.random(np_) < 0.5, 7, rng.integers(100, 200, np_))
    cases["skewed_build_side"] = (
        np.full(nb, 7, np.int64), np.ones(nb, bool),
        {"x": np.arange(nb, dtype=np.int64)},
        pk.astype(np.int64), np.ones(np_, bool),
        {"y": np.arange(np_, dtype=np.int64)}, [{}])

    rng = np.random.default_rng(11)
    nb, np_ = 300, 10000
    bk = rng.integers(0, 400, nb).astype(np.int64)
    pk = rng.integers(0, 1_000_000, np_).astype(np.int64)
    pk[:17] = bk[:17]
    cases["bloom_semijoin"] = (
        bk, np.ones(nb, bool), {}, pk, np.ones(np_, bool),
        {"p": np.arange(np_, dtype=np.int64)},
        [{"bloom_max_bits": 8192}, {"bloom_max_bits": 0}])

    rng = np.random.default_rng(5)
    nb, np_ = 3000, 12000
    bk = rng.integers(0, 900, nb).astype(np.int64)
    bv = rng.random(nb) > 0.1
    pk = rng.integers(0, 1800, np_).astype(np.int64)
    pk[: np_ // 3] = 42
    pv = rng.random(np_) > 0.1
    cases["chunked_exchange"] = (
        bk, bv, {"b": rng.integers(0, 1000, nb).astype(np.int64)},
        pk, pv, {"p": np.arange(np_, dtype=np.int64)},
        [{"exchange_chunks": 3},
         {"exchange_chunks": 4, "bloom_max_bits": 0}])

    rng = np.random.default_rng(3)
    nb, np_ = 1000, 8000
    bk = rng.integers(0, 200, nb).astype(np.int64)
    pk = rng.integers(0, 200, np_).astype(np.int64)
    pk[: np_ // 2] = 13
    cases["hot_and_cold_disjoint"] = (
        bk, np.ones(nb, bool), {}, pk, np.ones(np_, bool),
        {"p": np.arange(np_, dtype=np.int64)}, [{"max_hot_keys": 4}])
    return cases


def bench_join_inputs(n_probe: int):
    """The inputs of :func:`bench_join`, the same on every rank
    (``default_rng(11)``): ``n_probe / 4`` distinct build keys, 2% of each
    side invalid, one build key on 10% of the probe side (the hot-key
    broadcast path stays live)."""
    n_build = n_probe // 4
    rng = np.random.default_rng(11)
    bk = rng.permutation(n_build * 2)[:n_build].astype(np.int64)
    bv = rng.random(n_build) > 0.02
    pk = rng.integers(0, n_build * 2, n_probe).astype(np.int64)
    pk[rng.random(n_probe) < 0.10] = int(bk[0])  # one heavy hitter
    pv = rng.random(n_probe) > 0.02
    bp = {"x": rng.integers(0, 1 << 20, n_build).astype(np.int32)}
    pp = {"y": rng.integers(0, 1 << 20, n_probe).astype(np.int32)}
    return bk, bv, bp, pk, pv, pp


def bench_join(mesh, n_probe: int, repeats: int) -> dict:
    """``distributed_join_device`` at a fixed global size, timed by
    ``scaling_bench.timed_join`` on :func:`bench_join_inputs`: 2 warm-up
    runs (the first climbs the capacity ladder), then ``repeats`` runs,
    each through a fence. Returns the record rank 0 writes."""
    from ..ops import kernels
    from .scaling_bench import timed_join

    data = bench_join_inputs(n_probe)
    warmup = 2  # the capacity ladder and the allocator settle
    run = timed_join(mesh, data, repeats, warmup=warmup)
    steady = [t * 1e3 for t in run["times"]]
    mean = sum(steady) / len(steady)
    sigma = (sum((t - mean) ** 2 for t in steady) / len(steady)) ** 0.5
    return {
        "scenario": "bench_join",
        "processes": mesh.size,
        "backend": mesh.backend,
        "device": str(mesh.device),
        "probe_rows": n_probe,
        "build_rows": len(data[0]),
        "result_rows": run["total"],
        "best_ms": round(min(steady), 2),
        "mean_ms": round(mean, 2),
        "sigma_ms": round(sigma, 2),
        "warmup_dropped": warmup,
        "times_ms": [round(t, 2) for t in steady],
        "launches": kernels.launch_counts(),
    }


def table_columns(table):
    """A HostTable as ``[(valid, values)]`` in row order, NULL values zeroed
    and VARCHAR as byte-string objects (b"" where NULL)."""
    out = []
    for c in table.columns:
        if c.dtype.is_varchar:
            vals = c.objects()
        else:
            vals = np.where(c.valid, c.values, np.zeros((), c.values.dtype))
        out.append((np.asarray(c.valid, bool), vals))
    return out


def _run_plan(plan, mesh, config, label):
    """Cold, then warm on the learned state, each held to the row oracle
    (raises on a difference). Returns the record of both runs."""
    from radixjoin_tpu_torch.harness import oracle
    from radixjoin_tpu_torch.parallel import dist_executor, multihost

    expected = oracle.execute_plan_rows(plan)
    rec = {}
    for run in ("cold", "warm"):
        before = multihost.collective_stats()
        t0 = time.perf_counter()
        result = dist_executor.execute_distributed(plan, mesh=mesh,
                                                   config=config)
        ms = (time.perf_counter() - t0) * 1e3
        after = multihost.collective_stats()
        ok, detail = oracle.rows_equal(result.to_rows(), expected)
        if not ok:
            raise RuntimeError(f"{label} {run}: {detail}")
        rec[run] = {"columns": table_columns(result), "rows": result.num_rows,
                    "ms": ms,
                    **{k: after[k] - before[k] for k in after}}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None)
    ap.add_argument("--dist-chunks", default="0",
                    help="comma-separated DistJoinConfig.exchange_chunks "
                         "values; 0 = the monolithic exchange")
    ap.add_argument("--join-cases", action="store_true")
    ap.add_argument("--scenario", choices=["plans", "bench_join"],
                    default="plans",
                    help="plans: the scenarios above; bench_join: the "
                         "timed join alone")
    ap.add_argument("--bench-rows", type=int, default=1 << 20,
                    help="global probe rows for --scenario bench_join")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from radixjoin_tpu_torch.dtypes import DataType
    from radixjoin_tpu_torch.parallel import (
        DistJoinConfig, distributed_join, make_mesh, multihost)
    from radixjoin_tpu_torch.parallel.dist_join import collect_to_host
    from radixjoin_tpu_torch.plan.ir import Plan
    from radixjoin_tpu_torch.storage.columnar import ColumnarTable, HostTable

    t_start = time.perf_counter()
    multihost.init(f"localhost:{args.port}", args.nprocs, args.pid,
                   device=args.device, backend=args.backend)
    mesh = make_mesh(device=args.device)
    if args.scenario == "bench_join":
        import json

        record = bench_join(mesh, args.bench_rows, args.repeats)
        with open(args.out, "w") as f:
            f.write(json.dumps(record) if mesh.rank == 0 else "OK\n")
        dist.destroy_process_group()
        print(f"[rank {args.pid}] bench {record}", flush=True)
        return 0
    record = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
              "device": str(mesh.device), "active": multihost.active(),
              "plans": {}, "joins": {}}
    for scenario in SCENARIOS:
        for chunks in [int(c) for c in args.dist_chunks.split(",") if c]:
            plan = build_scenario(scenario, DataType, Plan, ColumnarTable,
                                  HostTable)
            record["plans"][f"{scenario}/{chunks}"] = _run_plan(
                plan, mesh, DistJoinConfig(exchange_chunks=max(1, chunks)),
                f"rank {mesh.rank} {scenario} chunks={chunks}")

    if args.join_cases:
        for name, (bk, bv, bp, pk, pv, pp, configs) in join_cases().items():
            for i, overrides in enumerate(configs):
                info = {}
                columns, live, totals = distributed_join(
                    bk, bv, bp, pk, pv, pp, mesh=mesh,
                    config=DistJoinConfig(**overrides), info_out=info)
                record["joins"][f"{name}/{i}"] = {
                    "out": collect_to_host(columns, live, mesh),
                    "totals": np.asarray(totals), "info": info}

    record["seconds"] = time.perf_counter() - t_start
    with open(args.out, "wb") as f:
        pickle.dump(record, f)
    dist.destroy_process_group()
    print(f"[rank {args.pid}] OK {len(record['plans'])} plans, "
          f"{len(record['joins'])} joins, {record['seconds']:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
