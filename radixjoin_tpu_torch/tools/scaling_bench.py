"""Distributed shuffle-join scaling bench (port of the JAX package's
``tools/scaling_bench.py``; imports torch and numpy only).

Measures probe rows/s of the distributed shuffle join
(``parallel/dist_join.py``) at group sizes 1..N and reports weak-scaling
efficiency (probe rows a rank held constant; ideal = flat rows/s a rank).
Each size is a fresh cluster of that many rank processes, started the way
a launcher starts them (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``); rank 0 prints its record on one
``CHILD_RESULT`` line. With ``--platform cpu`` the ranks are gloo
processes that share this host's cores, so efficiency there reads host
saturation; on the card every rank takes its own card over NCCL (``cuda:
<rank>``), so a size needs that many cards: one H100 runs ``--ndev 1``.

``--mode join`` times ``distributed_join_device`` on inputs sharded once
(rows a rank, ``n/8`` distinct build keys, one probe key on ``--skew`` of
the probe side); ``--mode plan`` a three-join star-schema plan through
``execute_distributed`` end to end. ``--breakdown`` adds the exchange phase
(all-to-all, then the merge join's sort and count a group) and the
expansion phase (local) timed apart, the same sort and count at the
received shapes without a collective, and the bytes and calls this rank
sent in the exchange's collectives (``multihost.collective_stats()``, its
own slab included). Each record carries rank 0's hand-kernel launches
(``launches``, from ``ops/kernels.launch_counts()``).

The JAX bench's projection onto TPU interconnect links (``_ici_projection``)
is not ported: it needs a link-rate figure, and the port's hardware model
(``hardware.py``) keeps none for a CUDA card.

Usage::

    python -m radixjoin_tpu_torch.tools.scaling_bench [--ndev 1,2,4,8] \
        [--rows 200000] [--skew 0.2] [--reps 3] [--mode join|plan] \
        [--chunks 1] [--breakdown] [--json out.json] [--platform cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: seconds a cluster of one size may take before its ranks are killed
SIZE_TIMEOUT_S = 1800


def make_join_data(ndev: int, rows_per_dev: int, skew: float):
    """``(bk, bv, bpl, pk, pv, ppl)`` of ``--mode join`` from
    ``default_rng(0)``, the same on every rank: ``rows_per_dev * ndev``
    probe rows, ``max(1024, n/8)`` distinct build keys, probe keys drawn
    from the build keys, ``skew`` of them the first build key."""
    rng = np.random.default_rng(0)
    n_probe = rows_per_dev * ndev
    n_build = max(1024, n_probe // 8)
    bk = rng.permutation(n_build * 4)[:n_build].astype(np.int64)
    bv = np.ones(n_build, bool)
    pk = rng.choice(bk, n_probe).astype(np.int64)
    n_hot = int(skew * n_probe)
    if n_hot:
        pk[:n_hot] = bk[0]  # one heavy hitter takes `skew` of the probe side
    pv = np.ones(n_probe, bool)
    bpl = {"val": (bk * 3).astype(np.int64)}
    ppl = {"row": np.arange(n_probe, dtype=np.int64)}
    return bk, bv, bpl, pk, pv, ppl


def _fence(mesh) -> None:
    import torch

    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def timed_join(mesh, data, reps: int, warmup: int = 1,
               chunks: int = 1) -> dict:
    """Shard ``data`` (``(bk, bv, bpl, pk, pv, ppl)``) once, detect its hot
    keys, run ``warmup`` untimed joins (the first climbs the capacity
    ladder) and time ``reps`` joins, each through a fence, so a timed run
    holds its own expansion and no earlier one's. Returns the seconds of
    each timed run (``times``), the last join's total (``total``) and what
    the breakdown reuses (``sharded``, ``hot_keys``, ``hot_valid`` and the
    resolved static configuration ``info``)."""
    from ..parallel import DistJoinConfig
    from ..parallel.dist_join import (
        _pad_to_shards, detect_hot_keys, distributed_join_device,
        shard_inputs)

    ndev = mesh.size
    _bk, _bv, _bpl, pk, pv, _ppl = data
    # shard once: the measure is the shuffle and join phases, not the
    # host staging
    config = DistJoinConfig(exchange_chunks=chunks)
    sharded = shard_inputs(mesh, *data)
    cap_p = max(16, int(config.capacity_factor * sharded[3].shape[0]
                        / ndev) + 1)
    hot_keys, hot_valid = detect_hot_keys(
        _pad_to_shards(pk, ndev), _pad_to_shards(pv, ndev, fill=False),
        config, ndev, cap_p)
    info: dict = {}
    for i in range(max(1, warmup)):
        distributed_join_device(*sharded, mesh, hot_keys, hot_valid, config,
                                info_out=info if i == 0 else None)
    _fence(mesh)
    times = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        _cols, _live, totals = distributed_join_device(
            *sharded, mesh, hot_keys, hot_valid, config)
        _fence(mesh)
        times.append(time.perf_counter() - t0)
    return {"times": times, "total": int(np.sum(totals)),
            "sharded": sharded, "hot_keys": hot_keys,
            "hot_valid": hot_valid, "info": info}


def run_one(mesh, rows_per_dev: int, skew: float, reps: int,
            chunks: int = 1, breakdown: bool = False) -> dict:
    """Rank body of ``--mode join``: :func:`timed_join` on
    :func:`make_join_data` (best of ``reps``)."""
    ndev = mesh.size
    data = make_join_data(ndev, rows_per_dev, skew)
    run = timed_join(mesh, data, reps, chunks=chunks)
    best = min(run["times"])
    n_probe = len(data[3])
    res = {
        "ndev": ndev,
        "probe_rows": n_probe,
        "out_rows": run["total"],
        "s": best,
        "probe_rows_per_s": n_probe / best,
        "chunks": chunks,
    }
    if breakdown:
        res.update(_phase_breakdown(mesh, run["sharded"], run["hot_keys"],
                                    run["hot_valid"], run["info"], reps))
    return res


def _phase_breakdown(mesh, sharded, hot_keys, hot_valid, info,
                     reps) -> dict:
    """The exchange phase (all-to-all, then a group's merge-join sort and
    count) and the expansion phase (local) timed apart, each through its
    own fence; the same sort and count at the received shapes without a
    collective, which separates the algorithm from the collectives and
    padding (exchange overhead = exchange - local); the bytes and calls
    this rank sent in one exchange."""
    import torch

    from ..ops import join as join_ops
    from ..parallel import multihost
    from ..parallel.dist_join import _exchange_phase, _expand_phase

    hk, hv = np.asarray(hot_keys), np.asarray(hot_valid)
    common = dict(cap_b=info["cap_b"], cap_p=info["cap_p"],
                  hot_cap=info["hot_cap"], bloom_bits=info["bloom_bits"],
                  chunks=info["chunks"])

    def exchange():
        return _exchange_phase(*sharded, hk, hv, mesh, **common)[0]

    exchange()
    _fence(mesh)
    ex_ms, mat_ms = [], []
    sent = calls = 0
    for _ in range(reps):
        before = multihost.collective_stats()
        t0 = time.perf_counter()
        groups = exchange()
        _fence(mesh)
        t1 = time.perf_counter()
        _expand_phase(groups, s_pad=info["s_pad"])
        _fence(mesh)
        mat_ms.append((time.perf_counter() - t1) * 1e3)
        ex_ms.append((t1 - t0) * 1e3)
        after = multihost.collective_stats()
        sent, calls = (after["bytes"] - before["bytes"],
                       after["calls"] - before["calls"])

    # local reference: the sort and count at the received shapes (ndev
    # senders x capacity rows each), no collective
    ndev = mesh.size
    rng = np.random.default_rng(1)
    nb, npb = ndev * info["cap_b"], ndev * info["cap_p"]
    dev = mesh.device
    lkb = torch.from_numpy(rng.integers(0, 1 << 40, nb)).to(dev)
    lkp = torch.from_numpy(rng.integers(0, 1 << 40, npb)).to(dev)
    lvb = torch.ones(nb, dtype=torch.bool, device=dev)
    lvp = torch.ones(npb, dtype=torch.bool, device=dev)
    join_ops.join_merge_impl(lkb, lvb, lkp, lvp)
    _fence(mesh)
    loc_ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        join_ops.join_merge_impl(lkb, lvb, lkp, lvp)
        _fence(mesh)
        loc_ms.append((time.perf_counter() - t0) * 1e3)
    return {
        "phase_exchange_ms": min(ex_ms),
        "phase_expand_ms": min(mat_ms),
        "local_sort_count_ms": min(loc_ms),
        "bytes_sent_per_dev": int(sent),
        "collective_calls": int(calls),
        "cap_b": info["cap_b"], "cap_p": info["cap_p"],
        "hot_cap": info["hot_cap"], "s_pad": info["s_pad"],
    }


def run_one_plan(mesh, rows_per_dev: int, reps: int) -> dict:
    """Rank body of ``--mode plan``: a 3-join star-schema plan end to end
    through ``execute_distributed`` (warm runs replay the learned state)."""
    from ..dtypes import DataType
    from ..parallel.dist_executor import execute_distributed
    from ..plan.ir import Plan
    from ..storage.columnar import ColumnarTable, HostTable

    ndev = mesh.size
    rng = np.random.default_rng(0)
    n_fact = rows_per_dev * ndev
    n_d1, n_d2 = max(256, n_fact // 16), max(64, n_fact // 64)
    I64 = DataType.INT64

    def table(rows, types):
        return ColumnarTable.from_host(HostTable.from_rows(rows, types))

    plan = Plan()
    fact_rows = np.stack([
        rng.integers(0, n_d1, n_fact),
        rng.integers(0, n_d2 * 2, n_fact),  # half miss dimension 2
    ], axis=1).astype(np.int64)
    f = plan.new_scan_node(
        plan.new_input(table(fact_rows.tolist(), [I64, I64])),
        [(0, I64), (1, I64)])
    d1 = plan.new_scan_node(
        plan.new_input(table([[int(k), int(k % 31)] for k in range(n_d1)],
                             [I64, I64])),
        [(0, I64), (1, I64)])
    j1 = plan.new_join_node(True, d1, f, 0, 0, [(1, I64), (3, I64)])
    d2 = plan.new_scan_node(
        plan.new_input(table([[int(k), int(k * 7)] for k in range(n_d2)],
                             [I64, I64])),
        [(0, I64), (1, I64)])
    plan.root = plan.new_join_node(True, d2, j1, 0, 1, [(1, I64), (2, I64)])

    out = execute_distributed(plan, mesh=mesh)  # warm-up: learns the state
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = execute_distributed(plan, mesh=mesh)
        times.append(time.perf_counter() - t0)
    best = min(times)
    return {
        "ndev": ndev,
        "probe_rows": n_fact,
        "out_rows": out.num_rows,
        "s": best,
        "probe_rows_per_s": n_fact / best,
    }


def _child(args) -> None:
    """One rank: join the group the launcher's environment names, run the
    mode, and print rank 0's record."""
    import torch.distributed as dist

    from ..ops import kernels
    from ..parallel import make_mesh, multihost

    env = os.environ
    device = "cpu" if args.platform == "cpu" else None
    multihost.init(f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                   int(env["WORLD_SIZE"]), int(env["RANK"]), device=device)
    try:
        mesh = make_mesh(device=device)
        if args.mode == "plan":
            result = run_one_plan(mesh, args.rows, args.reps)
        else:
            result = run_one(mesh, args.rows, args.skew, args.reps,
                             args.chunks, args.breakdown)
        result["backend"] = mesh.backend
        result["device"] = str(mesh.device)
        result["launches"] = kernels.launch_counts()
        if mesh.rank == 0:
            print("CHILD_RESULT " + json.dumps(result), flush=True)
    finally:
        dist.destroy_process_group()


def _run_size(ndev: int, args) -> dict:
    """Start ``ndev`` rank processes and return rank 0's record."""
    from ..parallel import multihost

    port = multihost.free_port()
    cmd = [sys.executable, "-m", "radixjoin_tpu_torch.tools.scaling_bench",
           "--child", "--rows", str(args.rows), "--skew", str(args.skew),
           "--reps", str(args.reps), "--mode", args.mode,
           "--chunks", str(args.chunks), "--platform", args.platform]
    if args.breakdown:
        cmd.append("--breakdown")
    procs = []
    for rank in range(ndev):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(ndev),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=SIZE_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (_out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(err[-2000:], file=sys.stderr)
            raise SystemExit(f"scaling_bench: ndev={ndev} rank {rank} "
                             f"exited {p.returncode}")
    line = [ln for ln in outs[0][0].splitlines()
            if ln.startswith("CHILD_RESULT ")]
    return json.loads(line[0][len("CHILD_RESULT "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ndev", default="1,2,4,8",
                    help="comma-separated group sizes (ranks)")
    ap.add_argument("--rows", type=int, default=200_000,
                    help="probe rows a rank")
    ap.add_argument("--skew", type=float, default=0.2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--mode", choices=["join", "plan"], default="join",
                    help="join: one shuffle join; plan: whole-plan "
                         "distributed execution (3-join star schema)")
    ap.add_argument("--chunks", type=int, default=1,
                    help="exchange_chunks for --mode join")
    ap.add_argument("--breakdown", action="store_true",
                    help="per-phase times and bytes sent a rank")
    ap.add_argument("--json", default=None)
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: NCCL, one card a rank (default; fails "
                         "without enough cards); cpu: gloo ranks")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.child:
        _child(args)
        return 0

    sizes = [int(x) for x in args.ndev.split(",")]
    if args.platform == "cuda":
        import torch

        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards == 0:
            print("scaling_bench: no CUDA card (torch.cuda.is_available() "
                  "is false); pass --platform cpu for gloo ranks on the CPU",
                  file=sys.stderr)
            return 2
        if max(sizes) > cards:
            print(f"scaling_bench: NCCL takes one card a rank; "
                  f"--ndev {max(sizes)} needs {max(sizes)} cards, this "
                  f"machine has {cards}", file=sys.stderr)
            return 2
    results = [_run_size(ndev, args) for ndev in sizes]

    base = results[0]["probe_rows_per_s"] if results else 1.0
    if args.platform == "cpu":
        print(f"NOTE: gloo ranks on {os.cpu_count()} host core(s): the ranks "
              f"share them, so efficiency here reads host saturation, not "
              f"interconnect scaling")
    print(f"{'ndev':>5} {'probe rows':>12} {'out rows':>10} {'ms':>9} "
          f"{'Mrows/s':>9} {'eff':>6}")
    for r in results:
        eff = r["probe_rows_per_s"] / (base * r["ndev"])
        r["weak_efficiency"] = eff
        print(f"{r['ndev']:>5} {r['probe_rows']:>12,} {r['out_rows']:>10,} "
              f"{r['s']*1e3:>9.2f} {r['probe_rows_per_s']/1e6:>9.2f} "
              f"{eff*100:>5.1f}%")
        if "phase_exchange_ms" in r:
            print(f"      exchange {r['phase_exchange_ms']:.2f} ms, expand "
                  f"{r['phase_expand_ms']:.2f} ms, local sort+count "
                  f"{r['local_sort_count_ms']:.2f} ms, "
                  f"{r['bytes_sent_per_dev']:,} bytes in "
                  f"{r['collective_calls']} collective calls a rank")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
