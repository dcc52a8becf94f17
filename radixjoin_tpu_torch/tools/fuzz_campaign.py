"""Fuzz campaign over randomized join plans (port of the JAX package's
``tools/fuzz_campaign.py``; imports torch and numpy only).

Each seed's plan (:func:`radixjoin_tpu_torch.harness.fuzz.gen_plan`) runs
in every mode asked for, and every result is held to the row-semantics
oracle (``harness/oracle.execute_plan_rows`` / ``rows_equal``):

* ``auto``, ``shared``, ``stepwise``: ``execute`` under that
  ``RJT_EXEC_MODE``, on a fresh context each;
* ``spill``: ``auto`` under a device budget of 4,096 bytes, so every plan
  takes the host-staged radix spill;
* ``dist`` and ``dist_chunked``: ``execute_distributed`` cold, then warm
  (the learned replay, without a host sync a join), monolithic and with
  ``exchange_chunks=3`` and the smallest Bloom bitmap (the most false
  positives in the semi-join filter).

The distributed modes run on a one-rank process group: NCCL on the card,
gloo with ``--platform cpu`` (or the group the calling process already
joined). The JAX campaign ran them over eight virtual devices in one
process; a torch rank is a process, so that layout has no counterpart
here, and multi-rank semantics are held by the gloo clusters of
``tests/test_torch_multihost.py``. The JAX campaign splits its seeds over
subprocesses only because XLA's CPU JIT runs out of memory maps after a
few hundred programs; torch compiles nothing a plan, so one process runs
every seed.

Usage::

    python -m radixjoin_tpu_torch.tools.fuzz_campaign [--seeds 500] \
        [--start 0] [--modes auto,shared,stepwise,spill,dist,dist_chunked] \
        [--platform cuda|cpu]

Runs on the CUDA card unless ``--platform cpu``. Every failure prints one
``FAIL seed=<seed> mode=<mode>: ...`` line (replay it with ``--seeds 1
--start <seed> --modes <mode>``); exit 0 only when every seed is clean.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

MODES = ("auto", "shared", "stepwise", "spill", "dist", "dist_chunked")
#: the device budget of the ``spill`` mode, bytes
SPILL_BUDGET = "4096"


@contextlib.contextmanager
def _env(**values):
    """Set (or, for None, unset) environment variables, restored on exit."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_campaign(seeds: int, start: int = 0, modes=MODES,
                 device=None) -> dict:
    """Fuzz seeds ``[start, start + seeds)`` in ``modes`` on ``device``
    (None: the card; ``"cpu"``), printing one ``FAIL`` line a failed run.
    Returns ``{"failures", "runs", "seconds"}`` (``runs``: the checked runs
    a mode)."""
    import torch.distributed as dist

    from ..engine import build_context, destroy_context, execute
    from ..harness import fuzz, oracle
    from ..parallel import DistJoinConfig, make_mesh, multihost
    from ..parallel.dist_executor import execute_distributed

    unknown = set(modes) - set(MODES)
    if unknown:
        raise ValueError(f"unknown modes {sorted(unknown)}; known: {MODES}")
    t0 = time.perf_counter()
    owns_group = False
    if any(m.startswith("dist") for m in modes) and not dist.is_initialized():
        multihost.init(f"localhost:{multihost.free_port()}", 1, 0,
                       device=device)
        owns_group = True
    failures = 0
    runs = {m: 0 for m in modes}
    try:
        for seed in range(start, start + seeds):
            plan = fuzz.gen_plan(np.random.default_rng(seed))
            expected = fuzz.mask_nan(oracle.execute_plan_rows(plan))

            def check(mode, label, run):
                nonlocal failures
                runs[mode] += 1
                try:
                    actual = run()
                except Exception as e:  # a crash fails the seed, not the campaign
                    failures += 1
                    print(f"FAIL seed={seed} mode={label}: "
                          f"{type(e).__name__}: {e}", flush=True)
                    return
                ok, msg = oracle.rows_equal(fuzz.mask_nan(actual), expected)
                if not ok:
                    failures += 1
                    print(f"FAIL seed={seed} mode={label}: {msg}", flush=True)

            for mode in modes:
                if mode in ("dist", "dist_chunked"):
                    config = (DistJoinConfig(exchange_chunks=3,
                                             bloom_max_bits=8192)
                              if mode == "dist_chunked" else None)
                    # one mesh for both runs: the learned state keys on it;
                    # the warm run replays the cold run's feedback
                    mesh = make_mesh(device=device)
                    for label in (mode + "_cold", mode):
                        check(mode, label, lambda: execute_distributed(
                            plan, mesh=mesh, config=config).to_rows())
                    continue
                budget = SPILL_BUDGET if mode == "spill" else None
                exec_mode = "auto" if mode == "spill" else mode

                def run_engine():
                    with _env(RJT_EXEC_MODE=exec_mode,
                              RJT_HBM_BUDGET_BYTES=budget):
                        ctx = build_context(device)
                        try:
                            return execute(plan, ctx).to_host().to_rows()
                        finally:
                            destroy_context(ctx)

                check(mode, mode, run_engine)
    finally:
        if owns_group:
            dist.destroy_process_group()
    return {"failures": failures, "runs": runs,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=500)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                    help="the CUDA card (default; fails without one) or the "
                         "CPU, where every kernel takes its plain version")
    args = ap.parse_args(argv)

    import torch

    if args.platform == "cuda" and not torch.cuda.is_available():
        print("fuzz_campaign: no CUDA card (torch.cuda.is_available() is "
              "false); pass --platform cpu to run on the CPU",
              file=sys.stderr)
        return 2
    modes = [m for m in args.modes.split(",") if m]
    out = run_campaign(args.seeds, args.start, modes,
                       device="cpu" if args.platform == "cpu" else None)
    verdict = ("CLEAN" if out["failures"] == 0
               else f"{out['failures']} FAILURES")
    print(f"campaign [{args.start}, {args.start + args.seeds}) x "
          f"[{','.join(modes)}] on {args.platform}: {verdict} "
          f"({sum(out['runs'].values())} checked runs, "
          f"{out['seconds']:.1f} s)", flush=True)
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
