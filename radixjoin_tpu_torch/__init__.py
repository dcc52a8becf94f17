"""radixjoin_tpu_torch — the join engine of radixjoin_tpu on PyTorch and
hand-written CUDA kernels for an NVIDIA H100.

It executes the same ``Plan`` trees of scan + equi-join nodes over 8 KiB
paged columnar tables and returns exact row multisets. The single-card
engine (engine.py) runs a plan through the fused whole-plan executor
(plan/fused.py) under a device-memory ledger with eviction, through the
stepwise executor where the fused structure declines it, and through the
host-staged radix spill (ops/radix.py) where its inputs exceed the device
budget. Its seven gather kernels are CUDA C++ for Hopper (csrc/), each
beside a plain PyTorch version (ops/kernels.py).

Top-level API (mirrors reference include/plan.h:337-344):

    ctx = build_context()            # the CUDA card; build_context("cpu")
    result: ColumnarTable = execute(plan, ctx)
    results = execute_many(plans, ctx)   # batch, results in input order
    destroy_context(ctx)

``engine.engine_stats()`` tallies every degradation (out-of-memory
retries, spills), ``engine.device_ledger(device)`` is the memory ledger,
``engine.clear_device_caches()`` drops the idle cached uploads,
``engine.precompile_fused(plan, ctx)`` prepares a plan's first execute
without running it. Any number of threads may call ``execute`` on
distinct plan objects at once under one budget. ``RJT_FEEDBACK_PATH``
names a file that keeps the learned cardinality feedback across
processes.

The package imports torch and numpy only; it never imports jax or the
radixjoin_tpu package (``convert.from_reference`` reads a radixjoin_tpu
plan by its attributes).
"""

from .dtypes import DataType, NULL
from .plan.ir import Plan, PlanNode, ScanNode, JoinNode
from .storage.columnar import Column, ColumnarTable
from .engine import build_context, destroy_context, execute, execute_many

__version__ = "0.1.0"

__all__ = [
    "DataType",
    "NULL",
    "Plan",
    "PlanNode",
    "ScanNode",
    "JoinNode",
    "Column",
    "ColumnarTable",
    "build_context",
    "destroy_context",
    "execute",
    "execute_many",
]
