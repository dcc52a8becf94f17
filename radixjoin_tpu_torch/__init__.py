"""radixjoin_tpu_torch — the join engine of radixjoin_tpu on PyTorch and
hand-written CUDA kernels for an NVIDIA H100.

It executes the same ``Plan`` trees of scan + equi-join nodes over 8 KiB
paged columnar tables and returns exact row multisets, through the fused
whole-plan executor (plan/fused.py). Its three gather kernels are CUDA C++
for Hopper (csrc/), each beside a plain PyTorch version (ops/kernels.py).

Top-level API (mirrors reference include/plan.h:337-344):

    ctx = build_context()            # the CUDA card; build_context("cpu")
    result: ColumnarTable = execute(plan, ctx)
    destroy_context(ctx)

The package imports torch and numpy only; it never imports jax or the
radixjoin_tpu package (``convert.from_reference`` reads a radixjoin_tpu
plan by its attributes).
"""

from .dtypes import DataType, NULL
from .plan.ir import Plan, PlanNode, ScanNode, JoinNode
from .storage.columnar import Column, ColumnarTable
from .engine import build_context, destroy_context, execute

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
]
