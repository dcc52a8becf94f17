"""Carry a radixjoin_tpu ``Plan`` over to this port.

:func:`from_reference` reads a JAX-package plan by its attributes only —
it never imports jax or radixjoin_tpu — and builds the port's own
``Plan`` and ``ColumnarTable`` objects from copies of its numpy arrays.
The copies are fresh objects, so none of the state the JAX package caches
on its own objects (upload memos on columns; learned buckets, structure
caches and join totals on plans) is shared: the two engines can run the
same query side by side in one process without specializing each other.
"""

from __future__ import annotations

from .dtypes import DataType
from .plan.ir import Plan
from .storage.columnar import Column, ColumnarTable, HostColumn, HostTable


def _copy_host_column(c) -> HostColumn:
    dtype = DataType(int(c.dtype))
    valid = c.valid.copy()
    if dtype is DataType.VARCHAR:
        return HostColumn.varchar(c.heap.copy(), c.ends.copy(), valid)
    return HostColumn(dtype, c.values.copy(), valid)


def _copy_host_table(t) -> HostTable:
    return HostTable(t.num_rows, [_copy_host_column(c) for c in t.columns])


def _copy_input(table) -> ColumnarTable:
    """Eager pages are copied byte for byte (scans then take the raw-page
    device decode, as in the reference); a table with a deferred page
    encode is rebuilt lazily from a copy of its host twin (dense upload,
    as in the reference)."""
    host = table._host
    host = None if host is None else _copy_host_table(host)
    if any(callable(c._pages) for c in table.columns):
        if host is None:
            raise ValueError("lazy input table without its host twin")
        return ColumnarTable.from_host(host, lazy=True)
    cols = [Column(DataType(int(c.type)), c.pages.copy())
            for c in table.columns]
    return ColumnarTable(table.num_rows, cols, _host=host)


def from_reference(ref_plan) -> Plan:
    """The port's copy of a radixjoin_tpu ``Plan``: same nodes and root,
    inputs copied (see :func:`_copy_input`)."""
    plan = Plan()
    for node in ref_plan.nodes:
        attrs = [(int(ci), DataType(int(dt))) for ci, dt in node.output_attrs]
        d = node.data
        if hasattr(d, "base_table_id"):
            plan.new_scan_node(int(d.base_table_id), attrs)
        else:
            plan.new_join_node(bool(d.build_left), int(d.left), int(d.right),
                               int(d.left_attr), int(d.right_attr), attrs)
    for table in ref_plan.inputs:
        plan.new_input(_copy_input(table))
    plan.root = int(ref_plan.root)
    return plan
