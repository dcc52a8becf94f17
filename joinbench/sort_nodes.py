"""The sort-based join nodes of one request: the ``unique_sort`` and
``merge`` nodes of the port's fused executor, which sort where no dense
key window serves (``sort_reason`` in the node's shape, where the port
records it), with the device time and the shape the port leaves for each
in ``_last_exec_stats`` (``node_device_ms``, ``node_shapes``)."""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

#: the strategies that sort their keys
SORT = ("unique_sort", "merge")


def sort_nodes(stats: Optional[dict]) -> Iterator[Tuple[float, dict]]:
    """``(device ms, shape)`` of each sort-based join node of one request's
    ``_last_exec_stats`` that has both; nothing where it has neither (a
    program that records no node time)."""
    if not stats:
        return
    device_ms = stats.get("node_device_ms") or {}
    shapes = stats.get("node_shapes") or {}
    for node, ms in device_ms.items():
        shape = shapes.get(node)
        if shape is not None and shape["strategy"] in SORT:
            yield ms, shape
