"""The least bytes of one join node of the port's fused executor, from the
shape the port leaves for it in ``_last_exec_stats["node_shapes"]``
(live rows, bytes of one key and of one value of each output column): each
input read once and each output written once, the rule of the port's
kernel table in PERF.md. For a unique-key join, the probe keys and their
validity, the build keys and theirs, and each output value read once from
its source and written once, with its validity:

    probe rows x (key + 1) + build rows x (key + 1)
        + out rows x sum over output columns of 2 x (column + 1)
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

#: the strategies of a unique-key join (the dimension probes of a star)
UNIQUE = ("unique_scatter", "unique_sort")


def least_bytes(shape: dict) -> int:
    key = shape["key_bytes"] + 1
    return (shape["probe_rows"] * key + shape["build_rows"] * key
            + shape["out_rows"] * sum(2 * (c + 1)
                                      for c in shape["out_col_bytes"]))


def unique_nodes(stats: Optional[dict]) -> Iterator[Tuple[float, dict]]:
    """``(device ms, shape)`` of each unique-key join node of one request's
    ``_last_exec_stats`` that has both; nothing where it has neither (a
    program that records no node time)."""
    if not stats:
        return
    device_ms = stats.get("node_device_ms") or {}
    shapes = stats.get("node_shapes") or {}
    for node, ms in device_ms.items():
        shape = shapes.get(node)
        if shape is not None and shape["strategy"] in UNIQUE:
            yield ms, shape
