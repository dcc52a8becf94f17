"""Query plan IR.

A ``Plan`` is a binary tree over two node kinds (reference include/plan.h:27-52):

* ``ScanNode(base_table_id)`` — leaf; reads ``plan.inputs[base_table_id]``
  (a pre-filtered paged ColumnarTable) and projects ``output_attrs``.
* ``JoinNode(build_left, left, right, left_attr, right_attr)`` — equi-join of
  two child nodes. ``left_attr``/``right_attr`` index into the respective
  child's *output* columns. ``build_left`` selects the hash-build side.
  ``output_attrs`` of a join index into the concatenation
  ``left_child_output ++ right_child_output``.

Construction methods mirror reference include/plan.h:112-149 so that the
reference's unit-test plans (tests/unit_tests.cpp) can be transliterated.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple, Union

from ..dtypes import DataType


@dataclasses.dataclass(frozen=True)
class ScanNode:
    base_table_id: int


@dataclasses.dataclass(frozen=True)
class JoinNode:
    build_left: bool
    left: int
    right: int
    left_attr: int
    right_attr: int


OutputAttrs = List[Tuple[int, DataType]]


@dataclasses.dataclass
class PlanNode:
    data: Union[ScanNode, JoinNode]
    output_attrs: OutputAttrs

    @property
    def is_join(self) -> bool:
        return isinstance(self.data, JoinNode)

    @property
    def output_types(self) -> List[DataType]:
        return [dt for _, dt in self.output_attrs]


@dataclasses.dataclass
class Plan:
    nodes: List[PlanNode] = dataclasses.field(default_factory=list)
    inputs: list = dataclasses.field(default_factory=list)  # list[ColumnarTable]
    root: int = 0

    def new_join_node(
        self,
        build_left: bool,
        left: int,
        right: int,
        left_attr: int,
        right_attr: int,
        output_attrs: OutputAttrs,
    ) -> int:
        node_id = len(self.nodes)
        self.nodes.append(
            PlanNode(
                JoinNode(build_left, left, right, left_attr, right_attr),
                [(int(i), DataType(t)) for i, t in output_attrs],
            )
        )
        return node_id

    def new_scan_node(self, base_table_id: int, output_attrs: OutputAttrs) -> int:
        node_id = len(self.nodes)
        self.nodes.append(
            PlanNode(
                ScanNode(base_table_id),
                [(int(i), DataType(t)) for i, t in output_attrs],
            )
        )
        return node_id

    def new_input(self, table) -> int:
        input_id = len(self.inputs)
        self.inputs.append(table)
        return input_id

    def validate(self) -> None:
        """Structural sanity checks (cheap; raise on malformed plans)."""
        n = len(self.nodes)
        if not (0 <= self.root < n):
            raise ValueError(f"root {self.root} out of range [0,{n})")
        for idx, node in enumerate(self.nodes):
            if isinstance(node.data, JoinNode):
                j = node.data
                for child in (j.left, j.right):
                    if not (0 <= child < n):
                        raise ValueError(f"node {idx}: child {child} out of range")
                left_w = len(self.nodes[j.left].output_attrs)
                right_w = len(self.nodes[j.right].output_attrs)
                if not (0 <= j.left_attr < left_w):
                    raise ValueError(f"node {idx}: left_attr {j.left_attr} out of range")
                if not (0 <= j.right_attr < right_w):
                    raise ValueError(f"node {idx}: right_attr {j.right_attr} out of range")
                for col, _ in node.output_attrs:
                    if not (0 <= col < left_w + right_w):
                        raise ValueError(f"node {idx}: output attr {col} out of range")
            else:
                if not (0 <= node.data.base_table_id < len(self.inputs)):
                    raise ValueError(
                        f"node {idx}: input {node.data.base_table_id} out of range"
                    )
                ncols = len(self.inputs[node.data.base_table_id].columns)
                for col, _ in node.output_attrs:
                    if not (0 <= col < ncols):
                        raise ValueError(
                            f"node {idx}: scan output attr {col} out of "
                            f"range [0,{ncols})"
                        )

    def topo_order(self) -> List[int]:
        """Post-order of the tree rooted at ``self.root`` (children first)."""
        order: List[int] = []
        seen = set()

        def visit(idx: int) -> None:
            if idx in seen:
                return
            seen.add(idx)
            node = self.nodes[idx]
            if isinstance(node.data, JoinNode):
                visit(node.data.left)
                visit(node.data.right)
            order.append(idx)

        visit(self.root)
        return order
