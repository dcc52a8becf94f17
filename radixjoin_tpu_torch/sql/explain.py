"""PostgreSQL EXPLAIN-JSON -> Plan converter.

Walks the EXPLAIN tree the same way the reference harness does
(tests/read_sql.cpp:861-1141):

* ``Aggregate``/``Gather`` wrappers are transparent;
* a ``Hash Join`` must have exactly one ``Hash`` child — that side is the
  build side (``build_left``), the child under ``Hash`` is unwrapped;
* ``Seq Scan``/``Index Only Scan`` resolve via ``Alias`` (or a unique
  ``Relation Name``) to a :class:`~.frontend.TableEntity` and load the
  pre-filtered base table through a pluggable ``table_provider``;
* the join condition is found by intersecting the entity sets of the two
  sides against the SQL join graph (any one edge suffices — the DSU closure
  guarantees the remaining cross conditions transitively);
* required output attributes are threaded top-down, adding each side's join
  key when not already required, and mapped to child output indices
  bottom-up.

The ``table_provider(entity, attributes, filter) -> ColumnarTable`` callback
decouples plan construction from the data source (CSV ingest, synthetic
data generator, or cache).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

from ..dtypes import DataType
from ..plan.ir import Plan
from ..storage.columnar import ColumnarTable
from . import catalog
from .frontend import ParsedSQL, TableEntity

_TRANSPARENT = {"Aggregate", "Gather"}
_JOINS = {"Nested Loop", "Hash Join", "Merge Join"}
_SCANS = {"Seq Scan", "Index Only Scan"}

TableProvider = Callable[..., ColumnarTable]

# (entity, column, type) describing one output column of a plan node
_ColInfo = Tuple[TableEntity, str, DataType]


class ExplainError(ValueError):
    pass


def _split_hash_join(node: dict) -> Tuple[bool, dict, dict]:
    """Returns (build_left, left_child, right_child) with Hash unwrapped."""
    if node["Node Type"] != "Hash Join":
        raise ExplainError(f"unsupported join type: {node['Node Type']}")
    plans = node["Plans"]
    left_is_hash = plans[0]["Node Type"] == "Hash"
    right_is_hash = plans[1]["Node Type"] == "Hash"
    if left_is_hash and not right_is_hash:
        return True, plans[0]["Plans"][0], plans[1]
    if right_is_hash and not left_is_hash:
        return False, plans[0], plans[1]["Plans"][0]
    raise ExplainError("Hash Join must have exactly one Hash child")


def _scan_entity(node: dict, parsed: ParsedSQL) -> TableEntity:
    alias = node.get("Alias")
    if alias is not None:
        ent = parsed.alias_map.get(alias)
        if ent is None:
            raise ExplainError(f"cannot resolve scan alias: {alias}")
        return ent
    relation = node.get("Relation Name")
    if relation is None:
        raise ExplainError("scan node has neither Alias nor Relation Name")
    if parsed.table_counts.get(relation) != 1:
        raise ExplainError(f"table {relation} is not unique in the query")
    return TableEntity(relation, 0)


def _entities(node: dict, parsed: ParsedSQL) -> Set[TableEntity]:
    node_type = node["Node Type"]
    if node_type in _TRANSPARENT:
        return _entities(node["Plans"][0], parsed)
    if node_type in _JOINS:
        _, left, right = _split_hash_join(node)
        return _entities(left, parsed) | _entities(right, parsed)
    if node_type in _SCANS:
        return {_scan_entity(node, parsed)}
    raise ExplainError(f"unsupported node type: {node_type}")


def plan_from_explain(
    explain: dict,
    parsed: ParsedSQL,
    table_provider: TableProvider,
) -> Plan:
    """Convert one EXPLAIN-JSON document (its "Plan" node) into a Plan."""
    plan = Plan()
    input_ids: Dict[TableEntity, int] = {}

    def recurse(
        node: dict, required: List[Tuple[TableEntity, str]]
    ) -> Tuple[int, List[_ColInfo]]:
        node_type = node["Node Type"]
        if node_type in _TRANSPARENT:
            return recurse(node["Plans"][0], required)
        if node_type in _JOINS:
            return handle_join(node, required)
        if node_type in _SCANS:
            return handle_scan(node, required)
        raise ExplainError(f"unsupported node type: {node_type}")

    def handle_join(
        node: dict, required: List[Tuple[TableEntity, str]]
    ) -> Tuple[int, List[_ColInfo]]:
        build_left, left_node, right_node = _split_hash_join(node)
        left_entities = _entities(left_node, parsed)
        right_entities = _entities(right_node, parsed)

        # Find one join-graph edge crossing the two sides. Any single edge is
        # sufficient: the SQL frontend materializes all pairwise conditions
        # of each DSU class, so intra-side pairs are enforced in the
        # subtrees and the remaining cross pairs follow by transitivity.
        edge = None
        for ent in sorted(left_entities):
            adj = parsed.join_graph.get(ent)
            if not adj:
                continue
            for other in sorted(adj):
                if other in right_entities:
                    lcol, rcol = adj[other]
                    edge = (ent, lcol, other, rcol)
        if edge is None:
            raise ExplainError(
                f"no join condition between {sorted(map(str, left_entities))} "
                f"and {sorted(map(str, right_entities))}"
            )
        left_entity, left_column, right_entity, right_column = edge

        left_required: List[Tuple[TableEntity, str]] = []
        right_required: List[Tuple[TableEntity, str]] = []
        left_key_in = right_key_in = False
        for ent, column in required:
            if ent in left_entities:
                if ent == left_entity and column == left_column:
                    left_key_in = True
                left_required.append((ent, column))
            elif ent in right_entities:
                if ent == right_entity and column == right_column:
                    right_key_in = True
                right_required.append((ent, column))
            else:
                raise ExplainError(
                    f"required attribute {ent}.{column} not found in either child"
                )
        if not left_key_in:
            left_required.append((left_entity, left_column))
        if not right_key_in:
            right_required.append((right_entity, right_column))

        left_id, left_cols = recurse(left_node, left_required)
        right_id, right_cols = recurse(right_node, right_required)

        def find_col(cols: List[_ColInfo], ent: TableEntity, column: str) -> int:
            for idx, (e, c, _) in enumerate(cols):
                if e == ent and c == column:
                    return idx
            raise ExplainError(f"join key {ent}.{column} missing from child output")

        left_attr = find_col(left_cols, left_entity, left_column)
        right_attr = find_col(right_cols, right_entity, right_column)

        combined = left_cols + right_cols
        output_cols: List[_ColInfo] = []
        output_attrs: List[Tuple[int, DataType]] = []
        for ent, column in required:
            idx = find_col(combined, ent, column)
            dt = combined[idx][2]
            output_cols.append((ent, column, dt))
            output_attrs.append((idx, dt))

        node_id = plan.new_join_node(
            build_left, left_id, right_id, left_attr, right_attr, output_attrs
        )
        return node_id, output_cols

    def handle_scan(
        node: dict, required: List[Tuple[TableEntity, str]]
    ) -> Tuple[int, List[_ColInfo]]:
        entity = _scan_entity(node, parsed)
        attributes = catalog.ATTRIBUTES[entity.table]
        filt = parsed.filters.get(entity)
        if entity not in input_ids:
            table = table_provider(entity, attributes, filt)
            input_ids[entity] = plan.new_input(table)
        output_cols: List[_ColInfo] = []
        output_attrs: List[Tuple[int, DataType]] = []
        for ent, column in required:
            if ent != entity:
                raise ExplainError(
                    f"required attribute {ent}.{column} does not belong to scan {entity}"
                )
            idx = catalog.column_index(entity.table, column)
            dt = attributes[idx][1]
            output_cols.append((ent, column, dt))
            output_attrs.append((idx, dt))
        node_id = plan.new_scan_node(input_ids[entity], output_attrs)
        return node_id, output_cols

    root, _ = recurse(explain, parsed.output_attrs)
    plan.root = root
    return plan
