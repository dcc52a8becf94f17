"""joins.sort_join_ms: device milliseconds a request spends in its
sort-based joins (``unique_sort`` / ``merge``, joinbench/sort_nodes.py):
the sum of those nodes' stream time, which the port brackets with two CUDA
events a fused join node (``_last_exec_stats["node_device_ms"]``, launch
gaps inside the node included), averaged over the requests that report
node times. None where none does."""

from joinbench.sort_nodes import sort_nodes


def read(rec):
    per_request = [sum(ms for ms, _shape in sort_nodes(r.stats))
                   for r in rec.requests
                   if r.stats and r.stats.get("node_device_ms")]
    return sum(per_request) / len(per_request) if per_request else None
