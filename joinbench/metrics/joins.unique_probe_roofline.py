"""joins.unique_probe_roofline: the unique-key join nodes' share of their
roofline, in percent: the least bytes of every such node in the window
(joinbench/node_bytes.py, from the node's live shape) over the card's HBM
bandwidth (joinbench/peaks.json), divided by the nodes' summed stream time
(``_last_exec_stats["node_device_ms"]``, at least the kernels' time). None
where no node reports a time or the card is not in the table."""

from joinbench.node_bytes import least_bytes, unique_nodes
from joinbench.trace import peak_bytes_per_s


def read(rec):
    peak = peak_bytes_per_s(rec.card)
    nodes = [n for r in rec.requests for n in unique_nodes(r.stats)]
    device_s = sum(ms for ms, _shape in nodes) / 1e3
    if peak is None or device_s <= 0:
        return None
    least_s = sum(least_bytes(shape) for _ms, shape in nodes) / peak
    return 100.0 * least_s / device_s
