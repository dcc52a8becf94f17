"""hand_kernels_roofline: the five main-path hand kernels' share of their
roofline, in percent: the least bytes of every call in the window
(joinbench/kernel_bytes.py) over the card's HBM bandwidth
(joinbench/peaks.json), divided by their device time in the profiler's
trace. None where they ran no device time or the card is not in the
table."""

from joinbench.kernel_bytes import KERNEL_NAMES
from joinbench.trace import peak_bytes_per_s


def read(rec):
    peak = peak_bytes_per_s(rec.card)
    device_s = sum(e.end_ns - e.start_ns for e in rec.events
                   if e.kind == "kernel"
                   and any(k in e.name for k in KERNEL_NAMES.values())) / 1e9
    if peak is None or device_s <= 0:
        return None
    least_s = sum(b for _name, b in rec.kernel_calls) / peak
    return 100.0 * least_s / device_s
