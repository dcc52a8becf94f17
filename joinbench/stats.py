"""What a run's window leaves for the end-to-end readers
(``joinbench/end_to_end/<metric>.py``), and the percentile they share."""

from __future__ import annotations

import dataclasses
import math
from typing import List


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of ``values``."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


@dataclasses.dataclass
class Window:
    """One measured window: every request's wall time in ms (failed ones
    included), the window's and the set-up's seconds on the host clock, and
    the device memory peak over the window."""

    times_ms: List[float]
    window_s: float
    setup_s: float
    peak_bytes: int
