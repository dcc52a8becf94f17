"""query_p95_ms: the 95th percentile (nearest rank) of the wall times of
all requests of the window, failed ones included."""

from joinbench.stats import percentile


def read(window):
    return percentile(window.times_ms, 95) if window.times_ms else None
