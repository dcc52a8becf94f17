"""query_p50_ms: the median wall time of all requests of the window, each
timed on the host from the call to ``execute`` to its paged result."""

from joinbench.stats import percentile


def read(window):
    return percentile(window.times_ms, 50) if window.times_ms else None
