"""queries_per_s: requests completed in the window over the window's
seconds, the last request's end included (all the work over all the
time)."""


def read(window):
    return len(window.times_ms) / window.window_s
