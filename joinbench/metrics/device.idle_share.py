"""device.idle_share: the share of the window in which no kernel or copy
ran on the device, from the profiler's trace (the union of the device
events' intervals)."""


def read(rec):
    if not rec.events:
        return None
    return 1.0 - rec.busy_s() / rec.window_s
