"""fused.dispatch_ms: host milliseconds a request spends dispatching the
plan's device work in the fused or wave executor, from the stage breakdown
the port leaves on the plan (``_last_exec_stats["dispatch_ms"]``)."""


def read(rec):
    return rec.stat_mean("dispatch_ms")
