"""fetch.wait_ms: host milliseconds a request waits in the executor's
fetches, the wait for the device included, from
``_last_exec_stats["fetch_ms"]`` (the wave executor counts its root fetch
under decode)."""


def read(rec):
    return rec.stat_mean("fetch_ms")
