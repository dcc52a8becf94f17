"""fetch.decode_ms: host milliseconds a request spends turning the fetched
root into host columns, from ``_last_exec_stats["decode_ms"]``."""


def read(rec):
    return rec.stat_mean("decode_ms")
