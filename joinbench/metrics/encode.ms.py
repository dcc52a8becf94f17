"""encode.ms: host milliseconds a request spends encoding its result into
8 KiB pages, timed by the benchmark around the port's
``engine._encode_result``."""


def read(rec):
    ms = [r.encode_ms for r in rec.requests if r.encode_ms is not None]
    return sum(ms) / len(ms) if ms else None
