"""fused.fetch_rounds: blocking fetches a request makes (totals and root;
more than two on the fused executor means an overflow retry), from
``_last_exec_stats["rounds"]``."""


def read(rec):
    return rec.stat_mean("rounds")
