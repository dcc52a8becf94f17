"""The least bytes of one call of each of the port's main-path hand
kernels, from the call's shapes alone: each input read once and each
output written once (the rule of the port's kernel table in PERF.md).
Where what is read depends on the values (the blocked gather's table
entries), it is left out, so the share of the roofline is a lower bound
there."""

from __future__ import annotations


def _arg(args, kwargs, i, name, default=None):
    if name in kwargs:
        return kwargs[name]
    return args[i] if len(args) > i else default


def window_gather(args, kwargs) -> int:
    tables, idx = list(_arg(args, kwargs, 0, "tables")), _arg(args, kwargs, 1, "idx")
    n, w = idx.numel(), tables[0].shape[0]
    return n * idx.element_size() + (n + w) * sum(t.element_size() for t in tables)


def blocked_window_gather_multi(args, kwargs) -> int:
    tables, idx = list(_arg(args, kwargs, 0, "tables")), _arg(args, kwargs, 1, "idx")
    with_ok = _arg(args, kwargs, 2, "with_ok", True)
    n = idx.numel()
    return n * (idx.element_size() + sum(t.element_size() for t in tables)
                + (4 if with_ok else 0))


def paged_window_gather(args, kwargs) -> int:
    body, idx = _arg(args, kwargs, 0, "body"), _arg(args, kwargs, 1, "idx")
    return body.numel() * body.element_size() + 2 * idx.numel() * idx.element_size()


def owner_recovery(args, kwargs) -> int:
    offsets = _arg(args, kwargs, 0, "offsets")
    total = _arg(args, kwargs, 1, "total")
    s_pad = int(_arg(args, kwargs, 2, "s_pad"))
    return (offsets.numel() * offsets.element_size()
            + total.numel() * total.element_size() + 4 * s_pad)


def cummax_i32(args, kwargs) -> int:
    x = _arg(args, kwargs, 0, "x")
    return 2 * x.numel() * x.element_size()


#: wrapper name -> least-bytes function
LEAST_BYTES = {f.__name__: f for f in (window_gather, blocked_window_gather_multi,
                                       paged_window_gather, owner_recovery,
                                       cummax_i32)}

#: wrapper name -> the name its CUDA kernel has in a profiler trace
KERNEL_NAMES = {
    "window_gather": "window_gather_kernel",
    "blocked_window_gather_multi": "bwg_kernel",
    "paged_window_gather": "paged_gather_kernel",
    "owner_recovery": "owner_merge_kernel",
    "cummax_i32": "max_scan_kernel",
}
