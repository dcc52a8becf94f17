"""joins.torch_device_ms: device milliseconds a request spends in kernels
that are neither copies nor the port's hand kernels (torch's sorts,
cumsums, scatters and elementwise passes of the join operators), from the
profiler's trace."""

from joinbench.trace import is_hand_kernel


def read(rec):
    return rec.device_ms_per_request(
        lambda e: e.kind == "kernel" and not is_hand_kernel(e))
