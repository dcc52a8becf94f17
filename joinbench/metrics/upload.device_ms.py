"""upload.device_ms: device milliseconds a request spends on host-to-device
copies and on the device page decode's gather kernel
(``paged_window_gather``), from the profiler's trace."""


def read(rec):
    return rec.device_ms_per_request(
        lambda e: e.kind == "htod" or "paged_gather_kernel" in e.name)
