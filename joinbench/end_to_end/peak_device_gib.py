"""peak_device_gib: ``torch.cuda.max_memory_allocated()`` over the window
(reset when it starts; the resident uploads included), in GiB."""


def read(window):
    return window.peak_bytes / 2 ** 30
