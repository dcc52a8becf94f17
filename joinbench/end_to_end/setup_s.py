"""setup_s: seconds from the process's start to the first timed request
(CUDA up, the data made, the plans built, the warm-up), host clock."""


def read(window):
    return window.setup_s
