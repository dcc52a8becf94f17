"""closed_loop: one client in a closed loop. Set-up runs every plan the
mix's ``warmup_passes`` times; the window runs round after round over the
plans, each round in a new order from the run's seed, starting rounds
until the window's seconds have passed, so every seed does the same work
in another order.

A driver is a file of ``joinbench/drivers/`` that a traffic mix names by
its ``driver`` key. It has two functions, each given the run's
``Session`` (``joinbench/run.py``) and the mix's parameters:
``warm_up`` executes what the window will, untimed, and returns the
seconds of its stages; ``window`` makes the timed requests with
``session.call(name)`` until ``session.over()``.
"""

import time


def warm_up(session, traffic) -> dict:
    split = {}
    for p in range(int(traffic["warmup_passes"])):
        t = time.perf_counter()
        for name in session.names:
            session.warm(name)
        split[f"warmup_pass{p + 1}_s"] = time.perf_counter() - t
    return split


def window(session, traffic) -> None:
    names = session.names
    while not session.over():
        for i in session.rng.permutation(len(names)):
            session.call(names[i])
