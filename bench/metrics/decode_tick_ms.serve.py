"""Median wall time of the window's ``tick()`` calls that admitted
nothing."""

import statistics

UNIT = "ms"
SOURCE = "host_clock"
LAYER = "engine"
MOVES = "output_tokens_per_s"


def read(run):
    ticks = [t["t1"] - t["t0"] for t in run.ticks if not t["prompts"]]
    if run.kind != "serve" or not ticks:
        return None
    return statistics.median(ticks) * 1e3
