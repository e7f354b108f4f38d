"""Median wall time of the window's ``tick()`` calls that admitted a
request."""

import statistics

UNIT = "ms"
SOURCE = "host_clock"
LAYER = "engine"
MOVES = "ttft_p50_ms"


def read(run):
    ticks = [t["t1"] - t["t0"] for t in run.ticks if t["prompts"]]
    if run.kind != "serve" or not ticks:
        return None
    return statistics.median(ticks) * 1e3
