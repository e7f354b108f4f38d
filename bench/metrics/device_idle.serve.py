"""Share of the traced ticks in which no kernel, copy or memset ran on the
card."""

UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "output_tokens_per_s"


def read(run):
    if run.kind != "serve" or run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
