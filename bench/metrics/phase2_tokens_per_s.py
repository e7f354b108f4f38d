"""Tokens of every Phase-2 step completed in the window over the window's
seconds (the window ends in a device sync)."""

UNIT = "tokens/s"
SOURCE = "host_clock"


def read(run):
    if run.kind != "phase2" or run.window_s <= 0:
        return None
    return run.tokens / run.window_s
