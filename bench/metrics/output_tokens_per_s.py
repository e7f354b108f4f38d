"""Tokens the engine emitted in the window over the window's seconds."""

UNIT = "tokens/s"
SOURCE = "host_clock"


def read(run):
    if run.kind != "serve" or run.window_s <= 0:
        return None
    return sum(t["tokens"] for t in run.ticks) / run.window_s
