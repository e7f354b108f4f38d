"""Median host ms of waiting for a decode tick's tokens: the program's
``serve.decode_read`` spans (the tick's one ``.cpu()`` read, which waits
for the device) in the traced ticks that admitted nothing.  Small next to
``decode_issue_ms.serve``, the tick is paced by the host."""

import statistics

UNIT = "ms"
SOURCE = "host_clock"
LAYER = "engine"
MOVES = "output_tokens_per_s"


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    try:
        from repro_torch import spans
    except ImportError:     # a program without spans
        return None
    rec = spans.recorded()
    admitting = {s["parent"] for s in rec if s["name"] == "serve.admit"}
    ticks = {s["id"] for s in rec
             if s["name"] == "serve.tick" and s["id"] not in admitting}
    ms = [s["host_ms"] for s in rec
          if s["name"] == "serve.decode_read" and s["parent"] in ticks]
    if not ms:
        return None
    return statistics.median(ms)
