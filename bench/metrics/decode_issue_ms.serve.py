"""Median host ms of issuing a decode tick: the program's ``serve.decode``
spans (``_tick_fn``, whose kernels the host enqueues and does not wait
for) in the traced ticks that admitted nothing."""

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
          if s["name"] == "serve.decode" and s["parent"] in ticks]
    if not ms:
        return None
    return statistics.median(ms)
