"""Median device ms of the traced admissions' prefills: the program's
``serve.prefill`` spans (the admission step: prefill, first-token sampler
and cache merge), timed by their CUDA event pairs."""

import statistics

UNIT = "ms"
SOURCE = "device_trace"
LAYER = "model step"
MOVES = "ttft_p50_ms"


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    try:
        from repro_torch import spans
    except ImportError:     # a program without spans
        return None
    ms = [s["device_ms"] for s in spans.recorded()
          if s["name"] == "serve.prefill"]
    if not ms or None in ms:
        return None
    return statistics.median(ms)
