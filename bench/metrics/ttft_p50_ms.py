"""Median time to first token of the requests whose first token came in the
window: from the client handing the request over to the end of the
``tick()`` that returned its first token."""

import statistics

UNIT = "ms"
SOURCE = "host_clock"


def read(run):
    if run.kind != "serve" or not run.ttft_s:
        return None
    return statistics.median(run.ttft_s) * 1e3
