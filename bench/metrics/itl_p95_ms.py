"""95th percentile (linear interpolation) of every gap between the ticks
that served consecutive tokens of a request, both inside the window."""

import numpy as np

UNIT = "ms"
SOURCE = "host_clock"


def read(run):
    if run.kind != "serve" or not run.itl_s:
        return None
    return float(np.percentile(run.itl_s, 95)) * 1e3
