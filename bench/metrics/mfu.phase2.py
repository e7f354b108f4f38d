"""The Phase-2 steps' useful FLOPs (student forward and backward, teacher
and buffer forwards, causal attention; no recompute) over the window's
seconds at the H100's 989 TFLOP/s bf16 peak."""

from benchlib import flops

UNIT = "%"
SOURCE = "host_clock"
LAYER = "Phase-2 step"
MOVES = "phase2_tokens_per_s"


def read(run):
    if run.kind != "phase2" or run.window_s <= 0:
        return None
    return 100 * run.steps * run.step_flops / (run.window_s * flops.PEAK_BF16)
