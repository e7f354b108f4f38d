"""FLOPs of the real prompt and output tokens served in the window (no
padding rows, no idle slots; the output head only where a token is
served) over the window's seconds at the H100's 989 TFLOP/s bf16 peak."""

from benchlib import flops

UNIT = "%"
SOURCE = "host_clock"
LAYER = "model step"
MOVES = "output_tokens_per_s"


def read(run):
    if run.kind != "serve" or run.window_s <= 0:
        return None
    return 100 * run.flops / (run.window_s * flops.PEAK_BF16)
