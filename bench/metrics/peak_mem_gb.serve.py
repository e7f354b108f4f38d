"""The allocator's peak (``torch.cuda.max_memory_allocated``, reset at the
window's start) within the window, in 1e9 bytes."""

UNIT = "GB"
SOURCE = "program_counter"
LAYER = "device"
MOVES = "output_tokens_per_s"


def read(run):
    if run.kind != "serve" or run.window_peak_bytes <= 0:
        return None
    return run.window_peak_bytes / 1e9
