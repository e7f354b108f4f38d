"""What one run measured: the record the metric readers read."""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch


@dataclasses.dataclass
class Run:
    kind: str                       # the runner: "phase2" or "serve"
    dims: dict                      # the configuration's widths
    traffic: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    memory_peak_bytes: int = 0      # the process's peak up to the window's end
    window_peak_bytes: int = 0      # the peak within the window
    reference_s: float = 0.0        # the comparison after the window
    attempted: int = 0
    failed: int = 0
    # phase2
    steps: int = 0
    tokens: int = 0
    step_flops: float = 0.0
    # serve: one dict a tick of the window (see runners/serve.py)
    ticks: list = dataclasses.field(default_factory=list)
    ttft_s: list = dataclasses.field(default_factory=list)
    itl_s: list = dataclasses.field(default_factory=list)
    flops: float = 0.0
    # --trace 1: the traced sub-window
    trace: Optional[object] = None
    trace_steps: int = 0
    trace_ticks: list = dataclasses.field(default_factory=list)


class Clock:
    """Host seconds since ``t0``, with the device drained first on a card
    (kernels are asynchronous; a host clock without it times the
    enqueue)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def now(self):
        self.sync()
        return time.perf_counter()


def memory(device):
    """(peak bytes allocated since the last reset) on a card, 0 elsewhere."""
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated()


def reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def free(device):
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
