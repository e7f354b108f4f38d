"""The serving cell's whole run on the CPU at the SMOKE widths: a sound run
is correct, its metrics are read, and the control and every fault a
serving cell can have come out not correct under the cell's own limits."""

import contextlib

import bench_tiny
import pytest
import torch

from benchlib import faults
from runners import serve

CPU = torch.device("cpu")
NAME = "qwen3-14b.serve-longprompt"


def _run(seed, fault=None, seconds=0.3, short=False):
    cell = bench_tiny.tiny_cell(NAME)
    if short:       # requests that finish within a few ticks of a slow CPU
        cell.traffic.update(output_len={"dist": "strata", "lo": 2, "hi": 5},
                            blocks=1000)
    ctx = (faults.planted(fault, serving=True) if fault
           else contextlib.nullcontext())
    with ctx:
        return cell, serve.run(cell, seed, seconds, False, CPU, 0.0)


def test_sound_run_and_its_metrics():
    import run
    cell, (rec, ok, checks) = _run(2**31 + 31, seconds=4.0, short=True)
    assert ok, checks
    assert rec.attempted > 0 and rec.failed == 0
    got = run.read_metrics(cell.end_to_end + cell.per_layer, rec)
    for name in ("output_tokens_per_s", "ttft_p50_ms", "itl_p95_ms",
                 "setup_s", "mfu.serve", "decode_tick_ms.serve"):
        assert got[name]["value"] > 0, name
    # the closed loop hands a request over only when one finishes
    assert rec.ticks and all(t["tokens"] <= 2 * 2 for t in rec.ticks)
    assert len(rec.ticks) >= 2


def test_control_is_not_correct():
    cell = bench_tiny.tiny_cell(NAME)
    gaps = serve.served_gaps(cell, 2**31 + 32, 0.3, CPU, ("f32", "fp8"))
    assert gaps["fp8"] > cell.limits["logit_gap"] > gaps["f32"]


@pytest.mark.parametrize("fault", faults.SERVING)
def test_faults_are_caught(fault):
    _, (rec, ok, checks) = _run(2**31 + 33, fault)
    assert not ok, checks
