"""A Phase-2 cell's whole run (set-up, window, reference) on the CPU at the
SMOKE widths: a sound run agrees with the reference far inside the
control's readings, and the control and every fault a training cell can
have come out not correct under the cell's own limits."""

import contextlib

import bench_tiny
import pytest
import torch

from benchlib import compare, faults, record
from runners import phase2

CPU = torch.device("cpu")
CELLS = ["granite-3-2b.phase2-bkd", "granite-3-2b.phase2-kd"]


def _run(cell, seed, fault=None):
    ctx = faults.planted(fault) if fault else contextlib.nullcontext()
    with ctx:
        rec, ok, checks = phase2.run(cell, seed, 0.05, False, CPU, 0.0)
    return rec, ok, {k: c["value"] for k, c in checks.items()}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_inside_the_control(name):
    cell = bench_tiny.tiny_cell(name)
    seed = 2**31 + 21
    rec, _, sound = _run(cell, seed)
    assert rec.steps >= 1 and rec.failed == 0 and rec.setup_s > 0
    feed = phase2.build(cell, seed, CPU)[2]
    record.free(CPU)
    ref = phase2.reference(cell, seed, CPU, feed)
    ctl = compare.training_numbers(
        phase2.reference(cell, seed, CPU, feed, prec="fp8"), ref)
    assert not compare.judge(ctl, cell.limits)[0], ctl
    assert sound["loss_gap"] * 3 < ctl["loss_gap"]
    assert sound["grad_gap"] * 3 < ctl["grad_gap"]


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_faults_are_caught(fault):
    cell = bench_tiny.tiny_cell(CELLS[0])
    _, ok, got = _run(cell, 2**31 + 22, fault)
    assert not ok, got
    if fault == "frozen_state":
        assert got["change_gap"] == pytest.approx(1.0)
