"""The trace reader on a hand-made Chrome trace."""

import bench_tiny  # noqa: F401
import pytest

from benchlib import trace


def ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def test_busy_idle_and_gaps():
    events = [
        ev(trace.WINDOW, "user_annotation", 0, 1000),
        ev("bench.tick", "user_annotation", 0, 1000),
        ev("aten::mm", "cpu_op", 0, 150),
        ev("cudaLaunchKernel", "cuda_runtime", 100, 40),
        ev("aten::item", "cpu_op", 700, 250),
        ev("gemm", "kernel", 150, 300, tid=7),
        ev("gemm", "kernel", 400, 100, tid=7),   # overlaps the first
        ev("swa_split_kernel<bf16>", "kernel", 600, 50, tid=7),
        ev("Memcpy DtoH", "gpu_memcpy", 900, 20, tid=7),
        ev("late", "kernel", 990, 50, tid=7),    # cut at the window's end
    ]
    t = trace.summarize(events)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx((350 + 50 + 20 + 10) * 1e-6)
    assert t.seconds("gemm") == (pytest.approx(400e-6), 2)
    assert t.seconds("swa_split_kernel") == (pytest.approx(50e-6), 1)
    gaps = t.idle_gaps
    assert gaps["bench.tick/aten::mm"] == pytest.approx(150e-6)
    # 500-600 and 920-990 in plain Python inside the tick annotation
    assert gaps["bench.tick"] == pytest.approx((100 + 70) * 1e-6)
    assert gaps["bench.tick/aten::item"] == pytest.approx(250e-6)
    assert sum(gaps.values()) == pytest.approx(1e-3 - t.busy_s)
    b = t.breakdown()
    assert b["device_ops"][0] == ["gemm", pytest.approx(400e-6)]


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        trace.summarize([ev("x", "kernel", 0, 1)])
