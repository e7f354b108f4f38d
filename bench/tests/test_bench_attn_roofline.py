"""``attn_roofline.phase2`` on hand-made traces: None on a run of the other
kind, on a run without a trace and on a trace of the plain attention's
kernels (the parent's names), and the value its docstring defines on
chosen numbers."""

import bench_tiny  # noqa: F401
import pytest

from benchlib import spec
from benchlib.record import Run
from benchlib.trace import Trace

DIMS = {"layers": 40, "h": 32, "hd": 64}
TRAFFIC = {"batch": 4, "seq": 2048}
# the plain attention's kernels, as the parent's traced steps show them
PLAIN = {"void__anonymous_namespace_::softmax_warp_forward_float": [0.002],
         "void_at::native::elementwise_kernel_128__2__at::native": [0.001],
         "Memcpy_DtoD__Device_-__Device_": [0.001]}
# 160 forwards of 0.1 ms; 40 backwards of 0.01 + 0.2 + 0.15 ms
PAIR = {"flash_attn_fwd_kernel": [1e-4] * 160,
        "flash_attn_bwd_delta_kernel": [1e-5] * 40,
        "flash_attn_bwd_dkdv_kernel": [2e-4] * 40,
        "flash_attn_bwd_dq_kernel": [1.5e-4] * 40}


def run_of(kind, kernels):
    run = Run(kind=kind, dims=dict(DIMS), traffic=dict(TRAFFIC))
    if kernels is not None:
        run.trace = Trace(window_s=1.0, busy_s=0.5, kernels=kernels,
                          idle_gaps={})
    return run


def test_none_where_nothing_to_read():
    reader = spec.metric_reader("attn_roofline.phase2")
    assert reader.read(run_of("phase2", None)) is None
    assert reader.read(run_of("serve", dict(PAIR))) is None
    assert reader.read(run_of("phase2", dict(PLAIN))) is None


def test_value_on_chosen_numbers():
    reader = spec.metric_reader("attn_roofline.phase2")
    # one layer's causal QK^T and PV over 4 sequences of 2,048 tokens
    layer = 4 * 2 * 2 * 32 * 64 * 2048 * 2049 / 2
    work = (160 + 2.5 * 40) * layer / 989e12
    busy = 160 * 1e-4 + 40 * (1e-5 + 2e-4 + 1.5e-4)
    got = reader.read(run_of("phase2", dict(PAIR, **PLAIN)))
    assert got == pytest.approx(100 * work / busy)
    assert 0 < got < 100
