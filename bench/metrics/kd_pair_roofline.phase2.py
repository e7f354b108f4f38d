"""The fused KD pair's share of its roofline in the traced steps: every
launch's least time (its logits read once, its outputs written once, or
its f32 operations at the CUDA-core peak) over the device time of the
``kd_stats_fwd`` and ``kd_grad_bwd`` kernels."""

from benchlib import flops

UNIT = "%"
SOURCE = "device_trace"
LAYER = "KD loss kernels"
MOVES = "phase2_tokens_per_s"
FWD = ("kd_stats_warp_kernel", "kd_stats_block_kernel")
BWD = ("kd_grad_kernel",)


def read(run):
    if run.kind != "phase2" or run.trace is None:
        return None
    t_f, n_f = run.trace.seconds(*FWD)
    t_b, n_b = run.trace.seconds(*BWD)
    if n_f + n_b == 0:
        return None
    tr, k = run.traffic, run.dims
    chunk = min(tr["loss_chunk"], tr["seq"])
    while tr["seq"] % chunk:
        chunk -= 1
    fwd, bwd = flops.kd_bounds(tr["batch"] * chunk, k["vocab_padded"], 4,
                               tr["buffer_mode"] == "clone")
    return 100 * (n_f * fwd + n_b * bwd) / (t_f + t_b)
