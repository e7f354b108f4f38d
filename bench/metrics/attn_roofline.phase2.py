"""The flash attention pair's share of its bound in the traced steps: each
forward launch's QK^T and PV FLOPs over the causal pairs of one layer of
the step's batch (``flops.causal_attention_flops``), and each backward
launch's 2.5 times that (dQ, dK, dV and the recomputed scores and dP), at
the bf16 tensor-core peak, over the device time of the pair's kernels
(``flash_attn_fwd_kernel`` and the backward's delta, dK/dV and dQ
kernels).  A backward launch is counted by its dK/dV kernel.  Only the
pairs the mask keeps count, so the share is understated, never
overstated.  None where no such kernel ran (the plain attention)."""

from benchlib import flops

UNIT = "%"
SOURCE = "device_trace"
LAYER = "model, attention"
MOVES = "phase2_tokens_per_s"
FWD = ("flash_attn_fwd_kernel",)
BWD = ("flash_attn_bwd_dkdv_kernel",)
PAIR = FWD + BWD + ("flash_attn_bwd_delta_kernel", "flash_attn_bwd_dq_kernel")


def read(run):
    if run.kind != "phase2" or run.trace is None:
        return None
    _, n_f = run.trace.seconds(*FWD)
    _, n_b = run.trace.seconds(*BWD)
    t, _ = run.trace.seconds(*PAIR)
    if n_f + n_b == 0 or t <= 0:
        return None
    tr = run.traffic
    layer = tr["batch"] * flops.causal_attention_flops(
        dict(run.dims, attn_layers=1), tr["seq"])
    return 100 * (n_f + 2.5 * n_b) * layer / flops.PEAK_BF16 / t
