"""``swa_decode``'s share of its roofline in the traced ticks: each call's
least time (the K/V rows the active slots read up to their positions,
plus q and out, at 3.35 TB/s), one call a layer that runs attention a
tick, over the device time of its split and combine kernels."""

from benchlib import flops

UNIT = "%"
SOURCE = "device_trace"
LAYER = "decode attention kernel"
MOVES = "output_tokens_per_s"
KERNELS = ("swa_split_kernel", "swa_attn::combine_kernel")


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    t, n = run.trace.seconds(*KERNELS)
    if n == 0:
        return None
    k = run.dims
    slots = run.traffic["engine"]["slots"]
    bound = sum(k["attn_layers"] * flops.swa_decode_bound(
        sum(tick["rows"]), slots, k["n"], k["h"] // k["n"], k["hd"], 2)
        for tick in run.trace_ticks if tick["rows"])
    return 100 * bound / t
