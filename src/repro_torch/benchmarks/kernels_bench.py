"""Kernel hot-spot benchmark of the port — the fused buffered-KD loss (the
JAX package's ``benchmarks/kernels_bench.py``).

Times the student gradient of the mean buffered-KD loss two ways at 256 rows
x 8,192 classes in f32: through the kernel pair ``ops.kd_loss``
(``kd_stats_fwd`` + ``kd_grad_bwd`` on a CUDA device; their plain versions
on the CPU) and through autograd of the plain loss
(``ref.kd_loss_mean_ref``); prints the loss and gradient parity and the
analytic HBM-traffic model that motivates the fusion:

    plain path  >= 6 full passes over the (rows, V) logits + softmax temps
    kernel      2 passes (forward stats + backward), no materialized softmax

then the parity of the ``rglru`` and ``ssd`` wrappers (the kernels on a
CUDA device) against their plain versions at the bench's shapes.  Rows are
``name,us_per_call,derived``; on the card the times are wall microseconds
a call between CUDA events (host dispatch included), on the CPU host
microseconds.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernels_bench [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops, ref


def bench(fn, *args, reps=3):
    """Microseconds a call (after one warm-up call)."""
    dev = args[0].device
    fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) / reps * 1e6


def _grad(loss_fn):
    def g(s, *rest):
        s = s.detach().requires_grad_()
        loss = loss_fn(s, *rest)
        return loss.detach(), torch.autograd.grad(loss, s)[0]
    return g


def main(rows=256, vocab=8192, device="cuda"):
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    f32 = dict(dtype=torch.float32, device=device, generator=gen)
    s = torch.randn((rows, vocab), **f32) * 2
    t = torch.randn((rows, vocab), **f32) * 2
    b = torch.randn((rows, vocab), **f32) * 2
    y = torch.randint(0, vocab, (rows,), device=device, generator=gen)
    tau = 2.0

    plain = _grad(lambda s_, y_, t_, b_: ref.kd_loss_mean_ref(y_, s_, t_, b_,
                                                               tau))
    fused = _grad(lambda s_, y_, t_, b_: ops.kd_loss(y_, s_, t_, b_, tau))
    us_ref = bench(plain, s, y, t, b)
    us_kernel = bench(fused, s, y, t, b)
    (loss_ref, g_ref), (loss_k, g_k) = plain(s, y, t, b), fused(s, y, t, b)
    parity = float((loss_k - loss_ref).abs())
    grad_err = float((g_k - g_ref).abs().max())
    grad_scale = float(g_ref.abs().max())

    # Derived HBM traffic (bytes) per backward step at fp32.
    tensor = rows * vocab * 4
    plain_traffic = 6 * 3 * tensor    # log_softmax temps + grads, 3 tensors
    kernel_traffic = 2 * 3 * tensor   # one fwd read + one bwd read/write
    print(f"kd_loss_jnp_grad,{us_ref:.0f},rows={rows};vocab={vocab};"
          f"traffic_model_bytes={plain_traffic}")
    print(f"kd_loss_kernel,{us_kernel:.0f},parity_maxerr={parity:.2e};"
          f"grad_maxerr={grad_err:.2e};grad_max={grad_scale:.2e};traffic_model_bytes={kernel_traffic};"
          f"traffic_ratio={plain_traffic / kernel_traffic:.1f}x")

    # RG-LRU + SSD kernel parity at bench scale.
    a = torch.sigmoid(torch.randn((8, 512, 256), **f32))
    bb = torch.randn((8, 512, 256), **f32)
    us_rg = bench(ref.rglru_ref, a, bb)
    err = float((ops.rglru(a, bb) - ref.rglru_ref(a, bb)).abs().max())
    print(f"rglru_ref_scan,{us_rg:.0f},shape=8x512x256")
    print(f"rglru_kernel,0,parity_maxerr={err:.2e}")

    x = torch.randn((2, 512, 8, 64), **f32)
    dt = torch.nn.functional.softplus(torch.randn((2, 512, 8), **f32))
    A = -torch.exp(torch.randn((8,), **f32) * 0.3)
    B = torch.randn((2, 512, 1, 64), **f32) * 0.5
    C = torch.randn((2, 512, 1, 64), **f32) * 0.5
    us_ssd = bench(lambda *a_: ref.ssd_ref(*a_, 128)[0], x, dt, A, B, C)
    yk, _ = ops.ssd(x, dt, A, B, C, 128)
    yr, _ = ref.ssd_ref(x, dt, A, B, C, 128)
    err_ssd = float((yk - yr).abs().max())
    print(f"ssd_ref_chunked,{us_ssd:.0f},shape=2x512x8x64")
    print(f"ssd_kernel,0,parity_maxerr={err_ssd:.2e}")
    return {"kd_parity": parity, "kd_grad_err": grad_err,
            "kd_grad_scale": grad_scale,
            "kd_us": us_kernel, "kd_plain_us": us_ref,
            "rglru_err": err, "ssd_err": err_ssd,
            "ssd_scale": float(yr.abs().max())}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
