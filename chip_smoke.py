"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (device 0) and ``nvcc``; builds the port's kernels from
the sources in this checkout, then:

1. device   prints ``nvidia-smi``'s name and power limit and torch's view;
2. kernel   holds ``paged_decode`` against its plain PyTorch version at the
            serving shapes (bf16 and f32, with and without a window) and
            times it (device time, replayed from a CUDA graph) beside the
            plain version, one library call (``scaled_dot_product_attention``
            on the gathered dense view, a yardstick the port never calls)
            and its bytes bound;
3. serve    serves 8 requests on 4 slots with Granite-3-2B at full width in
            bf16 through the paged engine and checks that every decode
            attention went through the kernel (launches == layers x ticks);
4. parity   serves one stream with Granite SMOKE in f32 on the card and on
            the CPU from the same weights and checks the greedy tokens match;
5. kernels  prints one JSON line per the port's kernel table.

Any failed check raises, so the script exits non-zero and prints no result.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import paged_decode as pd_mod  # noqa: E402
from repro_torch.kernels.ref import paged_decode_ref  # noqa: E402
from repro_torch.launch.serve import summarize  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serve import ServeEngine, build_stream  # noqa: E402
from repro_torch.serve.paged import pages_for  # noqa: E402

# H100 SXM data-sheet peaks: HBM3 bandwidth and dense FP32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

SLOTS, MAX_LEN, PAGE = 4, 512, 16
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, arg_sets, reps=20):
    """Device ms per call, free of Python dispatch: one CUDA graph holds one
    call on each of ``arg_sets`` (several copies of the inputs, which
    together exceed the 50 MB L2, so each call finds its K/V in device
    memory) and is replayed ``reps`` times between CUDA events."""
    for args in arg_sets:                      # warm-up outside the capture
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(arg_sets))


def eager_ms(fn, arg_sets, iters=200):
    """Wall ms per call issued eagerly from Python, as the engine issues
    them (host dispatch included), between CUDA events."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    print(f"[device] torch sees {name!r} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    return name


def phase_build():
    t0 = time.perf_counter()
    lib = pd_mod.build(verbose=True)
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.2f}s")


def _serving_case(dtype, seed=0, copies=1):
    """Decode-attention inputs at the serving shapes: B = slots, N=8, G=4,
    D=64 (Granite-3-2B), ps=16, a 512-position table.  Slots 0-2 share two
    prefix pages; rows end in trash entries; pos is random."""
    rng = np.random.default_rng(seed)
    b, n, g, d, ps = SLOTS, 8, 4, 64, PAGE
    pp = pages_for(MAX_LEN, ps)
    num_pages = b * pp + 1
    pos = rng.integers(0, MAX_LEN, size=b).astype(np.int32)
    pos[0] = MAX_LEN - 1
    pt = np.zeros((b, pp), np.int32)
    free = list(rng.permutation(np.arange(3, num_pages)))
    for s in range(b):
        need = pos[s] // ps + 1
        row = [1, 2] if s < 3 else []
        row += [int(free.pop()) for _ in range(need - len(row))]
        pt[s, :len(row)] = row[:need]
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.standard_normal((b, n, g, d)).astype(np.float32))
    sets = []
    for _ in range(copies):
        kp = torch.from_numpy(rng.standard_normal(
            (num_pages, ps, n, d)).astype(np.float32))
        vp = torch.from_numpy(rng.standard_normal(
            (num_pages, ps, n, d)).astype(np.float32))
        sets.append(tuple(t.to(dev, dtype) for t in (q, kp, vp)) +
                    (torch.from_numpy(pt).to(dev), torch.from_numpy(pos).to(dev)))
    return sets


def _bound(q, pt, pos, itemsize):
    """Least time for one call: each attended K/V row of every (slot, head)
    read once (positions 0..pos), q and the used table entries read, out
    written; f32 math at the CUDA-core peak.  Counts this call's positions,
    not the table's capacity."""
    b, n, g, d = q.shape
    rows = pos.cpu().numpy().astype(np.int64) + 1
    kv_bytes = int(rows.sum()) * n * d * 2 * itemsize
    pages = int(-(-rows // PAGE).sum())
    io_bytes = 2 * b * n * g * d * itemsize + 4 * (pages + b)
    flops = int(rows.sum()) * n * g * 4 * d
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _sdpa_inputs(q, kp, vp, pt, pos):
    """The gathered dense view for the library yardstick, built outside the
    timed call: q (B, H, 1, D), K/V (B, H, W, D), a (B, 1, 1, W) mask."""
    b, n, g, d = q.shape
    pp, ps = pt.shape[1], kp.shape[1]
    kd = kp[pt.long()].reshape(b, pp * ps, n, d).permute(0, 2, 1, 3)
    vd = vp[pt.long()].reshape(b, pp * ps, n, d).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(g, dim=1).contiguous()
    vd = vd.repeat_interleave(g, dim=1).contiguous()
    j = torch.arange(pp * ps, device=q.device)[None, :]
    valid = j <= pos.long()[:, None]
    return q.reshape(b, n * g, 1, d), kd, vd, valid[:, None, None, :]


def phase_kernel():
    """Returns the kernel-table entry of paged_decode (launches filled in by
    the serve phase)."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for window in (None, 100):
            q, kp, vp, pt, pos = _serving_case(dtype, seed=1)[0]
            got = pd_mod.paged_decode(q, kp, vp, pt, pos, window=window)
            torch.cuda.synchronize()
            want = paged_decode_ref(q, kp, vp, pt, pos, window=window)
            err = (got.float() - want.float()).abs().max().item()
            check(got.dtype == dtype and got.shape == q.shape,
                  f"paged_decode output {got.dtype} {tuple(got.shape)}")
            check(math.isfinite(err) and err <= TOL[dtype],
                  f"paged_decode {dtype} window={window}: max abs err {err} "
                  f"> {TOL[dtype]}")
            errs[(dtype, window)] = err
    print("[kernel] paged_decode vs paged_decode_ref, max abs err: " + ", ".join(
        f"{str(dt).split('.')[-1]} window={w}: {e:.3g}"
        for (dt, w), e in errs.items()) + " (limits f32 1e-5, bf16 1e-2)")

    # Timing at the main path's type (bf16) and shapes, no window.  16 copies
    # of the 4.2 MB pools (67 MB) exceed the L2, as 40 layers' pools do.
    sets = _serving_case(torch.bfloat16, seed=2, copies=16)
    ms = time_ms(lambda *a: pd_mod.paged_decode(*a), sets)
    wrapper_ms = eager_ms(lambda *a: pd_mod.paged_decode(*a), sets)
    plain_ms = time_ms(lambda *a: paged_decode_ref(*a), sets)
    sdpa_sets = [_sdpa_inputs(*s) for s in sets[:4]]
    qs, kd, vd, mask = sdpa_sets[0]
    lib = F.scaled_dot_product_attention(qs, kd, vd, attn_mask=mask)
    want = paged_decode_ref(*sets[0]).reshape(lib.shape)
    lib_err = (lib.float() - want.float()).abs().max().item()
    library_ms = time_ms(lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mm), sdpa_sets)
    q, _, _, pt, pos = sets[0]
    bound_ms, bound_by = _bound(q, pt, pos, 2)
    print(f"[kernel] paged_decode bf16 B={SLOTS} N=8 G=4 D=64 ps={PAGE} "
          f"PP={pt.shape[1]} pos={pos.tolist()}: kernel {ms:.5f} ms (eager "
          f"through the wrapper {wrapper_ms:.5f} ms), plain "
          f"{plain_ms:.5f} ms, sdpa on the gathered view {library_ms:.5f} ms "
          f"(err {lib_err:.3g}), bound {bound_ms:.5f} ms ({bound_by}), "
          f"{bound_ms / ms:.1%} of the bound")
    return {"name": "paged_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/swa_decode.py:116",
            "launches": None, "max_abs_err": errs[(torch.bfloat16, None)],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def _serve(cfg, params, reqs, device, **kw):
    engine = ServeEngine(cfg, params, paged=True, device=device, **kw)
    return engine, engine.run(reqs)


def phase_serve():
    """Granite-3-2B at full width in bf16: returns the kernel's launches in
    the measured run."""
    cfg = registry.get_config("granite-3-2b")
    t0 = time.perf_counter()
    params = Transformer.init(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name}: {n_params / 1e9:.3f} B parameters in "
          f"{cfg.param_dtype} initialised on the card in "
          f"{time.perf_counter() - t0:.2f}s")
    stream = lambda n: build_stream(  # noqa: E731
        "poisson", n, vocab=cfg.vocab_size, seed=0, prompt_max=192,
        out_max=32, shared_prefix=32)
    kw = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PAGE)
    engine = ServeEngine(cfg, params, paged=True, device="cuda", **kw)
    engine.run(stream(2))                     # warm-up: cuBLAS, allocator
    engine.reset()
    reqs = stream(8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pd_mod.paged_decode.launches = 0
    t0 = time.perf_counter()
    finished = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pd_mod.paged_decode.launches
    stats = summarize(finished, wall)
    ps = engine.prefix_stats()
    print(f"[serve] {stats['requests']}/8 requests, {stats['tokens']} tokens "
          f"in {stats['seconds']}s = {stats['tok_per_sec']} tok/s; TTFT "
          f"p50/p99 {stats['ttft_p50_ms']}/{stats['ttft_p99_ms']} ms; ITL "
          f"p50/p99 {stats['itl_p50_ms']}/{stats['itl_p99_ms']} ms; prefix "
          f"hits/misses {ps['hits']}/{ps['misses']}, peak pages "
          f"{ps['peak_pages']}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; paged_decode launches "
          f"{launches} over {engine.decode_ticks} decode ticks x "
          f"{cfg.num_layers} layers")
    check(len(finished) == 8, f"{len(finished)} of 8 requests served")
    for r in finished:
        want = min(r.max_new, MAX_LEN - len(r.prompt))
        check(len(r.out) == want, f"r{r.rid}: {len(r.out)} tokens, want {want}")
        check(all(0 <= t < cfg.vocab_size for t in r.out),
              f"r{r.rid}: token id outside the vocabulary")
    check(ps["hits"] > 0, "no prefix-hit admission ran")
    check(launches == cfg.num_layers * engine.decode_ticks > 0,
          f"paged_decode launched {launches} times, want "
          f"{cfg.num_layers} x {engine.decode_ticks}")
    return launches


def phase_parity():
    """Granite SMOKE in f32 on the card and on the CPU from the same
    weights: the greedy tokens must be equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = registry.get_smoke_config("granite-3-2b")
    weights = params_to_numpy(Transformer.init(cfg, 1, device="cpu"))
    stream = lambda: build_stream(  # noqa: E731
        "bursty", 10, vocab=cfg.vocab_size, seed=3, prompt_max=40,
        out_max=16, shared_prefix=16)
    kw = dict(slots=3, max_len=96, page_size=8)
    outs, stats = {}, {}
    for device in ("cpu", "cuda"):
        engine, finished = _serve(cfg, params_from_numpy(weights, device),
                                  stream(), device, **kw)
        outs[device] = {r.rid: r.out for r in finished}
        stats[device] = engine.prefix_stats()
    n_tok = sum(len(o) for o in outs["cpu"].values())
    same = sum(outs["cpu"][r] == outs["cuda"][r] for r in outs["cpu"])
    print(f"[parity] {cfg.name} f32: {same}/{len(outs['cpu'])} requests "
          f"({n_tok} tokens) identical card vs CPU; prefix stats "
          f"{stats['cuda']}")
    check(outs["cpu"] == outs["cuda"], "greedy tokens differ card vs CPU")
    check(stats["cpu"] == stats["cuda"], "prefix stats differ card vs CPU")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    name = phase_device()
    phase_build()
    entry = phase_kernel()
    entry["launches"] = phase_serve()
    phase_parity()
    print(json.dumps({"kernels": [entry]}))
    print(f"[done] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
