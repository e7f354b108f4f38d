"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (device 0) and ``nvcc``; builds the port's kernels from
the sources in this checkout (one ``nvcc`` per source, all started
together; each prints its kernels' registers and spills), then:

1. device     prints ``nvidia-smi``'s name and power limit and torch's view;
2. kernel     holds ``paged_decode`` against its plain PyTorch version at the
              serving shapes (bf16 and f32, with and without a window), at
              RecurrentGemma's G=16, D=256 heads and on the long-context
              table (``registry.for_shape("granite-3-2b", "long_500k")``
              served --paged: B=1, 32,768 pages of 16, window 8,192, pos
              524,287; a 1.1 GB pool, past the old kernel's 48 KiB table
              cap), prints each plan (splits, rows, blocks, shared bytes)
              and times each (device time, replayed from a CUDA graph)
              beside the plain version, one library call
              (``scaled_dot_product_attention`` on the gathered dense view,
              the window's pages for the long table, a yardstick the port
              never calls) and its bytes bound;
3. serve      serves 8 requests on 4 slots with Granite-3-2B at full width in
              bf16 through the paged engine and checks that every decode
              attention went through the kernel (launches == layers x ticks);
4. parity     serves one stream with Granite SMOKE in f32 on the card and on
              the CPU from the same weights and checks the greedy tokens match;
5. kd kernels holds ``kd_stats_fwd``/``kd_grad_bwd`` and ``ops.kd_loss``'s
              loss and gradient against their plain versions at the FL main
              path's shape (128 rows, 100 classes) and at an LLM shape (512
              rows, Granite's 49,155-token vocabulary ending in -1e30 pad
              columns, f32 and bf16), printing each forward plan; times the
              forward's two paths across ``WARP_MAX_V`` (V 512-8,192 at 128
              and 512 rows); times the backward as planned, at one logit
              a thread and at 16-byte vectors from the main path's shape
              to the LLM shape, each held against the plain version;
              holds the backward, 16-byte vectors asked for, against it
              with s, t and b at storage offsets 1-15 (one offset for all,
              and one each) and at V = 1 and 7;
              prints a graph's launch floor and times the pair beside the
              plain versions and their bounds;
6. fl         runs Algorithm 1 (``FederatedKD.run``) with ResNet-32 at full
              width on CIFAR-shaped data (1 core + 3 edge silos of ~2,500
              images), for kd, bkd and one bkd round with R=2 teachers, and
              checks that every Phase-2 step went through both kernels;
              prints the backward operands' base skews (bytes mod 16) on
              the first Phase-2 step;
7. fl parity  runs the quickstart's MLP federation (f32, TF32 off) on the
              card and on the CPU from one initial state: the first Phase-2
              loss and the per-round test accuracy must agree;
8. figures    runs the port's claim-check tally (``benchmarks/run.py
              --fast``: Figs. 4, 5, 7 and 9 at 3 rounds) on the card and
              prints each claim check and the tally; every run must end
              with finite metrics, every kd/bkd run must go through the kd
              kernel pair, and bkd_cached must equal bkd;
9. kdq        holds the dequant-fused ``kd_quant_stats_fwd``/
              ``kd_quant_grad_bwd`` and ``ops.kd_loss_quant``'s loss and
              gradient against their plain versions (teacher payloads from
              the port's int8 and int4 codecs) at the FL main path's shape
              and at the LLM shape, printing each forward plan, with phase
              5's path sweep (f32), backward widths and offset checks, and
              times them beside the plain versions and their bounds;
10. fl transport   runs phase 6's ResNet-32 federation with uplink transport
              (bkd@int8, kd@int4, one bkd@int8 round with R=2 teachers) and
              checks the uplink bytes against the codec's accounting and
              that every R=1 Phase-2 step went through the quant pair (R=2
              decodes and goes through the exact pair), printing the
              backward operands' skews on the first Phase-2 step;
11. fl transport parity   the quickstart's MLP federation with int8 on the
              card and on the CPU: first Phase-2 loss, per-round test
              accuracy and the round-0 payload codes;
12. transport bench   the port's transport benchmark (``--smoke``) on the
              card: identity transport must equal no transport bit for bit;
13. swa kernel   holds ``swa_decode`` against its plain version (f32 and
              bf16) on the dense engine's cache (4 slots x 512 positions,
              pos 0..511), with a window of 128, on ``--ring``'s 32-slot
              ring at wrapped positions and on the long-context case
              (``registry.for_shape("granite-3-2b", "long_500k")``: window
              8,192, with a ring cache, B=1, pos 524,287), prints each
              plan and times each beside the plain
              version, one library call (``scaled_dot_product_attention``
              on the dense cache with a boolean mask, a yardstick the port
              never calls) and its bytes bound;
14. serve dense   serves phase 3's stream with Granite-3-2B at full width
              in bf16 through the dense engine (the default), then with
              ``--ring``'s config (window 32, ring cache), and checks that
              every decode attention went through ``swa_decode`` (launches
              == layers x ticks) and none through ``paged_decode``;
15. dense parity  Granite SMOKE in f32 (TF32 off) on the dense engine on
              the card and on the CPU from the same weights, full and ring;
              the card's dense engine against its paged one; one hot-swap
              to a second weight set at a fixed tick, card vs CPU: greedy
              tokens must be equal;
16. ssd kernel    holds ``ssd`` against its plain version (f32, TF32 off; both also
              against the plain version in f64) at Mamba-2 370m's serving
              shape (4 slots x 32 heads, p=64, n=128, one B/C group) at s =
              32, 224 (chunk 112), 151 (chunk 1, the row kernel) and 2048
              (16 chunks of 128) and at SMOKE's p = n = 32, chunk 32, s =
              96, prints each plan and times each beside the plain version
              and two bounds: f32 operations on CUDA cores, and the
              precision the kernel uses (3xTF32 on tensor cores for the
              chunk kernel, f32 for the row kernel);
17. rglru kernel  holds ``rglru`` against its plain version at (4, 224,
              4096), (4, 32, 4096), (4, 2048, 4096), (1, 224, 4096) (one
              slot), (2, 128, 130) and (1, 384, 128) and times each beside
              the plain version and its bytes bound;
18. swa recurrentgemma   holds ``swa_decode`` against its plain version at
              RecurrentGemma-9B's local attention (B=4, W=512, N=1, G=16,
              D=256, window 2048; f32 and bf16) and times it;
19. serve recurrent   serves phase 3's stream on the dense engine in bf16
              with Mamba-2 370m at full width and depth (after a warm-up
              run), then RecurrentGemma-9B, and checks ssd launches == 48 x
              prefills, rglru launches == 26 x prefills, swa_decode launches
              == 12 x decode ticks and no paged_decode launch;
20. recurrent parity  both recurrent SMOKE configs in f32 (TF32 off) on the
              card and on the CPU from the same weights, on a schedule of
              same-tick arrivals of equal and of different prompt lengths
              that cross ``ssm_chunk`` (prime lengths included) and on a
              bursty stream: greedy tokens must be equal;
21. phase2 bench   the port's ``phase2_bench``: ``--all-methods`` must
              exit 0 (every method's accuracy finite), then every
              throughput variant at the bench's full sizes (steps/s, the
              scan/loop ratio beside the reference's exit rule, only
              ``scan_pallas`` launching the kd kernels) and the bkd_cached
              contract (within 0.005 of the exact cache);
22. decode archs  ``swa_decode`` and ``paged_decode`` against their plain
              versions (f32, bf16) on a 4 x 512 cache at the (N, G, D) of
              qwen3-14b (8, 5, 128), qwen1.5-4b (20, 1, 128),
              nemotron-4-340b (8, 12, 192) and qwen2-vl-72b (8, 8, 128),
              each timed beside its bound, its plain version and SDPA;
23. serve archs   those four archs at full width in bf16 on phase 3's
              stream, dense and then paged, with the depth cut to what one
              card holds (printed, with why), checking launches == layers
              x ticks and freeing the card between archs;
24. archs parity  each arch's SMOKE config in f32 (TF32 off, biases and
              norm scales redrawn) served dense and paged on the card and
              on the CPU from the same weights: greedy tokens equal; and
              qwen2-vl's prefill with vision embeddings on three position
              streams, logits card vs CPU within 1e-4;
25. serve moe   phi3.5-moe-42b-a6.6b and kimi-k2-1t-a32b at full width in
              bf16 on phase 3's stream, dense and then paged, with the depth
              cut to what one card holds (printed: phi 27 of 32 layers,
              kimi 1 of 61), the parameter bytes counted from the shapes
              (experts, shared experts, f32 router) equal to the drawn
              tensors', checking launches == layers x ticks for the decode
              kernel in use and none for the other;
26. moe parity    both MoE SMOKE configs in f32 (TF32 off) served dense and
              paged on the card and on the CPU from the same weights:
              greedy tokens equal (dense and paged are not compared: the
              experts' capacity couples a batch's rows);
27. llm phase2    ``repro_torch.launch.train --full --arch granite-3-2b
              --method bkd`` on the card (bf16, AdamW, 2 rounds of 3 steps a
              phase, batch 8 x 64 tokens): Phase 0/1/2 seconds, Phase-2
              steps/s and peak memory, the kd pair launched once a Phase-2
              step each; the pair held against its plain version on the
              first Phase-2 step's own inputs (512 x 49,408 f32, 253 pad
              columns at -1e30, with buffer; f32 limit 1e-5); then the
              Phase-2 step with the kd pair ('pallas') against the plain
              loss ('jnp') in turns on one set of weights;
28. llm parity    the LLM driver on granite's and phi3.5-moe's SMOKE configs
              (f32, TF32 off) on the card and on the CPU from one start
              state: every printed loss and the final NLL within 2e-4; then
              granite with ``--sim async:heavy_tail`` and ``--sim
              fleet:uniform`` (3 rounds over 3 edges): the same edges,
              staleness and event times, the losses within 1e-4;
29. fl async  phase 6's ResNet-32 (full width, f32, cuDNN TF32) over 1 core
              + 6 Dirichlet(1) edges of ~2,500: bkd under
              ``async_heavy_tail`` (deadline 2.0) and ``hier_uniform`` (2
              regions of 3 edges), kd under ``async_heavy_tail``, 3 core
              rounds at R = 2 each; prints each timeline (dispatches,
              staleness, makespan, region rounds), each round's test
              accuracy and Phase 0/1/2 s; the kd pair must launch once a
              Phase-2 step of every distill round of the plan stream
              (region rounds included), some teacher must be stale under
              ``async_heavy_tail``, ``history`` one entry a core round;
30. fl async parity  the quickstart's MLP (bkd, R = 2, f32, TF32 off)
              under ``async_uniform`` and ``hier_uniform``, card vs CPU
              from one initial state: first Phase-2 loss within 1e-5
              relative, test accuracy within 0.02, rounds equal;
31. async bench   the port's ``async_bench --smoke`` on the card (5
              scenarios x bkd, kd, fedavg, the 100k-edge timeline) with
              its exit rule;
32. transport frontiers   the transport bench's ``async_uniform`` and
              ``hier_uniform`` frontiers (``--smoke`` sizes) on the card
              and ``bench_sim_accounting``'s gates; the quant pair must
              launch;
33. hubert    hubert-xlarge at full width and depth (48 layers, d_model
              1280, bf16, AdamW): 3 masked pretrain steps on 8 x 500
              frames (every 4th masked), step s and peak memory; SMOKE's
              logits and masked loss card vs CPU;
34. recurrent train   ``launch.train --full --arch mamba2-370m --method
              bkd --rounds 1 --steps-per-phase 3`` on the card: no ``ssd``
              launch in training (printed beside phase 19's), the kd pair
              once a Phase-2 step; a SMOKE pretrain step of recurrentgemma-9b
              and mamba2-370m card vs CPU, loss within 1e-5 and gradients
              within 1e-4 (recurrentgemma's full width does not fit one card
              with AdamW: printed);
35. live      slice 6's main path at full width: Granite-3-2B (bf16)
              through ``LiveSystem`` with the live bench's settings (2
              edges, the async simulator's uniform stream, bkd, 2 rounds,
              quantum 2, a diurnal stream of 24 requests on 2 dense slots):
              the memory reckoning printed before the run (full depth under
              70 GB, else depth cut), serve-only against co-scheduled tok/s,
              the swap ticks and NLLs, peak memory, the phase seconds; the
              kd pair once a Phase-2 step of the plan stream, ``swa_decode``
              layers x decode ticks;
36. carry     engine carry/restore at full width (Granite-3-2B, bf16, phase
              3's stream and settings), dense and paged: saved mid-stream,
              restored into a fresh engine and resumed, tokens, clock and
              the allocator's books equal the uninterrupted run's;
37. live ckpt the fused live checkpoint, SMOKE (the JAX package's test
              setting) on the card: saved mid-round and mid-epoch, restored
              and resumed bit-identical to the uninterrupted run; that run
              card vs CPU (TF32 off): tokens equal, state within 1e-4;
38. legacy    ``serve_bench --smoke`` on the card (its paged gates must
              hold; its exit code and speedup printed), then Granite-3-2B at
              full width: the engine against the legacy loop on phase 3's
              stream, tok/s and ``swa_decode`` launches for both;
39. mesh      slice 9's meshed paths on a one-rank NCCL
              ``make_test_mesh(device="cuda")``: phase 3's stream with
              Granite-3-2B at full width in bf16 through ``simulate(mesh=
              mesh)``, dense and then paged, token-equal to the ``mesh=None``
              run, ``swa_decode``/``paged_decode`` launched layers x decode
              ticks through ``local_map``, tok/s, TTFT and ITL p50 of both
              runs; then phase 6's ResNet-32 federation, one bkd round with
              Phase 1 under the mesh (cuDNN deterministic), its history
              equal to the unmeshed run's and the kd pair once a Phase-2
              step;
40. kernels bench the port's ``kernels_bench`` on the card (the kd pair
              against the plain loss's autograd at 256 x 8,192, the
              gradient within 1e-5 of its largest entry; ``rglru`` and
              ``ssd`` against their plain versions);
41. dryrun    the mesh dry-run (``python -m repro_torch.launch.dryrun``,
              CPU and meta tensors only, started as subprocesses when the
              script starts): granite-3-2b train_4k and decode_32k at 16 x
              16 and kimi-k2-1t-a32b decode_32k at 2 x 16 x 16; prints each
              roofline row (compute, memory and collective ms at the H100's
              rates, bottleneck, peak GB a device against the card's 80 GB)
              and its seconds; checks the per-device parameter bytes
              (30,748,672 and 8,270,983,168) and ``param_count``;
42. kernels   prints one JSON line per the port's kernel table (eight
              kernels; the kd pair's launches include phases 29, 35 and
              39's, the quant pair's phase 32's, ``swa_decode``'s phases
              35, 38's legacy loop and 39's, ``paged_decode``'s 39's).

Each phase's seconds are printed (``[time]``).

Any failed check raises, so the script exits non-zero and prints no result.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.benchmarks import (async_bench, fig4_main,  # noqa: E402
                                    fig5_forget, fig7_aggregation,
                                    fig9_straggler, kernels_bench,
                                    phase2_bench, serve_bench,
                                    transport_bench)
from repro_torch.benchmarks import run as fig_run  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.resnet32_cifar import RESNET32  # noqa: E402
from repro_torch.checkpoint import save_tree  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.core.distill_engine import DistillEngine  # noqa: E402
from repro_torch.core.fl import FederatedKD, FLConfig, resnet_adapter  # noqa: E402
from repro_torch.core.scheduler import HIER_SCENARIOS, build_scenario  # noqa: E402
from repro_torch.core.simulator import EventDrivenSimulator  # noqa: E402
from repro_torch.data import (Dataset, dirichlet_partition,  # noqa: E402
                              make_cifar_like, make_token_stream)
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import kd_loss as kd_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_decode as pd_mod  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import rglru as rglru_mod  # noqa: E402
from repro_torch.kernels import ssd as ssd_mod  # noqa: E402
from repro_torch.kernels import swa_decode as swa_mod  # noqa: E402
from repro_torch.kernels.ref import paged_decode_ref  # noqa: E402
from repro_torch.launch import steps as St  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.serve import summarize  # noqa: E402
from repro_torch.live import (LiveSystem, LiveTrainer, lm_adapter,  # noqa: E402
                              lm_fl_data, nll_on)
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.nn import attention  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.serve import Request, ServeEngine, build_stream  # noqa: E402
from repro_torch.serve import legacy  # noqa: E402
from repro_torch.serve.paged import pages_for  # noqa: E402
from repro_torch.transport import parse_codec  # noqa: E402
from repro_torch.transport.method import PAYLOAD_KEY  # noqa: E402

# H100 SXM data-sheet peaks: HBM3 bandwidth, dense FP32 and TF32 rates.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12

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


KERNEL_SOURCES = ("paged_decode", "kd_loss", "swa_decode", "ssd", "rglru")


def phase_build():
    """One nvcc per source, all started together; each prints its
    registers and spills (``-Xptxas -v``)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        libs = list(pool.map(lambda n: kbuild.build(n, verbose=True),
                             KERNEL_SOURCES))
    print(f"[build] {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.2f}s")


def _serving_case(dtype, seed=0, copies=1, heads=(8, 4, 64)):
    """Decode-attention inputs at the serving shapes: B = slots, ``heads`` =
    (N, G, D) (Granite-3-2B's by default), ps=16, a 512-position table.
    Slots 0-2 share two prefix pages; rows end in trash entries; pos is
    random."""
    rng = np.random.default_rng(seed)
    b, ps = SLOTS, PAGE
    n, g, d = heads
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


def _bound(q, pt, pos, itemsize, ps=PAGE, window=None):
    """Least time for one call: each attended K/V row of every (slot, head)
    read once (positions 0..pos, or the window's), q and the used table
    entries read, out written; f32 math at the CUDA-core peak.  Counts this
    call's positions, not the table's capacity."""
    b, n, g, d = q.shape
    p = pos.cpu().numpy().astype(np.int64)
    rows = p + 1 if window is None else np.minimum(p + 1, window)
    kv_bytes = int(rows.sum()) * n * d * 2 * itemsize
    first = 0 if window is None else np.maximum(p - window + 1, 0) // ps
    pages = int((p // ps - first + 1).sum())
    io_bytes = 2 * b * n * g * d * itemsize + 4 * (pages + b)
    flops = int(rows.sum()) * n * g * 4 * d
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _sdpa_inputs(q, kp, vp, pt, pos, window=None):
    """The gathered dense view for the library yardstick, built outside the
    timed call: q (B, H, 1, D), K/V (B, H, W, D), a (B, 1, 1, W) mask.  With
    a window, only the table's last pages that hold the window (from the
    first row's page of the lowest window start to the highest pos)."""
    b, n, g, d = q.shape
    ps = kp.shape[1]
    t0, t1 = 0, pt.shape[1]
    if window is not None:
        t0 = max(int(pos.min()) - window + 1, 0) // ps
        t1 = int(pos.max()) // ps + 1
    pts = pt[:, t0:t1].long()
    w = (t1 - t0) * ps
    kd = kp[pts].reshape(b, w, n, d).permute(0, 2, 1, 3)
    vd = vp[pts].reshape(b, w, n, d).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(g, dim=1).contiguous()
    vd = vd.repeat_interleave(g, dim=1).contiguous()
    j = t0 * ps + torch.arange(w, device=q.device)[None, :]
    p = pos.long()[:, None]
    valid = j <= p
    if window is not None:
        valid &= j > p - window
    return q.reshape(b, n * g, 1, d), kd, vd, valid[:, None, None, :]


def _plan_line(p):
    return (f"plan S={p.splits} R={p.rows} chunk={p.chunk} blocks={p.blocks} "
            f"smem={p.smem} B")


def _time_paged(label, sets, window=None, sdpa_copies=4):
    """Kernel, wrapper, plain and SDPA times and the bound of paged_decode
    on ``sets`` (bf16); returns (ms, plain_ms, library_ms, bound_ms,
    bound_by)."""
    fn = lambda *a: pd_mod.paged_decode(*a, window=window)  # noqa: E731
    ms = time_ms(fn, sets)
    wrapper_ms = eager_ms(fn, sets)
    plain_ms = time_ms(lambda *a: paged_decode_ref(*a, window=window), sets)
    sdpa_sets = [_sdpa_inputs(*s, window=window) for s in sets[:sdpa_copies]]
    qs, kd, vd, mask = sdpa_sets[0]
    lib = F.scaled_dot_product_attention(qs, kd, vd, attn_mask=mask)
    want = paged_decode_ref(*sets[0], window=window).reshape(lib.shape)
    lib_err = (lib.float() - want.float()).abs().max().item()
    library_ms = time_ms(lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mm), sdpa_sets)
    q, kp, _, pt, pos = sets[0]
    bound_ms, bound_by = _bound(q, pt, pos, 2, kp.shape[1], window)
    b, n, g, d = q.shape
    plan = pd_mod.plan(b, n, d, kp.shape[1], pt.shape[1], window, q.dtype)
    print(f"[kernel] paged_decode {label}: bf16 B={b} N={n} G={g} D={d} "
          f"ps={kp.shape[1]} PP={pt.shape[1]} window={window} "
          f"pos={pos.tolist()}; {_plan_line(plan)}: kernel {ms:.5f} ms "
          f"(eager through the wrapper {wrapper_ms:.5f} ms), plain "
          f"{plain_ms:.5f} ms, sdpa on the gathered view {library_ms:.5f} ms "
          f"(err {lib_err:.3g}), bound {bound_ms:.5f} ms ({bound_by}), "
          f"{bound_ms / ms:.1%} of the bound")
    return ms, plain_ms, library_ms, bound_ms, bound_by


def _check_paged(label, sets, window, dtype):
    q, kp, vp, pt, pos = sets[0]
    got = pd_mod.paged_decode(q, kp, vp, pt, pos, window=window)
    torch.cuda.synchronize()
    want = paged_decode_ref(q, kp, vp, pt, pos, window=window)
    check(got.dtype == dtype and got.shape == q.shape,
          f"paged_decode output {got.dtype} {tuple(got.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    check(math.isfinite(rel) and max(err, rel) <= TOL[dtype],
          f"paged_decode {label} {dtype} window={window}: max abs err {err},"
          f" relative {rel}, limit {TOL[dtype]} for both")
    return err, rel


# The long-context paged case: Granite-3-2B at ``long_500k`` as
# ``registry.for_shape`` gives it (window 8192), served --paged: one slot
# whose 32,768-page table covers 524,288 positions, decoding the last.
LONG_PAGED_PP = SHAPES["long_500k"].seq_len // PAGE


def _long_paged_case(copies=4, seed=3):
    """B=1, Granite's heads, a 32,769-page pool (about 1.1 GB of K and V in
    bf16) shared by ``copies`` random page tables of 32,768 pages (each
    copy attends other pages, so the timed sets exceed the L2)."""
    n, g, d = GRANITE_HEADS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    num_pages = LONG_PAGED_PP + 1
    pool = [torch.randn((num_pages, PAGE, n, d), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2)]
    q = torch.randn((1, n, g, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    pos = torch.tensor([LONG_PAGED_PP * PAGE - 1], dtype=torch.int32,
                       device="cuda")
    return [(q, *pool, (torch.randperm(LONG_PAGED_PP, generator=gen,
                                       device="cuda") + 1)
             .to(torch.int32)[None], pos) for _ in range(copies)]


def phase_kernel():
    """Returns the kernel-table entry of paged_decode at the serving shape
    (launches filled in by the serve phase)."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for window in (None, 100):
            sets = _serving_case(dtype, seed=1)
            errs[(dtype, window)] = _check_paged("serving", sets, window,
                                                 dtype)[0]
    print("[kernel] paged_decode vs paged_decode_ref, max abs err: " + ", ".join(
        f"{str(dt).split('.')[-1]} window={w}: {e:.3g}"
        for (dt, w), e in errs.items()) + " (limits f32 1e-5, bf16 1e-2, "
        "absolute and relative)")

    # Timing at the main path's type (bf16) and shapes, no window.  16 copies
    # of the 4.2 MB pools (67 MB) exceed the L2, as 40 layers' pools do.
    sets = _serving_case(torch.bfloat16, seed=2, copies=16)
    ms, plain_ms, library_ms, bound_ms, bound_by = _time_paged(
        "serving", sets)
    entry = {"name": "paged_decode", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
             "replaces": "src/repro/kernels/swa_decode.py:116",
             "launches": None, "max_abs_err": errs[(torch.bfloat16, None)],
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": library_ms}
    del sets

    # RecurrentGemma's G=16, D=256 heads on the paged pool.
    rg = (1, 16, 256)
    for dtype in (torch.float32, torch.bfloat16):
        err, rel = _check_paged("G=16 D=256", _serving_case(
            dtype, seed=4, heads=rg), 128, dtype)
        print(f"[kernel] paged_decode G=16 D=256 {dtype}: relative err "
              f"{rel:.3g}")
    _time_paged("G=16 D=256", _serving_case(torch.bfloat16, seed=5, copies=32,
                                            heads=rg))

    # The long table: past the old kernel's 48 KiB cap (9,888 pages here).
    sets = _long_paged_case()
    window = LONG_ATTN.window
    err, rel = _check_paged("long table", sets, window, torch.bfloat16)
    print(f"[kernel] paged_decode long table PP={LONG_PAGED_PP}: relative "
          f"err {rel:.3g} (bf16)")
    _time_paged(f"long table window {window}", sets, window)
    del sets
    torch.cuda.empty_cache()
    return entry


def _serve(cfg, params, reqs, device, **kw):
    engine = ServeEngine(cfg, params, paged=True, device=device, **kw)
    return engine, engine.run(reqs)


def _serve_paged(cfg, params, label):
    """Phase 3's stream (8 requests with a 32-token shared prompt, 4 slots,
    ``max_len`` 512, page 16) on the paged engine after a two-request
    warm-up; returns paged_decode's launches in the measured run (the
    count set to 0 just before it)."""
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
    swa_before = swa_mod.swa_decode.launches
    pd_mod.paged_decode.launches = 0
    t0 = time.perf_counter()
    finished = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pd_mod.paged_decode.launches
    stats = summarize(finished, wall)
    ps = engine.prefix_stats()
    print(f"[serve] {label}: {stats['requests']}/8 requests, {stats['tokens']} "
          f"tokens in {stats['seconds']}s = {stats['tok_per_sec']} tok/s; TTFT "
          f"p50/p99 {stats['ttft_p50_ms']}/{stats['ttft_p99_ms']} ms; ITL "
          f"p50/p99 {stats['itl_p50_ms']}/{stats['itl_p99_ms']} ms; prefix "
          f"hits/misses {ps['hits']}/{ps['misses']}, peak pages "
          f"{ps['peak_pages']}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; paged_decode launches "
          f"{launches} over {engine.decode_ticks} decode ticks x "
          f"{cfg.num_layers} layers")
    check(len(finished) == 8, f"{label}: {len(finished)} of 8 requests served")
    for r in finished:
        want = min(r.max_new, MAX_LEN - len(r.prompt))
        check(len(r.out) == want,
              f"{label} r{r.rid}: {len(r.out)} tokens, want {want}")
        check(all(0 <= t < cfg.vocab_size for t in r.out),
              f"{label} r{r.rid}: token id outside the vocabulary")
    check(ps["hits"] > 0, f"{label}: no prefix-hit admission ran")
    check(launches == cfg.num_layers * engine.decode_ticks > 0,
          f"{label}: paged_decode launched {launches} times, want "
          f"{cfg.num_layers} x {engine.decode_ticks}")
    check(swa_mod.swa_decode.launches == swa_before,
          f"{label}: the paged engine launched swa_decode")
    return launches


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
    return _serve_paged(cfg, params, cfg.name)


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


# -- the fused KD loss kernels ---------------------------------------------

KD_MAIN = dict(rows=128, v=100)           # FL main path: batch x classes
KD_LLM = dict(rows=512, v=49155, pad=125)  # Granite's vocabulary, padded
TAU = 2.0


def _kd_inputs(rows, v, dtype, buffer, pad=0, seed=0, copies=1):
    """Sets of (labels, s, t, b, g) on the card from a seed: logits of unit
    scale x 3, the last ``pad`` columns at -1e30, labels avoiding them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sets = []
    for _ in range(copies):
        logits = []
        for _ in range(3 if buffer else 2):
            a = 3 * torch.randn((rows, v), generator=gen, device="cuda")
            if pad:
                a[:, v - pad:] = -1e30
            logits.append(a.to(dtype))
        y = torch.randint(0, v - pad, (rows,), generator=gen, device="cuda")
        g = torch.rand(rows, generator=gen, device="cuda") + 0.5
        s, t = logits[:2]
        sets.append((y, s, t, logits[2] if buffer else None, g))
    return sets


def _kd_bounds(rows, v, itemsize, buffer):
    """(fwd, bwd) least times in ms: every logit read once, stats / ds
    written once; f32 operations per logit at the CUDA-core peak (forward:
    four online-logsumexp streams, 16 operations with a buffer and 11
    without; backward: 14 and 11)."""
    n_in = 3 if buffer else 2
    out = []
    for bytes_, ops_per in (
            (rows * v * itemsize * n_in + rows * (8 + 4 * kd_mod.N_STATS),
             16 if buffer else 11),
            (rows * v * itemsize * (n_in + 1)
             + rows * (8 + 4 + 4 * kd_mod.N_STATS), 14 if buffer else 11)):
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = rows * v * ops_per / F32_FLOPS * 1e3
        out.append((max(t_bytes, t_ops),
                    "bytes" if t_bytes >= t_ops else "operations"))
    return out


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _kd_plan_line(p):
    return (f"plan {p.path} rows/block={p.rows_per_block} tile={p.tile} "
            f"blocks={p.blocks}")


# The forward's path sweep: both paths on either side of WARP_MAX_V, at the
# FL main path's rows and the LLM shape's, with buffer.
SWEEP_V = (512, 1024, 2048, 4096, 8192)
SWEEP_ROWS = (128, 512)


def _fwd_sweep(tag, fwd, make_sets, dtypes):
    """Times ``fwd`` (a forward wrapper) on the warp and the block path
    across the threshold; ``make_sets(rows, v, dtype)`` gives its argument
    sets."""
    for dtype in dtypes:
        name = str(dtype).split('.')[-1]
        for rows in SWEEP_ROWS:
            for v in SWEEP_V:
                sets = make_sets(rows, v, dtype)
                ms = {path: time_ms(
                    lambda *a, path=path: fwd(*a, TAU, path=path), sets)
                      for path in ("warp", "block")}
                print(f"[{tag}] sweep rows={rows} V={v} {name} buffer=True: "
                      f"warp {ms['warp']:.5f} ms, block {ms['block']:.5f} ms"
                      f" (plan: {kd_mod.plan(rows, v).path}; WARP_MAX_V="
                      f"{kd_mod.WARP_MAX_V})")


# The backward's width timing: the C side's plan against one logit a
# thread and 16-byte vectors, with buffer, at the FL main path's shape, the
# LLM shape and three between that bracket the plan's switch from one logit
# a thread to vectors (BWD_FILL_THREADS threads an SM).
BWD_SWEEP_SHAPES = ((128, 100), (256, 256), (128, 1000), (512, 1024),
                    (512, 49155))


def _bwd_sweep(tag, bwd, plain, make_sets, dtypes):
    """Times ``bwd`` (a backward wrapper) as the C side plans it and at
    each width (one logit a thread, 16 bytes of logits); ``make_sets(rows,
    v, dtype)`` gives its argument sets (without tau and mean_scale), each
    launch held against ``plain`` on the first set."""
    for dtype in dtypes:
        name = str(dtype).split('.')[-1]
        w = 16 // torch.empty(0, dtype=dtype).element_size()
        for rows, v in BWD_SWEEP_SHAPES:
            sets = make_sets(rows, v, dtype)
            want = plain(*sets[0], TAU, 1.0 / rows)
            cells, worst = [], 0.0
            for width in (None, 1, w):
                def fn(*a, width=width):
                    return bwd(*a, TAU, 1.0 / rows, width=width)
                got = fn(*sets[0])
                torch.cuda.synchronize()
                err = _rel_err(got, want)
                check(math.isfinite(err) and err <= TOL[dtype],
                      f"{tag} bwd sweep rows={rows} V={v} {name} width "
                      f"{width}: relative err {err} > {TOL[dtype]}")
                worst = max(worst, err)
                what = "planned" if width is None else f"width {width}"
                cells.append(f"{what} {time_ms(fn, sets):.5f}")
            print(f"[{tag}] bwd widths rows={rows} V={v} {name} buffer=True "
                  f"(ms): {', '.join(cells)}; relative err <= {worst:.3g}")


def _shifted(x, off):
    """x's values in a view ``off`` elements into a larger buffer whose
    first elements are NaN (codes: 127)."""
    fill = 127 if x.dtype == torch.int8 else float("nan")
    flat = torch.full((off + x.numel(),), fill, dtype=x.dtype, device=x.device)
    flat[off:] = x.reshape(-1)
    return flat[off:].view(x.shape)


def _check_bwd_edges(tag, bwd, plain, make_args):
    """``bwd`` against ``plain`` with 16-byte vectors asked for, at 6 x 100
    (bf16 vectors cross every other row end) with s, the teacher and b at
    storage offsets 1-15: all at one offset (a scalar head, then vectors,
    f32 ones crossing row ends too) and each at its own (skews that differ
    take one logit a thread); and at V = 1 and 7, 133 rows (rows end inside
    a vector, several times at V = 1).  ``make_args(rows, v, dtype)`` gives
    one argument set: labels, g, stats, s, the teacher (t or codes first)
    and b last."""
    worst = {}

    def hold(what, dtype, args, rows):
        w = 16 // torch.empty(0, dtype=dtype).element_size()
        got = bwd(*args, TAU, 1.0 / rows, width=w)
        err = _rel_err(got, plain(*args, TAU, 1.0 / rows))
        worst[(what, dtype)] = max(worst.get((what, dtype), 0), err)

    for dtype in (torch.float32, torch.bfloat16):
        for o in range(1, 16):
            for what, offs in (("one offset", (o, o, o)),
                               ("own offsets", (o, (o + 4) % 15 + 1,
                                                (o + 9) % 15 + 1))):
                args = list(make_args(6, 100, dtype))
                for pos, off in zip((3, 4, len(args) - 1), offs):
                    args[pos] = _shifted(args[pos], off)
                hold(what, dtype, args, 6)
        for v in (1, 7):
            hold(f"V={v}", dtype, make_args(133, v, dtype), 133)
    torch.cuda.synchronize()
    for (what, dtype), e in worst.items():
        check(math.isfinite(e) and e <= TOL[dtype],
              f"{tag} bwd {what} {dtype}: relative err {e} > {TOL[dtype]}")
    print(f"[{tag}] bwd with 16-byte vectors asked for, at storage offsets "
          f"1-15 (s, teacher, b; 6 x 100) and at V = 1, 7 (133 rows): "
          f"relative err "
          + ", ".join(f"{w} {str(d).split('.')[-1]} {e:.3g}"
                      for (w, d), e in worst.items()))


def launch_floor_ms():
    """A graph's launch floor: a one-element tensor's zero_(), replayed
    from a CUDA graph as the kernels are."""
    x = torch.zeros(1, device="cuda")
    return time_ms(lambda a: a.zero_(), [(x,)] * 8)


def _check_kd(rows, v, dtype, buffer, pad, seed):
    """Kernels against plain versions; ops.kd_loss's loss and autograd
    gradient against the plain path.  Returns the max abs errors of
    (stats, ds) and the relative ones."""
    y, s, t, b, g = _kd_inputs(rows, v, dtype, buffer, pad, seed)[0]
    return _check_kd_on(f"rows={rows} V={v} {str(dtype).split('.')[-1]} "
                        f"buffer={buffer} pad={pad}", y, s, t, b, g, TAU)


def _check_kd_on(name, y, s, t, b, g, tau):
    """``_check_kd`` on given inputs (labels, s, t, b, row weights g)."""
    rows, v = s.shape
    stats = kd_mod.kd_stats_fwd(y, s, t, b, tau)
    ds = kd_mod.kd_grad_bwd(y, g, stats, s, t, b, tau, 1.0 / rows)
    torch.cuda.synchronize()
    want = kref.kd_stats_ref(y, s, t, b, tau)
    want_ds = kref.kd_grad_ref(y, g, want, s, t, b, tau, 1.0 / rows)
    s1 = s.clone().requires_grad_()
    loss = ops.kd_loss(y, s1, t, b, tau)
    loss.backward()
    s2 = s.clone().requires_grad_()
    want_loss = kref.kd_loss_mean_ref(y, s2, t, b, tau)
    want_loss.backward()
    errs = {"stats": _rel_err(stats, want), "ds": _rel_err(ds, want_ds),
            "loss": abs(loss.item() - want_loss.item()) / abs(want_loss.item()),
            "grad": _rel_err(s1.grad, s2.grad)}
    tol = TOL[s.dtype]
    for what, e in errs.items():
        check(math.isfinite(e) and e <= tol,
              f"kd {what} {name}: relative err {e} > {tol}")
    check(stats.shape == (rows, kd_mod.N_STATS) and ds.dtype == s.dtype,
          f"kd outputs {tuple(stats.shape)} {ds.dtype}")
    print(f"[kd] {name}: {_kd_plan_line(kd_mod.plan(rows, v))}"
          f"; relative err stats {errs['stats']:.3g}, ds "
          f"{errs['ds']:.3g}, loss {errs['loss']:.3g}, autograd grad "
          f"{errs['grad']:.3g} (limit {tol})")
    return ((stats - want).abs().max().item(),
            (ds.float() - want_ds.float()).abs().max().item())


def _kd_bwd_sets(rows, v, dtype, seed, copies=1):
    """Backward argument sets (labels, g, stats, s, t, b), with buffer, the
    stats from the forward kernel."""
    sets = _kd_inputs(rows, v, dtype, True, seed=seed, copies=copies)
    return [(y, g, kd_mod.kd_stats_fwd(y, s, t, b, TAU), s, t, b)
            for y, s, t, b, g in sets]


def _time_kd(shape, dtype, buffer, copies):
    """Device ms of (fwd kernel, bwd kernel, fwd plain, bwd plain), each
    replayed from a CUDA graph over ``copies`` input sets."""
    rows = shape["rows"]
    sets = _kd_inputs(rows, shape["v"], dtype, buffer, shape.get("pad", 0),
                      seed=9, copies=copies)
    fwd = [(y, s, t, b) for y, s, t, b, _ in sets]
    stats = [kd_mod.kd_stats_fwd(*a, TAU) for a in fwd]
    bwd = [(y, g, st, s, t, b) for (y, s, t, b, g), st in zip(sets, stats)]
    return (time_ms(lambda *a: kd_mod.kd_stats_fwd(*a, TAU), fwd),
            time_ms(lambda *a: kd_mod.kd_grad_bwd(*a, TAU, 1.0 / rows), bwd),
            time_ms(lambda *a: kref.kd_stats_ref(*a, TAU), fwd),
            time_ms(lambda *a: kref.kd_grad_ref(*a, TAU, 1.0 / rows), bwd))


def _time_pair(tag, names, replaces, time_fn, bounds_fn, abs_errs):
    """Times a (forward, backward) kd kernel pair and its plain versions at
    the main path's shape (f32, with and without buffer; beside a graph's
    launch floor) and the LLM shape (f32 and bf16, with buffer) beside its
    bounds.  Returns the pair's kernel-table entries at the main path's
    shape with buffer (launches filled in by an fl phase)."""
    entries = []
    floor = launch_floor_ms()
    print(f"[{tag}] launch floor: a one-element zero_() replayed from a "
          f"CUDA graph, {floor:.5f} ms")
    for label, shape, dtype, copies in (
            ("main path", KD_MAIN, torch.float32, 8),
            ("LLM", KD_LLM, torch.float32, 2),
            ("LLM", KD_LLM, torch.bfloat16, 2)):
        rows, v = shape["rows"], shape["v"]
        for buffer in (False, True) if label == "main path" else (True,):
            ms = time_fn(shape, dtype, buffer, copies)
            bounds = bounds_fn(rows, v, torch.finfo(dtype).bits // 8, buffer)
            for k, name in enumerate(names):
                print(f"[{tag}] {name} {label} rows={rows} V={v} "
                      f"{str(dtype).split('.')[-1]} buffer={buffer}: kernel "
                      f"{ms[k]:.5f} ms, plain {ms[k + 2]:.5f} ms, bound "
                      f"{bounds[k][0]:.5f} ms ({bounds[k][1]}), "
                      f"{bounds[k][0] / ms[k]:.1%} of the bound; "
                      + (f"launch floor {floor:.5f} ms; "
                         if label == "main path" else "")
                      + "library: none (no single PyTorch call computes "
                      "this fused function)")
            if label == "main path" and buffer:
                entries += [{
                    "name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/kd_loss.cu",
                    "replaces": replaces[k], "launches": None,
                    "max_abs_err": max(e[k] for e in abs_errs),
                    "ms": ms[k], "plain_ms": ms[k + 2],
                    "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                    "library_ms": None} for k, name in enumerate(names)]
    return entries


def phase_kd_kernels():
    """Returns the kernel-table entries of kd_stats_fwd and kd_grad_bwd at
    the main path's shape (launches filled in by the fl phase)."""
    abs_errs = []
    for buffer in (False, True):
        abs_errs.append(_check_kd(**KD_MAIN, dtype=torch.float32,
                                  buffer=buffer, pad=0, seed=1))
    for dtype in (torch.float32, torch.bfloat16):
        _check_kd(**KD_LLM, dtype=dtype, buffer=True, seed=2)
    _fwd_sweep("kd", kd_mod.kd_stats_fwd,
               lambda rows, v, dtype: [a[:4] for a in _kd_inputs(
                   rows, v, dtype, True, seed=5, copies=4)],
               (torch.float32, torch.bfloat16))
    _bwd_sweep("kd", kd_mod.kd_grad_bwd, kref.kd_grad_ref,
               lambda rows, v, dtype: _kd_bwd_sets(rows, v, dtype, seed=6,
                                                   copies=4),
               (torch.float32, torch.bfloat16))
    _check_bwd_edges("kd", kd_mod.kd_grad_bwd, kref.kd_grad_ref,
                     lambda rows, v, dtype: _kd_bwd_sets(rows, v, dtype,
                                                         seed=7)[0])
    return _time_pair("kd", ("kd_stats_fwd", "kd_grad_bwd"),
                      ("src/repro/kernels/kd_loss.py:244",
                       "src/repro/kernels/kd_loss.py:271"),
                      _time_kd, _kd_bounds, abs_errs)


# -- Algorithm 1 on the card ------------------------------------------------


def _cifar_silos(num_edges=3):
    """CIFAR-shaped data (32x32x3, 100 classes): 1,000 test images and
    1 core + ``num_edges`` edge Dirichlet(1) silos of ~2,500 (the paper's
    50,000 / 20)."""
    x, y = make_cifar_like(num_classes=100, n=1000 + 2500 * (num_edges + 1),
                           seed=0)
    xs, ys = x[1000:], y[1000:]
    parts = dirichlet_partition(ys, num_edges + 1, alpha=1.0, seed=1)
    return (Dataset(xs[parts[0]], ys[parts[0]]),
            [Dataset(xs[p], ys[p]) for p in parts[1:]],
            Dataset(x[:1000], y[:1000]))


def _timed(obj, name, times, key):
    fn = getattr(obj, name)

    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        times[key] += time.perf_counter() - t0
        return out

    setattr(obj, name, wrapper)


KD_COUNTERS = {"kd_stats_fwd": kd_mod.kd_stats_fwd,
               "kd_grad_bwd": kd_mod.kd_grad_bwd,
               "kd_quant_stats_fwd": kd_mod.kd_quant_stats_fwd,
               "kd_quant_grad_bwd": kd_mod.kd_quant_grad_bwd}


@contextlib.contextmanager
def _print_bwd_skews(tag):
    """Inside the block, the first backward (``ops.kd_grad`` or
    ``ops.kd_quant_grad``, which call the two kernel wrappers: the first
    Phase-2 step) prints each logit operand's base skew, its data
    pointer's bytes mod 16 (0: the flat pass runs on vectors from element
    0)."""
    names = {"kd_grad": ("kd_grad_bwd",
                         ("labels", "g", "stats", "s", "t", "b")),
             "kd_quant_grad": ("kd_quant_grad_bwd",
                               ("labels", "g", "stats", "s", "codes",
                                "scale", "zero", "b"))}
    originals = {n: getattr(ops, n) for n in names}
    done = []

    def wrap(name, fn):
        def call(*args, **kw):
            ds = fn(*args, **kw)
            if not done:
                done.append(name)
                kernel, params = names[name]
                skew = {k: x.data_ptr() % 16 for k, x in zip(params, args)
                        if k in ("s", "t", "codes", "b") and x is not None}
                skew["ds"] = ds.data_ptr() % 16
                print(f"[{tag}] first Phase-2 step: {kernel} operands' base "
                      f"skew (bytes mod 16): {skew}")
            return ds
        return call

    for n, fn in originals.items():
        setattr(ops, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in originals.items():
            setattr(ops, n, fn)


def _fl_run(silos, method, rounds, r, transport="none", tag="fl",
            skews=False):
    """One ResNet-32 federation; returns each kd kernel's launches in it
    (every count set to 0 just before the run and read just after); with
    ``skews`` its first Phase-2 step prints the backward's operand skews."""
    core, edges, test = silos
    cfg = FLConfig(num_edges=3, rounds=rounds, aggregation_r=r, method=method,
                   core_epochs=2, edge_epochs=2, kd_epochs=2, batch_size=128,
                   lr=0.1, kd_lr=0.02, tau=2.0, loss_backend="auto",
                   transport=transport)
    fl = FederatedKD(resnet_adapter(RESNET32), cfg, core, edges, test,
                     device="cuda")
    times = {"phase0": 0.0, "phase1": 0.0}
    _timed(fl, "pretrain_core", times, "phase0")
    _timed(fl, "train_round_edges", times, "phase1")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in KD_COUNTERS.values():
        c.launches = 0
    t0 = time.perf_counter()
    with _print_bwd_skews(tag) if skews else contextlib.nullcontext():
        _, hist = fl.run(0, log=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in KD_COUNTERS.items()}
    steps = rounds * cfg.kd_epochs * max(len(core) // min(cfg.batch_size,
                                                        len(core)), 1)
    phase2 = wall - times["phase0"] - times["phase1"]
    name = f"{method} R={r}" + (f" {transport}" if transport != "none" else "")
    for h in hist:
        print(f"[{tag}] {name} round {h.round}: edges {h.edges} test_acc "
              f"{h.test_acc:.4f} acc_cur_edge {h.acc_cur_edge:.4f} "
              f"forget_score {h.get('forget_score')} lost {h.get('lost')}")
    print(f"[{tag}] {name}: {rounds} rounds in {wall:.2f}s: phase 0 "
          f"{times['phase0']:.2f}s, phase 1 {times['phase1']:.2f}s, phase 2 "
          f"(with the rounds' metrics passes) {phase2:.2f}s = "
          f"{steps / phase2:.2f} Phase-2 steps/s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; launches "
          f"{launches} for {steps} Phase-2 steps")
    quant = transport in ("int8", "int4") and r == 1
    want = {"kd_stats_fwd": 0 if quant else steps,
            "kd_grad_bwd": 0 if quant else steps,
            "kd_quant_stats_fwd": steps if quant else 0,
            "kd_quant_grad_bwd": steps if quant else 0}
    check(launches == want and steps > 0,
          f"{name}: kernel launches {launches}, want {want}")
    for h in hist:
        vals = [v for v in h.as_dict().values() if isinstance(v, float)]
        check(all(math.isfinite(v) for v in vals), f"{name}: non-finite {h}")
    check(len(hist) == rounds, f"{name}: {len(hist)} of {rounds} rounds")
    log = fl.distill_engine.uplink_log
    if transport != "none":
        per_teacher = parse_codec(transport).payload_bytes(len(core), 100)
        for rec in log:
            print(f"[{tag}] {name} round {rec['round']}: uplink "
                  f"{rec['bytes']} B from {rec['teachers']} teacher(s) "
                  f"({per_teacher} B per teacher by the codec's accounting)")
        check(len(log) == rounds and all(
            rec["bytes"] == per_teacher * rec["teachers"] == per_teacher * r
            for rec in log), f"{name}: uplink log {log}")
    return launches


def phase_fl():
    """ResNet-32 at full width, f32, PyTorch's default convolution math
    (cuDNN TF32 on).  Returns the kernels' launches over the phase."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    silos = _cifar_silos()
    core, edges, test = silos
    print(f"[fl] ResNet-{RESNET32.depth} width {RESNET32.width}, "
          f"{RESNET32.num_classes} classes; core {len(core)}, edges "
          f"{[len(e) for e in edges]}, test {len(test)}; cuDNN TF32 "
          f"{torch.backends.cudnn.allow_tf32}, matmul TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    total = [0, 0]
    for k, (method, rounds, r) in enumerate((("kd", 3, 1), ("bkd", 3, 1),
                                             ("bkd", 1, 2))):
        launches = _fl_run(silos, method, rounds, r, skews=k == 0)
        total = [a + launches[n] for a, n in zip(
            total, ("kd_stats_fwd", "kd_grad_bwd"))]
    return total


def phase_fl_parity():
    """The quickstart's MLP federation (2 rounds, f32, TF32 off) on the card
    (kernels) and on the CPU (plain versions) from one initial state."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    adapter, core, edges, test = quickstart.setup()
    init = params_to_numpy(adapter.init(torch.Generator().manual_seed(0),
                                        "cpu"))
    adapter = dataclasses.replace(
        adapter, init=lambda gen, device: params_from_numpy(init, device))
    for method in ("kd", "bkd"):
        cfg = quickstart.config(method, rounds=2)
        first, accs = {}, {}
        for device in ("cpu", "cuda"):
            fl = FederatedKD(adapter, cfg, core, edges, test, device=device)
            state = fl.pretrain_core(0)
            teachers = fl.train_round_edges([state], [0], seed=cfg.seed)
            stepper = fl.distill_stepper(state, teachers, 0, edge_ids=[0])
            stepper.step(max_steps=1)
            first[device] = stepper.losses[0].item()
            _, hist = FederatedKD(adapter, cfg, core, edges, test,
                                  device=device).run(0, log=None)
            accs[device] = [h["test_acc"] for h in hist]
        rel = abs(first["cuda"] - first["cpu"]) / abs(first["cpu"])
        gap = max(abs(a - b) for a, b in zip(accs["cuda"], accs["cpu"]))
        print(f"[fl parity] {method}: first Phase-2 loss card "
              f"{first['cuda']:.7f} cpu {first['cpu']:.7f} (relative "
              f"{rel:.3g}, limit 1e-5); test_acc card {accs['cuda']} cpu "
              f"{accs['cpu']} (max gap {gap:.4f}, limit 0.02)")
        check(rel <= 1e-5, f"{method}: first Phase-2 loss differs by {rel}")
        check(gap <= 0.02, f"{method}: test_acc differs by {gap}")


FIGURES = (fig4_main, fig5_forget, fig7_aggregation, fig9_straggler)


@contextlib.contextmanager
def _recorded_runs(runs):
    """Inside the block, every figure bench's ``run_method`` appends
    (bench, method, keyword arguments, history, kd pair launches) to
    ``runs``; each run's counts are set to 0 just before it and read just
    after."""
    originals = {mod: mod.run_method for mod in FIGURES}

    def wrap(mod, fn):
        def call(method, **kw):
            for c in KD_COUNTERS.values():
                c.launches = 0
            hist, dt = fn(method, **kw)
            launches = {n: c.launches for n, c in KD_COUNTERS.items()}
            runs.append((mod.__name__.split(".")[-1], method, kw, hist,
                         launches))
            return hist, dt
        return call

    for mod, fn in originals.items():
        mod.run_method = wrap(mod, fn)
    try:
        yield
    finally:
        for mod, fn in originals.items():
            mod.run_method = fn


def phase_figures():
    """The port's claim-check tally (``benchmarks/run.py --fast``: Figs. 4,
    5, 7 and 9 at 3 rounds) on the card.  The claims are learning outcomes
    and are printed, not required; what is deterministic is checked: every
    run ends with finite metrics for each round, bkd_cached equals bkd,
    and every kd/bkd run went through the kd kernel pair."""
    t0 = time.perf_counter()
    runs = []
    with _recorded_runs(runs):
        checks = fig_run.main(["--fast", "--device", "cuda"])
    for bench, method, kw, hist, launches in runs:
        opts = {k: v for k, v in kw.items() if k not in ("seed", "device")}
        print(f"[figures] {bench} {method} {opts}: test_acc "
              f"{[round(h.test_acc, 4) for h in hist]}; kd pair launches "
              f"{launches['kd_stats_fwd']} / {launches['kd_grad_bwd']}")
        check(len(hist) > 0 and all(
            math.isfinite(v) for h in hist for v in h.as_dict().values()
            if isinstance(v, float)), f"{bench} {method}: non-finite {hist}")
        if method in ("kd", "bkd"):
            check(launches["kd_stats_fwd"] > 0 and launches["kd_grad_bwd"]
                  == launches["kd_stats_fwd"],
                  f"{bench} {method} {opts}: kd pair launches {launches}")
    print(f"[figures] {len(runs)} runs in {time.perf_counter() - t0:.1f}s; "
          f"checks {checks}")
    check(checks["fig4"]["cached_equals_bkd"],
          "fig4: bkd_cached differs from bkd")
    return checks


def phase_phase2_bench():
    """The port's Phase-2 bench on the card: ``--all-methods`` (every
    registered method round-trips with a finite accuracy, exit 0), then the
    throughput variants at the bench's full sizes with the bkd_cached
    contract (within 0.005 of the exact cache).  The scan/loop ratio is
    printed beside the reference's exit rule, whose 2.0 measures JAX
    re-tracing a fresh engine's step every round; it is not required."""
    t0 = time.perf_counter()
    rc = phase2_bench.main(["--all-methods", "--device", "cuda"])
    check(rc == 0, f"phase2_bench --all-methods exited {rc}")
    counts = []      # kd_stats_fwd launches a variant, in VARIANTS' order
    time_variant = phase2_bench.time_variant

    def counted(*a, **kw):
        kd_mod.kd_stats_fwd.launches = 0
        out = time_variant(*a, **kw)
        counts.append(kd_mod.kd_stats_fwd.launches)
        return out

    phase2_bench.time_variant = counted
    try:
        report = phase2_bench.throughput_report(False, 3, "cuda")
    finally:
        phase2_bench.time_variant = time_variant
    tp, contract = report["throughput"], report["bkd_cached_accuracy"]
    check(list(tp) == list(phase2_bench.VARIANTS) and len(counts) == len(tp),
          f"phase2 bench: variants {list(tp)}, {len(counts)} timed")
    for (name, row), n in zip(tp.items(), counts):
        kw = phase2_bench.VARIANTS[name]
        print(f"[phase2 bench] {name}: {row['steps_per_sec']} steps/s "
              f"({row['total_steps']} steps in {row['seconds']}s); "
              f"kd_stats_fwd launches {n}")
        check(math.isfinite(row["steps_per_sec"]) and row["steps_per_sec"] > 0,
              f"phase2 bench {name}: {row}")
        check((n > 0) == (kw["loss_backend"] == "pallas"),
              f"phase2 bench {name}: {n} kd kernel launches")
    ok = phase2_bench.passes(report, False)
    print(f"[phase2 bench] config {report['config']}; speedup_scan_vs_loop "
          f"{report['speedup_scan_vs_loop']} (the reference's rule: >= 2.0); "
          f"bkd_cached contract {contract}; the reference's exit rule "
          f"{'holds' if ok else 'does not hold'}; "
          f"{time.perf_counter() - t0:.1f}s")
    check(all(math.isfinite(v) for v in contract.values())
          and contract["abs_delta"] <= 0.005,
          f"bkd_cached contract: {contract}")


# -- the dequant-fused KD loss kernels (transport) ---------------------------


def _kdq_inputs(rows, v, dtype, buffer, bits, seed=0, copies=1):
    """Sets of (labels, s, codes, scale, zero, b, g) on the card from a
    seed: student, teacher and buffer logits of unit scale x 3, the teacher
    through the port's int8 or int4 codec on the card (int4 unpacked to its
    int8 container, as the transport hands it to the kernels).  No -1e30
    pad columns: a payload cannot carry them (the port reads V columns)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    codec = parse_codec(f"int{bits}").transform
    sets = []
    for _ in range(copies):
        s = 3 * torch.randn((rows, v), generator=gen, device="cuda")
        p = codec.encode(3 * torch.randn((rows, v), generator=gen,
                                         device="cuda"))
        b = (3 * torch.randn((rows, v), generator=gen, device="cuda")
             if buffer else None)
        y = torch.randint(0, v, (rows,), generator=gen, device="cuda")
        g = torch.rand(rows, generator=gen, device="cuda") + 0.5
        sets.append((y, s.to(dtype), codec.unpack_codes(p["codes"], v),
                     p["scale"], p["zero"],
                     b.to(dtype) if buffer else None, g))
    return sets


def _kdq_bounds(rows, v, itemsize, buffer):
    """(fwd, bwd) least times in ms: student (and buffer) logits and the
    int8 codes read once, labels, scale, zero (and g, stats) read once,
    stats / ds written once; f32 operations per logit at the CUDA-core peak
    (those of the exact pair plus the dequant FMA's two)."""
    per_logit = itemsize * (2 if buffer else 1) + 1
    out = []
    for bytes_, ops_per in (
            (rows * v * per_logit + rows * (8 + 8 + 4 * kd_mod.N_STATS),
             18 if buffer else 13),
            (rows * v * (per_logit + itemsize)
             + rows * (8 + 8 + 4 + 4 * kd_mod.N_STATS), 16 if buffer else 13)):
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = rows * v * ops_per / F32_FLOPS * 1e3
        out.append((max(t_bytes, t_ops),
                    "bytes" if t_bytes >= t_ops else "operations"))
    return out


def _check_kdq(rows, v, dtype, buffer, bits, seed):
    """Quant kernels against their plain versions; ops.kd_loss_quant's loss
    and autograd gradient against the plain path.  Returns the max abs
    errors of (stats, ds)."""
    y, s, codes, scale, zero, b, g = _kdq_inputs(rows, v, dtype, buffer,
                                                 bits, seed)[0]
    stats = kd_mod.kd_quant_stats_fwd(y, s, codes, scale, zero, b, TAU)
    ds = kd_mod.kd_quant_grad_bwd(y, g, stats, s, codes, scale, zero, b, TAU,
                                  1.0 / rows)
    torch.cuda.synchronize()
    want = kref.kd_quant_stats_ref(y, s, codes, scale, zero, b, TAU)
    want_ds = kref.kd_quant_grad_ref(y, g, want, s, codes, scale, zero, b,
                                     TAU, 1.0 / rows)
    s1 = s.clone().requires_grad_()
    loss = ops.kd_loss_quant(y, s1, codes, scale, zero, b, TAU)
    loss.backward()
    s2 = s.clone().requires_grad_()
    want_loss = kref.kd_loss_mean_ref(y, s2, kref.dequantize(codes, scale,
                                                             zero), b, TAU)
    want_loss.backward()
    errs = {"stats": _rel_err(stats, want), "ds": _rel_err(ds, want_ds),
            "loss": abs(loss.item() - want_loss.item()) / abs(want_loss.item()),
            "grad": _rel_err(s1.grad, s2.grad)}
    tol = TOL[dtype]
    name = (f"rows={rows} V={v} {str(dtype).split('.')[-1]} buffer={buffer} "
            f"int{bits}")
    for what, e in errs.items():
        check(math.isfinite(e) and e <= tol,
              f"kdq {what} {name}: relative err {e} > {tol}")
    check(stats.shape == (rows, kd_mod.N_STATS) and ds.dtype == dtype,
          f"kdq outputs {tuple(stats.shape)} {ds.dtype}")
    print(f"[kdq] {name}: "
          f"{_kd_plan_line(kd_mod.plan(rows, v))}"
          f"; relative err stats {errs['stats']:.3g}, ds "
          f"{errs['ds']:.3g}, loss {errs['loss']:.3g}, autograd grad "
          f"{errs['grad']:.3g} (limit {tol}; the kernels dequantize with "
          f"one FMA, the plain version rounds twice)")
    return ((stats - want).abs().max().item(),
            (ds.float() - want_ds.float()).abs().max().item())


def _kdq_bwd_sets(rows, v, dtype, seed, copies=1):
    """Backward argument sets (labels, g, stats, s, codes, scale, zero, b)
    on int8 payloads, with buffer, the stats from the forward kernel."""
    sets = _kdq_inputs(rows, v, dtype, True, 8, seed=seed, copies=copies)
    return [(y, g, kd_mod.kd_quant_stats_fwd(y, s, c, sc, z, b, TAU), s, c,
             sc, z, b) for y, s, c, sc, z, b, g in sets]


def _time_kdq(shape, dtype, buffer, copies):
    """Device ms of (fwd kernel, bwd kernel, fwd plain, bwd plain) on int8
    payloads, each replayed from a CUDA graph over ``copies`` input sets
    (no pad columns: a payload cannot carry them)."""
    rows = shape["rows"]
    sets = _kdq_inputs(rows, shape["v"], dtype, buffer, 8, seed=9,
                       copies=copies)
    fwd = [a[:6] for a in sets]
    stats = [kd_mod.kd_quant_stats_fwd(*a, TAU) for a in fwd]
    bwd = [(y, g, st, s, c, sc, z, b)
           for (y, s, c, sc, z, b, g), st in zip(sets, stats)]
    return (time_ms(lambda *a: kd_mod.kd_quant_stats_fwd(*a, TAU), fwd),
            time_ms(lambda *a: kd_mod.kd_quant_grad_bwd(*a, TAU, 1.0 / rows),
                    bwd),
            time_ms(lambda *a: kref.kd_quant_stats_ref(*a, TAU), fwd),
            time_ms(lambda *a: kref.kd_quant_grad_ref(*a, TAU, 1.0 / rows),
                    bwd))


def phase_kdq_kernels():
    """Returns the kernel-table entries of kd_quant_stats_fwd and
    kd_quant_grad_bwd at the main path's shape (launches filled in by the
    fl transport phase); timed on int8 payloads."""
    abs_errs = []
    for bits in (8, 4):
        for buffer in (False, True):
            abs_errs.append(_check_kdq(**KD_MAIN, dtype=torch.float32,
                                       buffer=buffer, bits=bits, seed=1))
    for dtype in (torch.float32, torch.bfloat16):
        _check_kdq(KD_LLM["rows"], KD_LLM["v"], dtype, True, 8, seed=2)
    _fwd_sweep("kdq", kd_mod.kd_quant_stats_fwd,
               lambda rows, v, dtype: [a[:6] for a in _kdq_inputs(
                   rows, v, dtype, True, 8, seed=5, copies=4)],
               (torch.float32,))
    _bwd_sweep("kdq", kd_mod.kd_quant_grad_bwd, kref.kd_quant_grad_ref,
               lambda rows, v, dtype: _kdq_bwd_sets(rows, v, dtype, seed=6,
                                                    copies=4),
               (torch.float32, torch.bfloat16))
    _check_bwd_edges("kdq", kd_mod.kd_quant_grad_bwd, kref.kd_quant_grad_ref,
                     lambda rows, v, dtype: _kdq_bwd_sets(rows, v, dtype,
                                                          seed=7)[0])
    return _time_pair("kdq", ("kd_quant_stats_fwd", "kd_quant_grad_bwd"),
                      ("src/repro/kernels/kd_loss.py:298",
                       "src/repro/kernels/kd_loss.py:331"),
                      _time_kdq, _kdq_bounds, abs_errs)


def phase_fl_transport():
    """Phase 6's ResNet-32 federation with uplink transport.  Returns the
    quant pair's launches over the phase."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    silos = _cifar_silos()
    total = {n: 0 for n in KD_COUNTERS}
    for k, (method, rounds, r, spec) in enumerate((("bkd", 3, 1, "int8"),
                                                   ("kd", 3, 1, "int4"),
                                                   ("bkd", 1, 2, "int8"))):
        launches = _fl_run(silos, method, rounds, r, transport=spec,
                           tag="fl transport", skews=k == 0)
        total = {n: total[n] + launches[n] for n in total}
    print(f"[fl transport] launches over the phase: {total}")
    _phase2_ab(silos)
    return [total["kd_quant_stats_fwd"], total["kd_quant_grad_bwd"]]


def _phase2_ab(silos, pairs=3):
    """Wall seconds of one bkd Phase-2 round on the same student
    and teacher, without transport and with int8 (the fused path, which
    skips the step's teacher forward), run in turns (none, int8, int8,
    none, ...) after one warm-up each: host speed drifts within a call,
    so only runs in turns compare."""
    core, edges, test = silos
    adapter = resnet_adapter(RESNET32)
    cfg = FLConfig(num_edges=3, rounds=1, method="bkd", core_epochs=2,
                   edge_epochs=2, kd_epochs=2, batch_size=128, lr=0.1,
                   kd_lr=0.02, tau=2.0, loss_backend="auto")
    fl = FederatedKD(adapter, cfg, core, edges, test, device="cuda")
    state = fl.pretrain_core(0)
    teachers = fl.train_round_edges([state], [0], seed=0)
    engines = {spec: DistillEngine(adapter, dataclasses.replace(
        cfg, transport=spec), core, "cuda") for spec in ("none", "int8")}
    secs = {spec: [] for spec in engines}
    order = ["none", "int8"] + ["none", "int8", "int8", "none"] * (
        (pairs + 1) // 2)
    for k, spec in enumerate(order[:2 + 2 * pairs]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engines[spec].run(state, teachers, 0)
        torch.cuda.synchronize()
        if k >= 2:                      # the first of each is a warm-up
            secs[spec].append(time.perf_counter() - t0)
    med = {spec: float(np.median(v)) for spec, v in secs.items()}
    steps = cfg.kd_epochs * (len(core) // cfg.batch_size)
    print(f"[fl transport] Phase-2 round of bkd, {steps} steps, in turns: "
          f"none {[round(v, 4) for v in secs['none']]} s, int8 "
          f"{[round(v, 4) for v in secs['int8']]} s; medians none "
          f"{med['none']:.4f} s ({steps / med['none']:.2f} steps/s), int8 "
          f"{med['int8']:.4f} s ({steps / med['int8']:.2f} steps/s)")


def phase_fl_transport_parity():
    """The quickstart's MLP federation with int8 transport (bkd, 2 rounds,
    f32, TF32 off) on the card (quant kernels) and on the CPU (plain
    versions) from one initial state: the round-0 payload codes, the first
    Phase-2 loss and the per-round test accuracy.

    The codec puts each row's minimum exactly on a rounding tie (its
    quotient is -127.5), so teacher logits ~1e-6 apart can give codes one
    step apart there, and a payload differs in whole steps.  The first
    loss is therefore held at 1e-5 on equal payloads (the CPU stepper is
    handed the card's); the loss on each side's own payload is reported."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core.buffer import core_logits
    adapter, core, edges, test = quickstart.setup()
    init = params_to_numpy(adapter.init(torch.Generator().manual_seed(0),
                                        "cpu"))
    adapter = dataclasses.replace(
        adapter, init=lambda gen, device: params_from_numpy(init, device))
    cfg = quickstart.config("bkd", rounds=2, transport="int8")
    first, accs, payload, logits, logs = {}, {}, {}, {}, {}
    for device in ("cuda", "cpu"):
        fl = FederatedKD(adapter, cfg, core, edges, test, device=device)
        state = fl.pretrain_core(0)
        teachers = fl.train_round_edges([state], [0], seed=cfg.seed)
        stepper = fl.distill_stepper(state, teachers, 0, edge_ids=[0])
        payload[device] = stepper.mstate["cache"][PAYLOAD_KEY]
        logits[device] = core_logits(adapter, teachers[0], core).cpu()
        stepper.step(max_steps=1)
        first[device] = stepper.losses[0].item()
        if device == "cpu":
            twin = fl.distill_stepper(state, teachers, 0, edge_ids=[0])
            twin.mstate["cache"][PAYLOAD_KEY] = {
                k: v.cpu() for k, v in payload["cuda"].items()}
            twin.step(max_steps=1)
            first["cpu, card payload"] = twin.losses[0].item()
        fl = FederatedKD(adapter, cfg, core, edges, test, device=device)
        _, hist = fl.run(0, log=None)
        accs[device] = [h["test_acc"] for h in hist]
        logs[device] = fl.distill_engine.uplink_log
    rel = (abs(first["cuda"] - first["cpu, card payload"])
           / abs(first["cpu, card payload"]))
    rel_own = abs(first["cuda"] - first["cpu"]) / abs(first["cpu"])
    gap = max(abs(a - b) for a, b in zip(accs["cuda"], accs["cpu"]))
    pc, pg = ({k: v[:, 0].cpu() for k, v in payload[d].items()}
              for d in ("cpu", "cuda"))
    diff = (pc["codes"] != pg["codes"]).nonzero().tolist()
    # A differing code must sit on a rounding boundary: its quotient
    # (x - zero) / scale within 1e-3 of a half-integer on the CPU side, and
    # the two codes one step apart.
    x = logits["cpu"].double()
    q = (x - pc["zero"].double()[:, None]) / pc["scale"].double()[:, None]
    on_edge = [abs(abs(q[r, c] - q[r, c].floor()) - 0.5) < 1e-3 and abs(
        int(pc["codes"][r, c]) - int(pg["codes"][r, c])) == 1
        for r, c in diff]
    at_min = sum(abs(q[r, c] + 127.5) < 1e-3 for r, c in diff)
    lg_rel = ((logits["cuda"] - logits["cpu"]).abs().max()
              / logits["cpu"].abs().max()).item()
    sc_rel = ((pg["scale"] - pc["scale"]).abs().max()
              / pc["scale"].abs().max()).item()
    print(f"[fl transport parity] bkd@int8 round-0 payload: teacher logits "
          f"relative diff {lg_rel:.3g}, scale {sc_rel:.3g}; {len(diff)} of "
          f"{pc['codes'].numel()} codes ({pc['codes'].shape[0]} rows) "
          f"differ, {sum(on_edge)} of them on a rounding boundary, "
          f"{at_min} at a row's minimum (quotient -127.5)")
    print(f"[fl transport parity] first Phase-2 loss card {first['cuda']:.7f}"
          f", cpu on the card's payload {first['cpu, card payload']:.7f} "
          f"(relative {rel:.3g}, limit 1e-5), cpu on its own payload "
          f"{first['cpu']:.7f} (relative {rel_own:.3g}); test_acc card "
          f"{accs['cuda']} cpu {accs['cpu']} (max gap {gap:.4f}, limit "
          f"0.02); uplink logs equal {logs['cuda'] == logs['cpu']}")
    check(all(on_edge), f"transport: codes differ off a rounding boundary "
          f"at {[d for d, e in zip(diff, on_edge) if not e][:10]}")
    check(rel <= 1e-5, f"transport: first Phase-2 loss differs by {rel}")
    check(gap <= 0.02, f"transport: test_acc differs by {gap}")
    check(logs["cuda"] == logs["cpu"], "transport: uplink logs differ")


def phase_transport_bench():
    """The port's transport benchmark at --smoke sizes on the card."""
    t0 = time.perf_counter()
    out = transport_bench.bench_frontier("none", rounds=2, num_edges=4,
                                         epochs=(3, 3, 2), seed=0,
                                         device="cuda")
    for p in [dict(out["baseline"], codec="none")] + out["frontier"]:
        print(f"[transport bench] {p['codec']}: final_acc {p['final_acc']} "
              f"mean_acc {p['mean_acc']} uplink {p['uplink_bytes']} B "
              f"({p.get('compression_vs_identity')}x vs identity) in "
              f"{p['seconds']}s")
    ok = transport_bench.gates({"none": out})
    print(f"[transport bench] {time.perf_counter() - t0:.1f}s; "
          f"identity_bit_for_bit {out['identity_bit_for_bit']}; gates {ok}")
    check(out["identity_bit_for_bit"],
          "transport bench: identity differs from no transport")
    check(ok, "transport bench: a gate failed")


# -- dense / ring / windowed decode attention and the dense engine ----------

# The long-context case is Granite-3-2B at the ``long_500k`` shape, as
# ``registry.for_shape`` gives it (sliding window 8192), with a ring cache
# added so that the cache holds the window rather than 524,288 positions;
# it decodes the shape's last position.
LONG_SHAPE = SHAPES["long_500k"]
LONG_ATTN = dataclasses.replace(
    registry.for_shape("granite-3-2b", "long_500k"),
    ring_cache=True).attn_cfg(local=False)

# (label, B, W, window, ring, pos, copies, (N, G, D)): the dense engine's
# cache at the serving shape with pos from 0 to W-1; a window of 128 on it;
# --ring's 32-slot ring at wrapped positions; the long-context ring, all at
# Granite's heads.  Copies of the caches make each timed set exceed the
# 50 MB L2 where one layer's cache would not stay there across a 40-layer
# tick.
GRANITE_HEADS = (8, 4, 64)
SWA_CASES = (
    ("full", SLOTS, MAX_LEN, None, False, [0, 170, 341, 511], 16,
     GRANITE_HEADS),
    ("window 128", SLOTS, MAX_LEN, 128, False, [0, 100, 300, 511], 16,
     GRANITE_HEADS),
    ("ring 32", SLOTS, 32, 32, True, [95, 260, 1000, 33], 16, GRANITE_HEADS),
    (f"long ring {LONG_ATTN.window}", LONG_SHAPE.global_batch,
     attention.cache_len(LONG_ATTN, LONG_SHAPE.seq_len), LONG_ATTN.window,
     True, [LONG_SHAPE.seq_len - 1], 4, GRANITE_HEADS),
)
# RecurrentGemma-9B's local attention on the dense engine's cache: one KV
# head, 16 query groups of 256 (phase 18).
RG_SWA_CASE = ("recurrentgemma local", SLOTS, MAX_LEN, 2048, False,
               [0, 170, 341, 511], 32, (1, 16, 256))


def _swa_inputs(b, w, pos, dtype, heads=GRANITE_HEADS, seed=0, copies=1):
    """Sets of (q, k_cache, v_cache, pos) on the card: ``heads`` = (N KV
    heads, G query groups, D)."""
    n, g, d = heads
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    q = torch.randn((b, n, g, d), generator=gen, device="cuda").to(dtype)
    return [(q,) + tuple(torch.randn((b, w, n, d), generator=gen,
                                     device="cuda").to(dtype)
                         for _ in range(2)) + (pos_t,)
            for _ in range(copies)]


def _swa_valid(b, w, pos, window, ring):
    """(B, W) bool: the slots each row attends (the reference's mask)."""
    p = torch.tensor(pos, dtype=torch.int64, device="cuda")[:, None]
    j = torch.arange(w, device="cuda")[None, :]
    a = p - torch.remainder(p - j, w) if ring else j.expand(b, w)
    valid = (a >= 0) & (a <= p)
    if window is not None:
        valid &= a > p - window
    return valid


def _swa_bound(q, valid, itemsize):
    """Least time for one call: the K/V rows each (row, head) attends read
    once, q and pos read, out written; f32 math at the CUDA-core peak."""
    b, n, g, d = q.shape
    rows = int(valid.sum())
    bytes_ = rows * n * d * 2 * itemsize + 2 * b * n * g * d * itemsize + 4 * b
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = rows * n * g * 4 * d / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _swa_sdpa_inputs(q, kc, vc, valid):
    """The library yardstick's inputs, built outside the timed call: q
    (B, H, 1, D), K/V (B, H, W, D) with the KV heads repeated per group, a
    (B, 1, 1, W) boolean mask."""
    b, n, g, d = q.shape
    kd = kc.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
    vd = vc.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).contiguous()
    return q.reshape(b, n * g, 1, d), kd, vd, valid[:, None, None, :]


def phase_swa_kernel(cases=SWA_CASES):
    """Returns the kernel-table entry of swa_decode at the first case's
    shape (launches filled in by the serve dense phase)."""
    entry = None
    for label, b, w, window, ring, pos, copies, heads in cases:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, kc, vc, p = _swa_inputs(b, w, pos, dtype, heads, seed=1)[0]
            got = swa_mod.swa_decode(q, kc, vc, p, window=window, ring=ring)
            torch.cuda.synchronize()
            want = kref.swa_decode_ref(q, kc, vc, p, window=window, ring=ring)
            check(got.dtype == dtype and got.shape == q.shape,
                  f"swa_decode output {got.dtype} {tuple(got.shape)}")
            err = (got.float() - want.float()).abs().max().item()
            rel = err / want.float().abs().max().item()
            check(math.isfinite(rel) and rel <= TOL[dtype],
                  f"swa_decode {label} {dtype}: relative err {rel} > "
                  f"{TOL[dtype]}")
            errs[dtype] = (err, rel)
        # Timing at the main path's type (bf16).
        sets = _swa_inputs(b, w, pos, torch.bfloat16, heads, seed=2,
                           copies=copies)
        fn = lambda *a: swa_mod.swa_decode(  # noqa: E731
            *a, window=window, ring=ring)
        ms = time_ms(fn, sets)
        wrapper_ms = eager_ms(fn, sets)
        plain_ms = time_ms(lambda *a: kref.swa_decode_ref(
            *a, window=window, ring=ring), sets)
        valid = _swa_valid(b, w, pos, window, ring)
        sdpa_sets = [_swa_sdpa_inputs(*st[:3], valid) for st in sets[:2]]
        qs, kd, vd, mask = sdpa_sets[0]
        lib = F.scaled_dot_product_attention(qs, kd, vd, attn_mask=mask)
        want = kref.swa_decode_ref(*sets[0], window=window, ring=ring)
        lib_err = (lib.float() - want.reshape(lib.shape).float()).abs().max()
        library_ms = time_ms(lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mm), sdpa_sets)
        bound_ms, bound_by = _swa_bound(sets[0][0], valid, 2)
        plan = swa_mod.plan(b, heads[0], heads[2], w, torch.bfloat16)
        print(f"[swa] {label}: B={b} W={w} N={heads[0]} G={heads[1]} "
              f"D={heads[2]} window={window} "
              f"ring={ring} pos={pos} ({int(valid.sum())} valid slots); "
              f"{_plan_line(plan)}: "
              f"relative err f32 {errs[torch.float32][1]:.3g}, bf16 "
              f"{errs[torch.bfloat16][1]:.3g} (limits 1e-5, 1e-2); bf16 "
              f"kernel {ms:.5f} ms (eager through the wrapper "
              f"{wrapper_ms:.5f} ms), plain {plain_ms:.5f} ms, sdpa on the "
              f"dense cache {library_ms:.5f} ms (err {lib_err.item():.3g}), "
              f"bound {bound_ms:.5f} ms ({bound_by}), {bound_ms / ms:.1%} of "
              f"the bound")
        if entry is None:
            entry = {"name": "swa_decode", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/swa_decode.cu",
                     "replaces": "src/repro/kernels/swa_decode.py:160",
                     "launches": None,
                     "max_abs_err": errs[torch.bfloat16][0], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}
        del sets, sdpa_sets
    return entry


def _serve_dense(cfg, params, label):
    """Phase 3's stream on the dense engine; returns swa_decode's launches
    in the measured run (the count set to 0 just before it)."""
    stream = lambda n: build_stream(  # noqa: E731
        "poisson", n, vocab=cfg.vocab_size, seed=0, prompt_max=192,
        out_max=32, shared_prefix=32)
    engine = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                         device="cuda")
    engine.run(stream(2))                     # warm-up: cuBLAS, allocator
    engine.reset()
    reqs = stream(8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paged_before = pd_mod.paged_decode.launches
    swa_mod.swa_decode.launches = 0
    t0 = time.perf_counter()
    finished = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = swa_mod.swa_decode.launches
    stats = summarize(finished, wall)
    print(f"[serve dense] {label}: {stats['requests']}/8 requests, "
          f"{stats['tokens']} tokens in {stats['seconds']}s = "
          f"{stats['tok_per_sec']} tok/s; TTFT p50/p99 "
          f"{stats['ttft_p50_ms']}/{stats['ttft_p99_ms']} ms; ITL p50/p99 "
          f"{stats['itl_p50_ms']}/{stats['itl_p99_ms']} ms; cache "
          f"{engine.resident_cache_bytes()} B; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; swa_decode launches "
          f"{launches} over {engine.decode_ticks} decode ticks x "
          f"{cfg.num_layers} layers")
    check(len(finished) == 8, f"{label}: {len(finished)} of 8 requests served")
    for r in finished:
        want = min(r.max_new, MAX_LEN - len(r.prompt))
        check(len(r.out) == want,
              f"{label} r{r.rid}: {len(r.out)} tokens, want {want}")
        check(all(0 <= t < cfg.vocab_size for t in r.out),
              f"{label} r{r.rid}: token id outside the vocabulary")
    check(launches == cfg.num_layers * engine.decode_ticks > 0,
          f"{label}: swa_decode launched {launches} times, want "
          f"{cfg.num_layers} x {engine.decode_ticks}")
    check(pd_mod.paged_decode.launches == paged_before,
          f"{label}: the dense engine launched paged_decode")
    return launches


def phase_serve_dense():
    """Granite-3-2B at full width in bf16 on the dense engine, full caches
    and then --ring's config: returns swa_decode's launches in the
    full-cache run (the main path)."""
    cfg = registry.get_config("granite-3-2b")
    params = Transformer.init(cfg, 0, device="cuda")
    launches = _serve_dense(cfg, params, "full cache")
    ring = dataclasses.replace(cfg, sliding_window=32, ring_cache=True)
    _serve_dense(ring, params, "ring cache (window 32)")
    return launches


def _serve_swap(cfg, weights, reqs, device, swap_at=None, **kw):
    """Serve ``reqs``; with ``swap_at``, hot-swap to ``weights[1]`` before
    that tick.  Returns ({rid: tokens}, swap log)."""
    engine = ServeEngine(cfg, params_from_numpy(weights[0], device),
                         device=device, **kw)
    engine.begin(reqs)
    finished = []
    while engine.pending():
        if swap_at is not None and engine.ticks == swap_at:
            engine.hot_swap(params_from_numpy(weights[1], "cpu"))
        finished += engine.tick()
    return {r.rid: r.out for r in finished}, engine.swap_log


def phase_dense_parity():
    """Granite SMOKE in f32, TF32 off, on the dense engine: card vs CPU
    (full and ring caches), the card's dense vs paged engine, and a hot-swap
    at a fixed tick card vs CPU.  Greedy tokens must be equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = registry.get_smoke_config("granite-3-2b")
    weights = [params_to_numpy(Transformer.init(cfg, s, device="cpu"))
               for s in (1, 2)]
    stream = lambda: build_stream(  # noqa: E731
        "bursty", 10, vocab=cfg.vocab_size, seed=3, prompt_max=40,
        out_max=16, shared_prefix=16)
    kw = dict(slots=3, max_len=96)
    ring = dataclasses.replace(cfg, sliding_window=32, ring_cache=True)
    runs = {}
    for device in ("cpu", "cuda"):
        runs["full", device] = _serve_swap(cfg, weights, stream(), device, **kw)
        runs["ring", device] = _serve_swap(ring, weights, stream(), device,
                                           **kw)
        runs["swap", device] = _serve_swap(cfg, weights, stream(), device,
                                           swap_at=6, **kw)
    runs["paged", "cuda"] = _serve_swap(cfg, weights, stream(), "cuda",
                                        paged=True, page_size=8, **kw)
    n_tok = sum(len(o) for o in runs["full", "cpu"][0].values())
    for name, a, b in (("full card vs cpu", ("full", "cuda"), ("full", "cpu")),
                       ("ring card vs cpu", ("ring", "cuda"), ("ring", "cpu")),
                       ("dense vs paged on the card", ("full", "cuda"),
                        ("paged", "cuda")),
                       ("hot-swap at tick 6 card vs cpu", ("swap", "cuda"),
                        ("swap", "cpu"))):
        same = sum(runs[a][0][r] == runs[b][0][r] for r in runs[b][0])
        print(f"[dense parity] {cfg.name} f32, {name}: {same}/"
              f"{len(runs[b][0])} requests identical (swap logs "
              f"{runs[a][1]} / {runs[b][1]})")
        check(runs[a] == runs[b], f"dense parity: {name} differ")
    check(runs["swap", "cpu"][1] == [6], "dense parity: the swap never fired")
    check(runs["swap", "cpu"][0] != runs["full", "cpu"][0],
          "dense parity: the swap changed no token")
    print(f"[dense parity] {n_tok} tokens a run")


# -- the recurrent scans and recurrent serving ------------------------------

# The JAX package's own tolerance for its SSD kernel against its reference
# (tests/test_kernels.py): the kernel sums q-long dot products in another
# order than the plain version's einsums; exp(csum) reaches denormals.
TOL_SSD = 3e-4
# (label, b, s, h, p, n, g, chunk): Mamba-2 370m's serving shape (4 slots,
# 32 heads of 64, d_state 128, one group, chunk 128) at the stream's
# shortest and longest prompts, a prime length (chunk 1) and 2,048 tokens;
# SMOKE's heads (16 of 32, d_state 32, chunk 32).  The first is the main
# path's shape in the kernel table.
SSD_CASES = (
    ("serve s=224", SLOTS, 224, 32, 64, 128, 1, 128),
    ("serve s=32", SLOTS, 32, 32, 64, 128, 1, 128),
    ("serve s=151 (chunk 1)", SLOTS, 151, 32, 64, 128, 1, 128),
    ("serve s=2048", SLOTS, 2048, 32, 64, 128, 1, 128),
    ("smoke s=96", SLOTS, 96, 16, 32, 32, 1, 32),
)
# (label, B, S, D): RecurrentGemma-9B's d_rnn at the stream's longest prompt
# (the main path's shape in the kernel table), its shortest and 2,048
# tokens, one slot (a lone arrival); the JAX tests' D = 130 and their
# long-carry case.
RGLRU_CASES = (
    ("serve S=224", SLOTS, 224, 4096), ("serve S=32", SLOTS, 32, 4096),
    ("serve S=2048", SLOTS, 2048, 4096), ("one slot S=224", 1, 224, 4096),
    ("D=130", 2, 128, 130),
    ("long carry", 1, 384, 128),
)
L2_BYTES = 50 * 2 ** 20


def _ssd_inputs(b, s, h, p, n, g, seed=0, copies=1):
    """Sets of (x, dt, A, B, C) on the card: the JAX kernel test's
    distributions (x ~ N(0,1), dt = softplus(N(0,1)), A = -exp(0.3 N(0,1)),
    B and C ~ 0.5 N(0,1))."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    A = -torch.exp(0.3 * randn(h))
    return [(randn(b, s, h, p), F.softplus(randn(b, s, h)), A,
             0.5 * randn(b, s, g, n), 0.5 * randn(b, s, g, n))
            for _ in range(copies)]


def _ssd_bound(b, s, h, p, n, g, q):
    """Least times for one call, (f32 ms, tensor-core ms): the operations at
    the CUDA-core f32 peak (the reference is f32), and the same operations
    three times over (3xTF32) at the dense TF32 tensor-core peak; each
    against x, dt, A, B, C read once and y, the state written once,
    whichever is larger.  A chunk's scores C B^T belong to a B/C group, not
    a head: b g (s/q) q (q + 1) n operations, their causal half (j <= i, the
    terms the function needs).  Per head come the diagonal block's y (its
    causal half, q (q + 1) p), the carried state's y and the state update
    (dense, 2 q n p each): b h (s/q) (q (q + 1) p + 4 q n p)."""
    flops = (b * g * (s // q) * q * (q + 1) * n
             + b * h * (s // q) * (q * (q + 1) * p + 4 * q * n * p))
    bytes_ = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * g * n
                  + b * h * p * n)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    return tuple((max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
                  else "operations")
                 for t_ops in (flops / F32_FLOPS * 1e3,
                               3 * flops / TF32_FLOPS * 1e3))


def _ssd_smem_bytes(q, p, n):
    """The dynamic shared bytes a block of the call's kernel asks for, as
    the library computes them (``ssd_smem_bytes`` of ``csrc/ssd.cu``)."""
    fn = kbuild.load("ssd").ssd_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return fn(q, p, n)


def phase_ssd_kernel():
    """Returns the kernel-table entry of ssd at the main path's shape
    (launches filled in by the serve recurrent phase)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    entry = None
    for label, b, s, h, p, n, g, chunk in SSD_CASES:
        q = ssd_mod.chunk_size(chunk, s)
        # The C side's choice: the row kernel (p tiles of 64) at chunk 1,
        # else the chunk kernel (p tiles of 32 at p <= 32, else 64).
        kind = "row" if q == 1 else "chunk"
        tile = 32 if kind == "chunk" and p <= 32 else 64
        args = _ssd_inputs(b, s, h, p, n, g, seed=1)[0]
        y, state = ssd_mod.ssd(*args, q)
        torch.cuda.synchronize()
        wy, ws = kref.ssd_ref(*args, q)
        # Kernel and plain version against the same scan in f64.
        ey, es = kref.ssd_ref(*(a.double() for a in args), q)
        f64 = [((got.double() - ref).abs().max().item(),
                (plain.double() - ref).abs().max().item())
               for got, plain, ref in ((y, wy, ey), (state, ws, es))]
        del ey, es
        errs, tops = [], []
        for got, want, what in ((y, wy, "y"), (state, ws, "state")):
            check(got.shape == want.shape and got.dtype == torch.float32,
                  f"ssd {label} {what}: {tuple(got.shape)} {got.dtype}")
            diff = (got - want).abs()
            excess = (diff - TOL_SSD * (1 + want.abs())).max().item()
            check(math.isfinite(diff.max().item()) and excess <= 0,
                  f"ssd {label} {what}: max abs err {diff.max().item()} "
                  f"outside {TOL_SSD} abs + {TOL_SSD} rel")
            errs.append(diff.max().item())
            tops.append(want.abs().max().item())
        per_set = 4 * (2 * b * s * h * p + 2 * b * s * g * n)
        sets = _ssd_inputs(b, s, h, p, n, g, seed=2,
                           copies=max(1, -(-L2_BYTES // per_set)))
        ms = time_ms(lambda *a: ssd_mod.ssd(*a, q), sets, reps=5)
        plain_ms = time_ms(lambda *a: kref.ssd_ref(*a, q), sets, reps=5)
        (f32_ms, f32_by), (tc_ms, tc_by) = _ssd_bound(b, s, h, p, n, g, q)
        # The bound at the precision the kernel runs: 3xTF32 on tensor
        # cores (chunk kernel) or f32 FMAs on CUDA cores (row kernel).
        bound_ms, bound_by = (tc_ms, tc_by) if kind == "chunk" else (
            f32_ms, f32_by)
        print(f"[ssd] {label}: b={b} s={s} h={h} p={p} n={n} g={g} chunk "
              f"{q}: {kind} kernel, p tile {tile}, {b * h * -(-p // tile)} "
              f"blocks, {_ssd_smem_bytes(q, p, n)} B shared; max abs err y {errs[0]:.3g} "
              f"(largest |y| {tops[0]:.3g}), state {errs[1]:.3g} (largest "
              f"|state| {tops[1]:.3g}) (limit {TOL_SSD} abs + {TOL_SSD} "
              f"rel); against f64: kernel y {f64[0][0]:.3g}, state "
              f"{f64[1][0]:.3g}, plain f32 y {f64[0][1]:.3g}, state "
              f"{f64[1][1]:.3g}; "
              f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms; bounds: f32 "
              f"CUDA cores {f32_ms:.5f} ms ({f32_by}, {f32_ms / ms:.1%}), "
              f"3xTF32 tensor cores {tc_ms:.5f} ms ({tc_by}, "
              f"{tc_ms / ms:.1%}); the kernel's precision: "
              f"{'3xTF32' if kind == 'chunk' else 'f32'}, "
              f"{bound_ms / ms:.1%} of its bound; library: none (no PyTorch "
              f"call computes the SSD scan)")
        if entry is None:
            entry = {"name": "ssd", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/ssd.cu",
                     "replaces": "src/repro/kernels/ssd.py:73",
                     "launches": None, "max_abs_err": max(errs), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None}
        del sets
    return entry


def _rglru_inputs(b, s, d, seed=0, copies=1):
    """Sets of (a, b) on the card: a = sigmoid(N(0,1)), b ~ N(0,1) (the
    JAX kernel tests' distributions)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [(torch.sigmoid(torch.randn((b, s, d), generator=gen,
                                       device="cuda")),
             torch.randn((b, s, d), generator=gen, device="cuda"))
            for _ in range(copies)]


def phase_rglru_kernel():
    """Returns the kernel-table entry of rglru at the main path's shape
    (launches filled in by the serve recurrent phase)."""
    entry = None
    for label, b, s, d in RGLRU_CASES:
        a, x = _rglru_inputs(b, s, d, seed=1)[0]
        got = rglru_mod.rglru(a, x)
        torch.cuda.synchronize()
        want = kref.rglru_ref(a, x)
        check(got.shape == want.shape and got.dtype == torch.float32,
              f"rglru {label}: {tuple(got.shape)} {got.dtype}")
        diff = (got - want).abs()
        err = diff.max().item()
        excess = (diff - 1e-5 * (1 + want.abs())).max().item()
        check(math.isfinite(err) and excess <= 0,
              f"rglru {label}: max abs err {err} outside 1e-5 abs + 1e-5 rel")
        bytes_ = 12 * b * s * d
        sets = _rglru_inputs(b, s, d, seed=2,
                             copies=max(1, -(-L2_BYTES // bytes_)))
        ms = time_ms(lambda *a: rglru_mod.rglru(*a), sets)
        plain_ms = time_ms(lambda *a: kref.rglru_ref(*a), sets)
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * b * s * d / F32_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"[rglru] {label}: B={b} S={s} D={d}: max abs err {err:.3g} "
              f"(limit 1e-5 abs + 1e-5 rel); kernel {ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
              f"{bound_ms / ms:.1%} of the bound; library: none (no PyTorch "
              f"call computes a linear recurrence)")
        if entry is None:
            entry = {"name": "rglru", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/rglru.cu",
                     "replaces": "src/repro/kernels/rglru.py:40",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None}
        del sets
    return entry


def count_prefills(engine):
    """Wrap the engine's admission step so that each prefill it runs is
    counted; returns the list that grows by one a prefill."""
    admit, calls = engine._admit_fn, []

    def counted(*a, **k):
        calls.append(1)
        return admit(*a, **k)

    engine._admit_fn = counted
    return calls


def _serve_recurrent(arch):
    """Phase 3's stream on the dense engine with ``arch`` at full width and
    depth in bf16, after a two-request warm-up.  Returns every serving
    kernel's launches in the measured run (each count set to 0 just before
    it) and the parameter count."""
    cfg = registry.get_config(arch)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = Transformer.init(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve recurrent] {cfg.name}: {n_params / 1e9:.3f} B parameters "
          f"in {cfg.param_dtype} initialised on the card in "
          f"{time.perf_counter() - t0:.2f}s")
    stream = lambda n: build_stream(  # noqa: E731
        "poisson", n, vocab=cfg.vocab_size, seed=0, prompt_max=192,
        out_max=32, shared_prefix=32)
    engine = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                         device="cuda")
    engine.run(stream(2))                     # warm-up: cuBLAS, allocator
    engine.reset()
    prefills = count_prefills(engine)
    reqs = stream(8)
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)]
             for i in range(cfg.num_layers)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (ssd_mod.ssd, rglru_mod.rglru, swa_mod.swa_decode,
               pd_mod.paged_decode):
        fn.launches = 0
    t0 = time.perf_counter()
    finished = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in (
        ssd_mod.ssd, rglru_mod.rglru, swa_mod.swa_decode, pd_mod.paged_decode)}
    stats = summarize(finished, wall)
    print(f"[serve recurrent] {cfg.name}: {stats['requests']}/8 requests, "
          f"{stats['tokens']} tokens in {stats['seconds']}s = "
          f"{stats['tok_per_sec']} tok/s; TTFT p50/p99 "
          f"{stats['ttft_p50_ms']}/{stats['ttft_p99_ms']} ms; ITL p50/p99 "
          f"{stats['itl_p50_ms']}/{stats['itl_p99_ms']} ms; recurrent state "
          f"+ cache {engine.resident_cache_bytes()} B; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; {len(prefills)} prefills, "
          f"{engine.decode_ticks} decode ticks; launches {launches}")
    check(len(finished) == 8, f"{cfg.name}: {len(finished)} of 8 requests")
    for r in finished:
        want = min(r.max_new, MAX_LEN - len(r.prompt))
        check(len(r.out) == want,
              f"{cfg.name} r{r.rid}: {len(r.out)} tokens, want {want}")
        check(all(0 <= t < cfg.vocab_size for t in r.out),
              f"{cfg.name} r{r.rid}: token id outside the vocabulary")
    want = {"ssd": kinds.count("ssd") * len(prefills),
            "rglru": kinds.count("rglru") * len(prefills),
            "swa_decode": kinds.count("local") * engine.decode_ticks,
            "paged_decode": 0}
    check(launches == want and len(prefills) > 0,
          f"{cfg.name}: launches {launches}, want {want}")
    del engine, params
    torch.cuda.empty_cache()
    return launches, n_params


def phase_serve_recurrent():
    """Mamba-2 370m and then RecurrentGemma-9B at full width in bf16 on the
    dense engine: returns (ssd launches, rglru launches, RecurrentGemma-9B's
    parameter count)."""
    mamba, _ = _serve_recurrent("mamba2-370m")
    rg, rg_params = _serve_recurrent("recurrentgemma-9b")
    return mamba["ssd"], rg["rglru"], rg_params


# (rid, arrival, prompt length, max_new): three arrivals at tick 0 with two
# equal lengths and one prime length above ssm_chunk (32), two more at tick
# 1 (64: two chunks; 41: prime) waiting for slots, and a late short one.
PARITY_SCHEDULE = ((0, 0, 37, 6), (1, 0, 12, 5), (2, 0, 12, 7),
                   (3, 1, 64, 4), (4, 1, 41, 5), (5, 4, 12, 3))


def phase_recurrent_parity():
    """Both recurrent SMOKE configs in f32, TF32 off: the card's dense
    engine against the CPU's from the same weights.  Greedy tokens must be
    equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in ("mamba2-370m", "recurrentgemma-9b"):
        cfg = registry.get_smoke_config(arch)
        weights = params_to_numpy(Transformer.init(cfg, 1, device="cpu"))

        def schedule():
            rng = np.random.default_rng(17)
            return [Request(rid=r, arrival=a, max_new=m, prompt=rng.integers(
                0, cfg.vocab_size - 1, size=n)) for r, a, n, m in
                PARITY_SCHEDULE]

        streams = {"schedule": schedule,
                   "bursty": lambda: build_stream(
                       "bursty", 8, vocab=cfg.vocab_size, seed=3,
                       prompt_max=40, out_max=12)}
        for name, reqs in streams.items():
            outs = {}
            for device in ("cpu", "cuda"):
                engine = ServeEngine(cfg, params_from_numpy(weights, device),
                                     slots=3, max_len=96, device=device)
                prefills = count_prefills(engine)
                outs[device] = ({r.rid: r.out for r in engine.run(reqs())},
                                len(prefills))
            n_tok = sum(len(o) for o in outs["cpu"][0].values())
            same = sum(outs["cpu"][0][r] == outs["cuda"][0][r]
                       for r in outs["cpu"][0])
            print(f"[recurrent parity] {cfg.name} f32, {name}: {same}/"
                  f"{len(outs['cpu'][0])} requests ({n_tok} tokens, "
                  f"{outs['cpu'][1]} prefills) identical card vs CPU")
            check(outs["cpu"] == outs["cuda"],
                  f"recurrent parity: {cfg.name} {name} differ card vs CPU")


# -- the dense archs on the layers the port already had ----------------------

DENSE_ARCHS = ("qwen3-14b", "qwen1.5-4b", "nemotron-4-340b", "qwen2-vl-72b")
# What a full-width serve run needs besides its parameters: the prefill's
# f32 logits over up to 4 x 256 tokens (1.05 GB at Nemotron's 256,000-token
# vocabulary) and their bf16 product, the MLP's intermediate, the caches,
# the 1 GiB f32 draw of Transformer.init, cuBLAS and the CUDA context.
SERVE_RESERVE = 12e9


def _decode_heads(cfg):
    return cfg.kv_heads, cfg.num_heads // cfg.kv_heads, cfg.hd


def phase_decode_archs():
    """swa_decode and paged_decode against their plain versions (f32 and
    bf16; phases 13 and 2's tolerances) on the 4-slot x 512-position cache
    at each dense arch's (N, G, D), each timed beside its bound, its plain
    version and SDPA; enough copies of the caches that a timed set exceeds
    the L2, as a full stack of layers does."""
    for arch in DENSE_ARCHS:
        n, g, d = heads = _decode_heads(registry.get_config(arch))
        copies = -(-L2_BYTES // (2 * SLOTS * MAX_LEN * n * d * 2)) + 1
        phase_swa_kernel(((f"{arch} 4 x 512", SLOTS, MAX_LEN, None, False,
                           [0, 170, 341, 511], copies, heads),))
        for dtype in (torch.float32, torch.bfloat16):
            for window in (None, 100):
                err, rel = _check_paged(arch, _serving_case(
                    dtype, seed=6, heads=heads), window, dtype)
                print(f"[kernel] paged_decode {arch} N={n} G={g} D={d} "
                      f"{str(dtype).split('.')[-1]} window={window}: max abs "
                      f"err {err:.3g}, relative {rel:.3g}")
        pool = (pages_for(MAX_LEN, PAGE) * SLOTS + 1) * PAGE * n * d * 2 * 2
        _time_paged(f"{arch} 4 x 512", _serving_case(
            torch.bfloat16, seed=7, copies=-(-L2_BYTES // pool) + 1,
            heads=heads))
        torch.cuda.empty_cache()


def _param_bytes(cfg):
    """(bytes a layer, bytes outside the layers) of an attention-only arch,
    from its shapes, in its parameter dtype: a dense MLP, or a MoE's
    stacked experts (gate, up, down), its shared experts (a gated MLP of
    ``expert_dim x shared_experts``) and its router, which is f32 in any
    parameter dtype."""
    d, h, n, hd, ff = (cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hd,
                       cfg.d_ff)
    attn = 2 * d * h * hd + 2 * d * n * hd
    attn += (h + 2 * n) * hd if cfg.qkv_bias else 0
    attn += 2 * hd if cfg.qk_norm else 0
    norms = 2 * d * (2 if cfg.norm == "layernorm" else 1)
    size = torch.finfo(cfg.pdt).bits // 8
    router = 0
    if cfg.mlp == "moe":
        mlp = 3 * cfg.num_experts * d * cfg.expert_dim
        mlp += 3 * d * cfg.expert_dim * cfg.shared_experts
        router = d * cfg.num_experts * 4
    else:
        mlp = (3 if cfg.mlp == "swiglu" else 2) * d * ff
    return ((attn + norms + mlp) * size + router,
            (2 * cfg.padded_vocab * d + norms // 2) * size)


def _serve_depth(cfg):
    """``cfg`` at full width with as many layers as one card holds beside
    SERVE_RESERVE; prints the cut and why."""
    layer, fixed = _param_bytes(cfg)
    total = torch.cuda.get_device_properties(0).total_memory
    fit = int((total - SERVE_RESERVE - fixed) // layer)
    full = fixed + cfg.num_layers * layer
    if fit >= cfg.num_layers:
        print(f"[serve archs] {cfg.name}: full depth, {cfg.num_layers} layers "
              f"({full / 1e9:.2f} GB of {cfg.param_dtype} parameters on a "
              f"{total / 1e9:.1f} GB card)")
        return cfg
    check(fit >= 1, f"{cfg.name}: not one layer fits")
    print(f"[serve archs] {cfg.name}: depth cut to {fit} of {cfg.num_layers} "
          f"layers at full width: {layer / 1e9:.3f} GB a layer and "
          f"{fixed / 1e9:.2f} GB of embedding and output projection in "
          f"{cfg.param_dtype} ({full / 1e9:.1f} GB at full depth) against the "
          f"card's {total / 1e9:.1f} GB less {SERVE_RESERVE / 1e9:.0f} GB "
          f"for activations, caches and the init's draw")
    return dataclasses.replace(cfg, num_layers=fit)


def phase_serve_archs():
    """Each dense arch at full width in bf16 (depth cut to what one card
    holds) on phase 3's stream, dense then paged, each checked to launch
    its decode kernel layers x ticks times and the other kernel never; the
    card is freed between archs."""
    for arch in DENSE_ARCHS:
        cfg = _serve_depth(registry.get_config(arch))
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = Transformer.init(cfg, 0, device="cuda")
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        layer, fixed = _param_bytes(cfg)
        check(sum(t.numel() * t.element_size() for t in _leaves(params))
              == fixed + cfg.num_layers * layer,
              f"{arch}: parameter bytes differ from the count by shapes")
        print(f"[serve archs] {cfg.name}: {n_params / 1e9:.3f} B parameters "
              f"({cfg.num_layers} layers) in {cfg.param_dtype} initialised on "
              f"the card in {time.perf_counter() - t0:.2f}s ({before} B "
              f"allocated before); max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()} B")
        label = f"{cfg.name} ({cfg.num_layers} of {arch} layers)"
        _serve_dense(cfg, params, label)
        _serve_paged(cfg, params, label)
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _redrawn(weights, seed):
    """Biases around 0 and norm scales around 1, which the init sets to 0
    and 1 (where a bias or a scale left out would go unseen)."""
    rng = np.random.default_rng(seed)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        noise = (0.1 * rng.standard_normal(tree.shape)).astype(tree.dtype)
        if path[-1] in ("bq", "bk", "bv") or (
                path[-1] == "bias" and path[-2] != "mixer"):
            return noise
        if path[-1] in ("q_norm", "k_norm", "scale"):
            return 1 + noise
        return tree

    return walk(weights, ())


def _vision_batch(cfg, seed=9):
    """Two 20-token prompts, each with a 2 x 3 patch grid scattered in over
    rows 4-9 / 10-15, and Qwen2-VL's (t, h, w) positions for them."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size - 1, size=(2, 20))
    positions = np.zeros((2, 3, 20), np.int64)
    vpos = np.zeros((2, 6), np.int64)
    for row, start in enumerate((4, 10)):
        vpos[row] = start + np.arange(6)
        positions[row, :, :start] = np.arange(start)
        positions[row, 0, start:start + 6] = start
        positions[row, 1, start:start + 6] = start + np.arange(6) // 3
        positions[row, 2, start:start + 6] = start + np.arange(6) % 3
        positions[row, :, start + 6:] = start + 3 + np.arange(14 - start)
    return {"tokens": tokens, "positions": positions,
            "vision_positions": vpos,
            "vision_embeds": rng.standard_normal((2, 6, cfg.d_model))}


def _arch_parity(arch, dense_equals_paged=True):
    """``arch``'s SMOKE config in f32 (TF32 off), biases and norm scales
    redrawn: phase 4's stream served dense and paged on the card and on the
    CPU from the same weights, greedy tokens equal; with
    ``dense_equals_paged`` the card's dense engine must also equal its paged
    one (not for MoE archs: their expert capacity couples the rows of a
    batch, and the two engines batch their prefills differently)."""
    cfg = registry.get_smoke_config(arch)
    weights = _redrawn(params_to_numpy(Transformer.init(cfg, 1,
                                                        device="cpu")), 5)
    stream = lambda: build_stream(  # noqa: E731
        "bursty", 10, vocab=cfg.vocab_size, seed=3, prompt_max=40,
        out_max=16, shared_prefix=16)
    outs = {}
    for device in ("cpu", "cuda"):
        for paged in (False, True):
            engine = ServeEngine(cfg, params_from_numpy(weights, device),
                                 slots=3, max_len=96, paged=paged,
                                 page_size=8, device=device)
            outs[device, paged] = {r.rid: r.out for r in engine.run(stream())}
    n_tok = sum(len(o) for o in outs["cpu", False].values())
    for paged in (False, True):
        mode = "paged" if paged else "dense"
        same = sum(outs["cpu", paged][r] == outs["cuda", paged][r]
                   for r in outs["cpu", paged])
        print(f"[archs parity] {cfg.name} f32 {mode}: {same}/"
              f"{len(outs['cpu', paged])} requests ({n_tok} tokens) "
              f"identical card vs CPU")
        check(outs["cpu", paged] == outs["cuda", paged],
              f"archs parity: {cfg.name} {mode} differ card vs CPU")
    if dense_equals_paged:
        check(outs["cuda", False] == outs["cuda", True],
              f"archs parity: {cfg.name} dense vs paged differ on the card")
    return cfg, weights


def phase_archs_parity():
    """Each dense arch's SMOKE config (``_arch_parity``), and qwen2-vl's
    prefill with vision embeddings at three different position streams,
    logits card vs CPU within 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in DENSE_ARCHS:
        cfg, weights = _arch_parity(arch)
        if cfg.is_vlm:
            batch = _vision_batch(cfg)
            logits = {}
            for device in ("cpu", "cuda"):
                tb = {k: torch.from_numpy(v).to(device) for k, v in
                      batch.items()}
                tb["vision_embeds"] = tb["vision_embeds"].float()
                logits[device] = Transformer.prefill(
                    cfg, params_from_numpy(weights, device), tb, 64)[0].cpu()
            err = (logits["cuda"] - logits["cpu"]).abs().max().item()
            print(f"[archs parity] {cfg.name} f32 prefill with vision "
                  f"embeds (M-RoPE t/h/w streams): max abs logit diff card "
                  f"vs CPU {err:.3g} (limit 1e-4)")
            check(err <= 1e-4, f"{cfg.name}: vision prefill differs by {err}")


# -- MoE serving and LLM-scale Phase 2 -----------------------------------------

MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b")


def phase_serve_moe():
    """Both MoE archs at full width in bf16 (depth cut to what one card
    holds, printed) on phase 3's stream, dense then paged: each run checked
    to launch its decode kernel layers x ticks times and the other kernel
    never; the parameter bytes counted from the shapes (experts, shared
    experts, f32 router) equal the drawn tensors'.  Every MoE tick runs the
    reference's one-hot dispatch, which reads every expert's weights.
    Returns {arch: (dense launches, paged launches)}."""
    out = {}
    for arch in MOE_ARCHS:
        cfg = _serve_depth(registry.get_config(arch))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = Transformer.init(cfg, 0, device="cuda")
        torch.cuda.synchronize()
        layer, fixed = _param_bytes(cfg)
        drawn = sum(t.numel() * t.element_size() for t in _leaves(params))
        check(drawn == fixed + cfg.num_layers * layer,
              f"{arch}: parameter bytes {drawn} differ from the count by "
              f"shapes {fixed + cfg.num_layers * layer}")
        check(params["blocks"]["b0"]["mlp"]["router"].dtype == torch.float32,
              f"{arch}: the router is not f32")
        print(f"[serve moe] {cfg.name}: "
              f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
              f"parameters ({drawn / 1e9:.2f} GB; {cfg.num_layers} layers of "
              f"{cfg.num_experts} experts, top-{cfg.top_k}, "
              f"{cfg.shared_experts} shared) initialised on the card in "
              f"{time.perf_counter() - t0:.2f}s; a decode tick's capacity "
              f"{math.ceil(SLOTS * cfg.top_k * cfg.moe_capacity_factor / cfg.num_experts)}"
              f" token(s) an expert at {SLOTS} slots")
        label = f"{cfg.name} ({cfg.num_layers} of {arch} layers)"
        out[arch] = (_serve_dense(cfg, params, label),
                     _serve_paged(cfg, params, label))
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out


def phase_moe_parity():
    """Both MoE SMOKE configs (``_arch_parity``, f32, TF32 off): dense and
    paged engines, card vs CPU, token-exact."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in MOE_ARCHS:
        _arch_parity(arch, dense_equals_paged=False)


LLM_ARGV = ["--rounds", "2", "--edges", "2", "--steps-per-phase", "3",
            "--batch", "8", "--seq", "64"]
_PHASE_S = re.compile(r"\[phase0\] loss=\S+ \((\S+)s\)|\(phase1 (\S+)s\)"
                      r"|\(phase2 (\S+)s, (\S+) steps/s\)")


def _train(argv, seen=None):
    """``repro_torch.launch.train.main(argv)`` with its output echoed and
    returned; the kd pair's launches in the run (counts set to 0 just
    before it and read just after).  With a list ``seen``, the inputs of
    the run's first ``ops.kd_loss`` call (int64 labels, s, t, b, tau;
    copies, as the kernels receive them) are appended to it."""
    real = ops.kd_loss

    def kd_loss(y, s, t, b=None, tau=2.0):
        if seen is not None and not seen:
            seen.append((y.long(),) + tuple(
                None if a is None else a.detach().clone() for a in (s, t, b))
                + (tau,))
        return real(y, s, t, b, tau)

    for c in KD_COUNTERS.values():
        c.launches = 0
    buf = io.StringIO()
    ops.kd_loss = kd_loss
    try:
        with contextlib.redirect_stdout(buf):
            params = train.main(argv)
    finally:
        ops.kd_loss = real
    launches = {n: c.launches for n, c in KD_COUNTERS.items()}
    print(buf.getvalue(), end="")
    return params, buf.getvalue(), launches


def phase_llm_phase2():
    """Granite-3-2B's LLM Phase 2 at full width and depth
    (``launch.train --full --method bkd``, bf16, AdamW, --loss-backend auto:
    the kd pair on the card): Phase 0/1/2 seconds, Phase-2 steps/s and peak
    memory printed; the kd pair launched once a Phase-2 step each (one
    loss chunk: --seq 64 = the loss chunk) and the quant pair never.  The
    pair is then held against its plain version (``_check_kd_on``, phase
    5's f32 limit) on the first Phase-2 step's own inputs: 512 rows of
    Granite's padded vocabulary (49,408 columns, the 253 past 49,155 at
    -1e30), with buffer.  Then an A/B of the Phase-2 step, 'pallas' (the kd pair) against 'jnp'
    (the plain loss), in turns on one set of weights.  Returns the pair's
    launches in the driver run."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--full", "--arch", "granite-3-2b", "--method", "bkd",
            "--device", "cuda"] + LLM_ARGV
    t0 = time.perf_counter()
    seen = []
    params, out, launches = _train(argv, seen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = 2 * 3
    p0, p1, p2, rate = [], [], [], []
    for m in _PHASE_S.finditer(out):
        for lst, v in zip((p0, p1, p2, rate), m.groups()):
            if v is not None:
                lst.append(float(v))
    print(f"[llm phase2] granite-3-2b full width, 40 layers, bf16, batch 8 x "
          f"64 tokens, {steps} Phase-2 steps in {wall:.1f}s: phase 0 "
          f"{p0} s, phase 1 {p1} s, phase 2 {p2} s = {rate} steps/s; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B of "
          f"{torch.cuda.get_device_properties(0).total_memory} B; launches "
          f"{launches} for {steps} Phase-2 steps of 1 loss chunk")
    want = {"kd_stats_fwd": steps, "kd_grad_bwd": steps,
            "kd_quant_stats_fwd": 0, "kd_quant_grad_bwd": 0}
    check(launches == want, f"llm phase2: launches {launches}, want {want}")
    check(len(p2) == 2 and len(p1) == 2 and len(p0) == 1,
          f"llm phase2: phase lines missing in {out!r}")
    check(all(math.isfinite(float(v)) for v in re.findall(
        r"loss=(\S+)", out)), "llm phase2: a non-finite loss")
    del params
    torch.cuda.empty_cache()
    y, s, t, b, tau = seen[0]
    cfg = registry.get_config("granite-3-2b")
    pad = s.shape[1] - cfg.vocab_size
    check(b is not None and s.dtype == torch.float32 and pad > 0
          and bool((s[:, cfg.vocab_size:] <= -1e30).all()),
          f"llm phase2: kd inputs {tuple(s.shape)} {s.dtype} pad {pad}")
    gen = torch.Generator(device="cuda").manual_seed(27)
    g = torch.rand(s.shape[0], generator=gen, device="cuda") + 0.5
    _check_kd_on(f"llm phase2 main-path inputs rows={s.shape[0]} "
                 f"V={s.shape[1]} f32 buffer=True pad={pad}", y, s, t, b, g,
                 tau)
    del seen, y, s, t, b
    _llm_phase2_ab(cfg)
    return launches["kd_stats_fwd"], launches["kd_grad_bwd"]


def _llm_phase2_ab(cfg, pairs=3):
    """Phase-2 step seconds (AdamW, donated) with 'pallas' and 'jnp' in
    turns (pallas, jnp, jnp, pallas, ...) from one start state, after one
    warm-up step each; the kd pair must launch once a 'pallas' step and
    never in a 'jnp' step."""
    student = Transformer.init(cfg, 0, device="cuda")
    teacher = Transformer.init(cfg, 1, device="cuda")
    buffer = train._copy(student)
    opt = optimizers.adamw(3e-4)
    state = opt.init(student)
    data, _ = make_token_stream(cfg.vocab_size, 64, 65, seed=0)
    batches = train.lm_batches(data, 8, 64, 4 * pairs + 2, 0, "cuda")
    steps = {b: St.make_phase2_step(cfg, opt, loss_chunk=64, loss_backend=b)
             for b in ("pallas", "jnp")}
    times = {"pallas": [], "jnp": []}
    order = ["pallas", "jnp"] + [b for i in range(pairs) for b in (
        ("pallas", "jnp", "jnp", "pallas") if i % 2 == 0 else
        ("jnp", "pallas", "pallas", "jnp"))][:4 * pairs]
    torch.cuda.reset_peak_memory_stats()
    for i, (backend, batch) in enumerate(zip(order, batches)):
        kd_mod.kd_stats_fwd.launches = kd_mod.kd_grad_bwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        student, state, m = steps[backend](student, teacher, buffer, state,
                                           batch, i)
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        n = (kd_mod.kd_stats_fwd.launches, kd_mod.kd_grad_bwd.launches)
        check(n == ((1, 1) if backend == "pallas" else (0, 0)),
              f"phase-2 A/B: {backend} step launched the kd pair {n} times")
        check(math.isfinite(loss), f"phase-2 A/B: {backend} loss {loss}")
        if i >= 2:
            times[backend].append(dt)
    med = {b: float(np.median(v)) for b, v in times.items()}
    print(f"[llm phase2] A/B on one set of weights, turns {order[2:]}: "
          f"Phase-2 step s pallas {[round(t, 4) for t in times['pallas']]} "
          f"(median {med['pallas']:.4f}), jnp "
          f"{[round(t, 4) for t in times['jnp']]} (median {med['jnp']:.4f}); "
          f"jnp / pallas {med['jnp'] / med['pallas']:.3f}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    del student, teacher, buffer, state
    torch.cuda.empty_cache()


def _train_on_start_state(weights, argv):
    """``train.main(argv)`` with ``Transformer.init`` handing out
    ``weights`` (one start state on both devices)."""
    real = Transformer.init
    Transformer.init = staticmethod(
        lambda cfg, seed=0, *, device="cuda": params_from_numpy(weights,
                                                                device))
    try:
        return _train(argv)
    finally:
        Transformer.init = real


_NUMBERS = re.compile(r"(loss|kd|domain)[=:] ?(-?\d+\.\d+)")


_ROUND_LINE = re.compile(r"\[round \d+\] edge \d+ trained( stale=\S+)?"
                         r"( t=\S+)?,")


def phase_llm_parity():
    """The LLM driver on granite's and phi3.5-moe's SMOKE configs (f32,
    TF32 off; phi with its MoE aux loss) on the card and on the CPU from one
    start state: every printed loss (Phase 0, each round's edge and Phase 2,
    the final NLL) within 2e-4 (one unit of the last printed digit either
    way); the card's Phase 2 through the kd pair.  Then granite with the
    slice-7 plan sources, ``--sim async:heavy_tail`` and ``--sim
    fleet:uniform`` (3 rounds over 3 edges, distill-on-arrival): the same
    edges, staleness and event times, the printed losses within 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = ["--method", "bkd", "--steps-per-phase", "3", "--batch", "4",
            "--seq", "32"]
    sim = ["--rounds", "3", "--edges", "3", "--sim"]
    for arch, extra, limit in (
            ("granite-3-2b", ["--rounds", "2", "--edges", "2"], 2e-4),
            ("phi3.5-moe-42b-a6.6b", ["--rounds", "2", "--edges", "2"], 2e-4),
            ("granite-3-2b", sim + ["async:heavy_tail"], 1e-4),
            ("granite-3-2b", sim + ["fleet:uniform"], 1e-4)):
        cfg = registry.get_smoke_config(arch)
        weights = params_to_numpy(Transformer.init(cfg, 2, device="cpu"))
        argv = ["--arch", arch] + base + extra
        runs = {dev: _train_on_start_state(weights, argv + ["--device", dev])
                for dev in ("cpu", "cuda")}
        nums = {dev: [(k, float(v)) for k, v in _NUMBERS.findall(r[1])]
                for dev, r in runs.items()}
        diff = max(abs(a - b) for (_, a), (_, b) in zip(nums["cpu"],
                                                        nums["cuda"]))
        rounds = {dev: _ROUND_LINE.findall(r[1]) for dev, r in runs.items()}
        label = f"{cfg.name} f32 bkd {' '.join(extra)}"
        print(f"[llm parity] {label}: {len(nums['cpu'])} printed losses card "
              f"vs CPU, max abs diff {diff:.2g} (limit {limit:g}); rounds "
              f"(staleness, event time) {rounds['cuda']}; card launches "
              f"{runs['cuda'][2]}")
        check([k for k, _ in nums["cpu"]] == [k for k, _ in nums["cuda"]]
              and len(nums["cpu"]) >= 6, f"llm parity: {label} lines")
        check(rounds["cpu"] == rounds["cuda"]
              and len(rounds["cuda"]) == int(extra[1]),
              f"llm parity: {label} rounds {rounds}")
        check(diff <= limit + 1e-9, f"llm parity: {label} differs by {diff}")
        steps = 3 * int(extra[1])
        check(runs["cuda"][2]["kd_stats_fwd"] == steps > 0,
              f"llm parity: {label} launches {runs['cuda'][2]}")


def phase_kernels_bench():
    """The port's ``kernels_bench`` on the card: the fused KD loss (the kd
    pair) against the plain loss's autograd at 256 x 8,192 f32, and the
    ``rglru`` and ``ssd`` kernels against their plain versions."""
    out = kernels_bench.main(device="cuda")
    print(f"[kernels bench] {out}")
    check(out["kd_parity"] <= 1e-4
          and out["kd_grad_err"] <= 1e-5 * out["kd_grad_scale"],
          f"kernels bench: kd loss {out}")
    check(out["rglru_err"] <= 1e-5, f"kernels bench: rglru {out}")
    check(out["ssd_err"] <= TOL_SSD * (1.0 + out["ssd_scale"]),
          f"kernels bench: ssd {out}")


# -- slice 7: asynchronous and hierarchical FL -------------------------------

#: (method, scenario) runs of phase 31, each ASYNC_ROUNDS core rounds at
#: R = 2 over 6 edges (``_hier_regions(6)``: 2 regions of 3 edges).
ASYNC_RUNS = (("bkd", "async_heavy_tail"), ("bkd", "hier_uniform"),
              ("kd", "async_heavy_tail"))
ASYNC_ROUNDS = 3


def _fl_async_run(silos, method, scenario, rounds=ASYNC_ROUNDS, r=2):
    """One ResNet-32 federation over a simulator's plan stream; returns the
    kd kernels' launches in it (counts set to 0 just before the run and
    read just after), which must equal the Phase-2 steps the stream implies:
    every plan (flat rounds; region and core rounds) is one distill
    round."""
    core, edges, test = silos
    cfg = FLConfig(num_edges=len(edges), rounds=rounds, aggregation_r=r,
                   method=method, core_epochs=2, edge_epochs=2, kd_epochs=2,
                   batch_size=128, lr=0.1, kd_lr=0.02, tau=2.0,
                   loss_backend="auto")
    sim = build_scenario(scenario, len(edges), aggregation_r=r)
    plans = sim.plans(rounds)
    stats = dict(sim.stats)
    fl = FederatedKD(resnet_adapter(RESNET32), cfg, core, edges, test,
                     scheduler=sim, device="cuda")
    times = {"phase0": 0.0, "phase1": 0.0}
    _timed(fl, "pretrain_core", times, "phase0")
    _timed(fl, "train_round_edges", times, "phase1")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in KD_COUNTERS.values():
        c.launches = 0
    t0 = time.perf_counter()
    _, hist = fl.run(0, log=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in KD_COUNTERS.items()}
    per_round = cfg.kd_epochs * max(len(core) // min(cfg.batch_size,
                                                     len(core)), 1)
    steps = len(plans) * per_round
    phase2 = wall - times["phase0"] - times["phase1"]
    name = f"{method} {scenario} R={r}"
    teachers = sum(len(p.tasks) for p in plans
                   if getattr(p, "level", "") != "core")
    print(f"[fl async] {name}: timeline dispatches {stats['dispatches']}, "
          f"mean staleness {stats['mean_staleness']:.4f}, max staleness "
          f"{stats['max_staleness']}, makespan {stats['makespan']:.4f}, "
          f"region rounds {stats.get('region_rounds', 0)}; {len(plans)} "
          f"distill rounds, {teachers} edge trainings")
    for h in hist:
        print(f"[fl async] {name} round {h.round}: edges {h.edges} "
              f"staleness {h.staleness} test_acc {h.test_acc:.4f} "
              f"acc_cur_edge {h.acc_cur_edge:.4f}")
    print(f"[fl async] {name}: {rounds} core rounds in {wall:.2f}s: phase 0 "
          f"{times['phase0']:.2f}s, phase 1 {times['phase1']:.2f}s, phase 2 "
          f"(with the rounds' metrics passes) {phase2:.2f}s = "
          f"{steps / phase2:.2f} Phase-2 steps/s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; launches {launches} for "
          f"{steps} Phase-2 steps")
    want = {"kd_stats_fwd": steps, "kd_grad_bwd": steps,
            "kd_quant_stats_fwd": 0, "kd_quant_grad_bwd": 0}
    check(launches == want and steps > 0,
          f"{name}: kernel launches {launches}, want {want}")
    check(len(hist) == rounds, f"{name}: {len(hist)} of {rounds} core rounds")
    if scenario.startswith("async_heavy_tail"):
        check(stats["max_staleness"] > 0, f"{name}: no stale teacher {stats}")
    if scenario in HIER_SCENARIOS:
        check(stats["region_rounds"] == len(plans) - rounds > 0,
              f"{name}: region rounds {stats}")
    for h in hist:
        vals = [v for v in h.as_dict().values() if isinstance(v, float)]
        check(all(math.isfinite(v) for v in vals), f"{name}: non-finite {h}")
    return launches


def phase_fl_async():
    """Phase 6's ResNet-32 (full width, f32, cuDNN TF32 on) over 1 core +
    6 edges under an emergent-staleness timeline and a two-level fleet.
    Returns the kd pair's launches over the phase."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    silos = _cifar_silos(num_edges=6)
    core, edges, test = silos
    print(f"[fl async] ResNet-{RESNET32.depth} width {RESNET32.width}; core "
          f"{len(core)}, edges {[len(e) for e in edges]}, test {len(test)}")
    total = [0, 0]
    for method, scenario in ASYNC_RUNS:
        launches = _fl_async_run(silos, method, scenario)
        total = [a + launches[n] for a, n in zip(
            total, ("kd_stats_fwd", "kd_grad_bwd"))]
    return total


def phase_fl_async_parity():
    """The quickstart's MLP federation (bkd, R = 2, 2 core rounds, f32,
    TF32 off) under ``async_uniform`` and ``hier_uniform`` on the card and
    on the CPU from one initial state: the first Phase-2 loss of the
    stream's first round within 1e-5 relative, the per-round test accuracy
    within 0.02 (phase 7's limits), the rounds' edges and staleness
    equal."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    adapter, core, edges, test = quickstart.setup()
    init = params_to_numpy(adapter.init(torch.Generator().manual_seed(0),
                                        "cpu"))
    adapter = dataclasses.replace(
        adapter, init=lambda gen, device: params_from_numpy(init, device))
    cfg = dataclasses.replace(quickstart.config("bkd", rounds=2),
                              num_edges=len(edges), aggregation_r=2)
    for scenario in ("async_uniform", "hier_uniform"):
        first, hists = {}, {}
        for device in ("cpu", "cuda"):
            sim = build_scenario(scenario, len(edges), aggregation_r=2)
            fl = FederatedKD(adapter, cfg, core, edges, test, scheduler=sim,
                             device=device)
            state = fl.pretrain_core(0)
            plan = sim.plans(cfg.rounds)[0]
            teachers = fl.train_round_edges(
                [state] * len(plan.tasks), plan.edge_ids,
                seed=cfg.seed + 31 * plan.round_idx)
            stepper = fl.distill_stepper(state, teachers, plan.round_idx,
                                         edge_ids=plan.edge_ids)
            stepper.step(max_steps=1)
            first[device] = stepper.losses[0].item()
            _, hist = FederatedKD(adapter, cfg, core, edges, test,
                                  scheduler=sim, device=device).run(
                                      0, log=None)
            hists[device] = [(h.edges, h.staleness, h.test_acc)
                             for h in hist]
        rel = abs(first["cuda"] - first["cpu"]) / abs(first["cpu"])
        gap = max(abs(a[2] - b[2]) for a, b in zip(hists["cuda"],
                                                   hists["cpu"]))
        print(f"[fl async parity] bkd {scenario}: first Phase-2 loss card "
              f"{first['cuda']:.7f} cpu {first['cpu']:.7f} (relative "
              f"{rel:.3g}, limit 1e-5); rounds (edges, staleness, test_acc) "
              f"card {hists['cuda']} cpu {hists['cpu']} (max gap {gap:.4f}, "
              f"limit 0.02)")
        check(rel <= 1e-5, f"{scenario}: first Phase-2 loss differs by {rel}")
        check(gap <= 0.02, f"{scenario}: test_acc differs by {gap}")
        check([h[:2] for h in hists["cuda"]] == [h[:2] for h in hists["cpu"]]
              and len(hists["cuda"]) == cfg.rounds,
              f"{scenario}: rounds differ {hists}")


def phase_async_bench():
    """The port's ``async_bench --smoke`` on the card (5 scenarios x bkd,
    kd, fedavg at 2 rounds over 4 edges, the 100k-edge timeline) with the
    JAX package's exit rule; the kd pair's launches over it."""
    for c in KD_COUNTERS.values():
        c.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = async_bench.main(["--smoke", "--device", "cuda"])
    out = buf.getvalue()
    report = json.loads(out[out.index("\n{") + 1:])
    launches = {n: c.launches for n, c in KD_COUNTERS.items()}
    for name, sc in report["scenarios"].items():
        t = sc["timeline"]
        print(f"[async bench] {name}: max staleness {t['max_staleness']}, "
              f"mean {t['mean_staleness']:.4f}, teachers a round "
              f"{t['teachers_per_round']}; " + ", ".join(
                  f"{m} final {v['final_acc']} mean {v['mean_acc']} "
                  f"({v['seconds']}s)" for m, v in sc["methods"].items())
              + f"; bkd_minus_kd {sc.get('bkd_minus_kd')}")
    fs = report["fleet_scale"]
    print(f"[async bench] fleet scale: {fs['edges']} edges x {fs['rounds']} "
          f"rounds in {fs['seconds']}s (budget {fs['budget_seconds']}s), "
          f"hierarchical {fs['hierarchical']}, heap vs fleet "
          f"{fs['heap_vs_fleet']}; kd launches {launches}; exit {rc}")
    check(rc == 0, "async bench: its exit rule failed")
    check(launches["kd_stats_fwd"] > 0 and launches["kd_grad_bwd"] > 0,
          f"async bench: kd launches {launches}")


def phase_transport_frontiers():
    """The port's transport bench (``--smoke`` sizes) on the two slice-7
    regimes, ``async_uniform`` and ``hier_uniform``, on the card, with
    ``bench_sim_accounting``'s gates: identity equal to no transport bit
    for bit, every lossy codec compressing, the quant pair launched.
    Returns the quant pair's launches."""
    for c in KD_COUNTERS.values():
        c.launches = 0
    scenarios = {}
    for name in ("async_uniform", "hier_uniform"):
        scenarios[name] = out = transport_bench.bench_frontier(
            name, rounds=2, num_edges=4, epochs=(3, 3, 2), seed=0,
            device="cuda")
        for p in [dict(out["baseline"], codec="none")] + out["frontier"]:
            print(f"[transport frontiers] {name}/{p['codec']}: final_acc "
                  f"{p['final_acc']} mean_acc {p['mean_acc']} uplink "
                  f"{p['uplink_bytes']} B from {p['teachers']} teachers "
                  f"({p.get('compression_vs_identity')}x vs identity) in "
                  f"{p['seconds']}s")
    launches = {n: c.launches for n, c in KD_COUNTERS.items()}
    acct = transport_bench.bench_sim_accounting(seed=0)
    core_payload = acct["hierarchical"]["core_payload_bytes"]
    ok = transport_bench.gates(scenarios, acct)
    print(f"[transport frontiers] launches {launches}; sim accounting "
          f"heap_fleet_bit_identical {acct['heap_fleet_bit_identical']}, "
          f"split_consistent {acct['hierarchical']['split_consistent']}, "
          f"core payload {core_payload} B; gates {ok}")
    check(ok, "transport frontiers: a gate failed")
    check(core_payload == transport_bench.mlp_payload_bytes() == 27688.0,
          f"transport frontiers: core payload {core_payload}")
    check(launches["kd_quant_stats_fwd"] > 0
          and launches["kd_quant_grad_bwd"] > 0,
          f"transport frontiers: quant launches {launches}")
    return launches["kd_quant_stats_fwd"], launches["kd_quant_grad_bwd"]


# -- slice 4, the rest: the encoder and recurrent training ------------------

HUBERT_BATCH, HUBERT_FRAMES = 8, 500   # 10 s of audio at 50 frames/s


def _hubert_batch(cfg, b, s, device, seed=0):
    """Feature frames and codebook labels drawn from ``seed``; every 4th
    frame masked (the frames the masked CE scores)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mask = torch.zeros(b, s, dtype=torch.bool, device=device)
    mask[:, ::4] = True
    return {"features": torch.randn(b, s, cfg.feat_dim, generator=gen,
                                    device=device),
            "labels": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                    device=device),
            "mask": mask}


def phase_hubert():
    """hubert-xlarge at full width and depth (48 layers, d_model 1280,
    bf16, AdamW): 3 masked pretrain steps on 8 x 500 frames, each step's
    seconds and the peak memory printed; then SMOKE's forward logits (with
    the mask) and masked pretrain loss, f32 with TF32 off, card vs CPU from
    one start state (logits within 1e-4, loss within 1e-5)."""
    torch.cuda.empty_cache()
    cfg = registry.get_config("hubert-xlarge")
    params = Transformer.init(cfg, 0, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    opt = optimizers.adamw(3e-4)
    state = opt.init(params)
    step = St.make_pretrain_step(cfg, opt, loss_chunk=HUBERT_FRAMES)
    batch = _hubert_batch(cfg, HUBERT_BATCH, HUBERT_FRAMES, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, losses = [], []
    for i in range(3):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch, i)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    print(f"[hubert] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {n_params} parameters in {cfg.param_dtype}, "
          f"AdamW; masked pretrain on {HUBERT_BATCH} x {HUBERT_FRAMES} "
          f"frames (every 4th masked): step s {[round(t, 4) for t in secs]}, "
          f"losses {[round(v, 4) for v in losses]}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B")
    check(all(math.isfinite(v) for v in losses), f"hubert: losses {losses}")
    del params, state, batch
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = registry.get_smoke_config("hubert-xlarge")
    weights = params_to_numpy(Transformer.init(cfg, 3, device="cpu"))
    weights["mask_embed"] = np.random.default_rng(0).standard_normal(
        weights["mask_embed"].shape).astype(np.float32)
    cpu = _hubert_batch(cfg, 2, 64, "cpu", seed=1)
    out = {}
    for dev in ("cpu", "cuda"):
        batch = {k: v.to(dev) for k, v in cpu.items()}
        params = params_from_numpy(weights, dev)
        with torch.no_grad():
            logits, _ = Transformer.apply(
                cfg, params, {k: batch[k] for k in ("features", "mask")})
        _, _, m = St.make_pretrain_step(cfg, optimizers.adamw(3e-4),
                                        loss_chunk=32)(
            params, optimizers.adamw(3e-4).init(params), batch, 0)
        out[dev] = (logits.cpu(), float(m["loss"]))
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    dloss = abs(out["cuda"][1] - out["cpu"][1])
    print(f"[hubert] SMOKE parity card vs CPU: logits max abs diff "
          f"{err:.3g} (limit 1e-4), masked pretrain loss {out['cuda'][1]:.6f}"
          f" vs {out['cpu'][1]:.6f} (diff {dloss:.3g}, limit 1e-5)")
    check(err <= 1e-4, f"hubert parity: logits differ by {err}")
    check(dloss <= 1e-5, f"hubert parity: loss differs by {dloss}")


def phase_recurrent_train(serve_ssd_launches, rg_params):
    """Mamba-2 370m trained at full width and depth on the card
    (``launch.train --full --method bkd --rounds 1 --steps-per-phase 3``,
    bf16, AdamW): the training steps take the plain scans (``ssd`` launches
    0, beside phase 19's serving launches), the Phase-2 loss through the kd
    pair.  Then one SMOKE pretrain step of recurrentgemma-9b and of
    mamba2-370m card vs CPU (f32, TF32 off, from one start state): loss
    within 1e-5, each gradient leaf within 1e-4 of its largest CPU entry,
    no scan kernel launched."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ssd_mod.ssd.launches = rglru_mod.rglru.launches = 0
    argv = ["--full", "--arch", "mamba2-370m", "--method", "bkd", "--rounds",
            "1", "--steps-per-phase", "3", "--device", "cuda"]
    t0 = time.perf_counter()
    params, out, launches = _train(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    p0, p1, p2, rate = [], [], [], []
    for m in _PHASE_S.finditer(out):
        for lst, v in zip((p0, p1, p2, rate), m.groups()):
            if v is not None:
                lst.append(float(v))
    print(f"[recurrent train] mamba2-370m full width, 48 SSD layers, bf16, "
          f"batch 8 x 64 tokens, 3 Phase-2 steps in {wall:.1f}s: phase 0 "
          f"{p0} s, phase 1 {p1} s, phase 2 {p2} s = {rate} steps/s; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B; "
          f"ssd launches in training {ssd_mod.ssd.launches} (phase 19's "
          f"serving: {serve_ssd_launches}); kd launches {launches}")
    check(ssd_mod.ssd.launches == 0 and rglru_mod.rglru.launches == 0,
          "recurrent train: a scan kernel launched under autograd")
    check(launches["kd_stats_fwd"] == 3 and launches["kd_grad_bwd"] == 3,
          f"recurrent train: kd launches {launches}")
    check(all(math.isfinite(float(v)) for v in re.findall(r"loss=(\S+)",
                                                          out)),
          "recurrent train: a non-finite loss")
    del params
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grad_opt = optimizers.Optimizer(
        init=lambda p: {}, update=lambda g, s, p, step, lr=None: (g, s))
    toks = np.random.default_rng(8).integers(0, 256, size=(4, 65))
    for arch in ("recurrentgemma-9b", "mamba2-370m"):
        cfg = registry.get_smoke_config(arch)
        weights = params_to_numpy(Transformer.init(cfg, 2, device="cpu"))
        out = {}
        ssd_mod.ssd.launches = rglru_mod.rglru.launches = 0
        for dev in ("cpu", "cuda"):
            batch = {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
                     "labels": torch.as_tensor(toks[:, 1:], device=dev)}
            step = St.make_pretrain_step(cfg, grad_opt, loss_chunk=32)
            grads, _, m = step(params_from_numpy(weights, dev), {}, batch, 0)
            out[dev] = (list(_leaves(params_to_numpy(grads))),
                        float(m["loss"]))
        dloss = abs(out["cuda"][1] - out["cpu"][1])
        worst = max(float(np.abs(g - w).max()) / max(float(np.abs(w).max()),
                                                      1e-30)
                    for g, w in zip(out["cuda"][0], out["cpu"][0]))
        print(f"[recurrent train] {cfg.name} f32 pretrain step (4 x 64 "
              f"tokens, 2 loss chunks) card vs CPU: loss {out['cuda'][1]:.7f}"
              f" vs {out['cpu'][1]:.7f} (diff {dloss:.3g}, limit 1e-5); "
              f"gradients within {worst:.3g} of each leaf's largest (limit "
              f"1e-4); scan launches ssd {ssd_mod.ssd.launches}, rglru "
              f"{rglru_mod.rglru.launches}")
        check(dloss <= 1e-5, f"recurrent train: {cfg.name} loss {dloss}")
        check(worst <= 1e-4, f"recurrent train: {cfg.name} gradients {worst}")
        check(ssd_mod.ssd.launches == rglru_mod.rglru.launches == 0,
              f"recurrent train: {cfg.name} launched a scan kernel")
    n = rg_params
    print(f"[recurrent train] recurrentgemma-9b is not trained at full width "
          f"here: its {n / 1e9:.3f} B parameters (phase 19) need "
          f"{12 * n / 1e9:.1f} GB as f32 weights with AdamW's two f32 "
          f"moments ({8 * n / 1e9:.1f} GB for the moments alone), more than "
          f"the card's {torch.cuda.get_device_properties(0).total_memory} B")


# -- slice 6: the live co-scheduled system and checkpoints; the legacy loop ---

#: The most the live co-run may reckon to hold on the card; deeper models
#: are cut, never narrowed.
LIVE_BUDGET = 70e9
LIVE_ROUNDS, LIVE_REQUESTS, LIVE_QUANTUM = 2, 24, 2


def _live_reckoning(cfg):
    """(parameter bytes, reckoned peak bytes) of a live co-run by count:
    at a Phase-2 step the card holds the trainer's state, ``w0``, the
    stepper's state, bkd's frozen copy of it, the one-teacher stack, the
    engine's copy, the step's gradients and its new parameters (eight
    copies in the parameter dtype) and the old and new f32 momentum."""
    layer, fixed = _param_bytes(cfg)
    p = fixed + cfg.num_layers * layer
    n = p // (torch.finfo(cfg.pdt).bits // 8)
    return p, 8 * p + 2 * 4 * n


def _live_depth(cfg):
    """``cfg`` at full width, at full depth when its reckoned peak fits
    LIVE_BUDGET, else cut to the layers that fit; prints the reckoning."""
    p, peak = _live_reckoning(cfg)
    print(f"[live] reckoning for {cfg.name} at {cfg.num_layers} layers: "
          f"{p / 1e9:.2f} GB of {cfg.param_dtype} parameters; a Phase-2 step "
          f"holds 8 copies of them (state, w0, stepper state, bkd's frozen "
          f"copy, the teacher stack, the engine's copy, gradients, new "
          f"parameters) and 2 f32 momenta (old and new): {peak / 1e9:.1f} GB "
          f"against a budget of {LIVE_BUDGET / 1e9:.0f} GB")
    if peak <= LIVE_BUDGET:
        print(f"[live] {cfg.name}: full depth, {cfg.num_layers} layers")
        return cfg
    layer, fixed = _param_bytes(cfg)
    per = peak / p
    fit = int((LIVE_BUDGET / per - fixed) // layer)
    check(fit >= 1, f"live: not one layer of {cfg.name} fits")
    print(f"[live] {cfg.name}: depth cut to {fit} of {cfg.num_layers} layers")
    return dataclasses.replace(cfg, num_layers=fit)


def _phase2_steps(trainer):
    """Phase-2 optimizer steps of the trainer's plan stream: kd_epochs x
    (core windows // batch) a distilling round."""
    cfg, n = trainer.cfg, len(trainer.fl.core_ds)
    per_epoch = max(n // min(cfg.batch_size, n), 1)
    return sum(cfg.kd_epochs * per_epoch for p in trainer.plans
               if not p.withdraw)


def phase_live():
    """Slice 6's main path at full width: Granite-3-2B (bf16) through
    ``LiveSystem`` with the live bench's settings (``lm_fl_data`` 2 edges x
    8-token windows of 256 sequences; ``EventDrivenSimulator(2,
    'uniform')``; bkd, 2 rounds, 2 KD epochs, batch 8; quantum 2; one
    diurnal stream of 24 requests on a dense engine of 2 slots, ``max_len``
    32).  Prints serve-only tok/s (cold, warm) against co-scheduled tok/s,
    the swap ticks, the core NLL at each swap, peak memory against the
    reckoning, and the phase seconds.  The kd pair must launch once a
    Phase-2 step of the plan stream, ``swa_decode`` layers x decode ticks.
    Returns (kd_stats_fwd, kd_grad_bwd, swa_decode) launches."""
    torch.cuda.empty_cache()
    cfg = _live_depth(registry.get_config("granite-3-2b"))
    core, edges, test, silos = lm_fl_data(cfg, num_edges=2, seq_len=8,
                                          n_seqs=256, seed=0)
    flcfg = FLConfig(num_edges=2, rounds=LIVE_ROUNDS, method="bkd",
                     core_epochs=1, edge_epochs=1, kd_epochs=2, batch_size=8,
                     seed=0)
    torch.cuda.reset_peak_memory_stats()
    fl = FederatedKD(lm_adapter(cfg), flcfg, core, edges, test,
                     scheduler=EventDrivenSimulator(2, "uniform", seed=0),
                     device="cuda")
    times = {"phase0": 0.0, "phase1": 0.0, "train": 0.0, "nll": 0.0}
    _timed(fl, "pretrain_core", times, "phase0")
    _timed(fl, "train_round_edges", times, "phase1")
    trainer = LiveTrainer(fl, 0, log=print)
    stream = lambda: build_stream(  # noqa: E731
        "diurnal", LIVE_REQUESTS, vocab=cfg.vocab_size, seed=0,
        prompt_max=10, out_max=4)
    nll0 = nll_on(cfg, trainer.state, silos["core"])
    baseline = ServeEngine(cfg, trainer.state, slots=2, max_len=32,
                           device="cuda")
    serve_only = {}
    for key in ("cold", "warm"):
        baseline.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finished = baseline.run(stream())
        torch.cuda.synchronize()
        serve_only[key] = summarize(finished, time.perf_counter() - t0)
    del baseline

    engine = ServeEngine(cfg, trainer.state, slots=2, max_len=32,
                         device="cuda")
    horizon = max(r.arrival for r in stream()) + 2 * LIVE_REQUESTS
    t_last = max(p.time for p in trainer.plans)

    def on_swap(system, rec):
        t0 = time.perf_counter()
        rec["eval_nll_core"] = nll_on(cfg, system.trainer.state,
                                      silos["core"])
        times["nll"] += time.perf_counter() - t0

    system = LiveSystem(trainer, engine, quantum=LIVE_QUANTUM,
                        ticks_per_time=0.6 * horizon / t_last,
                        on_swap=on_swap)
    _timed(trainer, "step", times, "train")
    phase1_before = times["phase1"]
    for c in (*KD_COUNTERS.values(), swa_mod.swa_decode,
              pd_mod.paged_decode):
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finished = system.run(stream())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in KD_COUNTERS.items()}
    swa = swa_mod.swa_decode.launches
    co = summarize(finished, wall)
    steps = _phase2_steps(trainer)
    phase1 = times["phase1"] - phase1_before
    train_s = times["train"] - phase1
    serve_s = wall - times["train"] - times["nll"]
    for key, st in serve_only.items():
        print(f"[live] serve-only ({key}) on the pretrained core: "
              f"{st['tokens']} tokens in {st['seconds']}s = "
              f"{st['tok_per_sec']} tok/s; ITL p50 {st['itl_p50_ms']} ms")
    print(f"[live] co-scheduled: {co['requests']}/{LIVE_REQUESTS} requests, "
          f"{co['tokens']} tokens in {co['seconds']}s = {co['tok_per_sec']} "
          f"tok/s (serve-only warm {serve_only['warm']['tok_per_sec']}); "
          f"TTFT p50/p99 {co['ttft_p50_ms']}/{co['ttft_p99_ms']} ms, ITL "
          f"p50/p99 {co['itl_p50_ms']}/{co['itl_p99_ms']} ms; {engine.ticks} "
          f"ticks ({engine.decode_ticks} decode ticks)")
    print(f"[live] seconds: phase 0 {times['phase0']:.2f}, phase 1 "
          f"{phase1:.2f} (co-run) / {times['phase1']:.2f} (all), phase 2 "
          f"with the rounds' metrics passes {train_s:.2f} = "
          f"{steps / train_s:.2f} Phase-2 steps/s, serving {serve_s:.2f}, "
          f"swap NLLs {times['nll']:.2f}; co-run wall {wall:.2f}")
    print(f"[live] pretrained core NLL {nll0:.4f}; swaps at ticks "
          f"{engine.swap_log}: " + "; ".join(
              f"round {r['round']} tick {r['tick']} swap {r['swap']} NLL "
              f"{r['eval_nll_core']:.4f}" for r in system.swap_records))
    _, reckoned = _live_reckoning(cfg)
    print(f"[live] max_memory_allocated {torch.cuda.max_memory_allocated()} "
          f"B (reckoned {reckoned:.4g} B) of "
          f"{torch.cuda.get_device_properties(0).total_memory} B; launches "
          f"{launches} for {steps} Phase-2 steps; swa_decode {swa} over "
          f"{engine.decode_ticks} decode ticks x {cfg.num_layers} layers")
    committed = [r for r in system.swap_records if r["swap"] is not None]
    check(trainer.rounds_done == LIVE_ROUNDS,
          f"live: {trainer.rounds_done} of {LIVE_ROUNDS} rounds")
    check(committed and all(math.isfinite(r["eval_nll_core"])
                            for r in committed),
          f"live: swaps {system.swap_records}")
    check(len(finished) == LIVE_REQUESTS, f"live: {len(finished)} served")
    want = {"kd_stats_fwd": steps, "kd_grad_bwd": steps,
            "kd_quant_stats_fwd": 0, "kd_quant_grad_bwd": 0}
    check(launches == want and steps > 0,
          f"live: kd launches {launches}, want {want}")
    check(swa == cfg.num_layers * engine.decode_ticks > 0,
          f"live: swa_decode launched {swa} times, want {cfg.num_layers} x "
          f"{engine.decode_ticks}")
    check(pd_mod.paged_decode.launches == 0,
          "live: the dense engine launched paged_decode")
    del system, engine, trainer, fl
    torch.cuda.empty_cache()
    return launches["kd_stats_fwd"], launches["kd_grad_bwd"], swa


def _phase3_stream(cfg, n=8):
    return build_stream("poisson", n, vocab=cfg.vocab_size, seed=0,
                        prompt_max=192, out_max=32, shared_prefix=32)


def _engine_carry_restore(cfg, params, label, tmp, **kw):
    """Phase 3's stream uninterrupted, then saved mid-stream (live slots,
    queued requests, three decode ticks in), restored into a fresh engine
    and resumed: tokens, clock and (paged) the allocator books and host
    page table must equal the uninterrupted run's."""
    mk = lambda: ServeEngine(cfg, params, slots=SLOTS,  # noqa: E731
                             max_len=MAX_LEN, device="cuda", **kw)
    eng = mk()
    done = eng.run(_phase3_stream(cfg))
    want = ({r.rid: r.out for r in done}, eng.ticks)
    snap = (eng._alloc.snapshot(), eng._pt_host.copy()) if eng.paged else None
    del eng
    eng = mk()
    eng.begin(_phase3_stream(cfg))
    while not (any(r is not None for r in eng._host_active) and eng._queue
               and eng.decode_ticks >= 3):
        eng.tick()
        check(eng.pending(), f"{label}: no save point")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree, meta = eng.carry()
    carry_bytes = sum(t.numel() * t.element_size() for t in _leaves(tree)
                      if isinstance(t, torch.Tensor))
    path = str(Path(tmp) / f"{label.replace(' ', '_')}.npz")
    save_tree(path, {"engine": tree}, meta)
    save_s = time.perf_counter() - t0
    saved_at, live = eng.ticks, sum(r is not None for r in eng._host_active)
    queued = len(eng._queue)
    del eng, tree
    eng = mk()
    t0 = time.perf_counter()
    eng.restore(path, meta, _phase3_stream(cfg))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    while eng.pending():
        eng.tick()
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    got = ({r.rid: r.out for r in eng._finished}, eng.ticks)
    print(f"[carry] {label}: saved at tick {saved_at} ({live} live slots, "
          f"{queued} queued); carry {carry_bytes} B on the card, npz "
          f"{Path(path).stat().st_size} B, saved in {save_s:.2f}s, restored "
          f"in {restore_s:.2f}s, resumed {eng.ticks - saved_at} ticks in "
          f"{resume_s:.2f}s; tokens equal {got[0] == want[0]}, clock "
          f"{got[1]} / {want[1]}")
    check(got == want, f"{label}: resumed run differs from the "
          "uninterrupted one")
    if snap is not None:
        check(eng._alloc.snapshot() == snap[0]
              and np.array_equal(eng._pt_host, snap[1]),
              f"{label}: allocator books or page table differ")
    Path(path).unlink()


def phase_engine_carry():
    """Engine carry/restore at full width: Granite-3-2B in bf16 on phase
    3's stream and settings, dense (``swa_decode``) and paged
    (``paged_decode``)."""
    import tempfile
    cfg = registry.get_config("granite-3-2b")
    params = Transformer.init(cfg, 0, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        _engine_carry_restore(cfg, params, "dense", tmp)
        _engine_carry_restore(cfg, params, "paged", tmp, paged=True,
                              page_size=PAGE)
    del params
    torch.cuda.empty_cache()


LIVE_SMOKE_TOL = 1e-4


def _live_smoke_system(weights, device):
    """The JAX package's live test setting (``tests/test_live.py::
    _lm_setup``): Granite SMOKE with three attention layers, f32, 2 bkd
    rounds, quantum 1, 2 slots, ``max_len`` 32; every system starts from
    the same weights."""
    cfg = dataclasses.replace(registry.get_smoke_config("granite-3-2b"),
                              block_pattern=("attn",) * 3)
    core, edges, test, _ = lm_fl_data(cfg, num_edges=2, seq_len=8,
                                      n_seqs=96, seed=0)
    flcfg = FLConfig(num_edges=2, rounds=2, method="bkd", core_epochs=1,
                     edge_epochs=1, kd_epochs=2, batch_size=8, seed=0)
    adapter = dataclasses.replace(
        lm_adapter(cfg),
        init=lambda gen, dev: params_from_numpy(weights, dev))
    fl = FederatedKD(adapter, flcfg, core, edges, test, device=device)
    trainer = LiveTrainer(fl, 0, log=None)
    engine = ServeEngine(cfg, trainer.state, slots=2, max_len=32,
                         device=device)
    return cfg, LiveSystem(trainer, engine, quantum=1)


def _live_smoke_result(system, finished):
    return {"tokens": {r.rid: list(r.out) for r in finished},
            "ticks": system.engine.ticks,
            "swap_log": list(system.engine.swap_log),
            "swap_records": [dict(r) for r in system.swap_records],
            "history": [h.as_dict() for h in system.trainer.fl.history],
            "uplink_log": list(system.trainer.fl.distill_engine.uplink_log)}


def phase_live_checkpoint():
    """The fused live checkpoint on the card, SMOKE (the JAX package's
    test setting): saved mid-round and mid-epoch (``st.i > 0``,
    ``st._idx`` set) and mid-stream, restored into a fresh system and
    resumed, the final state must be bit-identical to the uninterrupted
    run's, and so must the history, every served token, the ticks, the
    swap log and records and the uplink log.  Then the uninterrupted run
    card vs CPU (TF32 off): greedy tokens equal, final state within
    LIVE_SMOKE_TOL."""
    import tempfile
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg0 = dataclasses.replace(registry.get_smoke_config("granite-3-2b"),
                               block_pattern=("attn",) * 3)
    weights = params_to_numpy(Transformer.init(cfg0, 0, device="cpu"))
    stream = lambda: build_stream("poisson", 5, vocab=cfg0.vocab_size,  # noqa: E731
                                  seed=3, prompt_max=10, out_max=4)
    runs = {}
    for device in ("cuda", "cpu"):
        _, system = _live_smoke_system(weights, device)
        finished = system.run(stream())
        runs[device] = (_live_smoke_result(system, finished),
                        params_to_numpy(system.trainer.state))
    _, sys_b = _live_smoke_system(weights, "cuda")
    eng, tr = sys_b.engine, sys_b.trainer
    eng.begin(stream())
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "live.npz")
        for _ in range(1000):
            if eng.pending():
                eng.tick()
            if tr.pending():
                sys_b._train_quantum()
            st = tr._stepper
            if (tr.mid_round and st is not None and st.i > 0
                    and st._idx is not None):
                sys_b.save(path)
                break
        check(Path(path).exists(), "live checkpoint: no mid-epoch save point")
        saved = (tr.cursor, st.i, st.epoch, st.pos, eng.ticks)
        _, sys_c = _live_smoke_system(weights, "cuda")
        reqs = stream()
        sys_c.restore(path, reqs)
        finished = sys_c.run(reqs, resume=True)
    resumed = (_live_smoke_result(sys_c, finished),
               params_to_numpy(sys_c.trainer.state))
    want, want_state = runs["cuda"]
    got, got_state = resumed
    same_state = all(np.array_equal(a, b) for a, b in
                     zip(_leaves(got_state), _leaves(want_state)))
    print(f"[live ckpt] SMOKE on the card: saved at round {saved[0]}, step "
          f"{saved[1]} (epoch {saved[2]}, row {saved[3]}), tick {saved[4]}; "
          f"resumed: state bit-identical {same_state}, " + ", ".join(
              f"{k} equal {got[k] == want[k]}" for k in got))
    check(same_state, "live ckpt: resumed state differs from uninterrupted")
    check(got == want, "live ckpt: resumed run differs from uninterrupted")
    cpu, cpu_state = runs["cpu"]
    err = max(float(np.max(np.abs(a - b))) for a, b in
              zip(_leaves(want_state), _leaves(cpu_state)))
    print(f"[live ckpt] card vs CPU, uninterrupted: tokens equal "
          f"{want['tokens'] == cpu['tokens']}, swap ticks {want['swap_log']} "
          f"/ {cpu['swap_log']}, final state max abs diff {err:.3g} (limit "
          f"{LIVE_SMOKE_TOL})")
    check(want["tokens"] == cpu["tokens"] and want["swap_log"] ==
          cpu["swap_log"], "live ckpt: card and CPU serve different tokens")
    check(err <= LIVE_SMOKE_TOL, f"live ckpt: card vs CPU state {err}")


def phase_legacy():
    """``serve_bench --smoke`` on the card (its JSON summary, the paged
    parity and residency gates, which must hold; its exit code and speedup,
    printed, not required: the speedup gate measures JAX's retracing), then
    Granite-3-2B at full width in bf16: the engine (after a warm-up run)
    and the legacy loop on phase 3's stream, tok/s for both and
    ``swa_decode``'s launches (layers x decode calls each).  Returns the
    legacy loop's ``swa_decode`` launches."""
    import tempfile
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "serve.json"
        with contextlib.redirect_stdout(buf):
            rc = serve_bench.main(["--smoke", "--device", "cuda",
                                   "--out", str(out)])
        report = json.loads(out.read_text())
    paged = report["paged"]
    print(f"[legacy] serve_bench --smoke report: {json.dumps(report)}")
    print(f"[legacy] serve_bench --smoke: exit {rc}; legacy "
          f"{report['legacy']['tok_per_sec']} tok/s, engine "
          f"{report['engine']['tok_per_sec']} tok/s, speedup "
          f"{report['speedup_tok_s']} (the reference's gate 1.5, not "
          f"required); prefill shapes {report['prefill_compiles']}; paged "
          f"tokens match {paged['tokens_match_all_streams']}, worst "
          f"residency cut {paged['worst_reduction_x']}x; streams " + ", ".join(
              f"{k} {v['tok_per_sec']}" for k, v in report["streams"].items())
          + f"; prefix {paged['prefix']}")
    check(paged["tokens_match_all_streams"]
          and paged["worst_reduction_x"] >= 4.0,
          f"legacy: serve_bench paged gates {paged}")
    check(report["prefill_compiles"]["count"]
          <= report["prefill_compiles"]["bound"],
          f"legacy: prefill shapes {report['prefill_compiles']}")

    cfg = registry.get_config("granite-3-2b")
    params = Transformer.init(cfg, 0, device="cuda")
    engine = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                         device="cuda")
    engine.run(_phase3_stream(cfg, 2))              # warm-up
    engine.reset()
    swa_mod.swa_decode.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finished = engine.run(_phase3_stream(cfg))
    torch.cuda.synchronize()
    eng_stats = summarize(finished, time.perf_counter() - t0)
    eng_swa = swa_mod.swa_decode.launches
    check(eng_swa == cfg.num_layers * engine.decode_ticks > 0,
          f"legacy: engine swa_decode {eng_swa}, want {cfg.num_layers} x "
          f"{engine.decode_ticks}")
    del engine
    calls = [0]
    real = legacy.legacy_serve_step

    def counted(c):
        step = real(c)

        def call(*a):
            calls[0] += 1
            return step(*a)
        return call

    legacy.legacy_serve_step = counted
    swa_mod.swa_decode.launches = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finished = legacy.simulate(cfg, params, _phase3_stream(cfg), SLOTS,
                                   MAX_LEN, log=lambda *a: None)
        torch.cuda.synchronize()
        leg_stats = summarize(finished, time.perf_counter() - t0)
    finally:
        legacy.legacy_serve_step = real
    leg_swa = swa_mod.swa_decode.launches
    print(f"[legacy] {cfg.name} full width, bf16, phase 3's stream: engine "
          f"{eng_stats['tokens']} tokens in {eng_stats['seconds']}s = "
          f"{eng_stats['tok_per_sec']} tok/s ({eng_swa} swa_decode launches); "
          f"legacy loop {leg_stats['tokens']} tokens in "
          f"{leg_stats['seconds']}s = {leg_stats['tok_per_sec']} tok/s "
          f"({leg_swa} swa_decode launches over {calls[0]} decode calls); "
          f"legacy/engine tok/s "
          f"{leg_stats['tok_per_sec'] / eng_stats['tok_per_sec']:.3f}")
    check(len(finished) == 8, f"legacy: {len(finished)} of 8 served")
    check(leg_swa == cfg.num_layers * calls[0] > 0,
          f"legacy: swa_decode {leg_swa}, want {cfg.num_layers} x {calls[0]}")
    del params
    torch.cuda.empty_cache()
    return leg_swa


# -- slice 9: meshed serving and Phase 1, and the mesh dry-run ---------------

def _mesh_serve(cfg, params, mesh, paged):
    """Phase 3's stream through ``simulate`` without a mesh and then with
    one (the decode kernel's count set to 0 just before each run, read just
    after); returns the meshed run's launches."""
    from repro_torch.serve import simulate
    kernel = pd_mod.paged_decode if paged else swa_mod.swa_decode
    other = swa_mod.swa_decode if paged else pd_mod.paged_decode
    kw = dict(paged=True, page_size=PAGE) if paged else {}
    label = "paged" if paged else "dense"
    engine = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                         device="cuda", **kw)
    engine.run(_phase3_stream(cfg, 2))        # warm-up
    engine.reset()
    out = {}
    for name in ("mesh=None", "mesh"):
        reqs = _phase3_stream(cfg)
        torch.cuda.synchronize()
        before_other = other.launches
        kernel.launches = 0
        t0 = time.perf_counter()
        if name == "mesh":
            finished = simulate(cfg, params, reqs, SLOTS, MAX_LEN, mesh=mesh,
                                log=None, device="cuda", **kw)
        else:
            finished = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = summarize(finished, wall)
        out[name] = (finished, kernel.launches)
        print(f"[mesh] {cfg.name} {label} {name}: {stats['tokens']} tokens in "
              f"{stats['seconds']}s = {stats['tok_per_sec']} tok/s; TTFT p50 "
              f"{stats['ttft_p50_ms']} ms; ITL p50 {stats['itl_p50_ms']} ms; "
              f"{kernel.__name__} launches {kernel.launches}")
        check(other.launches == before_other,
              f"{label} {name}: launched {other.__name__}")
    (plain, _), (meshed, launches) = out["mesh=None"], out["mesh"]
    check([(r.rid, r.out) for r in meshed] == [(r.rid, r.out) for r in plain],
          f"{label}: meshed tokens differ from the mesh=None run's")
    want = cfg.num_layers * engine.decode_ticks
    check(out["mesh=None"][1] == launches == want > 0,
          f"{label}: {kernel.__name__} launched {launches} times meshed, "
          f"want {cfg.num_layers} x {engine.decode_ticks}")
    return launches


def phase_mesh():
    """Granite-3-2B serving and a ResNet-32 bkd round's Phase 1 on a
    one-rank NCCL mesh; returns (paged_decode, swa_decode, kd_stats_fwd,
    kd_grad_bwd) launches of the meshed runs."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh, mesh_context
    from repro_torch.sharding import local as sharding_local
    mesh = make_test_mesh(device="cuda")
    calls = []
    run_local = sharding_local.run_local

    def counted(fn, *a, **k):
        calls.append(getattr(fn, "__name__", "fn"))
        return run_local(fn, *a, **k)

    sharding_local.run_local = counted
    try:
        print(f"[mesh] {mesh}; backend {dist.get_backend()}")
        cfg = registry.get_config("granite-3-2b")
        params = Transformer.init(cfg, 0, device="cuda")
        swa = _mesh_serve(cfg, params, mesh, paged=False)
        paged = _mesh_serve(cfg, params, mesh, paged=True)
        check(len(calls) > 0, "the meshed runs called no local_map")
        print(f"[mesh] local_map calls in the meshed runs: {len(calls)}")
        del params
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        silos = _cifar_silos()
        hists, kd = {}, None
        for name in ("mesh=None", "mesh"):
            core, edges, test = silos
            fcfg = FLConfig(num_edges=3, rounds=1, method="bkd",
                            core_epochs=2, edge_epochs=2, kd_epochs=2,
                            batch_size=128, lr=0.1, kd_lr=0.02, tau=2.0)
            fl = FederatedKD(resnet_adapter(RESNET32), fcfg, core, edges,
                             test, device="cuda")
            for c in KD_COUNTERS.values():
                c.launches = 0
            sharded = []
            if name == "mesh":
                from repro_torch.core import vectorized
                train_sharded = vectorized._train_sharded
                vectorized._train_sharded = lambda *a: (
                    sharded.append(1), train_sharded(*a))[1]
            t0 = time.perf_counter()
            try:
                with (mesh_context(mesh) if name == "mesh"
                      else contextlib.nullcontext()):
                    _, hist = fl.run(0, log=None)
            finally:
                if name == "mesh":
                    vectorized._train_sharded = train_sharded
            torch.cuda.synchronize()
            hists[name] = [h.as_dict() for h in hist]
            steps = fcfg.kd_epochs * max(len(core) // fcfg.batch_size, 1)
            kd = (kd_mod.kd_stats_fwd.launches, kd_mod.kd_grad_bwd.launches)
            print(f"[mesh] ResNet-32 bkd, 1 round, {name}: "
                  f"{time.perf_counter() - t0:.2f}s; history {hists[name]}; "
                  f"kd pair launches {kd} for {steps} Phase-2 steps; Phase 1 "
                  f"sharded over the edge axis {len(sharded)} time(s)")
            check(kd == (steps, steps), f"{name}: kd pair launched {kd}, "
                  f"want {steps} each")
            if name == "mesh":
                check(len(sharded) == 1, "Phase 1 did not shard its edges")
        torch.backends.cudnn.deterministic = det
        check(hists["mesh"] == hists["mesh=None"],
              "the meshed round's history differs from the unmeshed one's")
    finally:
        sharding_local.run_local = run_local
        dist.destroy_process_group()
    return paged, swa, kd[0], kd[1]


# (arch, shape, multi-pod, per-device parameter bytes by the reference's
# rules, params_total, params_active)
DRYRUN_CASES = (
    ("granite-3-2b", "train_4k", False, 30_748_672, 2_432_862_208,
     2_432_862_208),
    ("granite-3-2b", "decode_32k", False, 30_748_672, 2_432_862_208,
     2_432_862_208),
    ("kimi-k2-1t-a32b", "decode_32k", True, 8_270_983_168,
     1_042_512_049_152, 32_406_205_440),
)
DRYRUN_DIR = ROOT / "build" / "dryrun"


def start_dryruns():
    """Starts the dry-run subprocesses (CPU and meta tensors only, no card)
    so that they run beside the card's phases; ``phase_dryrun`` waits."""
    import os
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape, multi_pod, *_ in DRYRUN_CASES:
        mesh = "2x16x16" if multi_pod else "16x16"
        out = DRYRUN_DIR / f"{arch}_{shape}_{mesh}.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(out)]
        if multi_pod:
            cmd.append("--multi-pod")
        err = open(out.with_suffix(".err"), "w")
        procs.append((out, time.perf_counter(), subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err)))
        err.close()
    return procs


def phase_dryrun(procs):
    for (out, t0, p), (arch, shape, multi_pod, pbytes, total, active) in zip(
            procs, DRYRUN_CASES):
        try:
            p.wait(timeout=900)
        finally:
            if p.poll() is None:
                p.kill()
        secs = time.perf_counter() - t0
        check(p.returncode == 0, f"dryrun {arch} {shape}: exit "
              f"{p.returncode}\n{out.with_suffix('.err').read_text()[-3000:]}")
        r = json.loads(out.read_text())
        rl, pd = r["roofline"], r["per_device"]
        print(f"[dryrun] {arch} {shape} {r['mesh']}: compute "
              f"{rl['compute_s'] * 1e3:.3f} ms, memory "
              f"{rl['memory_s'] * 1e3:.3f} ms, collective "
              f"{rl['collective_s'] * 1e3:.3f} ms (H100 rates); bottleneck "
              f"{r['bottleneck']}; peak {pd['peak_bytes'] / 1e9:.2f} GB a "
              f"device of the card's 80 GB; parameter bytes a device "
              f"{r['param_bytes_per_device']}; params {r['params_total']} / "
              f"{r['params_active']} active; build {r['lower_s']}s + meta run "
              f"{r['compile_s']}s; its result read {secs:.1f}s after its "
              f"start")
        check(r["param_bytes_per_device"] == pbytes,
              f"{arch} {r['mesh']}: {r['param_bytes_per_device']} parameter "
              f"bytes a device, want {pbytes}")
        check((r["params_total"], r["params_active"]) == (total, active),
              f"{arch}: param_count {r['params_total']}/{r['params_active']}")
        check(all(math.isfinite(v) and v > 0 for v in rl.values()),
              f"{arch} {shape}: roofline {rl}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def timed(fn, *args):
    """Runs one phase and prints its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {fn.__name__}: {time.perf_counter() - t0:.1f}s")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dryruns = start_dryruns()
    name = timed(phase_device)
    timed(phase_build)
    entry = timed(phase_kernel)
    entry["launches"] = timed(phase_serve)
    timed(phase_parity)
    kd_entries = timed(phase_kd_kernels)
    launches = timed(phase_fl)
    for e, n in zip(kd_entries, launches):
        e["launches"] = n
    timed(phase_fl_parity)
    timed(phase_figures)
    kdq_entries = timed(phase_kdq_kernels)
    launches = timed(phase_fl_transport)
    for e, n in zip(kdq_entries, launches):
        e["launches"] = n
    timed(phase_fl_transport_parity)
    timed(phase_transport_bench)
    swa_entry = timed(phase_swa_kernel)
    swa_entry["launches"] = timed(phase_serve_dense)
    timed(phase_dense_parity)
    ssd_entry = timed(phase_ssd_kernel)
    rglru_entry = timed(phase_rglru_kernel)
    timed(phase_swa_kernel, (RG_SWA_CASE,))
    ssd_entry["launches"], rglru_entry["launches"], rg_params = timed(
        phase_serve_recurrent)
    timed(phase_recurrent_parity)
    timed(phase_phase2_bench)
    timed(phase_decode_archs)
    timed(phase_serve_archs)
    timed(phase_archs_parity)
    timed(phase_serve_moe)
    timed(phase_moe_parity)
    timed(phase_llm_phase2)
    timed(phase_llm_parity)
    launches = timed(phase_fl_async)
    for e, n in zip(kd_entries, launches):
        e["launches"] += n
    timed(phase_fl_async_parity)
    timed(phase_async_bench)
    launches = timed(phase_transport_frontiers)
    for e, n in zip(kdq_entries, launches):
        e["launches"] += n
    timed(phase_hubert)
    timed(phase_recurrent_train, ssd_entry["launches"], rg_params)
    kd_live, kdg_live, swa_live = timed(phase_live)
    kd_entries[0]["launches"] += kd_live
    kd_entries[1]["launches"] += kdg_live
    swa_entry["launches"] += swa_live
    timed(phase_engine_carry)
    timed(phase_live_checkpoint)
    swa_entry["launches"] += timed(phase_legacy)
    paged_mesh, swa_mesh, kd_mesh, kdg_mesh = timed(phase_mesh)
    entry["launches"] += paged_mesh
    swa_entry["launches"] += swa_mesh
    kd_entries[0]["launches"] += kd_mesh
    kd_entries[1]["launches"] += kdg_mesh
    timed(phase_kernels_bench)
    timed(phase_dryrun, dryruns)
    print(json.dumps({"kernels": [entry] + kd_entries + kdq_entries
                      + [swa_entry, ssd_entry, rglru_entry]}))
    print(f"[done] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
