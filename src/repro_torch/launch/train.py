"""End-to-end FL-distillation driver on one GPU — Algorithm 1 at LLM scale
(the JAX package's ``repro.launch.train``).

Runs the paper's protocol with transformer cores and edges: Phase 0
pre-trains the core on the core token silo, each round fine-tunes an edge
replica on its domain silo (Phase 1) and distills it back into the core
with buffered KD (Phase 2) through the step functions of ``steps.py``.
Rounds come from a plan source: a synchronous ``--scenario``, or the
event-driven simulator (``--sim async:<profile>`` or an ``async_*``
scenario) or its vectorized twin (``--sim fleet:<profile>``), whose
staleness emerges from the device profiles; one teacher is distilled a
round (distill-on-arrival), so the two-level ``hier_*`` streams are
refused.

By default ``--arch <id>`` runs its reduced (SMOKE) config; ``--full``
runs the full-width config.  This CLI runs without a mesh, on one
device (the port's sharding rules, meshed Phase 1 and the dry-run are in;
this CLI under ``make_test_mesh()`` and ``torchrun`` is ROADMAP queue 1's
last slice).  On a CUDA device the Phase-2 loss runs through the hand-written
kernel pair ``kd_stats_fwd`` + ``kd_grad_bwd`` (``--loss-backend
auto``/``pallas``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --rounds 2 --edges 2 --steps-per-phase 30 --method bkd [--device cpu]

The steps take over the trees they update (the reference's
``donate_argnums``), and the driver drops each optimizer state once nothing
reads it again (the core's after Phase 0 and after each Phase 2, the
edge's after Phase 1): the numbers are the reference's, the peak memory
holds one AdamW state.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.core import distill
from repro_torch.core.fleet import FleetSimulator
from repro_torch.core.methods import (method_names, resolve_method,
                                      validate_backend)
from repro_torch.core.scheduler import (ASYNC_SCENARIOS, FROZEN,
                                        HIER_SCENARIOS, SCENARIOS,
                                        build_scenario,
                                        max_retained_staleness)
from repro_torch.core.simulator import (PROFILE_FAMILIES, DistillOnArrival,
                                        EventDrivenSimulator)
from repro_torch.data import make_token_stream
from repro_torch.launch import steps as St
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw
from repro_torch.transport import codec_names, parse_codec
from repro_torch.tree import tree_map


def _copy(tree):
    return tree_map(lambda t: t.clone(), tree)


def lm_batches(tokens, batch, seq, steps, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    n = len(tokens)
    for _ in range(steps):
        sel = rng.integers(0, n, size=batch)
        chunk = tokens[sel, : seq + 1]
        yield {"tokens": torch.as_tensor(chunk[:, :-1], device=device),
               "labels": torch.as_tensor(chunk[:, 1:], device=device)}


@torch.no_grad()
def eval_nll(cfg, params, tokens, batch, seq, device, n_batches=4, seed=1):
    tot = torch.zeros((), dtype=torch.float32, device=device)
    for b in lm_batches(tokens, batch, seq, n_batches, seed, device):
        logits, _ = Transformer.apply(cfg, params, {"tokens": b["tokens"]})
        tot = tot + distill.ce_loss(logits, b["labels"], vocab=cfg.vocab_size)
    return float(tot) / n_batches


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--full", action="store_true",
                    help="use the full-width config")
    ap.add_argument("--method", default="bkd", choices=list(method_names()),
                    help="FL method, resolved through the DistillMethod "
                         "registry (repro_torch/core/methods.py)")
    ap.add_argument("--loss-backend", default="auto",
                    choices=["auto", "jnp", "pallas", "topk_cached"],
                    help="Phase-2 KD loss: the plain PyTorch loss ('jnp'), "
                         "the fused kernel pair ('pallas': the CUDA kernels "
                         "on a card, their plain versions on the CPU), or "
                         "top-k compressed logit transfer (topk_cached maps "
                         "to distill.topk_kl with --cache-topk entries); "
                         "validated against the method's declared backends")
    ap.add_argument("--cache-topk", type=int, default=64,
                    help="k for --loss-backend topk_cached")
    ap.add_argument("--transport", default="none",
                    help="uplink codec for the teacher logits: 'none', or a "
                         "spec of at most one transform and one filter "
                         "joined by '+', e.g. 'int8' or "
                         "'entropy:0.5+topk:16'; registered heads: "
                         f"{', '.join(codec_names())}")
    ap.add_argument("--ema-decay", type=float, default=0.9,
                    help="shadow decay for --method ema")
    ap.add_argument("--kd-epochs", type=int, default=2,
                    help="Phase-2 'epoch' segments for --method melting: "
                         "the buffer re-clones at each segment start")
    ap.add_argument("--scenario", default="none", choices=sorted(SCENARIOS),
                    help="round-scheduling policy; the async_* names run "
                         "the event-driven simulator with distill-on-arrival "
                         "(equivalent to --sim), the hier_* names are "
                         "refused (two-level streams)")
    ap.add_argument("--sim", default="sync",
                    help="'sync' (RoundScheduler via --scenario), "
                         "'async:<profile>': event-driven virtual-clock "
                         "simulation over heterogeneous device profiles "
                         f"({'|'.join(PROFILE_FAMILIES)}), staleness "
                         "emergent from the timeline, or "
                         "'fleet:<profile>': the same timeline from the "
                         "vectorized FleetSimulator (plan for plan "
                         "identical, scales to 100k+ edges)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--edges", type=int, default=2)
    ap.add_argument("--steps-per-phase", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tau", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)

    # Method/backend compatibility is rejected here, at argparse time, from
    # the method's declared capabilities.
    meth = resolve_method(args.method)
    if not meth.llm_driver:
        ap.error(f"--method {args.method} is CPU-scale only "
                 f"({meth.llm_unsupported_reason}); "
                 f"see repro_torch.core.fl.FederatedKD")
    try:
        validate_backend(args.method, args.loss_backend, llm=True)
    except ValueError as e:
        ap.error(str(e))
    codec = None
    if args.transport != "none":
        if meth.llm_averaging:
            ap.error(f"--transport compresses distilled logits; --method "
                     f"{args.method} uplinks parameters (no logit phase)")
        try:
            codec = parse_codec(args.transport)
        except ValueError as e:
            ap.error(str(e))
    device = resolve_device(args.device)
    cfg = (registry.get_config(args.arch) if args.full
           else registry.get_smoke_config(args.arch))
    if cfg.is_encoder or cfg.is_vlm:
        raise SystemExit("train.py drives token-LM FL; see examples/ for "
                         "encoder/VLM paths")
    print(f"arch={cfg.name} device={device} method={args.method}")

    # Domain-silo corpora: silo 0 is the core set, 1..K are edges.
    data, domains = make_token_stream(cfg.vocab_size, 256 * (args.edges + 1),
                                      args.seq + 1, num_domains=args.edges + 1,
                                      seed=args.seed)
    silos = [data[domains == d] for d in range(args.edges + 1)]
    batches = lambda silo, seed: lm_batches(  # noqa: E731
        silos[silo], args.batch, args.seq, args.steps_per_phase, seed, device)

    opt = adamw(args.lr)
    pre_step = St.make_pretrain_step(cfg, opt, loss_chunk=args.seq)
    backend = args.loss_backend
    topk = None
    if backend == "topk_cached":
        # Compressed logit transfer: top-k KL against teacher and buffer
        # (batches are resampled every step, so the compression lives in
        # the loss rather than a precomputed cache).
        backend, topk = "jnp", min(args.cache_topk, cfg.vocab_size - 1)
    # Phase-2 wiring comes from the method's LLM hints: buffer cloning
    # ("clone"/"remelt"), CE weight, EMA shadow, parameter averaging.
    p2_step = None
    if not meth.llm_averaging:
        # The codec is a value map on the teacher's chunk logits, applied
        # inside the loss: the student distills what the uplink delivered.
        transform = (None if codec is None else
                     (lambda lt, ls: codec.roundtrip(lt, student=ls)))
        p2_step = St.make_phase2_step(
            cfg, opt, tau=args.tau,
            buffer_mode="none" if meth.llm_buffer == "none" else "clone",
            loss_chunk=args.seq, topk=topk, loss_backend=backend,
            ce_weight=meth.llm_ce_weight, teacher_transform=transform)
    # Uplink accounting: one Phase-2 pass distills steps * batch * seq
    # token rows of teacher logits (filter codecs at the all-kept bound).
    payload_bytes = 0.0
    if codec is not None:
        kd_rows = args.steps_per_phase * args.batch * args.seq
        payload_bytes = float(codec.payload_bytes(kd_rows, cfg.vocab_size))
    # Plan source: the synchronous RoundScheduler, the event-driven async
    # simulator (--sim async:<profile>, or an async_* scenario name), or its
    # vectorized fleet-scale twin (--sim fleet:<profile>).  One teacher is
    # distilled a round, so the simulated paths use the distill-on-arrival
    # trigger (R = 1 a consumption).
    if args.scenario in HIER_SCENARIOS:
        # Two-level streams interleave region- and core-level plans; this
        # flat R=1 loop cannot consume them.
        ap.error(f"--scenario {args.scenario} emits a two-level region/core "
                 f"plan stream; drive it through the CPU orchestrator "
                 f"instead: python -m repro_torch.benchmarks.scenarios "
                 f"--scenario "
                 f"{args.scenario}")
    profile, sim_kind = None, None
    if args.sim != "sync":
        sim_kind, _, profile = args.sim.partition(":")
        if sim_kind not in ("async", "fleet") or not profile:
            ap.error(f"--sim must be 'sync', 'async:<profile>' or "
                     f"'fleet:<profile>', got {args.sim!r}")
        if args.scenario != "none":
            # Refuse rather than drop the scenario: the simulator replaces
            # the RoundScheduler entirely.
            ap.error(f"--sim {args.sim} conflicts with --scenario "
                     f"{args.scenario}: the event-driven simulator replaces "
                     f"the scenario's RoundScheduler")
    elif args.scenario in ASYNC_SCENARIOS:
        profile, sim_kind = args.scenario[len("async_"):], "async"
    if profile is not None:
        sim_cls = (FleetSimulator if sim_kind == "fleet"
                   else EventDrivenSimulator)
        source = sim_cls(args.edges, profiles=profile,
                         trigger=DistillOnArrival(), seed=args.seed,
                         payload_bytes=payload_bytes)
        print(f"{sim_kind} simulator: profiles={profile}, distill-on-arrival")
    else:
        source = build_scenario(args.scenario, num_edges=args.edges,
                                seed=args.seed)

    params = Transformer.init(cfg, args.seed, device=device)
    opt_state = opt.init(params)

    # Phase 0: core pre-training.
    t0 = time.perf_counter()
    for i, batch in enumerate(batches(0, args.seed)):
        params, opt_state, m = pre_step(params, opt_state, batch, i)
    opt_state = None   # Phase 2 starts its own; nothing reads this again
    print(f"[phase0] loss={float(m['loss']):.4f} "
          f"({time.perf_counter() - t0:.1f}s)")

    w0 = _copy(params)
    plans = list(source.plans(args.rounds))
    keep = 1 + max_retained_staleness(plans)
    core_log = []
    uplink_total = 0.0
    for plan in plans:
        r = plan.round_idx
        if keep > 1:
            # the steps take over `params`, so stale-weight plans need a
            # copy of each round's starting core (bounded ring buffer)
            core_log = (core_log + [_copy(params)])[-keep:]
        task = plan.tasks[0]          # the LLM driver distills R=1 per round
        edge = 1 + (task.edge_id % args.edges)  # silo 0 is the core set
        if task.staleness == FROZEN:
            src = w0
        elif task.staleness == 0:
            src = params
        else:
            src = core_log[max(len(core_log) - 1 - task.staleness, 0)]

        # Phase 1: edge fine-tune from the scheduled starting weights.
        t1 = time.perf_counter()
        teacher = _copy(src)
        t_opt = opt.init(teacher)
        for j, batch in enumerate(batches(edge, args.seed + 31 * r)):
            teacher, t_opt, m = pre_step(teacher, t_opt, batch, j)
        t_opt = None
        stale = ("" if not task.stale else
                 " stale=w0" if task.staleness == FROZEN else
                 f" stale={task.staleness}")
        tinfo = (f" t={plan.time:.2f}" if getattr(plan, "trigger", "")
                 else "")
        print(f"[round {r}] edge {edge} trained{stale}{tinfo}, "
              f"loss={float(m['loss']):.4f} "
              f"(phase1 {time.perf_counter() - t1:.2f}s)")

        if plan.withdraw:
            print(f"[round {r}] straggler round withdrawn (no distillation)")
            continue
        # One teacher's logits cross the uplink per distilled round.
        uplink_total += payload_bytes

        if meth.llm_averaging:
            # fedavg: the "distill" phase is parameter averaging (the
            # round's R=1 weighted average is the teacher itself).
            params = _copy(teacher)
            print(f"[round {r}] aggregated ({args.method}): "
                  f"core <- average of round teachers")
            continue

        # Phase 2: distillation into the core over the core silo, wired
        # per the method's LLM hints.
        t2 = time.perf_counter()
        if meth.llm_init_from_avg:
            params = _copy(teacher)   # FedDF: start from the teacher average
        buffer_params = (_copy(params)  # frozen clone
                         if meth.llm_buffer != "none" else teacher)
        ema = _copy(params) if meth.llm_ema else None
        opt_state = opt.init(params)
        # Melting's streaming "re-clone per epoch": --kd-epochs segments,
        # the buffer re-cloned at each segment start.
        remelt_every = max(args.steps_per_phase // max(args.kd_epochs, 1), 1)
        for j, batch in enumerate(batches(0, args.seed + 77 * r)):
            if meth.llm_buffer == "remelt" and j % remelt_every == 0 and j:
                buffer_params = _copy(params)
            params, opt_state, m = p2_step(params, teacher, buffer_params,
                                           opt_state, batch, j)
            if meth.llm_ema:
                ema = distill.ema_update(ema, params, args.ema_decay)
        if meth.llm_ema:
            params = ema
        opt_state = buffer_params = None
        loss, kd = float(m["loss"]), float(m["kd_loss"])
        dt = time.perf_counter() - t2
        print(f"[round {r}] distilled ({args.method}), loss={loss:.4f} "
              f"kd={kd:.4f} (phase2 {dt:.2f}s, "
              f"{args.steps_per_phase / dt:.2f} steps/s)")

    if codec is not None:
        ident = 4.0 * cfg.vocab_size * args.steps_per_phase * args.batch * args.seq
        print(f"transport={codec.spec}: uplink {uplink_total / 1e6:.3f} MB "
              f"total ({payload_bytes / 1e6:.3f} MB/teacher, "
              f"{ident / max(payload_bytes, 1.0):.1f}x vs raw float32)")
    nll = eval_nll(cfg, params, silos[1], args.batch, args.seq, device)
    print(f"final core NLL on edge-1 domain: {nll:.4f}")
    return params


if __name__ == "__main__":
    main()
