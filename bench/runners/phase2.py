"""Runner of the Phase-2 training mixes: the paper's buffered distillation
(Algorithm 1, Phase 2; Eq. 4) or plain KD on an LLM core, through the
program's ``launch.steps.make_phase2_step`` with AdamW.

Set-up builds the one step object with the student, the teacher, the
buffer and the optimizer state, drives it through the checked steps (the
warm-up), reads what the comparison needs, and hands the same object to
the window.  The window runs whole steps, one in flight ahead of the host,
until ``seconds`` have passed, and ends in a device sync.  Once it has
closed and the program's state is freed, the reference follows the
checked steps from the same drawn start and feed.
"""

from __future__ import annotations

import time

import torch

from benchlib import compare, flops, record, spec, weights
from benchlib.record import Run

# what this runner asks of the configuration's architecture module
NEEDS = ("forward_flops", "follow_steps")


def _adamw(traffic):
    a = traffic["adamw"]
    return dict(b1=a["b1"], b2=a["b2"], eps=a["eps"],
                weight_decay=a["weight_decay"])


def build(cell, seed, device):
    """The program's step and state, drawn from the seed: (step, state
    dict, feed)."""
    from repro_torch import optim
    from repro_torch.launch import steps
    from repro_torch.models.transformer import LMConfig
    conf, tr = cell.config, cell.traffic
    cfg = LMConfig(**weights.program_kwargs(conf))
    vocab = weights.dims(conf)["vocab"]
    student = weights.draw_params(conf, seed, "student", device)
    teacher = weights.draw_params(conf, seed, "teacher", device)
    buffer = (weights.draw_params(conf, seed, "student", device)
              if tr["buffer_mode"] == "clone" else None)
    opt = optim.adamw(tr["adamw"]["lr"], **_adamw(tr))
    step = steps.make_phase2_step(cfg, opt, tau=tr["tau"],
                                  buffer_mode=tr["buffer_mode"],
                                  loss_chunk=tr["loss_chunk"],
                                  loss_backend="auto")
    state = {"student": student, "teacher": teacher, "buffer": buffer,
             "opt": opt.init(student)}

    def feed(i):
        return weights.token_batch(seed, i, tr["batch"], tr["seq"], vocab,
                                   device)

    return step, state, feed


def run_step(step, state, feed, i):
    """Step ``i`` through the program, its state carried in ``state``;
    returns the step's loss (a device scalar)."""
    state["student"], state["opt"], out = step(
        state["student"], state["teacher"], state["buffer"], state["opt"],
        feed(i), i)
    return out["loss"]


def checked_steps(cell, seed, device, step, state, feed):
    """The program's readings over the checked steps: each step's loss,
    the first gradient's norm of each leaf as AdamW got it (its first
    moment after one step over 1 - b1), and each leaf's change."""
    conf, tr = cell.config, cell.traffic
    specs = weights.leaf_specs(conf)
    out = {"losses": []}
    for i in range(tr["checked_steps"]):
        out["losses"].append(float(run_step(step, state, feed, i)))
        if i == 0:
            b1 = tr["adamw"]["b1"]
            out["grad_norms"] = [
                float(weights.leaf(state["opt"]["m"], p).norm()) / (1 - b1)
                for p, _, _ in specs]
    out["change_norms"] = []
    for j, (p, _, _) in enumerate(specs):
        p0 = weights.draw_leaf(conf, seed, "student", j, device).float()
        out["change_norms"].append(
            float((weights.leaf(state["student"], p).float() - p0).norm()))
        del p0
    return out


def reference(cell, seed, device, feed, prec="f32"):
    """The plain reference's readings over the same steps and feed."""
    conf, tr = cell.config, cell.traffic
    arch = spec.architecture(cell, "follow_steps")
    clone = tr["buffer_mode"] == "clone"
    teacher = weights.draw_params(conf, seed, "teacher", device)
    buffer = (weights.draw_params(conf, seed, "student", device)
              if clone else None)
    ref_tr = dict(tau=tr["tau"], lr=tr["adamw"]["lr"], **_adamw(tr))
    losses, grads, leaves = arch.follow_steps(
        conf, ref_tr, weights.leaf_names(conf),
        lambda j: weights.draw_leaf(conf, seed, "student", j, device),
        teacher, buffer, feed, tr["checked_steps"], prec=prec)
    del teacher, buffer
    change = []
    for j, name in enumerate(weights.leaf_names(conf)):
        p0 = weights.draw_leaf(conf, seed, "student", j, device).float()
        change.append(float((leaves[name] - p0).norm()))
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def run(cell, seed, seconds, trace, device, t0):
    tr = cell.traffic
    arch = spec.architecture(cell, *NEEDS)
    k = arch.dims(cell.config)
    clock = record.Clock(device)
    step, state, feed = build(cell, seed, device)
    prog = checked_steps(cell, seed, device, step, state, feed)
    clock.sync()
    rec = Run(kind="phase2", dims=k, traffic=tr,
              setup_s=time.perf_counter() - t0,
              step_flops=flops.phase2_step_flops(
                  k, tr["batch"], tr["seq"], tr["buffer_mode"] == "clone",
                  arch.forward_flops))
    setup_peak = record.memory(device)
    record.reset_peak(device)
    i = tr["checked_steps"]
    losses = []
    start = time.perf_counter()
    prev = None
    while True:
        losses.append(run_step(step, state, feed, i))
        i += 1
        done = torch.cuda.Event() if clock.cuda else None
        if done is not None:
            done.record()
        if prev is not None:
            prev.synchronize()
        if time.perf_counter() - start >= seconds:
            break
        prev = done
    rec.window_s = clock.now() - start
    rec.steps = i - tr["checked_steps"]
    rec.tokens = rec.steps * tr["batch"] * tr["seq"]
    rec.window_peak_bytes = record.memory(device)
    rec.memory_peak_bytes = max(setup_peak, rec.window_peak_bytes)
    rec.attempted = rec.steps
    rec.failed = sum(not torch.isfinite(x).item() for x in losses)
    if trace:
        from torch.profiler import record_function

        from benchlib import trace as tracing

        def sub():
            for j in range(i, i + tr["trace_steps"]):
                with record_function("bench.phase2_step"):
                    run_step(step, state, feed, j)

        _, rec.trace = tracing.record(sub)
        rec.trace_steps = tr["trace_steps"]
    del step, state, losses
    record.free(device)
    t_ref = time.perf_counter()
    ref = reference(cell, seed, device, feed)
    rec.reference_s = time.perf_counter() - t_ref
    correct, checks = compare.judge(compare.training_numbers(prog, ref),
                                    cell.limits)
    return rec, correct, checks
