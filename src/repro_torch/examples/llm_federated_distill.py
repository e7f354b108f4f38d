"""LLM-scale federated distillation on the PyTorch port — Algorithm 1 with
transformer silos (the JAX package's ``examples/llm_federated_distill.py``).

Domain-specialist fine-tunes ("edges") are distilled into one central model
("core") that never sees the silo data.  Compares plain KD with buffered KD
on the core's own domain after distilling a foreign-domain specialist: BKD
should keep more of the core's own-domain quality (less forgetting).

Uses the reduced config of any ported token-LM arch; the same code path
runs at full width through ``repro_torch.launch.train --full``.

    PYTHONPATH=src python -m repro_torch.examples.llm_federated_distill \
        --arch granite-3-2b [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.core import distill
from repro_torch.data import make_token_stream
from repro_torch.launch import steps as St
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw
from repro_torch.tree import tree_map


def _copy(tree):
    return tree_map(lambda t: t.clone(), tree)


@torch.no_grad()
def nll_on(cfg, params, data, batch, seq, device, n=4, seed=9):
    rng = np.random.default_rng(seed)
    tot = torch.zeros((), dtype=torch.float32, device=device)
    for _ in range(n):
        sel = rng.integers(0, len(data), batch)
        toks = torch.as_tensor(data[sel], device=device)
        logits, _ = Transformer.apply(cfg, params, {"tokens": toks[:, :-1]})
        tot = tot + distill.ce_loss(logits, toks[:, 1:], vocab=cfg.vocab_size)
    return float(tot) / n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = registry.get_smoke_config(args.arch)
    data, domains = make_token_stream(cfg.vocab_size, 512, args.seq + 1,
                                      num_domains=2, seed=0)
    core_silo, edge_silo = data[domains == 0], data[domains == 1]

    opt = adamw(3e-4)
    pre = St.make_pretrain_step(cfg, opt, loss_chunk=args.seq)

    def batch_of(silo, rng):
        sel = rng.integers(0, len(silo), args.batch)
        toks = torch.as_tensor(silo[sel], device=device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def run_phase(params, silo, steps, seed):
        st = opt.init(params)
        rng = np.random.default_rng(seed)
        for i in range(steps):
            params, st, m = pre(params, st, batch_of(silo, rng), i)
        return params

    core = Transformer.init(cfg, 0, device=device)
    core = run_phase(core, core_silo, args.steps, 1)                # Phase 0
    teacher = run_phase(_copy(core), edge_silo, args.steps, 2)      # Phase 1
    base = nll_on(cfg, core, core_silo, args.batch, args.seq, device)
    print(f"core NLL on own domain before distillation: {base:.4f}")

    results = {}
    for mode in ("none", "clone"):                                  # KD vs BKD
        p2 = St.make_phase2_step(cfg, opt, buffer_mode=mode,
                                 loss_chunk=args.seq)
        p, buf = _copy(core), _copy(core)
        st = opt.init(p)
        rng = np.random.default_rng(3)
        for i in range(args.steps):
            barg = buf if mode == "clone" else torch.zeros((1,))
            p, st, m = p2(p, teacher, barg, st, batch_of(core_silo, rng), i)
        own = nll_on(cfg, p, core_silo, args.batch, args.seq, device)
        other = nll_on(cfg, p, edge_silo, args.batch, args.seq, device)
        name = "bkd" if mode == "clone" else "kd "
        print(f"{name}: own-domain NLL {own:.4f} (forgetting "
              f"{own - base:+.4f}), edge-domain NLL {other:.4f}")
        results[name.strip()] = (own, other)
    return base, results


if __name__ == "__main__":
    main()
