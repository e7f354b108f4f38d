"""Serving demo on the PyTorch port — prefill + batched greedy decode for any
ported arch (the JAX package's ``examples/serve_decode.py``).

Runs ``make_prefill_step`` / ``make_serve_step`` (``repro_torch.launch.steps``
re-exports them) on the arch's reduced config: prompt -> prefill -> N greedy
tokens, with recurrent-state caches for the SSM/hybrid families and the
experts for the MoE ones.  Weights and prompts are random, from seeds 0 and
1 (other bits than the JAX package's draws).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \
        --arch mamba2-370m -n 16 [--device cpu]
"""

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.launch import steps as St
from repro_torch.models.transformer import Transformer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b",
                    choices=registry.list_archs())
    ap.add_argument("-n", "--new-tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = registry.get_smoke_config(args.arch)
    max_len = args.prompt_len + args.new_tokens + 1
    params = Transformer.init(cfg, 0, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size - 1,
                           (args.batch, args.prompt_len), generator=gen,
                           device=device, dtype=torch.int32)
    prefill = St.make_prefill_step(cfg, max_len)
    serve = St.make_serve_step(cfg)

    t0 = time.perf_counter()
    tok, cache = prefill(params, {"tokens": prompt})
    out = [tok]
    for i in range(args.new_tokens - 1):
        tok, cache = serve(params, cache, tok, args.prompt_len + i)
        out.append(tok)
    gen_tokens = torch.cat(out, dim=1).cpu()
    dt = time.perf_counter() - t0
    recurrent = any(k in ("ssd", "rglru") for k in cfg.block_pattern)
    print(f"arch={cfg.name} cache={'recurrent' if recurrent else 'kv'}")
    for b in range(args.batch):
        print(f"  seq{b}: {' '.join(str(int(t)) for t in gen_tokens[b])}")
    print(f"{args.new_tokens} tokens x {args.batch} seqs in {dt:.2f}s "
          f"({args.new_tokens * args.batch / dt:.1f} tok/s on {device}, "
          f"reduced config)")
    return gen_tokens


if __name__ == "__main__":
    main()
