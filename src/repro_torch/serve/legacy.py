"""The frozen pre-engine serving loop, with its known defects: the parity
and bench baseline of the serving engine (the counterpart of
``repro.serve.legacy``; do not modernize).

``benchmarks/serve_bench.py`` measures the engine against this loop, and
the engine must be token-exact against it on request sets where the loop
is *correct* (position-homogeneous batches on tail-only configs).

Known defects, kept on purpose (the tests pin each):

  * shared-``ptick`` decode: every tick decodes the whole batch at
    ``max(pos)`` across slots, so a lagging slot attends and rotates at
    the wrong position whenever active slots sit at different positions;
  * ``max_new=1`` emits 2 tokens (one decode tick runs before the
    ``budget <= 0`` check);
  * one host read per slot per tick (``int(tokens[s, 0])``), and one
    exact-length prefill per admission;
  * ``prefill_into``'s per-slot cache write indexes the LEADING cache
    axis, which for stacked layers is the *layer* axis (n_super, S, W, N,
    D), not the batch axis, so on any stacked config the admitted cache is
    garbled (a slot index past the layer count writes nothing, as a JAX
    scatter drops out-of-bounds updates).  The loop is token-correct only
    on tail-only configs.

The port's ``decode_step`` takes a per-slot ``pos``; the loop hands it a
tensor filled with ``ptick``, so on the card its decode attention runs on
the ``swa_decode`` kernel.
"""

from __future__ import annotations

import torch

from repro_torch.models.transformer import Transformer
from repro_torch.tree import tree_device, tree_map


def legacy_serve_step(cfg):
    """The pre-engine ``make_serve_step``: one ``pos`` for the whole
    batch."""

    def step(params, cache, token, pos):
        logits, new_cache = Transformer.decode_step(cfg, params, cache, token,
                                                    pos)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        return nxt, new_cache

    return step


@torch.inference_mode()
def simulate(cfg, params, requests, slots, max_len, mesh=None, log=print):
    """Slot-based continuous batching, one decode tick per step, on the
    device ``params`` live on.  The port serves on one device, so ``mesh``
    must be None (meshes are slice 9)."""
    if mesh is not None:
        raise NotImplementedError(
            "legacy simulate(mesh=...) is not ported yet (ROADMAP.md queue 1, "
            "slice 9: sharding); the port serves on one device")
    device = tree_device(params)
    serve = legacy_serve_step(cfg)
    active = [None] * slots          # slot -> Request
    pos = [0] * slots                # per-slot decode position
    budget = [0] * slots
    queue = sorted(requests, key=lambda r: r.arrival)
    finished = []
    tokens = torch.zeros((slots, 1), dtype=torch.int32, device=device)
    caches = Transformer.init_cache(cfg, slots, max_len, device=device)
    step = 0

    def prefill_into(slot, req):
        """Single-sequence prefill written into the batched cache at
        ``slot`` (on the leading axis); the first token comes from the
        prefill's own last-position logits."""
        toks = torch.as_tensor(req.prompt, dtype=torch.int32,
                               device=device)[None, :]
        lg, c1 = Transformer.prefill(cfg, params, {"tokens": toks}, max_len)
        nxt = int(torch.argmax(lg[0, -1]))

        def put(batched, single):
            if slot < batched.shape[0]:
                batched[slot] = single[0].to(batched.dtype)
            return batched

        tree_map(put, caches, c1)
        tokens[slot, 0] = nxt
        req.out.append(nxt)
        return len(req.prompt)

    while queue or any(a is not None for a in active):
        # admit arrivals into free slots
        for s in range(slots):
            if active[s] is None and queue and queue[0].arrival <= step:
                req = queue.pop(0)
                plen = prefill_into(s, req)
                active[s], pos[s], budget[s] = req, plen, req.max_new - 1
                log(f"[t={step}] admit r{req.rid} -> slot {s} (prompt {plen})")
        if all(a is None for a in active):
            step += 1
            continue
        # one decode tick for the whole batch
        ptick = max(p if a is not None else 0 for p, a in zip(pos, active))
        tokens, caches = serve(params, caches, tokens,
                               torch.full((slots,), ptick, dtype=torch.int32,
                                          device=device))
        for s in range(slots):
            if active[s] is None:
                continue
            active[s].out.append(int(tokens[s, 0]))
            pos[s] += 1
            budget[s] -= 1
            if budget[s] <= 0 or pos[s] >= max_len - 1:
                active[s].done_at = step
                finished.append(active[s])
                log(f"[t={step}] finish r{active[s].rid} "
                    f"({len(active[s].out)} tokens)")
                active[s] = None
        step += 1
    return finished
