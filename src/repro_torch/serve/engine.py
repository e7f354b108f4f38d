"""Serving engine of the port: slot-based continuous batching over dense
(full or ring) per-slot KV caches, the default, or the block-paged KV pool
(``paged=True``), with bucketed batched prefill (exact-length prefill on
recurrent archs) and params hot-swap.

The counterpart of ``repro.serve.engine.ServeEngine``.  Per-slot state
(current token, position, budget, active flag, caches or page table and
pools) lives on the engine's device; the host groups arrivals into
admissions and pulls ``(emitted, done)`` once per tick.  Where JAX jits an
admission step and a decode tick, the port runs the same functions eagerly.

Slot lifecycle: free -> (prefill writes cache/token/pos/budget, first token
from the prefill's own last-real-position logits) -> active decode ticks ->
done (budget exhausted or ``pos == max_len - 1``) -> free.  Inactive slots
ride along in the decode batch at a stale position and their outputs are
discarded; on the dense engine their cache writes are junk that the next
admission overwrites wholesale, on the paged engine they are redirected to
the trash page.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch import resolve_device, spans
from repro_torch.models.transformer import (LMConfig, Transformer,
                                            attention_only)
from repro_torch.serve.paged import (Admission, PageAllocator, TRASH_PAGE,
                                     pages_for)
from repro_torch.sharding.local import full, inference, whole
from repro_torch.sharding.rules import constrain, tree_map_axes


def make_serve_step(cfg: LMConfig):
    """One greedy decode step: (params, cache, token, pos) -> (next_token
    (B, 1) int32, cache).  ``pos`` is a scalar (the whole batch at one
    position) or (B,) (the engine's per-slot path); the cache is updated in
    place and returned."""

    @inference
    def step(params, cache, token, pos):
        logits, new_cache = Transformer.decode_step(cfg, params, cache, token,
                                                    pos)
        nxt = torch.argmax(whole(logits[:, -1, :]), dim=-1)
        nxt = nxt.to(torch.int32)[:, None]
        return nxt, new_cache

    return step


def make_prefill_step(cfg: LMConfig, max_len):
    """Prompt -> (first greedy token (B, 1) int32, fresh dense caches)."""

    @inference
    def step(params, batch):
        logits, cache = Transformer.prefill(cfg, params, batch, max_len)
        nxt = torch.argmax(whole(logits[:, -1, :]), dim=-1)
        nxt = nxt.to(torch.int32)[:, None]
        return nxt, cache

    return step


def make_sampler(sample: str = "greedy", temperature: float = 1.0,
                 top_k: int = 0):
    """Token sampler over (B, V) logits: ``(logits, generator) -> (B,)
    int32``.  ``greedy`` is exact argmax (first index on ties, as in JAX);
    ``topk`` masks to the top-k logits and draws at ``temperature`` from
    the engine's ``torch.Generator`` (other bits than ``jax.random``)."""
    if sample == "greedy":
        return lambda logits, generator: torch.argmax(
            whole(logits), dim=-1).to(torch.int32)
    if sample != "topk":
        raise ValueError(f"unknown sampler {sample!r}; known: greedy, topk")

    def sampler(logits, generator):
        lg = logits / max(temperature, 1e-6)
        if top_k:
            kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
            lg = lg.masked_fill(lg < kth, float("-inf"))
        probs = torch.softmax(lg, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

    return sampler


def bucket_length(n: int, *, minimum: int = 8) -> int:
    """Smallest power of two >= max(n, minimum) — the prefill length bucket."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _merge_caches(old, new, fill):
    """Per-slot cache replacement: rows of ``new`` where ``fill`` (S,) bool,
    rows of ``old`` elsewhere.  The batch axis is axis 1 under the stacked
    "blocks" subtree (leading layers axis) and axis 0 for tail blocks."""

    def merge(o, n, batch_axis):
        if isinstance(o, dict):
            return {k: merge(o[k], n[k], batch_axis) for k in o}
        shape = [1] * o.dim()
        shape[batch_axis] = fill.shape[0]
        return torch.where(fill.reshape(shape), n.to(o.dtype), o)

    return {key: merge(old[key], new[key], 1 if key == "blocks" else 0)
            for key in old}


def make_admit_step(cfg: LMConfig, max_len: int, sampler, *, padded=True):
    """Bucketed batched admission on the dense engine: prefill (S, L)
    right-padded prompts and splice the filled slots' state.  Returns the
    new slot state, the first token per slot (from the prefill's own
    last-real-position logits) and the slots already done at admission
    (``max_new == 1``, or a prompt that reaches the ``max_len - 1`` edge).

    ``padded=False`` (recurrent archs) admits exact-length groups: every
    filled row's prompt spans the whole (S, L) row, so the prefill needs,
    and recurrent state tolerates, no pad-awareness; ``lengths`` still
    picks the last logit and sets ``pos``."""

    def admit(params, caches, tokens, pos, budget, active,
              prompts, lengths, max_news, fill, generator):
        logits, new_caches = Transformer.prefill(
            cfg, params, {"tokens": prompts}, max_len,
            lengths=lengths if padded else None)
        rows = torch.arange(prompts.shape[0], device=prompts.device)
        last = logits[rows, (lengths - 1).clamp(min=0).long()]   # (S, V)
        first = sampler(last, generator)                         # (S,)
        caches = _merge_caches(caches, new_caches, fill)
        tokens = torch.where(fill, first, tokens[:, 0])[:, None]
        pos = torch.where(fill, lengths, pos)
        budget = torch.where(fill, max_news - 1, budget)
        done_now = fill & ((budget <= 0) | (pos >= max_len - 1))
        active = (active | fill) & ~done_now
        return tokens, caches, pos, budget, active, first, done_now

    return admit


def _slot_state(slots, device):
    """Idle slots' (tokens, pos, budget, active), placed by their logical
    axes (the batch of slots)."""
    i32 = dict(dtype=torch.int32, device=device)
    return (constrain(torch.zeros((slots, 1), **i32), ("batch", None)),
            constrain(torch.zeros((slots,), **i32), ("batch",)),
            constrain(torch.zeros((slots,), **i32), ("batch",)),
            constrain(torch.zeros((slots,), dtype=torch.bool, device=device),
                      ("batch",)))


def make_init_state(cfg: LMConfig, slots: int, max_len: int, device):
    """Fresh dense slot state: zeroed caches and idle slots, placed by the
    same logical axes the admission and tick steps give them (caches by
    ``Transformer.cache_specs``; no-ops without an active mesh)."""

    def init():
        caches = tree_map_axes(
            lambda ax, c: constrain(c, ax), Transformer.cache_specs(cfg),
            Transformer.init_cache(cfg, slots, max_len, device=device))
        tokens, pos, budget, active = _slot_state(slots, device)
        return tokens, caches, pos, budget, active

    return init


def make_decode_tick(cfg: LMConfig, max_len: int, sampler):
    """One decode tick over all S slots of the dense engine: per-slot
    position decode (the ``swa_decode`` kernel on the card), device-side
    sampling, budget/done bookkeeping."""

    def tick(params, caches, tokens, pos, budget, active, generator):
        logits, caches = Transformer.decode_step(cfg, params, caches, tokens,
                                                 pos)
        nxt = sampler(logits[:, -1, :], generator)               # (S,)
        act = active.to(torch.int32)
        emitted = torch.where(active, nxt, tokens[:, 0])
        pos = pos + act
        budget = budget - act
        done = active & ((budget <= 0) | (pos >= max_len - 1))
        return emitted[:, None], caches, pos, budget, active & ~done, done

    return tick


def make_paged_admit_step(cfg: LMConfig, max_len: int, sampler, page_size: int):
    """One batched admission of a group of slots sharing a prefix-hit depth
    ``npp`` (pages already resident from the prefix cache).  ``prompts``
    holds the right-padded prompt *suffixes*; the prefill scatters their
    K/V into the slots' private pages and attends [shared prefix pages,
    suffix] at absolute positions.  Returns the new slot state, the first
    token per slot and the slots already done at admission."""

    def admit(params, caches, pt, tokens, pos, budget, active,
              prompts, lengths, max_news, fill, generator, *, npp):
        b, length = prompts.shape
        start = npp * page_size
        positions = (start + torch.arange(length, dtype=torch.int32,
                                          device=prompts.device)).expand(b, length)
        if cfg.rope == "mrope":
            positions = positions[:, None, :].expand(b, 3, length)
        logits, caches = Transformer.paged_prefill(
            cfg, params, {"tokens": prompts, "positions": positions},
            caches, pt, lengths, fill, npp, page_size)
        rows = torch.arange(b, device=prompts.device)
        last = logits[rows, (lengths - 1).clamp(min=0).long()]   # (S, V)
        first = sampler(last, generator)                         # (S,)
        tokens = torch.where(fill, first, tokens[:, 0])[:, None]
        pos = torch.where(fill, start + lengths, pos)
        budget = torch.where(fill, max_news - 1, budget)
        done_now = fill & ((budget <= 0) | (pos >= max_len - 1))
        active = (active | fill) & ~done_now
        return tokens, caches, pos, budget, active, first, done_now

    return admit


def make_paged_decode_tick(cfg: LMConfig, max_len: int, sampler,
                           page_size: int):
    """One decode tick over all S slots: per-slot-position paged decode,
    device-side sampling, budget/done bookkeeping.  Inactive rows' cache
    writes go to the trash page (a freed slot's stale table may alias pages
    since granted to another slot)."""

    def tick(params, caches, pt, tokens, pos, budget, active, generator):
        logits, caches = Transformer.paged_decode_step(
            cfg, params, caches, pt, tokens, pos, active,
            page_size=page_size)
        nxt = sampler(logits[:, -1, :], generator)               # (S,)
        act = active.to(torch.int32)
        emitted = torch.where(active, nxt, tokens[:, 0])
        pos = pos + act
        budget = budget - act
        done = active & ((budget <= 0) | (pos >= max_len - 1))
        return emitted[:, None], caches, pos, budget, active & ~done, done

    return tick


def make_paged_init_state(cfg: LMConfig, slots: int, num_pages: int,
                          page_size: int, pages_per_slot: int, device):
    """Fresh slot state: zeroed pools, an all-trash page table, and idle
    slots."""

    def init():
        caches = tree_map_axes(
            lambda ax, c: constrain(c, ax), Transformer.paged_cache_specs(cfg),
            Transformer.init_paged_cache(cfg, num_pages, page_size,
                                         device=device))
        pt = constrain(torch.zeros((slots, pages_per_slot), dtype=torch.int32,
                                   device=device), ("batch", None))
        tokens, pos, budget, active = _slot_state(slots, device)
        return tokens, caches, pt, pos, budget, active

    return init


class ServeEngine:
    """Slot-based continuous batching with device-resident slot state, over
    dense per-slot KV caches (the default; full length, or a ring buffer
    with ``ring_cache``) or a block-paged KV pool with prefix sharing
    (``paged=True``)::

        engine = ServeEngine(cfg, params, slots=4, max_len=96)
        finished = engine.run(build_stream("poisson", 16, vocab=cfg.vocab_size))

    ``params`` must live on ``device`` (default ``cuda``)."""

    def __init__(self, cfg: LMConfig, params, *, slots: int, max_len: int,
                 sample: str = "greedy", temperature: float = 1.0,
                 top_k: int = 0, seed: int = 0, min_bucket: int = 8,
                 paged: bool = False, page_size: int = 16,
                 num_pages: int = None, device="cuda"):
        if cfg.is_encoder:
            raise ValueError("encoder-only arch has no decode step")
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, engine device "
                             f"is {self.device}")
        self.cfg, self.params = cfg, params
        self.slots, self.max_len = slots, max_len
        self.min_bucket = min_bucket
        sampler = make_sampler(sample, temperature, top_k)
        self._stochastic = sample != "greedy"
        self._seed = seed
        self._generator = torch.Generator(device=self.device)
        # Recurrent blocks need exact-length (unbucketed) prefill: padded
        # prompts would fold pad tokens into the carried state.
        self._bucketed = attention_only(cfg)
        # (prompt length, prefix-hit depth) of every admission run; kept
        # across reset(), as the JAX engine's jit cache is
        self._admit_shapes = set()
        self.paged = paged
        if paged:
            self.page_size = page_size
            self.pages_per_slot = pages_for(max_len, page_size)
            # +1 for the trash page: with every unreferenced cached prefix
            # evictable, the default pool can always grant what a free slot
            # needs.
            self.num_pages = num_pages or slots * self.pages_per_slot + 1
            self._alloc = PageAllocator(self.num_pages, page_size)
            self._admit_fn = make_paged_admit_step(cfg, max_len, sampler,
                                                   page_size)
            self._tick_fn = make_paged_decode_tick(cfg, max_len, sampler,
                                                   page_size)
            self._init_fn = make_paged_init_state(
                cfg, slots, self.num_pages, page_size, self.pages_per_slot,
                self.device)
        else:
            self._admit_fn = make_admit_step(cfg, max_len, sampler,
                                             padded=self._bucketed)
            self._tick_fn = make_decode_tick(cfg, max_len, sampler)
            self._init_fn = make_init_state(cfg, slots, max_len, self.device)
        self.reset()

    @inference
    def reset(self):
        if self.paged:
            (self.tokens, self.caches, self.pt, self.pos, self.budget,
             self.active) = self._init_fn()
            self._alloc.reset()
            self._pt_host = np.zeros((self.slots, self.pages_per_slot),
                                     np.int32)
            self._slot_adm = [None] * self.slots  # slot -> Admission | None
        else:
            (self.tokens, self.caches, self.pos, self.budget,
             self.active) = self._init_fn()
        self._host_active = [None] * self.slots   # slot -> Request | None
        self.ticks = 0
        self.decode_ticks = 0    # ticks that ran the decode step
        # a reset engine reproduces a fresh ServeEngine(seed=...)
        self._generator.manual_seed(self._seed)
        # hot-swap standby buffer and counters restart with the sampler, so
        # back-to-back runs on one engine reproduce each other
        self._standby = None
        self.swaps = 0
        self.swap_log = []       # tick index of each committed swap
        self._queue = []
        self._queue_total = 0
        self._finished = []
        self._base = 0
        self._now = 0
        self._log = None

    # -- hot swap ------------------------------------------------------------

    def stage_params(self, params):
        """Copy ``params`` onto the engine's device into the standby buffer,
        off the tick path.  The served params are untouched until
        :meth:`commit_swap`.  The copy is a real one even on the same device
        (JAX arrays are immutable, tensors are not): a trainer that goes on
        updating its tensors in place cannot change what is served."""
        self._standby = _copy_to(params, self.device)

    def commit_swap(self):
        """Flip the served params to the staged buffer.  Call it between
        ticks: :meth:`tick` reads ``self.params`` once at entry, so every
        token of a tick (admission prefill and decode) sees one version."""
        if self._standby is None:
            raise RuntimeError("commit_swap() without stage_params()")
        self.params = self._standby
        self._standby = None
        self.swaps += 1
        self.swap_log.append(self.ticks)
        if self.paged:
            # Cached prefix K/V was computed under the old params: drop the
            # prefix map (pages pinned by in-flight slots live on, as a
            # dense slot decodes on across a swap).
            self._alloc.bump_epoch()

    def hot_swap(self, params):
        """``stage_params`` + ``commit_swap`` in one call."""
        self.stage_params(params)
        self.commit_swap()

    # -- bookkeeping ---------------------------------------------------------

    def _bucket(self, prompt_len: int) -> int:
        """Pow2 length bucket, capped at max_len."""
        return min(bucket_length(prompt_len, minimum=self.min_bucket),
                   self.max_len)

    def prefill_compile_count(self) -> int:
        """Distinct admission shapes run so far: one per (length bucket,
        prefix-hit depth), the key of a jit cache entry in the JAX engine,
        which traces one prefill executable per such shape.  The port runs
        eagerly and has no trace to pay; the count says what the JAX
        engine would have compiled on the same stream."""
        return len(self._admit_shapes)

    def cache_page_bytes(self) -> int:
        """Bytes one physical page occupies summed over every layer's K and
        V pool (0 on the dense engine)."""
        if not self.paged:
            return 0
        return sum(t.numel() // self.num_pages * t.element_size()
                   for t in _leaves(self.caches))

    def resident_cache_bytes(self, peak: bool = True) -> int:
        """KV-cache residency: the dense engine always holds its full
        ``slots x cache length`` allocation; the paged engine pages in use
        (or their high-water mark with ``peak``) times the page bytes."""
        if not self.paged:
            return sum(t.numel() * t.element_size()
                       for t in _leaves(self.caches))
        pages = self._alloc.peak if peak else self._alloc.in_use
        return pages * self.cache_page_bytes()

    def prefix_stats(self) -> dict:
        """Prefix-cache counters (zeros on the dense engine)."""
        if not self.paged:
            return {"hits": 0, "misses": 0, "evictions": 0,
                    "peak_pages": 0, "pages_in_use": 0}
        a = self._alloc
        return {"hits": a.hits, "misses": a.misses, "evictions": a.evictions,
                "peak_pages": a.peak, "pages_in_use": a.in_use}

    def _tensor(self, array):
        return torch.tensor(array, device=self.device)

    # -- admission -----------------------------------------------------------

    def _admit_group(self, params, group, now, log):
        """One batched dense admission: prompts right-padded to the group's
        largest length bucket at the full slot batch (exact length, and
        length-homogeneous, on the recurrent path).  ``params`` is the
        tick's single params read."""
        s = self.slots
        length = max(len(r.prompt) for _, r in group)
        if self._bucketed:
            length = self._bucket(length)
        with spans.span("serve.admit", rows=len(group),
                        prompt_tokens=sum(len(r.prompt) for _, r in group),
                        positions=s * length,
                        rids=[r.rid for _, r in group]):
            prompts = np.zeros((s, length), np.int32)
            lengths = np.ones((s,), np.int32)
            max_news = np.ones((s,), np.int32)
            fill = np.zeros((s,), bool)
            for slot, req in group:
                plen = len(req.prompt)
                prompts[slot, :plen] = req.prompt
                lengths[slot], max_news[slot], fill[slot] = (plen,
                                                             req.max_new,
                                                             True)
            self._admit_shapes.add((length, None))
            with spans.span("serve.prefill"):
                (self.tokens, self.caches, self.pos, self.budget,
                 self.active, first, done_now) = self._admit_fn(
                    params, self.caches, self.tokens, self.pos, self.budget,
                    self.active, self._tensor(prompts), self._tensor(lengths),
                    self._tensor(max_news), self._tensor(fill),
                    self._generator)
            self._post_admit(group, first, done_now, now, length, log)

    def _post_admit(self, group, first, done_now, now, length, log):
        """Pull (first, done) once, stamp the requests, finish the
        already-done slots."""
        first_np, done_np = full(torch.stack(
            [first, done_now.to(torch.int32)])).cpu().numpy()
        t_wall = time.perf_counter()
        for slot, req in group:
            req.out.append(int(first_np[slot]))
            req.t_tokens.append(t_wall)
            req.admitted_at = now
            req.t_first = t_wall
            self._host_active[slot] = req
            if log:
                log(f"[t={now}] admit r{req.rid} -> slot {slot} "
                    f"(prompt {len(req.prompt)} pad {length})")
            if done_np[slot]:
                self._finish(slot, now, t_wall, log)

    def _admit_paged(self, params, batch, now, log):
        """Grant pages (consulting the prefix cache) per request, then run
        one batched prefill per prefix-hit depth, shallower groups first so
        that a same-tick deeper hit gathers pages a shallower admission just
        wrote.  A request the pool cannot grant requeues with everything
        behind it (FIFO order kept)."""
        groups = {}
        requeue = []
        for idx, (slot, req) in enumerate(batch):
            total = min(len(req.prompt) + req.max_new - 1, self.max_len - 1)
            adm = self._alloc.admit(req.prompt, total)
            if adm is None:
                requeue = [r for _, r in batch[idx:]]
                break
            self._slot_adm[slot] = adm
            self._pt_host[slot, :] = TRASH_PAGE
            self._pt_host[slot, :len(adm.pages)] = adm.pages
            req.prefix_pages = adm.shared
            groups.setdefault(adm.shared, []).append((slot, req))
        if requeue:
            self._queue[:0] = requeue
        if not groups:
            return
        self.pt = self._tensor(self._pt_host)
        for npp in sorted(groups):
            self._admit_group_paged(params, groups[npp], npp, now, log)

    def _admit_group_paged(self, params, group, npp, now, log):
        """One batched admission at prefix-hit depth ``npp``: rows carry the
        prompt suffixes, right-padded to the suffix length bucket, at the
        full slot batch."""
        s = self.slots
        start = npp * self.page_size
        length = self._bucket(max(len(r.prompt) - start for _, r in group))
        with spans.span("serve.admit", rows=len(group),
                        prompt_tokens=sum(len(r.prompt) - start
                                          for _, r in group),
                        positions=s * length,
                        rids=[r.rid for _, r in group]):
            prompts = np.zeros((s, length), np.int32)
            lengths = np.ones((s,), np.int32)
            max_news = np.ones((s,), np.int32)
            fill = np.zeros((s,), bool)
            for slot, req in group:
                sl = len(req.prompt) - start
                prompts[slot, :sl] = req.prompt[start:]
                lengths[slot], max_news[slot], fill[slot] = (sl, req.max_new,
                                                             True)
            self._admit_shapes.add((length, npp))
            with spans.span("serve.prefill"):
                (self.tokens, self.caches, self.pos, self.budget,
                 self.active, first, done_now) = self._admit_fn(
                    params, self.caches, self.pt, self.tokens, self.pos,
                    self.budget, self.active, self._tensor(prompts),
                    self._tensor(lengths), self._tensor(max_news),
                    self._tensor(fill), self._generator, npp=npp)
            self._post_admit(group, first, done_now, now, length, log)

    def _finish(self, slot, now, t_wall, log):
        req = self._host_active[slot]
        req.done_at, req.t_done = now, t_wall
        self._host_active[slot] = None
        self._finished.append(req)
        if self.paged:
            # Cached prefix pages stay resident at refcount zero for later
            # hits.  The device table is refreshed at the next admission;
            # until then the stale row only backs trash-redirected writes
            # and masked reads.
            self._alloc.release(self._slot_adm[slot])
            self._slot_adm[slot] = None
            self._pt_host[slot, :] = TRASH_PAGE
        if log:
            log(f"[t={now}] finish r{req.rid} ({len(req.out)} tokens)")

    # -- the loop ------------------------------------------------------------

    def begin(self, requests, log=None, rebase=True):
        """Open a serving session over ``requests``; the caller advances it
        one :meth:`tick` at a time.  Arrival ticks are relative to this
        call by default: a warm engine (a second session without
        ``reset``) rebases them onto its running clock.  ``rebase=False``
        keeps absolute arrival ticks."""
        for r in requests:
            if len(r.prompt) >= self.max_len:
                raise ValueError(f"request {r.rid}: prompt length "
                                 f"{len(r.prompt)} >= max_len {self.max_len}")
        self._queue = sorted(requests, key=lambda r: (r.arrival, r.rid))
        self._queue_total = len(self._queue)
        self._finished = []
        self._base = self.ticks if rebase else 0
        self._now = self.ticks
        self._log = log

    def pending(self) -> bool:
        """True while the session has queued or in-flight requests."""
        return bool(self._queue) or any(r is not None
                                        for r in self._host_active)

    @property
    def queue_cursor(self) -> int:
        """How many of the session's requests left the queue (admitted or
        finished): the stream cursor the live checkpoint records."""
        return self._queue_total - len(self._queue)

    @inference
    def tick(self):
        """One iteration of the serving loop: stamp newly eligible arrivals,
        admit them into free slots, run one decode tick over all slots
        (skipped while none is active), advance the virtual clock.  Returns
        the requests finished during this tick.

        ``self.params`` is read once at entry, so a :meth:`commit_swap`
        between ticks is atomic: no tick mixes params versions."""
        with spans.span("serve.tick"):
            return self._tick()

    def _tick(self):
        params = self.params
        log, now, base = self._log, self._now, self._base
        queue = self._queue
        n_done = len(self._finished)
        # TTFT starts when a request becomes eligible, not at admission.
        t_wall = time.perf_counter()
        for r in queue:
            if r.arrival + base <= now and r.t_enqueue < 0:
                r.t_enqueue = t_wall
            elif r.arrival + base > now:
                break
        free = [s for s in range(self.slots) if self._host_active[s] is None]
        batch = []
        while free and queue and queue[0].arrival + base <= now:
            batch.append((free.pop(0), queue.pop(0)))
        if self.paged and batch:
            self._admit_paged(params, batch, now, log)
        elif self._bucketed and batch:
            # One admission per tick at the largest arrival's bucket: the
            # padding is invisible (lengths= masks it), so splitting
            # same-tick arrivals per bucket would only add prefills.
            self._admit_group(params, batch, now, log)
        elif batch:
            # Recurrent (exact-length) admission: rows cannot be padded, so
            # one prefill per exact prompt length, shortest first.
            groups = {}
            for slot, req in batch:
                groups.setdefault(len(req.prompt), []).append((slot, req))
            for _, group in sorted(groups.items()):
                self._admit_group(params, group, now, log)
        if any(r is not None for r in self._host_active):
            with spans.span("serve.decode"):
                if self.paged:
                    (self.tokens, self.caches, self.pos, self.budget,
                     self.active, done) = self._tick_fn(
                        params, self.caches, self.pt, self.tokens,
                        self.pos, self.budget, self.active,
                        self._generator)
                else:
                    (self.tokens, self.caches, self.pos, self.budget,
                     self.active, done) = self._tick_fn(
                        params, self.caches, self.tokens, self.pos,
                        self.budget, self.active, self._generator)
            self.decode_ticks += 1
            with spans.span("serve.decode_read"):
                emitted_np, done_np = full(torch.stack(
                    [self.tokens[:, 0],
                     done.to(torch.int32)])).cpu().numpy()
            t_wall = time.perf_counter()
            for s in range(self.slots):
                req = self._host_active[s]
                if req is None:
                    continue
                req.out.append(int(emitted_np[s]))
                req.t_tokens.append(t_wall)
                if done_np[s]:
                    self._finish(s, now, t_wall, log)
        self._now = now + 1
        self.ticks = self._now
        return self._finished[n_done:]

    def run(self, requests, log=None):
        """Serve ``requests`` to completion; returns them finished, with
        per-request tick and wall-clock lifecycle stamps filled in."""
        self.begin(requests, log=log)
        while self.pending():
            self.tick()
        return self._finished

    # -- fused-checkpoint carry (repro_torch.checkpoint.io.save_live_state) --

    def carry(self):
        """(arrays tree, JSON meta) capturing the engine between ticks: the
        device-resident slot state, the sampling generator's state, and the
        session's host bookkeeping (clock, swap epoch, stream cursor, and
        each in-flight/finished request's lifecycle, by rid, so the
        deterministic arrival stream can be re-spliced on restore).

        The sampling state deviates from the JAX package, whose RNGs the
        port's cannot match: the generator's state goes under
        ``generator``, and ``key`` holds ``[0, seed]`` as uint32, the JAX
        engine's ``key_data(jax.random.key(seed))``, which a greedy JAX
        engine never advances, so the JAX loader finds the leaf it asks
        for."""
        tree = {"tokens": self.tokens, "caches": self.caches,
                "pos": self.pos, "budget": self.budget,
                "active": self.active,
                "key": np.asarray([0, self._seed], np.uint32),
                "generator": self._generator.get_state()}
        if self.paged:
            tree["pt"] = self.pt
        req_meta = lambda r: {"rid": r.rid,  # noqa: E731
                              "out": [int(t) for t in r.out],
                              "admitted_at": r.admitted_at,
                              "done_at": r.done_at}
        meta = {"ticks": self.ticks, "now": self._now, "base": self._base,
                "swaps": self.swaps, "swap_log": list(self.swap_log),
                "queue_cursor": self.queue_cursor,
                "queue_total": self._queue_total,
                "slots": [None if r is None else req_meta(r)
                          for r in self._host_active],
                "finished": [req_meta(r) for r in self._finished]}
        if self.paged:
            meta["paged"] = {
                "alloc": self._alloc.snapshot(),
                "pt": self._pt_host.tolist(),
                "slot_adm": [None if a is None else a.as_meta()
                             for a in self._slot_adm]}
        return tree, meta

    @inference
    def restore(self, path, meta, requests):
        """Inverse of :meth:`carry` (in place, from the fused checkpoint at
        ``path``): ``requests`` must be the same arrival stream the saved
        session was begun with; its Request objects are re-spliced into
        queue/slots/finished by rid.  A checkpoint without ``generator``
        (one the JAX package wrote) restores a greedy engine and is
        refused by a sampling one: its key stream cannot be carried
        across."""
        from repro_torch.checkpoint import io
        p = path if path.endswith(".npz") else path + ".npz"
        with np.load(p) as data:
            has_generator = "engine/generator" in data.files
        if not has_generator and self._stochastic:
            raise ValueError(
                "checkpoint has no engine/generator (the JAX package's "
                "format: its sampling key cannot drive the port's "
                "torch.Generator); only a greedy engine restores it")
        like = {"engine": {"tokens": self.tokens, "caches": self.caches,
                           "pos": self.pos, "budget": self.budget,
                           "active": self.active}}
        if has_generator:
            like["engine"]["generator"] = self._generator.get_state()
        if self.paged:
            like["engine"]["pt"] = self.pt
        tree = io.load_tree(path, like)["engine"]
        (self.tokens, self.caches, self.pos, self.budget, self.active) = (
            tree["tokens"], tree["caches"], tree["pos"], tree["budget"],
            tree["active"])
        if has_generator:
            self._generator.set_state(tree["generator"])
        if self.paged:
            pm = meta["paged"]
            self.pt = tree["pt"]
            self._pt_host = np.asarray(pm["pt"], np.int32)
            self._alloc = PageAllocator.from_snapshot(pm["alloc"])
            self._slot_adm = [None if a is None else Admission.from_meta(a)
                              for a in pm["slot_adm"]]
        ordered = sorted(requests, key=lambda r: (r.arrival, r.rid))
        by_rid = {r.rid: r for r in ordered}
        if len(ordered) != meta["queue_total"]:
            raise ValueError(
                f"restore stream has {len(ordered)} requests; checkpoint "
                f"was begun with {meta['queue_total']}")

        def splice(m):
            r = by_rid[m["rid"]]
            r.out = list(m["out"])
            r.admitted_at, r.done_at = m["admitted_at"], m["done_at"]
            return r

        self._queue = ordered[meta["queue_cursor"]:]
        self._queue_total = meta["queue_total"]
        self._host_active = [None if m is None else splice(m)
                             for m in meta["slots"]]
        self._finished = [splice(m) for m in meta["finished"]]
        self.ticks, self._now = meta["ticks"], meta["now"]
        self._base = meta["base"]
        self.swaps, self.swap_log = meta["swaps"], list(meta["swap_log"])
        self._standby = None


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _copy_to(tree, device):
    if isinstance(tree, dict):
        return {k: _copy_to(v, device) for k, v in tree.items()}
    return tree.detach().to(device, copy=True)


@contextlib.contextmanager
def engine_on(cfg, params, slots, max_len, mesh=None, **engine_kw):
    """A :class:`ServeEngine` to build and run inside the block.  With a
    ``mesh`` (a ``DeviceMesh``) the block is ``mesh_context(mesh)``, so
    the engine is built and run in the mesh's scope: its slot state and
    caches are DTensors placed by their logical axes, as the steps place
    their outputs, parameters the caller did not shard count as
    replicated, and the decode kernels run on every rank's local shards.
    What reaches the host (the emitted tokens) is whole on every rank."""
    from repro_torch.launch.mesh import mesh_scope
    with mesh_scope(mesh):
        yield ServeEngine(cfg, params, slots=slots, max_len=max_len,
                          **engine_kw)


def simulate(cfg, params, requests, slots, max_len, mesh=None, log=print,
             **engine_kw):
    """Functional wrapper with the JAX package's ``simulate`` signature:
    build an engine (on ``mesh``, :func:`engine_on`), serve the request
    list, return the finished requests."""
    with engine_on(cfg, params, slots, max_len, mesh=mesh,
                   **engine_kw) as engine:
        return engine.run(requests, log=log)
