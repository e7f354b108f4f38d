"""Runner of the serving mixes: the program's ``ServeEngine`` (greedy) fed
by a closed loop of clients through its public session API (``begin``,
``tick``, ``pending``).

``begin`` replaces the session's queue, so the API cannot take a request
into a running session.  The closed loop is therefore queued whole at
``begin``, every request eligible at tick 0, in the order the clients hand
them over: with at least as many clients as slots and no think time the
engine then admits exactly what the clients would have handed it, and a
request counts as handed when the tick that finished the request before it
in that order returned (the first ``clients`` at ``begin``).  Each token
is stamped when the ``tick()`` that produced it returns: ``tick()`` ends in
a host read, so every stamp follows a device sync.

Set-up draws the weights, builds the engine and runs the warm-up ticks
(the first admission's prefill at the cell's bucket and a decode tick), so
every shape the window runs is warm.  The window is a fixed number of
ticks, ``seconds`` x the traffic's ``ticks_per_second`` (about the
program's tick rate on one H100 when the cell was made), and not a span
of the clock: output lengths in a fixed order make the closed loop's
schedule of admissions the same in every run, so every run does the same
work whatever the host's speed.  A window cut by the clock ends at one of
that schedule's uneven admissions, and on a host where one of them lands
next to the cut, runs of one seed read some 8% apart by which of the two
closes the window.  At three times ``seconds`` the window closes whatever
it has done, so that a stalled run still ends in time.  Once it has
closed and the engine is freed, the reference recomputes the
logits of a sample of finished requests.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchlib import compare, record, spec, streams, weights
from benchlib.record import Run

# what this runner asks of the configuration's architecture module
NEEDS = ("prefill_flops", "decode_token_flops", "served_logit_gaps")


class Book:
    """The clients' side of the loop: hand-over times, token stamps and
    one record a tick."""

    def __init__(self, requests, clients, now):
        self.requests = requests
        self.handed = {r.rid: now for r in requests[:clients]}
        self.open = list(requests[:clients])
        self.next = clients
        self.first = {}
        self.stamps = {}

    def tick(self, engine):
        before = {r.rid: len(r.out) for r in self.open}
        t0 = time.perf_counter()
        finished = engine.tick()
        t1 = time.perf_counter()
        rec = {"t0": t0, "t1": t1, "prompts": [], "rows": [], "tokens": 0}
        for r in self.open:
            had, got = before[r.rid], len(r.out) - before[r.rid]
            if got == 0:
                continue
            rec["tokens"] += got
            self.stamps.setdefault(r.rid, []).append(t1)
            if had == 0:
                self.first[r.rid] = t1
                rec["prompts"].append(len(r.prompt))
            if had > 0 or got > 1:
                # the decode fed out[-2] at position P + len(out) - 2 and
                # read the cache rows up to it
                rec["rows"].append(len(r.prompt) + len(r.out) - 1)
        for r in finished:
            self.open.remove(r)
            if self.next >= len(self.requests):
                raise RuntimeError("the closed loop ran out of requests; "
                                   "raise the traffic's blocks")
            nxt = self.requests[self.next]
            self.handed[nxt.rid] = t1
            self.open.append(nxt)
            self.next += 1
        return rec


def _tick_flops(arch, k, rec):
    return (sum(arch.prefill_flops(k, p) for p in rec["prompts"])
            + sum(arch.decode_token_flops(k, c) for c in rec["rows"]))


def session(cell, seed, device):
    """The engine over the seed's weights with the closed loop begun and
    warmed up: (engine, book, requests)."""
    from repro_torch.models.transformer import LMConfig
    from repro_torch.serve import engine as serve_engine
    from repro_torch.serve.streams import Request
    conf, tr = cell.config, cell.traffic
    eng = tr["engine"]
    if tr["clients"] < eng["slots"]:
        raise ValueError("a closed loop queued whole needs at least as many "
                         "clients as slots")
    k = weights.dims(conf)
    cfg = LMConfig(**weights.program_kwargs(conf))
    params = weights.draw_params(conf, seed, "weights", device)
    loop = streams.closed_loop(tr, seed, k["vocab"])
    requests = [Request(rid=i, arrival=0, prompt=p, max_new=o)
                for i, (p, o) in enumerate(loop)]
    engine = serve_engine.ServeEngine(
        cfg, params, slots=eng["slots"], max_len=eng["max_len"],
        paged=eng.get("paged", False), sample="greedy", device=device)
    engine.begin(requests)
    book = Book(requests, tr["clients"], time.perf_counter())
    for _ in range(tr["warm_ticks"]):
        book.tick(engine)
    return engine, book, requests


def run(cell, seed, seconds, trace, device, t0):
    tr = cell.traffic
    arch = spec.architecture(cell, *NEEDS)
    k = arch.dims(cell.config)
    engine, book, requests = session(cell, seed, device)
    clock = record.Clock(device)
    clock.sync()
    rec = Run(kind="serve", dims=k, traffic=tr,
              setup_s=time.perf_counter() - t0)
    setup_peak = record.memory(device)
    record.reset_peak(device)
    window = max(2, round(seconds * tr["ticks_per_second"]))
    start = time.perf_counter()
    while engine.pending() and len(rec.ticks) < window:
        tick = book.tick(engine)
        rec.ticks.append(tick)
        if tick["t1"] - start >= seconds * 3:
            break
    end = rec.ticks[-1]["t1"]
    rec.window_s = end - start
    rec.window_peak_bytes = record.memory(device)
    rec.memory_peak_bytes = max(setup_peak, rec.window_peak_bytes)
    rec.flops = sum(_tick_flops(arch, k, t) for t in rec.ticks)
    for rid, t in book.first.items():
        if start <= t <= end:
            rec.ttft_s.append(t - book.handed[rid])
    for stamps in book.stamps.values():
        rec.itl_s += [b - a for a, b in zip(stamps, stamps[1:]) if a >= start
                      and b <= end]
    served = [r for r in requests if r.rid in book.first
              and start <= book.first[r.rid] <= end]
    rec.attempted = len(served)
    if trace:
        from torch.profiler import record_function

        from benchlib import trace as tracing

        def sub():
            out = []
            for _ in range(tr["trace_ticks"]):
                with record_function("bench.tick"):
                    out.append(book.tick(engine))
            return out

        rec.trace_ticks, rec.trace = tracing.record(sub)
    done = _finished(book, engine, requests, tr["check"]["requests"])
    rec.failed = sum(len(r.out) != r.max_new for r in done)
    sample = _sample(done, tr["check"]["requests"], seed)
    del engine, book
    record.free(device)
    t_ref = time.perf_counter()
    widest = widest_gaps(cell.config, seed, device, sample)["f32"]
    rec.reference_s = time.perf_counter() - t_ref
    correct, checks = compare.judge({"logit_gap": widest}, cell.limits)
    return rec, correct and rec.failed == 0, checks


def served_gaps(cell, seed, seconds, device, precs=("f32",)):
    """The widest logit gaps of a sample of the requests that ``seconds``
    of the cell's own load finished (the readings a limit is set from)."""
    engine, book, requests = session(cell, seed, device)
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        book.tick(engine)
    done = _finished(book, engine, requests, cell.traffic["check"]["requests"])
    sample = _sample(done, cell.traffic["check"]["requests"], seed)
    del engine, book
    record.free(device)
    return widest_gaps(cell.config, seed, device, sample, precs)


def _finished(book, engine, requests, n, wait_s=60.0):
    """The finished requests, after ticking on (outside the window) for up
    to ``wait_s`` seconds until ``n`` have finished."""
    until = time.perf_counter() + wait_s
    while (sum(r.t_done >= 0 for r in requests) < n
           and time.perf_counter() < until):
        book.tick(engine)
    return [r for r in requests if r.t_done >= 0]


def _sample(done, n, seed):
    """The finished request with the most served tokens and ``n - 1``
    others drawn from the seed."""
    longest = max(done, key=lambda r: (len(r.out), -r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng((seed % 2**64, 0xC4EC))
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def sequences(sample, device):
    """Each request's prompt and served tokens but the last, and the
    served tokens."""
    seqs = [torch.as_tensor(np.concatenate([r.prompt, r.out[:-1]]),
                            dtype=torch.long, device=device) for r in sample]
    served = [torch.as_tensor(r.out, dtype=torch.long, device=device)
              for r in sample]
    return seqs, served


def widest_gaps(conf, seed, device, sample, precs=("f32",)):
    """{precision: widest gap}: "f32" for the served tokens, and for each
    further precision the gap of the tokens that precision puts first."""
    arch = spec.architecture(conf, "served_logit_gaps")
    params = weights.draw_params(conf, seed, "weights", device)
    seqs, served = sequences(sample, device)
    gaps = arch.served_logit_gaps(conf, params, seqs, served, precs)
    out = {"f32": float(max(g.max() for g, _ in gaps))}
    for p in precs[1:]:
        out[p] = float(max(o[p].max() for _, o in gaps))
    return out
