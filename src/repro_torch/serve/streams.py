"""Request-stream scenarios — named arrival processes for the serving engine.

A copy of the JAX package's ``repro/serve/streams.py`` (numpy only, carried
over verbatim apart from this docstring's cross-references and the
request's per-token stamps, ``Request.t_tokens``, in place of its mean
``itl``): the same arguments and seed give the same stream in both
packages, which ``tests/test_torch_serve.py`` checks.

*When* requests arrive and *how long* their prompts/outputs are is a
distribution family, not a hard-coded loop: a ``STREAMS`` registry of named
arrival processes consumed by ``--stream <name>`` in the serving CLI.

Arrival times are integer *ticks* of the engine's virtual admission clock
(one decode step = one tick), matching the event-driven FL simulator's
virtual-clock convention.

Determinism: every draw comes from ``numpy.random.default_rng`` streams
keyed on ``(seed, tag)``, so a stream rebuilt with the same arguments is
identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Request:
    """One serving request plus its lifecycle bookkeeping.

    ``arrival`` is the virtual tick the request enters the queue; the
    engine stamps ``admitted_at``/``done_at`` (ticks) and
    ``t_enqueue``/``t_first``/``t_done`` (host wall-clock seconds) as the
    request moves through the slot lifecycle, and ``t_tokens``: the host
    time each token of ``out`` reached the host — the raw material for
    time-to-first-token and inter-token latency percentiles."""

    rid: int
    arrival: int
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    admitted_at: int = -1
    done_at: int = -1
    t_enqueue: float = -1.0
    t_first: float = -1.0
    t_done: float = -1.0
    prefix_pages: int = 0    # pages served from the paged engine's prefix
                             # cache at admission (0 on the dense engine)
    t_tokens: list = dataclasses.field(default_factory=list)

    @property
    def ttft(self) -> float:
        """Wall seconds from queue-eligible to first token on the host."""
        return self.t_first - self.t_enqueue


#: name -> one-line description (the CLI/docs surface).
STREAMS = {
    "poisson": "memoryless arrivals (exp. inter-arrival), uniform prompt/output lengths",
    "bursty": "closed bursts: groups of requests land on the same tick, idle gaps between",
    "diurnal": "sinusoidally modulated arrival rate (load peaks and troughs)",
    "heavy_tail": "poisson arrivals, lognormal prompt and output lengths (a few giants)",
}


def _lengths_uniform(rng, n, lo, hi):
    return rng.integers(lo, hi + 1, size=n)


def _lengths_lognormal(rng, n, lo, hi, sigma=0.8):
    """Lognormal lengths clipped to [lo, hi] — most requests short, a few
    near the cap (the serving analogue of the ``heavy_tail`` device
    family's lognormal speeds)."""
    raw = lo * np.exp(rng.normal(0.0, sigma, size=n))
    return np.clip(raw.astype(np.int64), lo, hi)


def with_shared_prefix(requests, prefix_len: int, *, vocab: int,
                       seed: int = 0, fraction: float = 1.0):
    """Prepend one deterministic ``prefix_len``-token system prompt to a
    ``fraction`` of the requests (the leading share of each stream, by
    rid) — the millions-of-users shape where most traffic opens with the
    same instructions.  Mutates and returns ``requests``; callers must
    budget ``max_len`` for the longer prompts."""
    rng = np.random.default_rng((seed, 0x9AEF, 1))
    prefix = rng.integers(0, max(vocab - 1, 1), size=prefix_len)
    cut = int(round(len(requests) * fraction))
    for r in requests:
        if r.rid < cut:
            r.prompt = np.concatenate([prefix, np.asarray(r.prompt)])
    return requests


def build_stream(name: str, num_requests: int, *, vocab: int, seed: int = 0,
                 mean_interarrival: float = 2.0, prompt_max: int = 48,
                 out_max: int = 16, shared_prefix: int = 0):
    """Instantiate a named stream from :data:`STREAMS` as a list of
    :class:`Request` sorted by arrival tick.

    ``vocab`` bounds the token ids (prompts draw from [0, vocab-1));
    ``prompt_max``/``out_max`` cap prompt/output lengths so callers can
    align them with the engine's ``max_len`` budget.  ``shared_prefix > 0``
    prepends that many identical system-prompt tokens to every request
    (see :func:`with_shared_prefix`)."""
    if name not in STREAMS:
        raise ValueError(f"unknown stream {name!r}; known: {sorted(STREAMS)}")
    # str hash() is per-process salted; key the stream on stable bytes.
    tag = int.from_bytes(name.encode()[:4], "little")
    rng = np.random.default_rng((seed, 0x57E3, tag))
    n = num_requests

    if name == "poisson":
        gaps = rng.exponential(mean_interarrival, size=n)
        arrivals = np.floor(np.cumsum(gaps)).astype(np.int64)
        plens = _lengths_uniform(rng, n, 4, prompt_max)
        onews = _lengths_uniform(rng, n, 2, out_max)
    elif name == "bursty":
        # Bursts of 2-6 requests on one tick, exponential gaps between
        # bursts — the worst case for one-at-a-time prefill admission.
        arrivals, t = [], 0.0
        while len(arrivals) < n:
            burst = int(rng.integers(2, 7))
            arrivals.extend([int(t)] * min(burst, n - len(arrivals)))
            t += rng.exponential(4.0 * mean_interarrival)
        arrivals = np.asarray(arrivals, np.int64)
        plens = _lengths_uniform(rng, n, 4, prompt_max)
        onews = _lengths_uniform(rng, n, 2, out_max)
    elif name == "diurnal":
        # Thinned Poisson: instantaneous rate follows one sinusoidal
        # "day" across the stream, so arrivals cluster at the peak.
        horizon = max(n * mean_interarrival, 1.0)
        times, t = [], 0.0
        while len(times) < n:
            t += rng.exponential(mean_interarrival / 2.0)
            phase = 2.0 * np.pi * (t % horizon) / horizon
            if rng.random() < 0.5 * (1.0 + np.sin(phase)):
                times.append(t)
        arrivals = np.floor(np.asarray(times)).astype(np.int64)
        plens = _lengths_uniform(rng, n, 4, prompt_max)
        onews = _lengths_uniform(rng, n, 2, out_max)
    else:  # heavy_tail
        gaps = rng.exponential(mean_interarrival, size=n)
        arrivals = np.floor(np.cumsum(gaps)).astype(np.int64)
        plens = _lengths_lognormal(rng, n, 4, prompt_max)
        onews = _lengths_lognormal(rng, n, 2, out_max)

    reqs = [Request(rid=i, arrival=int(a),
                    prompt=rng.integers(0, max(vocab - 1, 1), size=int(p)),
                    max_new=int(m))
            for i, (a, p, m) in enumerate(zip(arrivals, plens, onews))]
    if shared_prefix:
        with_shared_prefix(reqs, shared_prefix, vocab=vocab, seed=seed)
    return sorted(reqs, key=lambda r: (r.arrival, r.rid))
