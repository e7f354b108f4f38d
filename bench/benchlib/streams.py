"""The serving traffic generator: one general generator that every serving
mix's data file parametrises (lengths, clients, shared documents).

The length arithmetic is carried over from the program's
``serve/streams.py`` (``_lengths_uniform``, ``_lengths_lognormal``, the
shared prefix), with its seeding on ``numpy.random.default_rng``; the
benchmark keeps its own copy so that a change to the program cannot move
its traffic.  "strata" lengths give every block of ``clients`` requests the
same set of lengths (evenly spaced from ``lo`` to ``hi``) in an order drawn
from the seed, so two seeds do the same work in another order; with
``"order": "fixed"`` the order is one fixed draw for every seed.  Output
lengths alone decide when a closed loop's requests finish and so which
ticks admit; in a fixed order every seed runs the same schedule of
admissions, and the seed changes the weights, the prompts and their
lengths' order.
"""

from __future__ import annotations

import numpy as np


def lengths(rng, spec: dict, n: int, block: int):
    lo, hi, dist = spec["lo"], spec["hi"], spec["dist"]
    if dist == "uniform":
        return rng.integers(lo, hi + 1, size=n)
    if dist == "lognormal":
        raw = lo * np.exp(rng.normal(0.0, spec.get("sigma", 0.8), size=n))
        return np.clip(raw.astype(np.int64), lo, hi)
    if dist == "strata":
        grid = np.rint(np.linspace(lo, hi, block)).astype(np.int64)
        blocks = -(-n // block)
        if spec.get("order", "seed") == "fixed":
            rng = np.random.default_rng(0x0DE5)
        return np.concatenate([rng.permutation(grid)
                               for _ in range(blocks)])[:n]
    raise ValueError(f"unknown length distribution {dist!r}")


def closed_loop(traffic: dict, seed: int, vocab: int):
    """[(prompt ids, output tokens)] of a closed loop of ``clients``
    clients: ``blocks`` rounds of one request each, in the order they are
    handed to the engine.  With ``shared_prefix`` documents, each prompt
    is a document drawn from the seed followed by its own question of
    ``prompt_len`` tokens."""
    clients = traffic["clients"]
    n = clients * traffic["blocks"]
    rng = np.random.default_rng((seed % 2**64, 0x57E3, 0xB))
    plens = lengths(rng, traffic["prompt_len"], n, clients)
    olens = lengths(rng, traffic["output_len"], n, clients)
    docs_spec = traffic.get("shared_prefix", {"docs": 0, "len": 0})
    docs = [rng.integers(0, vocab, size=docs_spec["len"])
            for _ in range(docs_spec["docs"])]
    out = []
    for p, o in zip(plens, olens):
        prompt = rng.integers(0, vocab, size=int(p))
        if docs:
            prompt = np.concatenate([docs[rng.integers(len(docs))], prompt])
        out.append((prompt, int(o)))
    return out
