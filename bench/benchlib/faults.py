"""Faults planted underneath the timed path, to show that the comparison
catches them: each patches the program's module attributes for the length
of a ``with`` block (the runners look them up at call time).

Training: ``frozen_state`` (a step that returns its state unchanged) and
``half_batch`` (half of the batch left out, the mean taken over the rest).
Serving: ``frozen_cache`` (the decode step writes no K/V: its cache state
unchanged), ``half_batch`` (the decode logits of the second half of the
slots are the first half's) and ``token_altered`` (every seventh sampling
call emits the next token id).  A one-card cell has no exchange between
cards to leave out.
"""

from __future__ import annotations

import contextlib

import torch

TRAINING = ("half_batch",)          # frozen_state reads 1 with no run
SERVING = ("frozen_cache", "half_batch", "token_altered")


def _patch(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    return lambda: setattr(module, name, old)


def _frozen_state():
    from repro_torch.launch import steps
    from repro_torch.tree import tree_map
    make = steps.make_phase2_step

    def faulty(*a, **kw):
        step = make(*a, **kw)

        def frozen(student, teacher, buf, opt_state, batch, i):
            copy = lambda t: tree_map(torch.clone, t)  # noqa: E731
            _, _, out = step(copy(student), teacher, buf, copy(opt_state),
                             batch, i)
            return student, opt_state, out
        return frozen

    return _patch(steps, "make_phase2_step", faulty)


def _half_batch_training():
    from repro_torch.launch import steps
    make = steps.make_phase2_step

    def faulty(*a, **kw):
        step = make(*a, **kw)

        def half(student, teacher, buf, opt_state, batch, i):
            part = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return step(student, teacher, buf, opt_state, part, i)
        return half

    return _patch(steps, "make_phase2_step", faulty)


def _frozen_cache():
    from repro_torch.nn import attention
    return _patch(attention, "write_slots", lambda cache, value, slot: None)


def _half_batch_serving():
    from repro_torch.models import transformer
    decode = transformer.Transformer.decode_step

    def half(*a, **kw):
        logits, caches = decode(*a, **kw)
        b = logits.shape[0]
        logits = logits.clone()
        logits[b - b // 2:] = logits[:b // 2]
        return logits, caches

    return _patch(transformer.Transformer, "decode_step", staticmethod(half))


def _token_altered():
    from repro_torch.serve import engine
    make = engine.make_sampler

    def faulty(*a, **kw):
        sampler = make(*a, **kw)
        calls = [0]

        def altered(logits, generator):
            calls[0] += 1
            out = sampler(logits, generator)
            if calls[0] % 7 == 0:
                out = (out + 1) % logits.shape[-1]
            return out
        return altered

    return _patch(engine, "make_sampler", faulty)


_FAULTS = {"frozen_state": _frozen_state, "half_batch": _half_batch_training,
           "frozen_cache": _frozen_cache,
           "half_batch_serving": _half_batch_serving,
           "token_altered": _token_altered}


@contextlib.contextmanager
def planted(name, serving=False):
    """Plant fault ``name`` for the block (``half_batch`` of a serving
    cell with ``serving``)."""
    key = "half_batch_serving" if serving and name == "half_batch" else name
    undo = _FAULTS[key]()
    try:
        yield
    finally:
        undo()
