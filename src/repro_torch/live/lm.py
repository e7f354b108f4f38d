"""LM adapter + data: one Transformer as both FL core model and served model.

``lm_adapter`` wraps ``models.transformer.Transformer`` in the
:class:`repro_torch.core.fl.ModelAdapter` protocol so the whole FL stack
(Phase-0/1 training, every ``DistillMethod``, the KD kernel pair,
transport codecs) runs on LM params unchanged: the "classification" task
is next-token prediction at a token window's last position (logits sliced
to the real vocab; the padded tail never wins an argmax because it is
never a label).  The adapter's state *is* the Transformer params tree, so
``ServeEngine(cfg, trainer.state, ...)`` serves what the trainer updates.

``lm_fl_data`` builds the paper's edge-bias setting over
``data.synthetic.make_token_stream``: each edge silo is a distinct bigram
process (domain), the core/test sets draw from a reserved core domain, so
distilling a foreign-domain teacher drags the core off its own
distribution — the drift the live bench measures between swaps.  The
counterpart of ``repro.live.lm``; the arrays are the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import distill
from repro_torch.core.fl import ModelAdapter
from repro_torch.data.pipeline import Dataset
from repro_torch.data.synthetic import make_token_stream
from repro_torch.models.transformer import Transformer
from repro_torch.tree import tree_device


def lm_adapter(cfg):
    """A :class:`ModelAdapter` over ``Transformer`` for decoder configs:
    ``state`` is the params tree; ``logits(state, x)`` scores the next
    token after the (B, T) window ``x``.  ``init(gen, device)`` draws the
    params from ``gen``'s seed on ``device``."""
    if cfg.is_encoder:
        raise ValueError("lm_adapter needs a decoder config")
    # Phases 0 and 1 differentiate through torch.func (grad, vmap), which
    # takes no torch.utils.checkpoint; rematerialisation changes memory,
    # not numbers, and the FL windows are a few tokens long.
    fwd_cfg = dataclasses.replace(cfg, remat="none")

    def init(gen, device):
        return Transformer.init(cfg, gen.initial_seed(), device=device)

    def logits(state, x, train):
        lg, _ = Transformer.apply(fwd_cfg, state, {"tokens": x})
        return lg[:, -1, :cfg.vocab_size], state

    return ModelAdapter(init, logits, lambda s: s, lambda s, p: p)


def lm_fl_data(cfg, *, num_edges, seq_len=16, n_seqs=512, core_frac=0.7,
               seed=0):
    """Edge-biased LM datasets: ``(core_ds, edge_dss, test_ds, silos)``.

    ``num_edges + 1`` bigram domains; domain 0 is the core's own
    distribution (split ``core_frac`` / rest into core/test), domains
    ``1..num_edges`` are the edge silos.  Dataset rows are (T,) token
    windows with the following token as the label; ``silos`` maps
    ``"core"`` and each edge index to its raw (N, T+1) sequences for
    sequence-level NLL evaluation (:func:`nll_on`)."""
    toks, domains = make_token_stream(cfg.vocab_size, n_seqs, seq_len + 1,
                                      num_domains=num_edges + 1, seed=seed)
    x, y = toks[:, :-1], toks[:, -1]

    def subset(rows):
        return Dataset(x[rows], y[rows])

    core_rows = np.flatnonzero(domains == 0)
    n_core = max(int(len(core_rows) * core_frac), 1)
    core_ds, test_ds = subset(core_rows[:n_core]), subset(core_rows[n_core:])
    edge_dss = [subset(np.flatnonzero(domains == d))
                for d in range(1, num_edges + 1)]
    silos = {"core": toks[core_rows]}
    for d in range(1, num_edges + 1):
        silos[d - 1] = toks[domains == d]
    return core_ds, edge_dss, test_ds, silos


@torch.no_grad()
def nll_on(cfg, params, seqs, batch=16, n=2, seed=9):
    """Mean next-token NLL of ``params`` over (N, T+1) sequences ``seqs``
    (n deterministic minibatches, the JAX package's draw) — the live
    bench's drift metric."""
    rng = np.random.default_rng(seed)
    device = tree_device(params)
    losses = []
    for _ in range(n):
        sel = rng.integers(0, len(seqs), batch)
        toks = torch.as_tensor(seqs[sel], device=device)
        logits, _ = Transformer.apply(cfg, params, {"tokens": toks[:, :-1]})
        losses.append(distill.ce_loss(logits, toks[:, 1:],
                                      vocab=cfg.vocab_size))
    return float(torch.mean(torch.stack(losses)))
