"""Step functions of the LLM-scale driver — the paper's Phase 2 with
transformer cores and edges (``repro.launch.steps``).

``make_phase2_step`` builds the buffered-KD training step: student forward
and backward, frozen teacher and frozen buffer forwards, and the chunked
big-vocabulary loss (Eqs. 3/4).  ``buffer_mode``:

    "clone"   the paper's setup: the frozen clone does a third forward
    "cached"  beyond the paper: precomputed (top-k compressed) buffer
              logits enter as an input
    "none"    plain KD (the Lin et al. baseline / ablation)

``ce_weight`` scales (or, at 0, drops) the CE term: FedDF's label-free
ensemble distillation.  ``make_pretrain_step`` is Phase 0/1 (plain CE).
The inference steps (``make_serve_step`` / ``make_prefill_step``) live
with the serving engine and are re-exported here.

Gradients come from ``torch.autograd``; a step returns the new parameters
and optimizer state.  The step takes over the parameter and
optimizer-state dicts it is given, as the reference's
``jax.jit(..., donate_argnums=...)`` does, and updates them leaf by leaf
(``optim.update_in_place``): the numbers are those of ``opt.update``, and
the peak memory holds one copy of the optimizer state instead of two.
Pass copies to keep the old trees.

The ``"pallas"`` loss backend keeps the reference's name.  Here it means
``repro_torch.kernels.ops.kd_loss``: the hand-written kernel pair
``kd_stats_fwd`` + ``kd_grad_bwd`` on a CUDA tensor, their plain versions on
a CPU tensor.  ``"auto"`` is ``"pallas"`` on a CUDA device and ``"jnp"``
(the plain PyTorch loss) elsewhere.
"""

from __future__ import annotations

import contextlib
import warnings

import torch
import torch.utils.checkpoint

from repro_torch import spans
from repro_torch.core import distill
from repro_torch.kernels import ops
from repro_torch.models.transformer import LMConfig, Transformer
from repro_torch.optim import update_in_place
from repro_torch.serve.engine import make_prefill_step, make_serve_step  # noqa: F401
from repro_torch.tree import tree_device, tree_leaves, tree_unflatten


def _chunks(s, chunk):
    """The loss chunk (``min(chunk, s)``, lowered until it divides s) and the
    number of chunks."""
    chunk = min(chunk, s)
    while s % chunk:
        chunk -= 1
    return chunk, s // chunk


def _map_chunks(one, nc):
    """``one(0)`` alone, or the mean of ``one(i)`` over the chunks with each
    chunk under ``torch.utils.checkpoint`` (the reference's
    ``lax.map(jax.checkpoint(one))``): only one chunk's (B, chunk, V)
    logits are alive at a time, and the backward pass runs each chunk's
    forward again."""
    if nc == 1:
        return one(0)
    return torch.mean(torch.stack([
        torch.utils.checkpoint.checkpoint(one, i, use_reentrant=False)
        for i in range(nc)]))


def _chunked_bkd_loss(cfg: LMConfig, student, teacher, buffer_params, batch,
                      h_s, h_t, h_b, tau, chunk, cached_buffer_logits=None,
                      topk=None, loss_backend="jnp", ce_weight=1.0,
                      teacher_transform=None):
    """Loss over sequence chunks, so that the (B, chunk, V) logit tensors
    are the only full-vocabulary values alive.  ``loss_backend="pallas"``
    evaluates each chunk's CE + KL (+ clone-buffer KL) with the fused kernel
    pair (``ops.kd_loss``) when the chunk has no token mask and no top-k
    approximation is asked for; with ``nc`` chunks (nc > 1) the recompute in
    the backward pass launches ``kd_stats_fwd`` again, so a step launches it
    2·nc times and ``kd_grad_bwd`` nc times (once each at nc = 1)."""
    b, s, d = h_s.shape
    chunk, nc = _chunks(s, chunk)
    labels = batch["labels"]
    mask = batch.get("mask")
    vocab = cfg.vocab_size

    def from_hidden(params, h):
        return Transformer.logits_from_hidden(cfg, params, h)

    def one(idx):
        sl = lambda t: t[:, idx * chunk:(idx + 1) * chunk]  # noqa: E731
        ls = from_hidden(student, sl(h_s))
        y = sl(labels)
        m = sl(mask).float() if mask is not None else None
        with torch.no_grad():
            lt = from_hidden(teacher, sl(h_t))
        if teacher_transform is not None:
            # Uplink transport: the student distills what the wire
            # delivered, not the raw teacher logits.
            lt = teacher_transform(lt, ls)
        if loss_backend == "pallas" and m is not None:
            # The fused kernel has no token mask, so masked batches take
            # the plain path; say so rather than mislabel the run (Python
            # shows a warning once per call site).
            warnings.warn("loss_backend='pallas' ignored for masked batches; "
                          "using the jnp chunked loss")
        if loss_backend == "pallas" and m is None and not topk:
            lb2 = None
            if h_b is not None:
                with torch.no_grad():
                    lb2 = from_hidden(buffer_params, sl(h_b))
                lb2 = distill._mask_pad(lb2.reshape(-1, lb2.shape[-1]), vocab)
            flat = lambda a: distill._mask_pad(  # noqa: E731
                a.reshape(-1, a.shape[-1]), vocab)
            loss = ops.kd_loss(y.reshape(-1), flat(ls), flat(lt), lb2, tau)
            if cached_buffer_logits is not None:
                c = cached_buffer_logits
                loss = loss + distill.topk_kl_cached(
                    ls, sl(c["top_vals"]), sl(c["top_idx"]),
                    sl(c["tail_lse"]), tau, vocab=vocab)
            return loss
        # ce_weight=1 keeps the reference's composition; 0 skips the CE
        # term (FedDF's label-free ensemble distillation).
        if ce_weight == 1.0:
            loss = distill.ce_loss(ls, y, vocab=vocab, mask=m)
        elif ce_weight:
            loss = ce_weight * distill.ce_loss(ls, y, vocab=vocab, mask=m)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=ls.device)
        if topk:
            loss = loss + distill.topk_kl(ls, lt, tau, topk, vocab=vocab, mask=m)
        else:
            loss = loss + distill.kl_soft(ls, lt, tau, vocab=vocab, mask=m)
        if h_b is not None:
            with torch.no_grad():
                lb = from_hidden(buffer_params, sl(h_b))
            if topk:
                loss = loss + distill.topk_kl(ls, lb, tau, topk, vocab=vocab,
                                              mask=m)
            else:
                loss = loss + distill.kl_soft(ls, lb, tau, vocab=vocab, mask=m)
        elif cached_buffer_logits is not None:
            c = cached_buffer_logits
            loss = loss + distill.topk_kl_cached(
                ls, sl(c["top_vals"]), sl(c["top_idx"]), sl(c["tail_lse"]),
                tau, vocab=vocab, mask=m)
        return loss

    return _map_chunks(one, nc)


def _value_and_grad(loss_fn, params, backward_span=None):
    """(outputs of ``loss_fn(params)``, gradient tree of its first output
    w.r.t. ``params``).  Every intermediate (the graph, the parameter
    views) is released before this returns.  ``backward_span`` names the
    span around the backward pass (remat recompute included)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    outs = loss_fn(tree_unflatten(params, leaves))
    with (spans.span(backward_span) if backward_span
          else contextlib.nullcontext()):
        grads = torch.autograd.grad(outs[0], leaves)
    return tuple(o.detach() for o in outs), tree_unflatten(params, grads)


def make_phase2_step(cfg: LMConfig, opt, *, tau=2.0, buffer_mode="clone",
                     loss_chunk=512, aux_weight=0.01, topk=None,
                     loss_backend="auto", ce_weight=1.0,
                     teacher_transform=None):
    """``step(student, teacher, buffer_arg, opt_state, batch, step_idx) ->
    (new_params, new_opt_state, {"loss", "kd_loss"})``; ``buffer_arg`` is
    the buffer params ("clone"), the cached logits ``{"top_vals",
    "top_idx", "tail_lse"}`` ("cached") or ignored ("none")."""
    if buffer_mode not in ("clone", "cached", "none"):
        raise ValueError(f"buffer_mode {buffer_mode!r}")
    if loss_backend not in ("auto", "jnp", "pallas"):
        raise ValueError(f"loss_backend {loss_backend!r}")
    if loss_backend == "pallas" and topk:
        warnings.warn("loss_backend='pallas' ignored: topk is set, so the "
                      "chunked jnp top-k loss is used instead")
        loss_backend = "jnp"
    if loss_backend in ("auto", "pallas") and ce_weight != 1.0:
        # The fused kernel computes CE+KL in one pass; a weighted CE term
        # (FedDF's ce_weight=0) needs the chunked plain composition.
        warnings.warn("loss_backend='pallas' ignored: ce_weight != 1, so "
                      "the chunked jnp loss is used instead")
        loss_backend = "jnp"

    def backend_on(device):
        if loss_backend != "auto":
            return loss_backend
        return "pallas" if device.type == "cuda" else "jnp"

    def step(student, teacher, buffer_arg, opt_state, batch, step_idx):
        backend = backend_on(tree_device(student))

        def loss_fn(params):
            with spans.span("phase2.forward"):
                h_s, aux = Transformer.apply_hidden(cfg, params, batch)
                h_b = cached = None
                with torch.no_grad():
                    h_t, _ = Transformer.apply_hidden(cfg, teacher, batch)
                    if buffer_mode == "clone":
                        h_b, _ = Transformer.apply_hidden(cfg, buffer_arg,
                                                          batch)
                if buffer_mode == "cached":
                    cached = buffer_arg
                loss = _chunked_bkd_loss(
                    cfg, params, teacher,
                    buffer_arg if buffer_mode == "clone" else None, batch,
                    h_s, h_t, h_b, tau, loss_chunk,
                    cached_buffer_logits=cached, topk=topk,
                    loss_backend=backend, ce_weight=ce_weight,
                    teacher_transform=teacher_transform)
                return loss + aux_weight * aux, loss

        with spans.span("phase2.step"):
            (total, kd_loss), grads = _value_and_grad(loss_fn, student,
                                                      "phase2.backward")
            with spans.span("phase2.optimizer"):
                new = update_in_place(opt, grads, opt_state, student, step_idx)
        return (*new, {"loss": total, "kd_loss": kd_loss})

    return step


def make_pretrain_step(cfg: LMConfig, opt, *, loss_chunk=512, aux_weight=0.01):
    """``step(params, opt_state, batch, step_idx) -> (new_params,
    new_opt_state, {"loss"})``: chunked CE plus the MoE aux loss."""

    def step(params, opt_state, batch, step_idx):
        def loss_fn(p):
            h, aux = Transformer.apply_hidden(cfg, p, batch)
            chunk, nc = _chunks(h.shape[1], loss_chunk)
            labels = batch["labels"]
            mask = batch.get("mask")

            def one(idx):
                sl = lambda t: t[:, idx * chunk:(idx + 1) * chunk]  # noqa: E731
                lg = Transformer.logits_from_hidden(cfg, p, sl(h))
                m = sl(mask).float() if mask is not None else None
                return distill.ce_loss(lg, sl(labels), vocab=cfg.vocab_size,
                                       mask=m)

            return (_map_chunks(one, nc) + aux_weight * aux,)

        (loss,), grads = _value_and_grad(loss_fn, params)
        new_params, new_opt = update_in_place(opt, grads, opt_state, params,
                                              step_idx)
        return new_params, new_opt, {"loss": loss}

    return step
