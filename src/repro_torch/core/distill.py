"""Distillation losses — Eqs. (1)–(4) of the paper, plus variants.

Notation (paper §3.1):
    F(x)     core/student softmax;  f_k(x) k-th edge/teacher softmax
    A_f(x)   ensemble average of the R returned teachers' probabilities
    L_core   = sum CE(F(x), y)                                   (Eq. 1)
    L_KD     = L_core + tau^2 * sum KL(F || A_f / tau)           (Eq. 3)
    L_BKD    = L_KD   + tau^2 * sum KL(F || F0 / tau)            (Eq. 4)
where F0 is the student cloned & frozen at the start of Phase 2 — the
"buffer".  KL terms follow Hinton et al.: softened distributions at
temperature tau, scaled by tau^2 so gradients match the CE scale.

All losses take *logits* and are mean-reduced over examples.  `vocab`
masks out padded vocabulary entries.  The PyTorch counterpart of the JAX
package's ``repro/core/distill.py``, function for function; on a CUDA
device the fused kernel pair (``repro_torch.kernels.ops.kd_loss``)
computes Eqs. 3/4 in one pass.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_map

NEG_INF = -1e30


def _mask_pad(logits, vocab):
    if vocab is not None and vocab != logits.shape[-1]:
        valid = torch.arange(logits.shape[-1], device=logits.device) < vocab
        logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    return logits


def _reduce(per_example, mask):
    if mask is not None:
        mask = mask.to(per_example.dtype)
        return torch.sum(per_example * mask) / torch.clamp(torch.sum(mask),
                                                           min=1.0)
    return torch.mean(per_example)


def ce_loss(logits, labels, *, vocab=None, mask=None):
    """Cross entropy, mean over (optionally masked) examples.
    logits: (..., V); labels: (...) int."""
    logits = _mask_pad(logits.float(), vocab)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return _reduce(lse - ll, mask)


def kl_soft(student_logits, teacher_logits, tau, *, vocab=None, mask=None):
    """tau^2 * KL( softmax(t/tau) || softmax(s/tau) ), mean over examples."""
    s = _mask_pad(student_logits.float(), vocab) / tau
    t = _mask_pad(teacher_logits.float(), vocab) / tau
    ls = torch.log_softmax(s, dim=-1)
    lt = torch.log_softmax(t, dim=-1)
    kl = torch.sum(torch.exp(lt) * (lt - ls), dim=-1) * (tau ** 2)
    return _reduce(kl, mask)


def kl_soft_vs_probs(student_logits, teacher_probs, tau, *, vocab=None,
                     mask=None):
    """KL against an ensemble probability vector A_f (already temperature-soft).
    teacher_probs must be a valid distribution over the (unpadded) vocab."""
    s = _mask_pad(student_logits.float(), vocab) / tau
    ls = torch.log_softmax(s, dim=-1)
    pt = teacher_probs.float()
    lt = torch.log(torch.clamp(pt, min=1e-30))
    kl = torch.sum(pt * (lt - ls), dim=-1) * (tau ** 2)
    return _reduce(kl, mask)


def ensemble_probs(teacher_logits, tau, *, vocab=None):
    """A_f: mean of temperature-softened teacher probabilities.

    Accepts either a list of R ``(..., V)`` logit tensors or one stacked
    ``(R, ..., V)`` tensor."""
    if isinstance(teacher_logits, (list, tuple)):
        ps = [torch.softmax(_mask_pad(t.float(), vocab) / tau, dim=-1)
              for t in teacher_logits]
        return sum(ps) / len(ps)
    p = torch.softmax(_mask_pad(teacher_logits.float(), vocab) / tau, dim=-1)
    return torch.mean(p, dim=0)


def _num_teachers(teacher_logits):
    return (len(teacher_logits) if isinstance(teacher_logits, (list, tuple))
            else teacher_logits.shape[0])


def l_kd(student_logits, teacher_logits_list, labels, tau, *, vocab=None,
         mask=None):
    """Eq. 3.  teacher_logits_list: R teachers (R=1: single-edge
    distillation), as a list or a stacked ``(R, ..., V)`` tensor."""
    ce = ce_loss(student_logits, labels, vocab=vocab, mask=mask)
    if _num_teachers(teacher_logits_list) == 1:
        kd = kl_soft(student_logits, teacher_logits_list[0], tau, vocab=vocab,
                     mask=mask)
    else:
        af = ensemble_probs(teacher_logits_list, tau, vocab=vocab)
        kd = kl_soft_vs_probs(student_logits, af, tau, vocab=vocab, mask=mask)
    return ce + kd


def l_bkd(student_logits, teacher_logits_list, buffer_logits, labels, tau,
          *, vocab=None, mask=None):
    """Eq. 4 — buffered KD: Eq. 3 plus the frozen-clone KL term."""
    kd = l_kd(student_logits, teacher_logits_list, labels, tau, vocab=vocab,
              mask=mask)
    buf = kl_soft(student_logits, buffer_logits, tau, vocab=vocab, mask=mask)
    return kd + buf


# ---------------------------------------------------------------------------
# Chunked LLM-scale variants (token-level, big vocab).
# ---------------------------------------------------------------------------

def chunked_token_bkd(student_logits_fn, teacher_logits_fn, buffer_logits_fn,
                      hidden_chunks, labels_chunks, tau, vocab, kd_weight=1.0,
                      buffer_weight=1.0):
    """Streaming form: callers pass per-chunk logit functions so the three
    (tokens, V) logit tensors never coexist for the full sequence."""
    total, count = 0.0, 0
    for h, y in zip(hidden_chunks, labels_chunks):
        s = student_logits_fn(h)
        t = teacher_logits_fn(h)
        loss = ce_loss(s, y, vocab=vocab)
        loss = loss + kd_weight * kl_soft(s, t, tau, vocab=vocab)
        if buffer_logits_fn is not None:
            b = buffer_logits_fn(h)
            loss = loss + buffer_weight * kl_soft(s, b, tau, vocab=vocab)
        total = total + loss
        count += 1
    return total / count


def topk_kl(student_logits, teacher_logits, tau, k, *, vocab=None, mask=None):
    """Beyond-paper: KL restricted to the teacher's top-k entries plus a
    renormalised tail bucket.  Exact in the limit k -> V."""
    s = _mask_pad(student_logits.float(), vocab) / tau
    t = _mask_pad(teacher_logits.float(), vocab) / tau
    lt = torch.log_softmax(t, dim=-1)
    ls = torch.log_softmax(s, dim=-1)
    top_lt, idx = torch.topk(lt, k, dim=-1)
    top_ls = torch.gather(ls, -1, idx)
    pt_top = torch.exp(top_lt)
    head = torch.sum(pt_top * (top_lt - top_ls), dim=-1)
    # Tail bucket: remaining teacher mass vs remaining student mass.
    mt = torch.clamp(1.0 - pt_top.sum(-1), min=1e-9)
    ms = torch.clamp(1.0 - torch.exp(top_ls).sum(-1), min=1e-9)
    tail = mt * (torch.log(mt) - torch.log(ms))
    return _reduce((head + tail) * (tau ** 2), mask)


def topk_kl_cached(student_logits, top_vals, top_idx, tail_lse, tau,
                   *, vocab=None, mask=None):
    """KL(buffer || student) from a *compressed* cached buffer: the buffer's
    top-k logits + logsumexp of its tail (see ``core/buffer.py``).

    top_vals/top_idx: (..., k) raw buffer logits (temperature applied here);
    tail_lse: (...,) logsumexp of the buffer's non-top logits.  As in the
    reference, the tail lse is divided by tau like a logit.
    """
    s = _mask_pad(student_logits.float(), vocab) / tau
    ls = torch.log_softmax(s, dim=-1)
    tv = top_vals.float() / tau
    tl = tail_lse.float() / tau  # lse scales ~1/tau approximately
    # Buffer log-normalizer over {top-k, tail bucket} at temperature tau.
    z = torch.logaddexp(torch.logsumexp(tv, dim=-1), tl)
    lp_top = tv - z[..., None]
    lp_tail = tl - z
    ls_top = torch.gather(ls, -1, top_idx.long())
    ms_tail = torch.log(torch.clamp(1.0 - torch.exp(ls_top).sum(-1),
                                    min=1e-9))
    kl = (torch.sum(torch.exp(lp_top) * (lp_top - ls_top), dim=-1)
          + torch.exp(lp_tail) * (lp_tail - ms_tail)) * (tau ** 2)
    return _reduce(kl, mask)


# ---------------------------------------------------------------------------
# EMA baseline (paper Fig. 4a) and Factor Transfer (FT+KD baseline).
# ---------------------------------------------------------------------------

def ema_update(ema_params, new_params, decay):
    return tree_map(lambda e, p: decay * e + (1.0 - decay) * p,
                    ema_params, new_params)


def factor_loss(student_feat, teacher_feat, translator_w):
    """Simplified Factor Transfer (Kim et al. 2018): a linear translator maps
    student features into the teacher's factor space; loss is the L2 between
    L2-normalised factors (identity paraphraser)."""
    fs = student_feat.reshape(student_feat.shape[0], -1) @ translator_w
    ft = teacher_feat.reshape(teacher_feat.shape[0], -1)

    def norm(v):
        # generous eps: ReLU features can be exactly zero for some inputs,
        # and 1/||v|| gradients explode through near-zero norms
        return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-3)

    return torch.mean(torch.sum((norm(fs) - norm(ft)) ** 2, dim=-1))
