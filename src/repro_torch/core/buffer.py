"""Cached-logit buffer — beyond-paper optimization of buffered KD.

The buffer F0 is *frozen* for the whole of Phase 2 and the core set C is
static, so F0(x_i) is a constant per round: compute it once, cache it, and
drop the third forward pass from every KD step.  The loss is
mathematically identical to Eq. 4.

`topk` compresses the cache: store top-k logits + a tail logsumexp so memory
is O(N*k) instead of O(N*V); the reconstructed distribution lumps the tail
into a single bucket (see ``distill.topk_kl_cached`` for the matching loss).

The cache lives on the state's device and :meth:`LogitCache.lookup`
gathers there.  :func:`core_logits` runs every batch at one batch shape,
padding the tail batch up to it, as the JAX package's does.  The PyTorch
counterpart of ``repro/core/buffer.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.tree import tree_device

#: Floor on the tail probability mass of a top-k compressed cache entry:
#: ``1 - exp(top_lse - full_lse)`` cancels to exactly 0 when the top-k hold
#: all the mass, and log(0) would poison every loss that reads the cache
#: (the reference's reasoning, ``repro/core/buffer.py``).
TAIL_MASS_FLOOR = 1e-9


@torch.no_grad()
def core_logits(adapter, state, ds, batch=512):
    """Logits of ``state`` over every example of ``ds`` as one (N, V)
    float32 tensor on the state's device.  The tail batch is padded up to
    the batch shape (repeating its last row) and the padding rows are
    sliced off again."""
    n = len(ds)
    b = min(batch, n)
    device = tree_device(state)
    outs = []
    for i in range(0, n, b):
        xb = np.asarray(ds.x[i:i + b])
        pad = b - xb.shape[0]
        if pad:
            xb = np.concatenate(
                [xb, np.broadcast_to(xb[-1:], (pad,) + xb.shape[1:])])
        lg = adapter.logits(state, torch.as_tensor(xb, device=device),
                            False)[0]
        outs.append(lg[:b - pad] if pad else lg)
    return torch.cat(outs).float()


@dataclasses.dataclass
class LogitCache:
    logits: object = None       # (N, V) exact cache
    top_vals: object = None     # (N, k) compressed cache
    top_idx: object = None      # (N, k)
    tail_lse: object = None     # (N,) logsumexp of non-top entries

    def lookup(self, idx):
        """Gather cache rows on the cache's device.  ``idx`` may be a slice
        (the whole-cache view) or an index array."""
        def take(a):
            if isinstance(idx, slice):
                return a[idx]
            return a[torch.as_tensor(idx, device=a.device)]
        if self.logits is not None:
            return take(self.logits)
        return (take(self.top_vals), take(self.top_idx), take(self.tail_lse))

    @property
    def exact(self):
        return self.logits is not None


def precompute_logits(adapter, state, ds, batch=512, topk=None):
    """Run the frozen buffer once over the core set."""
    logits = core_logits(adapter, state, ds, batch)
    if topk is None:
        return LogitCache(logits=logits)
    if topk < 1:
        raise ValueError(f"topk must be >= 1, got {topk} (k=0 would drop the "
                         "buffer KL term entirely)")
    # Keep at least one tail entry: k = V would make the tail logsumexp
    # log(0) and the compressed form pointless (use the exact cache then).
    topk = min(topk, logits.shape[-1] - 1)
    tv, ti = torch.topk(logits, topk, dim=-1)
    full_lse = torch.logsumexp(logits, dim=-1)
    top_lse = torch.logsumexp(tv, dim=-1)
    # tail lse: log(exp(full) - exp(top)) computed stably; see TAIL_MASS_FLOOR
    diff = torch.exp(torch.clamp(top_lse - full_lse, max=0.0))
    tail = full_lse + torch.log(torch.clamp(1.0 - diff, min=TAIL_MASS_FLOOR))
    return LogitCache(top_vals=tv, top_idx=ti, tail_lse=tail)


def reconstruct_logits(cache_entry, vocab):
    """Expand a compressed cache entry back to a (B, V) logit tensor whose
    softmax matches the original on the top-k support (the tail mass is
    spread uniformly over the V-k non-top entries)."""
    tv, ti, tail = cache_entry
    b, k = tv.shape
    n_tail = max(vocab - k, 1)
    fill_val = tail[:, None].float() - float(np.log(np.float32(n_tail)))
    out = fill_val.expand(b, vocab).clone()
    return out.scatter(1, ti.long(), tv.float())
