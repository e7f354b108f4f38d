"""PyTorch/CUDA port of the ``repro`` package, slice by slice.

Slice 1 is serving: the block-paged continuous-batching engine
(``repro_torch.serve.engine.ServeEngine(paged=True)``) over the
attention-only Transformer, with decode attention on a hand-written Hopper
kernel (``repro_torch.kernels.paged_decode``).  Slice 2 is the paper's
Algorithm 1 (``repro_torch.core.fl.FederatedKD``) with the MLP and
ResNet-32 models, whose Phase-2 loss runs on the hand-written kernels
``repro_torch.kernels.kd_loss.kd_stats_fwd``/``kd_grad_bwd``; the same pair
carries the LLM-scale Phase 2 (``repro_torch.launch.train``, the Algorithm 1
driver over transformer cores and edges, MoE archs included).  Module names
follow the JAX package so each counterpart is easy to find; parameters and
states keep its nested-dict layout (``repro_torch.interop`` moves them
across).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
CUDA entry point with no card raises instead of falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and there is
    no usable card, so no entry point silently carries on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch path")
    return device
