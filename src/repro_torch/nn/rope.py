"""Rotary position embeddings (standard RoPE; M-RoPE is not ported yet).

Split-halves convention, as in the JAX package: the first D/2 features
rotate against the last D/2 (not interleaved pairs), with f32 angles.
"""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    return torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=device), exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (B, S, H, D); positions: (B, S) int.  Rotates in f32, casts back."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)        # (D/2,)
    angles = positions[..., None].float() * freqs                  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
