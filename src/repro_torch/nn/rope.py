"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE.

Split-halves convention, as in the JAX package: the first D/2 features
rotate against the last D/2 (not interleaved pairs), with f32 angles.

M-RoPE (arXiv:2409.12191) splits the D/2 rotary frequencies into three
sections (temporal, height, width); each section is rotated by its own
position stream.  Text tokens carry t = h = w = the text position (so
M-RoPE equals RoPE on text), vision patch tokens their (t, h, w) grid
coordinates.  ``positions`` is (B, 3, S) for M-RoPE and (B, S) for RoPE.
"""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    return torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=device), exps)


def _rotate(x, angles):
    """x: (B, S, H, D); angles: (B, S, D/2) f32.  Rotates in f32, casts back."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (B, S, H, D); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)        # (D/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x, positions, sections=(16, 24, 24), theta: float = 10000.0):
    """x: (B, S, H, D); positions: (B, 3, S) int; ``sections`` sum to D/2.
    Frequency f takes its angle from the stream of the section it lies in."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"head_dim / 2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)        # (half,)
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)    # (half,)
    pos = positions.float()[:, sec_id, :]                          # (B, half, S)
    return _rotate(x, pos.transpose(1, 2) * freqs)
