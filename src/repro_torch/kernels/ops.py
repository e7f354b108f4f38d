"""Public wrappers around the port's kernels: a CPU tensor takes the plain
PyTorch version, a CUDA tensor the hand-written kernel."""

from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.paged_decode import paged_decode


def paged_decode_attn(q, k_pool, v_pool, pt, pos, *, window=None):
    """Block-paged decode attention (the paged ServeEngine's tick hot spot).
    q: (B, N, G, D); k/v_pool: (P, page_size, N, D); pt: (B, PP) int32 page
    table; pos: (B,) int32."""
    if q.device.type == "cpu":
        return _ref.paged_decode_ref(q, k_pool, v_pool, pt, pos, window=window)
    return paged_decode(q, k_pool, v_pool, pt, pos, window=window)
