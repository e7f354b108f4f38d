"""Operation and byte counts from shapes, and the H100's published peaks.

The counts of a forward pass, a prefill and a served token are the dense
decoder's; the runners take them through the configuration's architecture
module (``spec.architecture``), which may use them or count its own.

The yardstick lives here and not in the program, so that a change to the
program cannot move it.  Peaks: NVIDIA H100 SXM data sheet, dense, at the
700 W limit (989 TFLOP/s bf16, 67 TFLOP/s f32 outside the tensor cores,
3.35 TB/s HBM3).  The kernels' byte and operation arithmetic is carried
over from ``chip_smoke.py`` (``_kd_bounds``, ``_swa_bound``).
"""

from __future__ import annotations

PEAK_BF16 = 989e12      # FLOP/s
PEAK_F32 = 67e12        # FLOP/s, CUDA cores
HBM = 3.35e12           # bytes/s
KD_STATS = 11           # f32 columns of the forward KD stats


def matmul_flops_per_token(k: dict, unembed: bool = True) -> float:
    """Forward FLOPs of one token through the weight matrices: Q, K, V and
    O projections, the gated MLP, and (``unembed``) the output head over
    the true vocabulary."""
    d, h, n, hd, ff = k["d"], k["h"], k["n"], k["hd"], k["ff"]
    per_layer = 2 * (d * h * hd + 2 * d * n * hd + h * hd * d + 3 * d * ff)
    head = 2 * d * k["vocab"] if unembed else 0
    return k["layers"] * per_layer + head


def causal_attention_flops(k: dict, seq: int) -> float:
    """Forward FLOPs of causal attention over one sequence of ``seq``
    tokens: QK^T and PV over the seq (seq + 1) / 2 pairs that the mask
    keeps, in every layer that runs attention."""
    pairs = seq * (seq + 1) / 2
    return k["attn_layers"] * 2 * 2 * k["h"] * k["hd"] * pairs


def forward_flops(k: dict, batch: int, seq: int) -> float:
    """One forward pass of ``batch`` sequences of ``seq`` tokens."""
    return batch * (seq * matmul_flops_per_token(k)
                    + causal_attention_flops(k, seq))


def phase2_step_flops(k: dict, batch: int, seq: int, buffer: bool,
                      forward=forward_flops) -> float:
    """Useful FLOPs of one Phase-2 step: the student's forward and
    backward (twice the forward), the teacher's forward and, with the
    buffer, the frozen clone's forward, each ``forward(k, batch, seq)``
    (the architecture module's count).  The block recompute and the
    loss's recompute are not counted."""
    fwd = forward(k, batch, seq)
    return fwd * (3 + 1 + (1 if buffer else 0))


def decode_token_flops(k: dict, context: int) -> float:
    """One served token fed at a position that sees ``context`` keys."""
    return (matmul_flops_per_token(k)
            + k["attn_layers"] * 2 * 2 * k["h"] * k["hd"] * context)


def prefill_flops(k: dict, prompt: int) -> float:
    """A prompt's useful prefill: every real token through the layers,
    causal attention among them, and the output head at its last
    position only (the one logit row that serves a token)."""
    return (prompt * matmul_flops_per_token(k, unembed=False)
            + causal_attention_flops(k, prompt) + 2 * k["d"] * k["vocab"])


def kd_bounds(rows: int, v: int, itemsize: int, buffer: bool):
    """(forward, backward) least seconds of one launch of the KD pair:
    every logit read once, the stats (and ds) written once, labels read;
    or the f32 operations a logit at the CUDA-core peak (forward 16 with
    a buffer, 11 without; backward 14 and 11), whichever is larger."""
    n_in = 3 if buffer else 2
    fwd_bytes = rows * v * itemsize * n_in + rows * (8 + 4 * KD_STATS)
    bwd_bytes = (rows * v * itemsize * (n_in + 1)
                 + rows * (8 + 4 + 4 * KD_STATS))
    fwd = max(fwd_bytes / HBM, rows * v * (16 if buffer else 11) / PEAK_F32)
    bwd = max(bwd_bytes / HBM, rows * v * (14 if buffer else 11) / PEAK_F32)
    return fwd, bwd


def swa_decode_bound(rows: int, b: int, n: int, g: int, d: int,
                     itemsize: int) -> float:
    """Least seconds of one ``swa_decode`` call: the ``rows`` K/V cache
    rows the active slots attend read once for each of the ``n`` kv heads,
    q read and out written for the ``b`` rows, pos read; or f32 math at the
    CUDA-core peak, whichever is larger."""
    bytes_ = rows * n * d * 2 * itemsize + 2 * b * n * g * d * itemsize + 4 * b
    return max(bytes_ / HBM, rows * n * g * 4 * d / PEAK_F32)
