"""RG-LRU recurrent block (Griffin / RecurrentGemma): the port of
``repro.nn.rglru``.

    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    a_t = a^(c * r_t),  a = sigmoid(Lambda)  (per channel), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

``forward`` runs the linear recurrence as the JAX function does: with
``use_kernel=False`` (the default, and the model's full-sequence forward,
training included) through :func:`rglru_scan_reference`, which autograd
differentiates; with ``use_kernel=True`` (the serving prefill) through
:func:`repro_torch.kernels.ops.rglru`: the hand-written ``rglru`` kernel on
a CUDA tensor, the same reference on a CPU one.  The block around
it is Griffin's recurrent block: two linear branches, a short causal
depthwise conv on the recurrent one, a GeLU gate.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.nn import layers as L

_C = 8.0
_MAX_SQRT = 1e-6


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int
    conv_width: int = 4


def init(cfg: RGLRUConfig, generator, device, *, stack=None,
         dtype=torch.float32):
    """The JAX ``init``'s tree, shapes and per-leaf dtypes (``b_a``, ``b_x``
    and ``lam`` f32 in any model dtype), drawn from ``generator``."""
    sh = (lambda *s: s) if stack is None else (lambda *s: (stack, *s))
    std_m = 1.0 / math.sqrt(cfg.d_model)
    std_r = 1.0 / math.sqrt(cfg.d_rnn)

    def draw(shape, std):
        return L.trunc_normal(sh(*shape), std, dtype, device, generator)

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in_x": draw((cfg.d_model, cfg.d_rnn), std_m),
        "w_in_gate": draw((cfg.d_model, cfg.d_rnn), std_m),
        "conv": L.conv1d_depthwise_init(cfg.conv_width, cfg.d_rnn, dtype=dtype,
                                        device=device, generator=generator,
                                        stack=stack),
        "w_a": draw((cfg.d_rnn, cfg.d_rnn), std_r),
        "b_a": torch.zeros(sh(cfg.d_rnn), **f32),
        "w_x": draw((cfg.d_rnn, cfg.d_rnn), std_r),
        "b_x": torch.zeros(sh(cfg.d_rnn), **f32),
        # Lambda = logit(0.95): a = sigmoid(Lambda) in (0.9, 0.999).
        "lam": torch.full(sh(cfg.d_rnn), math.log(0.95 / 0.05), **f32),
        "w_out": draw((cfg.d_rnn, cfg.d_model), std_r),
    }


def _gates(params, xr):
    """xr: (..., d_rnn) post-conv recurrent-branch input -> (a, b), f32."""
    xf = xr.float()
    r = torch.sigmoid(xf @ params["w_a"].float() + params["b_a"].float())
    i = torch.sigmoid(xf @ params["w_x"].float() + params["b_x"].float())
    log_a = _C * r * F.logsigmoid(params["lam"].float())
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=_MAX_SQRT))
    return a, mult * (i * xf)


def rglru_scan_reference(a, b, h0=None):
    """Linear recurrence h_t = a_t h_{t-1} + b_t along axis 1 of (B, S, D)
    f32 tensors, from ``h0`` (B, D) or zero.  A log-step (Hillis-Steele)
    scan over S with the JAX ``associative_scan``'s combine
    (a_l, b_l) . (a_r, b_r) = (a_l a_r, a_r b_l + b_r)."""
    if h0 is not None:
        b = b.clone()
        b[:, 0, :] = b[:, 0, :] + a[:, 0, :] * h0
    s = a.shape[1]
    k = 1
    while k < s:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return b


def forward(params, cfg: RGLRUConfig, x, *, use_kernel=False,
            return_cache=False):
    """x: (B, S, D) -> (B, S, D) [, cache]."""
    xr_pre = x @ params["w_in_x"].to(x.dtype)
    gate = L.gelu(x @ params["w_in_gate"].to(x.dtype))
    xr = L.conv1d_depthwise(params["conv"], xr_pre)
    a, b = _gates(params, xr)
    h = ops.rglru(a, b) if use_kernel else rglru_scan_reference(a, b)
    y = (h.to(x.dtype) * gate) @ params["w_out"].to(x.dtype)
    if return_cache:
        kw = cfg.conv_width - 1
        cache = {"h": h[:, -1, :].float(),
                 "conv": xr_pre[:, xr_pre.shape[1] - kw:, :]}
        return y, cache
    return y


def init_cache(cfg: RGLRUConfig, batch, *, device, dtype=torch.float32,
               stack=None):
    """Zeroed decode state: h (B, d_rnn) in f32 whatever ``dtype`` is, the
    conv window (B, K-1, d_rnn) in ``dtype``; a leading ``stack`` axis for
    stacked layers."""
    sh = (lambda *s: s) if stack is None else (lambda *s: (stack, *s))
    return {
        "h": torch.zeros(sh(batch, cfg.d_rnn), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros(sh(batch, cfg.conv_width - 1, cfg.d_rnn),
                            dtype=dtype, device=device),
    }


def decode_step(params, cfg: RGLRUConfig, cache, x):
    """x: (B, 1, D).  Returns (y (B, 1, D), new cache)."""
    xt = x[:, 0, :]
    xr = xt @ params["w_in_x"].to(x.dtype)
    gate = L.gelu(xt @ params["w_in_gate"].to(x.dtype))
    new_conv, xr = L.conv1d_depthwise_step(params["conv"], cache["conv"], xr)
    a, b = _gates(params, xr)
    h = a * cache["h"] + b
    y = ((h.to(x.dtype) * gate) @ params["w_out"].to(x.dtype))[:, None, :]
    return y, {"h": h, "conv": new_conv}
