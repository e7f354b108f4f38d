"""CIFAR ResNet (He et al. 2016) — the paper's edge/core model (ResNet-32).

Functional with explicit BatchNorm state (running mean/var) so the FL
orchestrator can clone/freeze teachers exactly.  Projection ('option b')
downsampling per the paper's appendix.  Depth = 6n+2 (n blocks per stage).

Parameters keep the JAX package's layout (``repro/nn/resnet.py``): HWIO
convolution weights, ``{"scale", "bias"}`` BN parameters and
``{"mean", "var"}`` BN state, NHWC inputs.  Two of its conventions differ
from PyTorch's defaults and are kept here:

* ``"SAME"`` padding: at stride 2 on an even size JAX pads (0, 1), not
  (1, 1), so the padding is applied explicitly with ``F.pad``;
* BatchNorm normalises with the *biased* batch variance and moves its
  running stats as ``0.9 * old + 0.1 * new`` with that biased variance.

Inside the network activations are NCHW (the layout cuDNN expects); the
input is converted once and the pooled features do not depend on it.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 32                 # 6n+2
    num_classes: int = 100
    width: int = 16

    @property
    def blocks_per_stage(self):
        if (self.depth - 2) % 6:
            raise ValueError(f"ResNet depth must be 6n+2, got {self.depth}")
        return (self.depth - 2) // 6


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def _conv_init(gen, kh, kw, cin, cout):
    fan_in = kh * kw * cin
    return math.sqrt(2.0 / fan_in) * _normal(gen, (kh, kw, cin, cout))


def _bn_init(c):
    return ({"scale": torch.ones(c), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


def _same_pad(n, k, stride):
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(w, x, stride=1):
    """``lax.conv_general_dilated(x, w, stride, "SAME")`` on NCHW ``x`` with
    an HWIO weight."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = _same_pad(x.shape[-2], kh, stride)
    left, right = _same_pad(x.shape[-1], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _bn(params, state, x, train, momentum=0.9, eps=1e-5):
    if train:
        mu = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        new_state = {
            "mean": momentum * state["mean"] + (1 - momentum) * mu,
            "var": momentum * state["var"] + (1 - momentum) * var,
        }
    else:
        mu, var = state["mean"], state["var"]
        new_state = state
    c = (-1, 1, 1)
    y = ((x - mu.reshape(c)) * torch.rsqrt(var + eps).reshape(c)
         * params["scale"].reshape(c) + params["bias"].reshape(c))
    return y, new_state


def init(gen, cfg: ResNetConfig, device="cpu"):
    """Parameters and BN state from the ``torch.Generator`` ``gen`` (drawn
    on the CPU, then moved, so a seed gives the same weights on any
    device), with the reference's distributions."""
    params, state = {}, {}
    params["conv0"] = _conv_init(gen, 3, 3, 3, cfg.width)
    params["bn0"], state["bn0"] = _bn_init(cfg.width)
    cin = cfg.width
    for stage in range(3):
        cout = cfg.width * (2 ** stage)
        for b in range(cfg.blocks_per_stage):
            pref = f"s{stage}b{b}"
            stride = 2 if (stage > 0 and b == 0) else 1
            params[pref] = {
                "conv1": _conv_init(gen, 3, 3, cin, cout),
                "conv2": _conv_init(gen, 3, 3, cout, cout),
            }
            state[pref] = {}
            params[pref]["bn1"], state[pref]["bn1"] = _bn_init(cout)
            params[pref]["bn2"], state[pref]["bn2"] = _bn_init(cout)
            if stride != 1 or cin != cout:
                params[pref]["proj"] = _conv_init(gen, 1, 1, cin, cout)
                params[pref]["bnp"], state[pref]["bnp"] = _bn_init(cout)
            cin = cout
    params["fc_w"] = _normal(gen, (cin, cfg.num_classes)) / math.sqrt(cin)
    params["fc_b"] = torch.zeros(cfg.num_classes)
    move = lambda t: {k: move(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.to(device)  # noqa: E731
    return move(params), move(state)


def apply(params, state, cfg: ResNetConfig, x, train: bool):
    """x: (B, H, W, 3) -> logits (B, classes); returns (logits, new_state)."""
    new_state = {}
    h = _conv(params["conv0"], x.permute(0, 3, 1, 2))
    h, new_state["bn0"] = _bn(params["bn0"], state["bn0"], h, train)
    h = F.relu(h)
    for stage in range(3):
        for b in range(cfg.blocks_per_stage):
            pref = f"s{stage}b{b}"
            stride = 2 if (stage > 0 and b == 0) else 1
            blk, bst, nst = params[pref], state[pref], {}
            y = _conv(blk["conv1"], h, stride)
            y, nst["bn1"] = _bn(blk["bn1"], bst["bn1"], y, train)
            y = F.relu(y)
            y = _conv(blk["conv2"], y)
            y, nst["bn2"] = _bn(blk["bn2"], bst["bn2"], y, train)
            if "proj" in blk:
                sc = _conv(blk["proj"], h, stride)
                sc, nst["bnp"] = _bn(blk["bnp"], bst["bnp"], sc, train)
            else:
                sc = h
            h = F.relu(y + sc)
            new_state[pref] = nst
    h = h.mean(dim=(2, 3))
    logits = h @ params["fc_w"] + params["fc_b"]
    return logits, new_state


# -- Small MLP classifier used by fast CPU-scale FL experiments/tests. ------

def mlp_init(gen, in_dim, hidden, classes, depth=2, device="cpu"):
    params = {}
    d = in_dim
    for i in range(depth):
        params[f"w{i}"] = _normal(gen, (d, hidden)) * math.sqrt(2.0 / d)
        params[f"b{i}"] = torch.zeros(hidden)
        d = hidden
    params["w_out"] = _normal(gen, (d, classes)) / math.sqrt(d)
    params["b_out"] = torch.zeros(classes)
    return {k: v.to(device) for k, v in params.items()}


def mlp_features(params, x):
    """The penultimate activations (FT's feature tap)."""
    h = x.reshape(x.shape[0], -1)
    i = 0
    while f"w{i}" in params:
        h = F.relu(h @ params[f"w{i}"] + params[f"b{i}"])
        i += 1
    return h


def mlp_apply(params, x):
    return mlp_features(params, x) @ params["w_out"] + params["b_out"]
