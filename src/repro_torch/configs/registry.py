"""Architecture registry of the port: ``--arch <id>`` resolution.

Every architecture of the JAX package's registry, with the same ids and
the same values.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.shapes import SHAPES

ARCHS = {
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe_42b_a6_6b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
}


SUBQUADRATIC = {"recurrentgemma-9b", "mamba2-370m"}
LONG_WINDOW = 8192  # sliding-window variant for full-attention archs at 500k


def list_archs():
    return list(ARCHS)


def _module(arch):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch])


def get_config(arch):
    return _module(arch).CONFIG


def get_smoke_config(arch):
    return _module(arch).SMOKE


def get_family(arch):
    return _module(arch).FAMILY


def skip_reason(arch, shape_name):
    """Return a skip string for invalid (arch x shape) combos, else None."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if cfg.is_encoder and shape.kind == "decode":
        return "encoder-only: no decode step (DESIGN.md shape-coverage policy)"
    return None


def for_shape(arch, shape_name):
    """Config adjusted for the given input shape: at ``long_500k`` a
    full-attention arch becomes its sliding-window variant (window 8192,
    the window ``swa_decode`` serves).  Raises ValueError for skipped
    combos."""
    reason = skip_reason(arch, shape_name)
    if reason:
        raise ValueError(f"{arch} x {shape_name} skipped: {reason}")
    cfg = get_config(arch)
    if shape_name == "long_500k" and arch not in SUBQUADRATIC:
        cfg = dataclasses.replace(cfg, sliding_window=LONG_WINDOW,
                                  name=cfg.name + "+swa8k")
    return cfg
