"""Nemotron-4-340B [arXiv:2402.16819].

96L, d_model 18432, 96 heads (GQA kv=8), head_dim 192, d_ff 73728,
vocab 256000; squared-ReLU MLP (non-gated), LayerNorm, no bias.  The same
values as the JAX package's ``repro.configs.nemotron_4_340b``.  In bf16 a
layer holds 6.91 GB and the untied embedding and output projection 18.9
GB, so one 80 GB card holds the full width at a few layers only.
"""

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="nemotron-4-340b",
    num_layers=96, d_model=18432, num_heads=96, kv_heads=8, head_dim=192,
    d_ff=73728, vocab_size=256000,
    block_pattern=("attn",), mlp="squared_relu", norm="layernorm",
    rope="rope",
)

SMOKE = LMConfig(
    name="nemotron-smoke",
    num_layers=2, d_model=384, num_heads=6, kv_heads=2, head_dim=64,
    d_ff=768, vocab_size=512,
    block_pattern=("attn",), mlp="squared_relu", norm="layernorm",
    dtype="float32", param_dtype="float32",
)

FAMILY = "dense"
