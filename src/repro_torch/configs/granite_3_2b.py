"""Granite-3.0-2B [hf:ibm-granite/granite-3.0-2b-base].

40L, d_model 2048, 32 heads (GQA kv=8), head_dim 64, d_ff 8192,
vocab 49155 (padded to 49408).  The same values as the JAX package's
``repro.configs.granite_3_2b``.
"""

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="granite-3-2b",
    num_layers=40, d_model=2048, num_heads=32, kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=49155,
    block_pattern=("attn",), mlp="swiglu", norm="rmsnorm", rope="rope",
)

SMOKE = LMConfig(
    name="granite-smoke",
    num_layers=2, d_model=256, num_heads=4, kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=512,
    block_pattern=("attn",), mlp="swiglu", norm="rmsnorm",
    dtype="float32", param_dtype="float32",
)

FAMILY = "dense"
