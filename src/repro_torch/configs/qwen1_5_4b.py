"""Qwen1.5-4B [hf:Qwen/Qwen1.5-0.5B family card].

40L, d_model 2560, 20 heads with kv=20 (full MHA), head_dim 128,
d_ff 6912, vocab 151936; QKV bias (the Qwen1.5 signature).  The same
values as the JAX package's ``repro.configs.qwen1_5_4b``.
"""

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen1.5-4b",
    num_layers=40, d_model=2560, num_heads=20, kv_heads=20, head_dim=128,
    d_ff=6912, vocab_size=151936,
    block_pattern=("attn",), mlp="swiglu", norm="rmsnorm",
    qkv_bias=True, rope="rope",
)

SMOKE = LMConfig(
    name="qwen1.5-smoke",
    num_layers=2, d_model=256, num_heads=4, kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=512,
    block_pattern=("attn",), mlp="swiglu", norm="rmsnorm", qkv_bias=True,
    dtype="float32", param_dtype="float32",
)

FAMILY = "dense"
