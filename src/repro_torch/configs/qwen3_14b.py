"""Qwen3-14B [hf:Qwen/Qwen3-8B family card].

40L, d_model 5120, 40 heads (GQA kv=8), head_dim 128, d_ff 17408,
vocab 151936; per-head q/k RMS norm (qk_norm), no QKV bias.  The same
values as the JAX package's ``repro.configs.qwen3_14b``.
"""

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen3-14b",
    num_layers=40, d_model=5120, num_heads=40, kv_heads=8, head_dim=128,
    d_ff=17408, vocab_size=151936,
    block_pattern=("attn",), mlp="swiglu", norm="rmsnorm",
    qk_norm=True, rope="rope", rope_theta=1e6,
)

SMOKE = LMConfig(
    name="qwen3-smoke",
    num_layers=2, d_model=256, num_heads=4, kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=512,
    block_pattern=("attn",), mlp="swiglu", norm="rmsnorm", qk_norm=True,
    dtype="float32", param_dtype="float32",
)

FAMILY = "dense"
