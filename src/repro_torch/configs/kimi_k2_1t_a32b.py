"""Kimi K2 — 1T-param MoE, 32B active.

61L, d_model 7168, 64 heads (GQA kv=8), head_dim 128, vocab 163840; MoE
with 384 experts, top-8 routing, expert d_ff 2048, plus 1 shared expert.
The same values as the JAX package's ``repro.configs.kimi_k2_1t_a32b``.
"""

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="kimi-k2-1t-a32b",
    num_layers=61, d_model=7168, num_heads=64, kv_heads=8, head_dim=128,
    d_ff=2048, vocab_size=163840,
    block_pattern=("attn",), mlp="moe", norm="rmsnorm", rope="rope",
    num_experts=384, top_k=8, expert_dim=2048, shared_experts=1,
    moe_tokens_per_group=128, moe_capacity_factor=1.25,
)

SMOKE = LMConfig(
    name="kimi-k2-smoke",
    num_layers=2, d_model=256, num_heads=4, kv_heads=2, head_dim=64,
    d_ff=128, vocab_size=512,
    block_pattern=("attn",), mlp="moe", norm="rmsnorm",
    num_experts=4, top_k=2, expert_dim=128, shared_experts=1,
    moe_tokens_per_group=32,
    dtype="float32", param_dtype="float32",
)

FAMILY = "moe"
