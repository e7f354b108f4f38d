"""Phi-3.5-MoE (42B total / 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model 4096, 32 heads (GQA kv=8), head_dim 128, vocab 32064; MoE
with 16 experts, top-2 routing, expert d_ff 6400.  The same values as the
JAX package's ``repro.configs.phi3_5_moe_42b_a6_6b``.
"""

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="phi3.5-moe-42b-a6.6b",
    num_layers=32, d_model=4096, num_heads=32, kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32064,
    block_pattern=("attn",), mlp="moe", norm="rmsnorm", rope="rope",
    num_experts=16, top_k=2, expert_dim=6400,
    moe_tokens_per_group=512, moe_capacity_factor=1.25,
)

SMOKE = LMConfig(
    name="phi3.5-moe-smoke",
    num_layers=2, d_model=256, num_heads=4, kv_heads=2, head_dim=64,
    d_ff=256, vocab_size=512,
    block_pattern=("attn",), mlp="moe", norm="rmsnorm",
    num_experts=4, top_k=2, expert_dim=256, moe_tokens_per_group=32,
    dtype="float32", param_dtype="float32",
)

FAMILY = "moe"
