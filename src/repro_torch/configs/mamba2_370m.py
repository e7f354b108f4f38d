"""Mamba2-370m [arXiv:2405.21060]: attention-free SSD (state-space duality).

48L, d_model 1024, ssm_state 128, vocab 50280 (padded to 50432), no MLP
(d_ff = 0: Mamba blocks only).  The same values as the JAX package's
``repro.configs.mamba2_370m``.
"""

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="mamba2-370m",
    num_layers=48, d_model=1024, num_heads=16, kv_heads=16,  # attn unused
    d_ff=0, vocab_size=50280,
    block_pattern=("ssd",), mlp="none",
    d_state=128, ssm_head_dim=64, ssm_chunk=128, conv_width=4,
    norm="rmsnorm", rope="none",
)

SMOKE = LMConfig(
    name="mamba2-smoke",
    num_layers=2, d_model=256, num_heads=4, kv_heads=4,
    d_ff=0, vocab_size=512,
    block_pattern=("ssd",), mlp="none", d_state=32, ssm_head_dim=32,
    ssm_chunk=32, norm="rmsnorm", rope="none",
    dtype="float32", param_dtype="float32",
)

FAMILY = "ssm"
