"""Qwen2-VL-72B language backbone [arXiv:2409.12191].

80L, d_model 8192, 64 heads (GQA kv=8), d_ff 29568, vocab 152064; M-RoPE
(3-section rotary over t/h/w), QKV bias, dynamic-resolution vision.  The
same values as the JAX package's ``repro.configs.qwen2_vl_72b``.  The ViT +
merger front-end is a stub, as there: callers hand ``Transformer.prefill``
patch embeddings already projected to d_model (``vision_embeds``), the
sequence rows they replace (``vision_positions``) and (B, 3, S) M-RoPE
positions.
"""

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen2-vl-72b",
    num_layers=80, d_model=8192, num_heads=64, kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064,
    block_pattern=("attn",), mlp="swiglu", norm="rmsnorm",
    rope="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
    qkv_bias=True,  # Qwen2 attention bias
    is_vlm=True,
)

SMOKE = LMConfig(
    name="qwen2-vl-smoke",
    num_layers=2, d_model=256, num_heads=4, kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=512,
    block_pattern=("attn",), mlp="swiglu", norm="rmsnorm",
    rope="mrope", mrope_sections=(8, 12, 12), qkv_bias=True, is_vlm=True,
    dtype="float32", param_dtype="float32",
)

FAMILY = "vlm"
