"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427].

38L, d_model 4096, 16 heads (MQA kv=1), d_ff 12288, vocab 256000.
Pattern: two RG-LRU recurrent blocks per local-attention block, local
window 2048.  38 = 12 super-blocks of (rglru, rglru, local) + 2 trailing
recurrent layers.  The same values as the JAX package's
``repro.configs.recurrentgemma_9b``.
"""

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="recurrentgemma-9b",
    num_layers=38, d_model=4096, num_heads=16, kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"), window=2048,
    d_rnn=4096, conv_width=4,
    mlp="swiglu", norm="rmsnorm", rope="rope",
)

SMOKE = LMConfig(
    name="recurrentgemma-smoke",
    num_layers=5, d_model=256, num_heads=4, kv_heads=1, head_dim=64,
    d_ff=512, vocab_size=512,
    block_pattern=("rglru", "rglru", "local"), window=64, d_rnn=256,
    mlp="swiglu", norm="rmsnorm",
    dtype="float32", param_dtype="float32",
)

FAMILY = "hybrid"
