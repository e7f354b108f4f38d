"""HuBERT X-Large [arXiv:2106.07447] — encoder-only audio transformer.

48L, d_model 1280, 16 heads (kv=16, i.e. MHA), d_ff 5120, vocab 504
(masked-prediction codebook, padded to 512).  The mel-spectrogram + conv
feature extractor front end is a stub: the batch supplies frame
embeddings (``features``, feat_dim 512) and a ``mask`` for masked-prediction
training.  Encoder-only: no decode step.  The same values as the JAX
package's ``repro.configs.hubert_xlarge``.
"""

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="hubert-xlarge",
    num_layers=48, d_model=1280, num_heads=16, kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504,
    block_pattern=("attn",), mlp="gelu", norm="layernorm",
    causal=False, rope="none",
    is_encoder=True, feat_dim=512,
)

SMOKE = LMConfig(
    name="hubert-smoke",
    num_layers=2, d_model=256, num_heads=4, kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=504,
    block_pattern=("attn",), mlp="gelu", norm="layernorm",
    causal=False, rope="none", is_encoder=True, feat_dim=64,
    dtype="float32", param_dtype="float32",
)

FAMILY = "audio"
