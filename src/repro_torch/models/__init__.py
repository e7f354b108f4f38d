from repro_torch.models.transformer import LMConfig, Transformer  # noqa: F401
