from repro_torch.configs.registry import (ARCHS, get_config, get_smoke_config,
                                          list_archs)

__all__ = ["ARCHS", "get_config", "get_smoke_config", "list_archs"]
