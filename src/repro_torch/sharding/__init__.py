from repro_torch.sharding.rules import (
    DEFAULT_RULES,
    MULTIPOD_RULES,
    LogicalRules,
    Spec,
    constrain,
    get_active_mesh_or_none,
    logical_to_spec,
    named_sharding,
    placements,
    tree_shardings,
    tree_specs,
)

__all__ = [
    "LogicalRules",
    "DEFAULT_RULES",
    "MULTIPOD_RULES",
    "Spec",
    "logical_to_spec",
    "placements",
    "named_sharding",
    "tree_shardings",
    "tree_specs",
    "constrain",
    "get_active_mesh_or_none",
]
