from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    constant_schedule,
    cosine_schedule,
    decay_lr,
    sgd_momentum,
    step_decay,
    update_in_place,
)

__all__ = [
    "Optimizer",
    "sgd_momentum",
    "adamw",
    "step_decay",
    "update_in_place",
    "decay_lr",
    "cosine_schedule",
    "constant_schedule",
]
