from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    constant_schedule,
    cosine_schedule,
    decay_lr,
    sgd_momentum,
    step_decay,
)

__all__ = [
    "Optimizer",
    "sgd_momentum",
    "adamw",
    "step_decay",
    "decay_lr",
    "cosine_schedule",
    "constant_schedule",
]
