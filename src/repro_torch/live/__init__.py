"""Live co-scheduled system: serve traffic while distillation updates the core.

`LiveTrainer` re-cuts the `FederatedKD.run` round loop into a resumable
step iterator over `RoundStepper` microbatches; `LiveSystem` interleaves
those steps with `ServeEngine` decode ticks on one device and hot-swaps
the served params at round boundaries.  `lm_adapter` lets one Transformer
be both the FL core model and the served model.
"""

from repro_torch.live.lm import lm_adapter, lm_fl_data, nll_on
from repro_torch.live.system import LiveSystem
from repro_torch.live.trainer import LiveTrainer

__all__ = ["LiveTrainer", "LiveSystem", "lm_adapter", "lm_fl_data", "nll_on"]
