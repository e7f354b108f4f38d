"""The FL round loop as a resumable step iterator (``LiveTrainer``)."""

from repro_torch.live.trainer import LiveTrainer

__all__ = ["LiveTrainer"]
