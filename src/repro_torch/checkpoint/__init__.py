"""Checkpoints in the JAX package's format (one ``.npz`` + ``.meta.json``)."""

from repro_torch.checkpoint.io import (load_fl_state, load_tree, save_fl_state,
                                       save_tree)

__all__ = ["save_tree", "load_tree", "save_fl_state", "load_fl_state"]
