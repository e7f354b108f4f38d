"""Numpy-only data modules: copies of the JAX package's ``repro.data``
(``tests/test_torch_fl.py`` holds each equal to its original)."""

from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import (
    make_synthetic_classification,
    make_cifar_like,
    make_token_stream,
)
from repro_torch.data.pipeline import Dataset, batches

__all__ = [
    "dirichlet_partition",
    "make_synthetic_classification",
    "make_cifar_like",
    "make_token_stream",
    "Dataset",
    "batches",
]
