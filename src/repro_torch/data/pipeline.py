"""Minimal in-memory dataset + deterministic shuffled batching."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Dataset:
    x: np.ndarray
    y: np.ndarray

    def __len__(self):
        return len(self.x)

    def subset(self, idx):
        return Dataset(self.x[idx], self.y[idx])


def batches(ds: Dataset, batch_size: int, *, seed: int = 0, epochs: int = 1,
            drop_remainder: bool = True, with_indices: bool = False,
            indices_only: bool = False):
    """Yield (x, y[, idx]) numpy batches; reshuffled each epoch.

    ``indices_only=True`` yields just the per-step index arrays from the
    identical RNG stream — for schedule-building consumers (the scanned
    engines) that gather on device and must not pay host copies of the data.
    """
    rng = np.random.default_rng(seed)
    n = len(ds)
    bs = min(batch_size, n)
    for _ in range(epochs):
        perm = rng.permutation(n)
        stop = n - (n % bs) if drop_remainder else n
        for i in range(0, stop, bs):
            sel = perm[i : i + bs]
            if indices_only:
                yield sel
            elif with_indices:
                yield ds.x[sel], ds.y[sel], sel
            else:
                yield ds.x[sel], ds.y[sel]
