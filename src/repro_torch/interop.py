"""Parameters across the two packages.

The JAX package keeps parameters as nested dicts of arrays; the port keeps
the same keys, shapes and layouts as tensors: Transformer parameters, MLP
states and ResNet ``{"params", "bn"}`` states (HWIO convolution weights),
optimizer slots.  Callers hand over numpy arrays
(``jax.tree.map(np.asarray, state)``), so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_tensor(a, device, dtype):
    a = np.array(a)  # a writable copy: the tensor must not alias the caller's
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_numpy(tree, device, dtype=None):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (cast to ``dtype`` if given, else in the arrays' own dtype)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return _to_tensor(tree, device, dtype)


def params_to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays on the host.
    bfloat16 tensors come back as float32 (exact: numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
