"""Non-i.i.d. federated partitioning (paper §4).

The paper samples per-edge class ratios from a Dirichlet distribution with
alpha = 1 ("uniformly sampled from the C-1 probability simplex") — each of
K+1 subsets (1 core + K edges) gets a different class mixture.
"""

from __future__ import annotations

import numpy as np


def dirichlet_partition(labels, num_subsets, alpha=1.0, seed=0, min_per_subset=1):
    """Split indices into `num_subsets` disjoint, covering subsets whose class
    mixtures are Dirichlet(alpha) distributed.

    labels: (N,) int array.  Returns list of index arrays (np.int64).
    """
    labels = np.asarray(labels)
    if len(labels) < num_subsets * min_per_subset:
        raise ValueError(
            f"cannot split {len(labels)} samples into {num_subsets} subsets "
            f"of at least {min_per_subset}: need "
            f">= {num_subsets * min_per_subset}")
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    subsets = [[] for _ in range(num_subsets)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        # Proportion of class c assigned to each subset.
        props = rng.dirichlet(alpha * np.ones(num_subsets))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for s, part in enumerate(np.split(idx, cuts)):
            subsets[s].extend(part.tolist())
    out = []
    for s in range(num_subsets):
        arr = np.asarray(sorted(subsets[s]), dtype=np.int64)
        out.append(arr)
    # Guarantee min_per_subset by moving spares from the largest *other*
    # subset.  Excluding s keeps the subsets disjoint (a subset donating to
    # itself would duplicate its own last index and never terminate); the
    # feasibility check above guarantees some other subset is above the
    # minimum whenever s is below it, so the donor always has a spare.
    for s in range(num_subsets):
        while len(out[s]) < min_per_subset:
            sizes = [len(o) if i != s else -1 for i, o in enumerate(out)]
            donor = int(np.argmax(sizes))
            out[s] = np.append(out[s], out[donor][-1])
            out[donor] = out[donor][:-1]
    return out
