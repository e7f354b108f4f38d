"""Synthetic datasets.

The paper's experiments use CIFAR-100 / downsampled ImageNet; this container
has no dataset downloads, so the reproduction benchmarks run on (a) a
Gaussian-mixture classification task whose class structure makes "edge bias"
observable at CPU scale, and (b) a CIFAR-shaped random-feature task for the
ResNet path.  Token streams feed the LLM-scale distillation trainer.
"""

from __future__ import annotations

import numpy as np


def make_synthetic_classification(num_classes=20, dim=32, per_class=200,
                                  cluster_std=1.0, sub_clusters=3, seed=0):
    """Gaussian mixture with `sub_clusters` modes per class.

    Different edges (Dirichlet-partitioned) see different modes of each class,
    so an edge-overfitted teacher genuinely carries *biased* knowledge —
    mirroring the (\\) vs (/) picture in the paper's Fig. 2.
    """
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for c in range(num_classes):
        centers = rng.normal(0, 4.0, size=(sub_clusters, dim))
        for m in range(sub_clusters):
            n = per_class // sub_clusters
            xs.append(centers[m] + cluster_std * rng.normal(size=(n, dim)))
            ys.append(np.full(n, c, dtype=np.int64))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys)
    perm = rng.permutation(len(x))
    return x[perm], y[perm]


def make_cifar_like(num_classes=100, n=5000, hw=32, seed=0):
    """CIFAR-shaped images: class templates + noise (for ResNet plumbing)."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(0, 1, size=(num_classes, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, num_classes, size=n)
    x = templates[y] + 0.8 * rng.normal(size=(n, hw, hw, 3)).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int64)


def make_token_stream(vocab, n_seqs, seq_len, num_domains=1, seed=0):
    """Synthetic LM corpus: each domain is a distinct bigram process, so
    domain-silo "edges" genuinely differ (the LLM analogue of non-iid)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n_seqs, seq_len), dtype=np.int32)
    domains = rng.integers(0, num_domains, size=n_seqs)
    # Per-domain sparse bigram tables over a small working vocab.
    work = min(vocab, 512)
    for d in range(num_domains):
        trans = rng.integers(0, work, size=(work, 4))
        rows = np.flatnonzero(domains == d)
        for r in rows:
            t = rng.integers(0, work)
            for i in range(seq_len):
                out[r, i] = t
                t = trans[t, rng.integers(0, 4)]
    return out, domains
