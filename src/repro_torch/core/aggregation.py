"""Parameter-averaging FL baselines the paper positions itself against.

FedAvg (McMahan et al. 2017) and FedProx (Li et al. 2020, proximal penalty
between client and core weights): (a) a standalone synchronized round
protocol over the same silos as ``FederatedKD`` (the context row of the
Fig. 4 benchmark), and (b) ``average_params``, also used by the registry
methods ``fedavg`` and ``feddf`` (``core/methods.py``).  The PyTorch
counterpart of the JAX package's ``repro/core/aggregation.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core import distill
from repro_torch.data.pipeline import Dataset, batches
from repro_torch.optim import sgd_momentum, step_decay
from repro_torch.tree import tree_leaves, tree_map


def average_params(params_list, weights=None):
    """Weighted parameter average (the FedAvg aggregation step), summed in
    float32 and cast back to each leaf's dtype."""
    n = len(params_list)
    if weights is None:
        weights = [1.0 / n] * n
    total = sum(weights)
    weights = [w / total for w in weights]

    def avg(*leaves):
        out = weights[0] * leaves[0].float()
        for w, l in zip(weights[1:], leaves[1:]):
            out = out + w * l.float()
        return out.to(leaves[0].dtype)

    return tree_map(avg, *params_list)


@dataclasses.dataclass
class FedAvgConfig:
    rounds: int = 5
    clients_per_round: int = 5
    local_epochs: int = 5
    batch_size: int = 128
    lr: float = 0.1
    weight_decay: float = 1e-4
    prox_mu: float = 0.0       # > 0 => FedProx
    seed: int = 0


def _local_train(adapter, state, global_params, ds: Dataset,
                 cfg: FedAvgConfig, seed, device):
    from repro_torch.core.fl import grad_step
    steps_per_epoch = max(len(ds) // min(cfg.batch_size, len(ds)), 1)
    total = steps_per_epoch * cfg.local_epochs
    opt = sgd_momentum(step_decay(cfg.lr, [total // 2, 3 * total // 4]),
                       weight_decay=cfg.weight_decay)
    opt_state = opt.init(adapter.params(state))

    def loss_fn(lg, y, params):
        loss = distill.ce_loss(lg, y)
        if cfg.prox_mu > 0:  # FedProx proximal term ||w - w_global||^2
            sq = tree_map(lambda p, g: torch.sum((p.float() - g.float()) ** 2),
                          params, global_params)
            loss = loss + 0.5 * cfg.prox_mu * sum(tree_leaves(sq))
        return loss

    step = grad_step(adapter, opt, loss_fn)
    i = 0
    for x, y in batches(ds, cfg.batch_size, seed=seed,
                        epochs=cfg.local_epochs):
        state, opt_state = step(state, opt_state,
                                torch.as_tensor(x, device=device),
                                torch.as_tensor(y, device=device), i)
        i += 1
    return state


class FedAvg:
    """Synchronized parameter-averaging rounds over the same silos as
    FederatedKD (clients = edge datasets)."""

    def __init__(self, adapter, cfg: FedAvgConfig, edge_dss, test_ds, *,
                 device="cuda"):
        self.adapter, self.cfg = adapter, cfg
        self.edge_dss, self.test_ds = edge_dss, test_ds
        self.device = resolve_device(device)
        self.history = []

    def run(self, key, log=None):
        from repro_torch.core.fl import _accuracy, _generator
        adapter, cfg = self.adapter, self.cfg
        state = adapter.init(_generator(key), self.device)
        for r in range(cfg.rounds):
            gp = adapter.params(state)
            clients, sizes = [], []
            for k in range(min(cfg.clients_per_round, len(self.edge_dss))):
                ds = self.edge_dss[k]
                cs = adapter.with_params(state, tree_map(torch.clone, gp))
                cs = _local_train(adapter, cs, gp, ds, cfg,
                                  cfg.seed + 31 * r + k, self.device)
                clients.append(adapter.params(cs))
                sizes.append(len(ds))
            state = adapter.with_params(state, average_params(clients, sizes))
            rec = {"round": r,
                   "test_acc": _accuracy(adapter, state, self.test_ds)}
            self.history.append(rec)
            if log:
                log(f"[fedavg round {r}] acc={rec['test_acc']:.4f}")
        return state, self.history
