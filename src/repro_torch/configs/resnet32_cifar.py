"""The paper's own experimental configuration (§4).

CIFAR-100, ResNet-32 on every edge and the core; 20 Dirichlet(alpha=1)
subsets (1 core + 19 edges); SGD momentum 0.9, wd 1e-4, lr 0.1 decayed 10x
at epochs 80/120 of 160; batch 128; tau = 2.  The reduced configuration
cuts epochs and edges but keeps every algorithmic choice.
"""

import dataclasses

from repro_torch.core.fl import FLConfig
from repro_torch.nn.resnet import ResNetConfig

RESNET32 = ResNetConfig(depth=32, num_classes=100, width=16)

PAPER_FL = FLConfig(
    num_edges=19, rounds=19, aggregation_r=1, tau=2.0, method="bkd",
    core_epochs=160, edge_epochs=160, kd_epochs=40,
    batch_size=128, lr=0.1, weight_decay=1e-4,
)

# Reduced budget used by the benchmarks (same algorithm, fewer epochs).
REDUCED_FL = dataclasses.replace(
    PAPER_FL, num_edges=5, rounds=5, core_epochs=12, edge_epochs=12,
    kd_epochs=6, batch_size=128,
)
