"""The paper's Algorithm 1 in PyTorch: KD-based federated learning with
buffered distillation (Eqs. 1-4), its baselines, the cached-logit buffer
and the method registry — the counterpart of the JAX package's
``repro.core`` on the synchronous path."""

from repro_torch.core import distill
from repro_torch.core.aggregation import FedAvg, FedAvgConfig, average_params
from repro_torch.core.buffer import (LogitCache, precompute_logits,
                                     reconstruct_logits)
from repro_torch.core.distill_engine import (BACKENDS, DistillEngine,
                                             resolve_backend)
from repro_torch.core.fl import (FederatedKD, FLConfig, ModelAdapter,
                                 RoundMetrics, mlp_adapter, resnet_adapter)
from repro_torch.core.methods import (METHODS, DistillMethod, MethodContext,
                                      method_names, register_method,
                                      resolve_method)
from repro_torch.core.scheduler import (FROZEN, SCENARIOS, RoundPlan,
                                        RoundScheduler, build_scenario,
                                        max_retained_staleness)
from repro_torch.core.vectorized import VectorizedEdgeEngine

__all__ = [
    "distill",
    "FederatedKD", "FLConfig", "ModelAdapter", "RoundMetrics",
    "mlp_adapter", "resnet_adapter",
    "FedAvg", "FedAvgConfig", "average_params",
    "LogitCache", "precompute_logits", "reconstruct_logits",
    "BACKENDS", "DistillEngine", "resolve_backend",
    "METHODS", "DistillMethod", "MethodContext", "method_names",
    "register_method", "resolve_method",
    "FROZEN", "RoundPlan", "RoundScheduler", "SCENARIOS", "build_scenario",
    "max_retained_staleness",
    "VectorizedEdgeEngine",
]
