"""Method-as-strategy API — every FL variant behind one pluggable interface.

The PyTorch counterpart of the JAX package's ``repro/core/methods.py``:
subclass :class:`DistillMethod`, decorate with :func:`register_method`, and
``FederatedKD``/``DistillEngine`` and the benchmarks pick it up by name.

Round lifecycle (all hooks optional):

    init_round      build the method-state dict (and optionally replace
                    the student — FedDF inits from the teacher average)
    on_epoch_start  per-epoch state refresh (melting's re-clone)
    loss            compose the Eq. 3/4 terms from the engine-provided
                    student/teacher logits (jnp / pallas / topk backends)
    apply_aux_grads transform param grads + update the learned auxiliary
                    (FT's translator SGD) — only when ``learns_aux``
    post_step       per-step state update (EMA shadow)
    finalize        end-of-round state swap (EMA weights)
    distill_round   replace the whole gradient phase (FedAvg's averaging)
                    — only when ``full_round``

The method state is a dict with three groups the engine treats
differently: ``"frozen"`` (epoch-constant inputs: the frozen buffer
clone), ``"cache"`` (per-example tensors gathered with each step's batch
indices: the ``bkd_cached`` logit cache) and ``"step"`` (carried and
updated step to step: EMA shadow, FT translator).

The ``"pallas"`` backend name is kept from the reference: here it means the
hand-written CUDA kernel pair behind ``repro_torch.kernels.ops.kd_loss``
(its plain PyTorch version on a CPU tensor).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import distill
from repro_torch.core.aggregation import average_params
from repro_torch.core.buffer import precompute_logits
from repro_torch.tree import tree_leaves, tree_map

#: name -> DistillMethod subclass.  Populated by :func:`register_method`.
METHODS: dict = {}


def register_method(cls):
    """Class decorator: register ``cls`` under ``cls.name``; duplicate
    names are rejected (shadowing would silently change results)."""
    name = cls.name
    if not name or not isinstance(name, str):
        raise ValueError(f"{cls.__name__} must define a non-empty string "
                         f"`name` class attribute")
    if name in METHODS:
        raise ValueError(f"method {name!r} is already registered "
                         f"({METHODS[name].__name__}); duplicate names are "
                         f"rejected — pick a new one")
    METHODS[name] = cls
    return cls


def resolve_method(name: str) -> "DistillMethod":
    """Instantiate the registered method ``name`` (methods are stateless —
    all per-round state lives in the method-state dict)."""
    if isinstance(name, DistillMethod):
        return name
    try:
        return METHODS[name]()
    except KeyError:
        raise ValueError(f"unknown method {name!r}; registered methods: "
                         f"{method_names()}") from None


def method_names() -> tuple:
    """Sorted registered method names."""
    return tuple(sorted(METHODS))


def validate_backend(method: str, backend: str, *, llm: bool = False):
    """Raise ``ValueError`` if ``backend`` can't drive ``method``: the CLIs
    reject a bad ``--method``/``--loss-backend`` pair at argparse time.
    ``llm=True`` checks the LLM driver's backend set
    (``launch/train.py``) instead of the FL engine's."""
    meth = resolve_method(method)
    allowed = meth.llm_backends if llm else ("auto",) + meth.supported_backends
    if backend not in allowed:
        raise ValueError(
            f"loss_backend {backend!r} is not supported by method "
            f"{method!r} (allowed: {tuple(allowed)})")


def empty_state() -> dict:
    """A method state with no frozen/cache/step components."""
    return {"frozen": None, "cache": None, "step": None}


@dataclasses.dataclass
class MethodContext:
    """Everything a method hook may need, bundled.  ``core_ds``,
    ``round_idx`` and ``teacher_weights`` are set for the round-level
    hooks, not inside the step."""

    adapter: object
    cfg: object
    backend: str = "jnp"
    core_ds: object = None
    round_idx: int = 0
    teacher_weights: Optional[list] = None


def clip_grads(g, max_norm=5.0):
    """Global-norm clip for the simplified-FT factor loss."""
    tot = torch.sqrt(sum(torch.sum(torch.square(l.float()))
                         for l in tree_leaves(g)))
    scale = torch.clamp(max_norm / torch.clamp(tot, min=1e-9), max=1.0)
    return tree_map(lambda l: l * scale, g)


def kd_terms(ctx: MethodContext, lg, tls, bl, y):
    """Eq. 3 (+ the Eq. 4 buffer KL when ``bl`` is given), routed through
    the configured loss backend — the composition shared by the KD family.
    With R > 1 teachers the ensemble enters the kernel as
    ``tau * log(A_f)``, whose softmax at temperature tau is A_f."""
    tau = ctx.cfg.tau
    if ctx.backend == "pallas":
        from repro_torch.kernels import ops
        if tls.shape[0] == 1:
            t_eff = tls[0]
        else:
            af = distill.ensemble_probs(tls, tau)
            t_eff = tau * torch.log(torch.clamp(af, min=1e-30))
        return ops.kd_loss(y, lg, t_eff, bl, tau)
    loss = distill.l_kd(lg, tls, y, tau)
    if bl is not None:
        loss = loss + distill.kl_soft(lg, bl, tau)
    return loss


class DistillMethod:
    """Strategy protocol: one FL method's round lifecycle."""

    #: Registry key.
    name: str = ""
    #: One-line description.
    description: str = ""
    #: Loss backends the engine can run this method with ("auto" is always
    #: accepted and resolved against this set).
    supported_backends: tuple = ("jnp", "pallas")
    #: The method has a differentiable auxiliary (FT's translator).
    learns_aux: bool = False
    #: The method replaces the whole gradient phase (``distill_round``).
    full_round: bool = False

    # --- LLM-driver (launch/train.py) capability hints -------------------
    #: The LLM driver can run this method.  When False,
    #: ``llm_unsupported_reason`` says why (argparse error text).
    llm_driver: bool = True
    llm_unsupported_reason: str = ""
    #: ``--loss-backend`` choices valid on the LLM driver.
    llm_backends: tuple = ("auto", "jnp", "pallas")
    #: Phase-2 buffer wiring on the LLM driver: "none" | "clone" (frozen at
    #: round start) | "remelt" (re-cloned each segment: the melting
    #: ablation at streaming scale).
    llm_buffer: str = "none"
    #: Weight on the CE term of the LLM chunked loss (FedDF: 0).
    llm_ce_weight: float = 1.0
    #: The driver keeps an EMA shadow over Phase-2 steps and swaps it in.
    llm_ema: bool = False
    #: The driver replaces Phase 2 with parameter averaging.
    llm_averaging: bool = False
    #: The driver re-inits the student from the teacher average before
    #: Phase 2 (FedDF).
    llm_init_from_avg: bool = False

    def init_round(self, ctx: MethodContext, state, teachers):
        return state, empty_state()

    def on_epoch_start(self, ctx: MethodContext, state, mstate):
        return mstate

    def loss(self, ctx: MethodContext, lg, tls, y, *, x, student_state,
             frozen, cache, learned, tstack):
        """Per-step loss from the student logits ``lg`` and the stacked
        (frozen) teacher logits ``tls`` ``(R, B, V)``."""
        raise NotImplementedError

    def wants_teacher_logits(self, cache) -> bool:
        """Whether the step must compute the teacher logits ``tls`` for
        :meth:`loss` (False where the teachers arrive another way, as a
        transport payload in ``cache``)."""
        return True

    def learned(self, step_state):
        """The differentiable part of the step state (``learns_aux`` only)."""
        return None

    def wants_aux(self, adapter) -> bool:
        return self.learns_aux

    def apply_aux_grads(self, ctx: MethodContext, grads, aux_grads,
                        step_state):
        return grads, step_state

    def post_step(self, ctx: MethodContext, step_state, new_params):
        return step_state

    def finalize(self, ctx: MethodContext, state, mstate):
        return state

    def distill_round(self, ctx: MethodContext, state, teachers):
        raise NotImplementedError


@register_method
class KD(DistillMethod):
    name = "kd"
    description = ("vanilla KD, Eq. 3 (= Lin et al. 2020 at R=1): CE + "
                   "tau^2 KL against the teacher ensemble A_f")
    llm_backends = ("auto", "jnp", "pallas", "topk_cached")

    def loss(self, ctx, lg, tls, y, *, x, student_state, frozen, cache,
             learned, tstack):
        return kd_terms(ctx, lg, tls, None, y)


@register_method
class BKD(DistillMethod):
    name = "bkd"
    description = ("buffered KD, Eq. 4 (the paper's contribution): Eq. 3 + "
                   "tau^2 KL against the frozen start-of-round clone F0")
    llm_buffer = "clone"
    llm_backends = ("auto", "jnp", "pallas", "topk_cached")

    def init_round(self, ctx, state, teachers):
        mstate = empty_state()
        mstate["frozen"] = state  # Fig. 3 clone (states are never mutated)
        return state, mstate

    def loss(self, ctx, lg, tls, y, *, x, student_state, frozen, cache,
             learned, tstack):
        with torch.no_grad():
            bl = ctx.adapter.logits(frozen, x, False)[0]
        return kd_terms(ctx, lg, tls, bl, y)


@register_method
class Melting(BKD):
    name = "melting"
    description = ("ablation (Fig. 4): the buffer is re-cloned every epoch "
                   "— a melting buffer collapses BKD back toward KD")
    llm_buffer = "remelt"
    llm_backends = ("auto", "jnp", "pallas")

    def on_epoch_start(self, ctx, state, mstate):
        return dict(mstate, frozen=state)


@register_method
class EMA(DistillMethod):
    name = "ema"
    description = ("EMA-of-weights baseline (Fig. 4a): plain KD while an "
                   "exponential moving average of the student is tracked "
                   "and swapped in at round end")
    llm_ema = True

    def init_round(self, ctx, state, teachers):
        mstate = empty_state()
        mstate["step"] = ctx.adapter.params(state)
        return state, mstate

    def loss(self, ctx, lg, tls, y, *, x, student_state, frozen, cache,
             learned, tstack):
        return kd_terms(ctx, lg, tls, None, y)

    def post_step(self, ctx, step_state, new_params):
        return distill.ema_update(step_state, new_params, ctx.cfg.ema_decay)

    def finalize(self, ctx, state, mstate):
        return ctx.adapter.with_params(state, mstate["step"])


@register_method
class FT(DistillMethod):
    name = "ft"
    description = ("Factor-Transfer+KD baseline (§4.1): KD plus a linear "
                   "translator trained by SGD inside the step to match "
                   "normalized teacher factors")
    learns_aux = True
    llm_driver = False
    llm_unsupported_reason = ("it needs penultimate-feature taps the "
                              "token-LM path does not expose")

    def init_round(self, ctx, state, teachers):
        mstate = empty_state()
        if ctx.adapter.features is not None:
            device = tree_leaves(state)[0].device
            with torch.no_grad():
                f = ctx.adapter.features(
                    state, torch.as_tensor(ctx.core_ds.x[:1], device=device))
            mstate["step"] = torch.eye(f.shape[-1], dtype=torch.float32,
                                       device=device)
        return state, mstate

    def learned(self, step_state):
        return step_state

    def wants_aux(self, adapter):
        return adapter.features is not None

    def loss(self, ctx, lg, tls, y, *, x, student_state, frozen, cache,
             learned, tstack):
        loss = kd_terms(ctx, lg, tls, None, y)
        if learned is not None:
            fs = ctx.adapter.features(student_state, x)
            with torch.no_grad():
                ft = ctx.adapter.features(tree_map(lambda l: l[0], tstack), x)
            loss = loss + ctx.cfg.ft_weight * distill.factor_loss(fs, ft,
                                                                  learned)
        return loss

    def apply_aux_grads(self, ctx, grads, aux_grads, step_state):
        return clip_grads(grads), step_state - 0.01 * clip_grads(aux_grads)


@register_method
class BKDCached(DistillMethod):
    name = "bkd_cached"
    description = ("beyond-paper cached-logit buffer: F0 is frozen and the "
                   "core set static, so its logits are precomputed once — "
                   "mathematically identical to Eq. 4, no third forward")
    supported_backends = ("jnp", "pallas", "topk_cached")
    llm_buffer = "clone"  # LLM batches are resampled; cache lives in the loss
    llm_backends = ("auto", "jnp", "pallas", "topk_cached")

    def init_round(self, ctx, state, teachers):
        topk = ctx.cfg.cache_topk if ctx.backend == "topk_cached" else None
        cache = precompute_logits(ctx.adapter, state, ctx.core_ds, topk=topk)
        mstate = empty_state()
        mstate["cache"] = cache.lookup(slice(None))
        return state, mstate

    def loss(self, ctx, lg, tls, y, *, x, student_state, frozen, cache,
             learned, tstack):
        if ctx.backend == "topk_cached":
            tv, ti, tail = cache
            loss = distill.l_kd(lg, tls, y, ctx.cfg.tau)
            return loss + distill.topk_kl_cached(lg, tv, ti, tail,
                                                 ctx.cfg.tau)
        return kd_terms(ctx, lg, tls, cache, y)


@register_method
class FedAvgMethod(DistillMethod):
    name = "fedavg"
    description = ("FedAvg (McMahan et al. 2017) under the KD orchestrator: "
                   "the 'distill' phase is a shard-size-weighted parameter "
                   "average of the round's teachers — no gradient epochs")
    full_round = True
    llm_backends = ("auto",)
    llm_averaging = True

    def distill_round(self, ctx, state, teachers):
        params = [ctx.adapter.params(t) for t in teachers]
        avg = average_params(params, ctx.teacher_weights)
        return ctx.adapter.with_params(state, avg)


@register_method
class FedDF(DistillMethod):
    name = "feddf"
    description = ("FedDF ensemble distillation (Lin et al. 2020): student "
                   "inits from the teacher parameter average, then distills "
                   "A_f of the round's teachers — pure KL, no CE or buffer "
                   "term (meaningful at R>1)")
    supported_backends = ("jnp",)  # the fused kernel always includes CE
    # The LLM driver distills R=1 per round, where init-from-average makes
    # FedDF degenerate (KL against a copy of the teacher: zero value and
    # gradient), so it is rejected there until that driver grows R>1.
    llm_driver = False
    llm_unsupported_reason = ("it is only meaningful at R>1 teachers per "
                              "round and the token-LM driver distills R=1 "
                              "(at R=1 it degenerates to fedavg at full "
                              "gradient cost)")
    llm_backends = ("auto", "jnp")
    llm_ce_weight = 0.0
    llm_init_from_avg = True

    def init_round(self, ctx, state, teachers):
        avg = average_params([ctx.adapter.params(t) for t in teachers],
                             ctx.teacher_weights)
        return ctx.adapter.with_params(state, avg), empty_state()

    def loss(self, ctx, lg, tls, y, *, x, student_state, frozen, cache,
             learned, tstack):
        tau = ctx.cfg.tau
        if tls.shape[0] == 1:
            return distill.kl_soft(lg, tls[0], tau)
        af = distill.ensemble_probs(tls, tau)
        return distill.kl_soft_vs_probs(lg, af, tau)
