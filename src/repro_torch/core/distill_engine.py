"""Phase-2 distillation engine — KD epochs over an index schedule,
method-agnostic.

The PyTorch counterpart of the JAX package's ``repro/core/distill_engine.py``.
There a KD epoch is one jitted ``lax.scan`` over the pre-batched core-set
index schedule; here it is a Python loop over the same schedule (the same
``data.pipeline.batches`` stream, seed ``cfg.seed + 997 * round + epoch``)
whose steps gather their batch from a device-resident copy of the core
set.  ``cfg.scan=False`` keeps the reference's per-batch path: each batch
is cut on the host and copied over, with the same step math.  What a round
does comes from the :class:`repro_torch.core.methods.DistillMethod`
resolved by name; the engine carries its state dict generically:

    mstate["frozen"]  epoch-constant inputs (buffer clone)
    mstate["cache"]   per-example tensors, gathered with each step's batch
                      indices (the bkd_cached logit cache)
    mstate["step"]    carried step to step and updated by the method's
                      hooks (EMA shadow, FT translator)

A step differentiates the loss with ``torch.autograd`` (the fused KD loss
is a ``torch.autograd.Function`` over hand-written kernels); teacher and
buffer logits are computed under ``torch.no_grad()``.

Loss backends (``FLConfig.loss_backend``):

    "jnp"          the plain losses in ``repro_torch.core.distill`` (Eqs. 3/4)
    "pallas"       the fused loss ``repro_torch.kernels.ops.kd_loss``: the
                   hand-written CUDA kernels ``kd_stats_fwd``/``kd_grad_bwd``
                   on a CUDA device, their plain versions on the CPU.  R>1
                   ensembles enter as ``tau * log(A_f)``.
    "topk_cached"  ``bkd_cached`` only: the buffer term from the top-k
                   compressed logit cache.
    "auto"         "pallas" on a CUDA device, else "jnp" — downgraded to
                   "jnp" when the method does not support it (FedDF).

The names are the reference's, so configurations carry over.

Uplink transport (``FLConfig.transport``, a codec spec from
``repro_torch.transport``, or "none"): the round's method is wrapped in a
:class:`repro_torch.transport.TransportMethod`, and every round's uplink
bytes under the codec's accounting go to ``DistillEngine.uplink_log``.
With ``int8``/``int4`` and one teacher on the "pallas" backend, every step
runs the dequant-fused kernel pair ``kd_quant_stats_fwd``/
``kd_quant_grad_bwd``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.buffer import core_logits
from repro_torch.core.methods import MethodContext, resolve_method
from repro_torch.data.pipeline import batches
from repro_torch.optim import sgd_momentum, step_decay
from repro_torch.tree import (stack_trees, tree_leaves, tree_map,
                              tree_unflatten)

BACKENDS = ("auto", "jnp", "pallas", "topk_cached")


def resolve_backend(backend: str, method, device) -> str:
    """Map "auto" onto a concrete backend for ``device`` and validate it
    against the method's declared ``supported_backends``."""
    if backend not in BACKENDS:
        raise ValueError(f"loss_backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    meth = resolve_method(method)
    if backend == "auto":
        backend = "pallas" if torch.device(device).type == "cuda" else "jnp"
        if backend not in meth.supported_backends:
            backend = "jnp"
    if backend not in meth.supported_backends:
        raise ValueError(
            f"loss_backend {backend!r} is not supported by method "
            f"{meth.name!r} (supported: {meth.supported_backends})"
            + (" — it evaluates the buffer term from the compressed cache"
               if backend == "topk_cached" else ""))
    return backend


def teacher_logits(adapter, tstack, x):
    """Logits (R, B, V) of the R stacked teacher states on ``x`` (eval
    mode, no gradient)."""
    n = tree_leaves(tstack)[0].shape[0]
    with torch.no_grad():
        return torch.stack([
            adapter.logits(tree_map(lambda l, r=r: l[r], tstack), x, False)[0]
            for r in range(n)])


def make_step_impl(adapter, opt, cfg, method, backend):
    """The Phase-2 update:

    step(state, opt_state, step_state, tstack, frozen, cache, x, y, i)
        -> (state, opt_state, step_state, loss)

    ``frozen``/``cache``/``step_state`` are the method-state groups (any may
    be ``None``); the method's ``loss``/``apply_aux_grads``/``post_step``
    hooks compose the variant-specific math.
    """
    meth = resolve_method(method)
    ctx = MethodContext(adapter=adapter, cfg=cfg, backend=backend)
    aux_mode = meth.learns_aux and meth.wants_aux(adapter)

    def step(state, opt_state, step_state, tstack, frozen, cache, x, y, i):
        params = adapter.params(state)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        learned = meth.learned(step_state)
        if aux_mode:
            learned = learned.detach().requires_grad_()
        st = adapter.with_params(state, tree_unflatten(params, leaves))
        lg, new_state = adapter.logits(st, x, True)
        tls = (teacher_logits(adapter, tstack, x)
               if meth.wants_teacher_logits(cache) else None)
        loss = meth.loss(ctx, lg, tls, y, x=x, student_state=st,
                         frozen=frozen, cache=cache, learned=learned,
                         tstack=tstack)
        wrt = leaves + ([learned] if aux_mode else [])
        g = torch.autograd.grad(loss, wrt, allow_unused=True)
        g = [torch.zeros_like(w) if gi is None else gi
             for gi, w in zip(g, wrt)]
        grads = tree_unflatten(params, g[:len(leaves)])
        with torch.no_grad():
            if aux_mode:
                grads, step_state = meth.apply_aux_grads(ctx, grads, g[-1],
                                                         step_state)
            new_params, opt_state = opt.update(grads, opt_state, params, i)
            state = adapter.with_params(tree_map(torch.Tensor.detach,
                                                 new_state), new_params)
            step_state = meth.post_step(ctx, step_state, new_params)
        return state, opt_state, step_state, loss.detach()

    return step


class DistillEngine:
    """Round-level Phase-2 runner: resolve the method, run its lifecycle.

    One engine lives for the whole FL run and keeps its step functions per
    (method, backend) and a device copy of the core set.
    """

    def __init__(self, adapter, cfg, core_ds, device):
        self.adapter, self.cfg = adapter, cfg
        self.core_ds = core_ds
        self.device = torch.device(device)
        self._data = None    # device copy of the core set
        self._opt = None
        self._fns = {}       # (method, backend) -> step function
        # Uplink transport: parsed once so a bad spec fails at
        # construction, not round 5.  Wrapped methods are cached per inner
        # name so the step-function cache stays keyed on one instance.
        # (repro_torch.transport imports this package: imported here.)
        transport = getattr(cfg, "transport", "none") or "none"
        if transport == "none":
            self._codec = None
        else:
            from repro_torch.transport import parse_codec
            self._codec = parse_codec(transport)
        self._wrapped = {}
        self._vocab = None
        #: One record per distillation round: round, method, codec, teacher
        #: count, and the round's total uplink bytes under the codec's
        #: accounting (full_round methods ship parameters, not logits).
        self.uplink_log = []

    @property
    def uplink_bytes_total(self):
        return sum(rec["bytes"] for rec in self.uplink_log)

    def _vocab_size(self, state):
        if self._vocab is None:
            with torch.no_grad():
                lg, _ = self.adapter.logits(
                    state, torch.as_tensor(self.core_ds.x[:1],
                                           device=self.device), False)
            self._vocab = int(lg.shape[-1])
        return self._vocab

    def _wrap(self, meth):
        """The transport-wrapped view of ``meth`` (cached per inner name)."""
        from repro_torch.transport import TransportMethod
        if meth.name not in self._wrapped:
            self._wrapped[meth.name] = TransportMethod(meth, self._codec)
        return self._wrapped[meth.name]

    def _account(self, meth, teacher_states, round_idx):
        """Log this round's uplink bytes.  Gradient methods ship each
        teacher's core-set logits through the codec; full_round methods
        (FedAvg) ship raw f32 parameters — the codec does not apply."""
        if self._codec is None:
            return
        if meth.full_round:
            total = sum(4 * leaf.numel() for t in teacher_states
                        for leaf in tree_leaves(self.adapter.params(t)))
        else:
            n = len(self.core_ds)
            v = self._vocab_size(teacher_states[0])
            total = 0
            for t in teacher_states:
                lg = (core_logits(self.adapter, t, self.core_ds)
                      if self._codec.needs_logits else None)
                total += self._codec.payload_bytes(n, v, logits=lg)
        self.uplink_log.append({"round": round_idx, "method": meth.name,
                                "codec": self._codec.spec,
                                "teachers": len(teacher_states),
                                "bytes": int(total)})

    def _device_data(self):
        if self._data is None:
            self._data = (torch.as_tensor(self.core_ds.x, device=self.device),
                          torch.as_tensor(self.core_ds.y, device=self.device))
        return self._data

    def _optimizer(self):
        if self._opt is None:
            cfg = self.cfg
            n = len(self.core_ds)
            steps_per_epoch = max(n // min(cfg.batch_size, n), 1)
            total = steps_per_epoch * cfg.kd_epochs
            self._opt = sgd_momentum(
                step_decay(cfg.kd_lr, [total // 2, 3 * total // 4]),
                weight_decay=cfg.weight_decay)
        return self._opt

    def _get_fn(self, method, backend):
        key = (method, backend)
        if key not in self._fns:
            self._fns[key] = make_step_impl(self.adapter, self._optimizer(),
                                            self.cfg, method, backend)
        return self._fns[key]

    def _round_backend(self, method_name, meth):
        """The concrete backend for this round's (possibly overridden)
        method."""
        cfg = self.cfg
        backend = cfg.loss_backend
        if (backend != "auto" and backend not in meth.supported_backends
                and method_name != cfg.method
                and backend in resolve_method(cfg.method).supported_backends):
            # Per-round method override (the paper's plain-KD warm-up rounds,
            # §4.2): the configured backend fits cfg.method but not this
            # round's override — fall back to the jnp loss.
            backend = "jnp"
        return resolve_backend(backend, meth, self.device)

    def stepper(self, state, teacher_states, round_idx, method=None,
                teacher_weights=None):
        """A resumable :class:`RoundStepper` for this round."""
        return RoundStepper(self, state, teacher_states, round_idx,
                            method=method, teacher_weights=teacher_weights)

    def run(self, state, teacher_states, round_idx, method=None,
            teacher_weights=None):
        """Distill the round's teachers into ``state`` (Algorithm 1 Phase 2)
        via the resolved method's lifecycle: a :class:`RoundStepper`
        driven one epoch per call to the end."""
        stepper = self.stepper(state, teacher_states, round_idx,
                               method=method, teacher_weights=teacher_weights)
        while not stepper.finished:
            stepper.step()
        return stepper.result


class RoundStepper:
    """One Phase-2 distillation round as a resumable step iterator.

    Construction performs the round preamble (method resolution,
    ``init_round``, optimizer init, teacher stacking); each :meth:`step`
    advances the epoch loop by at most ``max_steps`` microbatches, carrying
    ``(state, opt_state, method-state, global step counter)`` across calls.
    Chunking never changes the math: a stepper driven to completion in any
    chunks returns what one call per epoch returns.
    """

    def __init__(self, engine, state, teacher_states, round_idx,
                 method=None, teacher_weights=None):
        cfg, adapter = engine.cfg, engine.adapter
        self.engine, self.cfg = engine, cfg
        self.round_idx = round_idx
        self.finished = False
        #: The finalized post-round state once ``finished`` is True.
        self.result = None
        #: Each optimizer step's loss, a scalar tensor on the device
        #: (reading one synchronises).
        self.losses = []
        self.i = 0
        name = method or cfg.method
        meth = resolve_method(name)
        engine._account(meth, teacher_states, round_idx)
        ctx = MethodContext(adapter=adapter, cfg=cfg, core_ds=engine.core_ds,
                            round_idx=round_idx,
                            teacher_weights=teacher_weights)
        if meth.full_round:
            # FedAvg-style methods replace the gradient epochs with one
            # aggregation — the whole round is a single step.
            self._full = (meth, ctx, state, teacher_states)
            return
        self._full = None
        ctx.backend = engine._round_backend(name, meth)
        if engine._codec is not None:
            # Teachers are observed through the uplink codec; the wrapper is
            # itself a DistillMethod, so the lifecycle below is unchanged.
            meth = engine._wrap(meth)
            name = meth   # step-function cache key: the stable wrapper
        self.meth, self.ctx = meth, ctx
        opt = engine._optimizer()
        self.state, self.mstate = meth.init_round(ctx, state, teacher_states)
        self.opt_state = opt.init(adapter.params(self.state))
        self.tstack = stack_trees(teacher_states)
        self.fn = engine._get_fn(name, ctx.backend)
        self.i = 0        # global optimizer step (lr-schedule position)
        self.epoch = 0    # completed-epoch count
        self.pos = 0      # row offset into the current epoch's schedule
        self._idx = None  # (S, B) index schedule of the in-flight epoch
        self._idx_dev = None

    @property
    def steps_done(self):
        return self.i

    def _maybe_finish(self):
        if self._idx is None and self.epoch >= self.cfg.kd_epochs:
            self.result = self.meth.finalize(self.ctx, self.state,
                                             self.mstate)
            self.finished = True

    def _run_one(self, x, y, cache):
        self.state, self.opt_state, step_state, loss = self.fn(
            self.state, self.opt_state, self.mstate["step"], self.tstack,
            self.mstate["frozen"], cache, x, y, self.i)
        self.losses.append(loss)
        self.mstate = dict(self.mstate, step=step_state)
        self.i += 1

    def step(self, max_steps=None):
        """Advance by at most ``max_steps`` microbatches (one full epoch —
        or the remainder of the in-flight one — when ``None``).  Returns the
        number of optimizer steps executed; 0 once the round is finished."""
        if self.finished:
            return 0
        if self._full is not None:
            meth, ctx, state, teachers = self._full
            self.result = meth.distill_round(ctx, state, teachers)
            self.finished = True
            self._full = None
            return 1
        self._maybe_finish()
        if self.finished:
            return 0
        cfg, engine = self.cfg, self.engine
        if self._idx is None:
            # Epoch boundary: same hook order and batch-schedule seed as the
            # reference (on_epoch_start, then the epoch's permutation).
            self.mstate = self.meth.on_epoch_start(self.ctx, self.state,
                                                   self.mstate)
            seed = cfg.seed + 997 * self.round_idx + self.epoch
            self._idx = np.stack(list(batches(
                engine.core_ds, cfg.batch_size, seed=seed, epochs=1,
                indices_only=True)))
            self._idx_dev = (torch.as_tensor(self._idx, device=engine.device)
                             if cfg.scan else None)
            self.pos = 0
        n = self._idx.shape[0] - self.pos
        if max_steps is not None:
            n = min(n, int(max_steps))
        if n <= 0:
            return 0
        full = self.mstate["cache"]
        for k in range(self.pos, self.pos + n):
            if cfg.scan:
                data_x, data_y = engine._device_data()
                sel = self._idx_dev[k]
                x, y = data_x[sel], data_y[sel]
            else:
                sel = self._idx[k]
                x = torch.as_tensor(engine.core_ds.x[sel], device=engine.device)
                y = torch.as_tensor(engine.core_ds.y[sel], device=engine.device)
                sel = torch.as_tensor(sel, device=engine.device)
            cache = tree_map(lambda a: a[sel], full)
            self._run_one(x, y, cache)
        self.pos += n
        if self.pos >= self._idx.shape[0]:
            self._idx = self._idx_dev = None
            self.epoch += 1
            self._maybe_finish()
        return n
