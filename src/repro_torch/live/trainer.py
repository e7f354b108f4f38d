"""LiveTrainer — the FL round loop as a resumable step iterator.

``FederatedKD.run``'s flat round loop, cut so that an outer loop can drive
Phase-2 microbatches itself:

    trainer = LiveTrainer(fl, key)
    while trainer.pending():
        trainer.step(max_steps=4)     # <= 4 KD microbatches

Each round runs as (Phase-1 edge training at ``start_round``) -> (a
``RoundStepper`` advanced ``max_steps`` microbatches per :meth:`step`
call) -> (round completion: metrics recording, state update).  The PyTorch
counterpart of the JAX package's ``repro/live/trainer.py`` without the
checkpoint carry: ``carry``/``restore`` are not ported yet.
"""

from __future__ import annotations

from repro_torch.core.scheduler import max_retained_staleness

_NOT_PORTED = ("not ported yet (ROADMAP.md queue 1, slice 6: live system "
               "and checkpoints)")


class LiveTrainer:
    """Resumable runner of the flat FL round loop over ``fl``'s plan stream.

    Construction runs Phase 0 (core pretraining) and materializes the plan
    stream; each :meth:`step` advances by at most ``max_steps`` Phase-2
    microbatches, starting the next round (Phase 1) when idle and
    completing rounds (metrics + ``state`` update) as their steppers
    finish.
    """

    def __init__(self, fl, key, plans=None, log=print):
        self.fl, self.cfg, self.log = fl, fl.cfg, log
        self.state = fl.pretrain_core(key)
        self.plans = (list(fl.scheduler.plans(self.cfg.rounds))
                      if plans is None else list(plans))
        if any(getattr(p, "level", "") == "region" for p in self.plans):
            raise ValueError("hierarchical plan streams are not steppable")
        # The history ring retains exactly as many past core states as the
        # stream's deepest staleness needs.
        self.keep = 1 + max_retained_staleness(self.plans)
        self.core_log = []          # core state at the start of recent rounds
        self.prev_edge_ds, self.prev_preds = None, None
        self.cursor = 0             # next plan index
        self.rounds_done = 0
        self._plan = None           # in-flight round's plan
        self._stepper = None        # its RoundStepper (None for withdraw)
        self._pre_preds = None

    @property
    def mid_round(self):
        return self._plan is not None

    def pending(self) -> bool:
        return self.mid_round or self.cursor < len(self.plans)

    def start_round(self):
        """Run the next plan's Phase 1 (edge training, seed
        ``cfg.seed + 31 * round``) and arm its Phase-2 stepper."""
        fl, cfg = self.fl, self.cfg
        plan = self.plans[self.cursor]
        r = plan.round_idx
        self.core_log = (self.core_log + [self.state])[-self.keep:]
        inits = [fl._resolve_init(t, self.core_log, self.state)
                 for t in plan.tasks]
        teachers = fl.train_round_edges(inits, plan.edge_ids,
                                        seed=cfg.seed + 31 * r)
        self._plan = plan
        # `state` has not changed since the previous round's acc_cur_edge
        # pass over this same dataset, so its predictions carry over.
        self._pre_preds = self.prev_preds
        self._stepper = (None if plan.withdraw else
                         fl.distill_stepper(self.state, teachers, r,
                                            edge_ids=plan.edge_ids))

    def _complete_round(self):
        fl, plan = self.fl, self._plan
        r = plan.round_idx
        if self._stepper is not None:
            self.state = self._stepper.result
        edge_ids, straggler_round = plan.edge_ids, plan.straggler
        cur_ds = fl._round_union(edge_ids)
        rec, cur_preds = fl._record_round(
            self.state, r, edge_ids, straggler_round,
            [t.staleness for t in plan.tasks], cur_ds, self._pre_preds,
            self.prev_edge_ds)
        if self.log:
            self.log(
                f"[round {r:02d}] edges={edge_ids} test_acc={rec.test_acc:.4f}"
                + (f" prev_edge={rec.acc_prev_edge:.4f}"
                   if rec.acc_prev_edge is not None else "")
                + (" (straggler)" if straggler_round else "")
                # Async plans carry their event-time provenance.
                + (f" t={plan.time:.2f} via {plan.trigger}"
                   if getattr(plan, "trigger", "") else ""))
        self.prev_edge_ds, self.prev_preds = cur_ds, cur_preds
        self._plan = self._stepper = self._pre_preds = None
        self.cursor += 1
        self.rounds_done += 1

    def step(self, max_steps=None):
        """Start the next round when idle (Phase 1 runs here), then advance
        its Phase-2 stepper by at most ``max_steps`` microbatches; complete
        the round when the stepper finishes.  Returns the number of
        optimizer steps executed."""
        if not self.mid_round:
            if self.cursor >= len(self.plans):
                return 0
            self.start_round()
        n = 0
        if self._stepper is not None:
            n = self._stepper.step(max_steps)
            if not self._stepper.finished:
                return n
        self._complete_round()
        return n

    def run(self):
        """Drive every remaining round to completion."""
        while self.pending():
            self.step()
        return self.state, self.fl.history

    def carry(self):
        raise NotImplementedError(f"trainer checkpoints are {_NOT_PORTED}")

    def restore(self, path, meta):
        raise NotImplementedError(f"trainer checkpoints are {_NOT_PORTED}")
