"""LiveSystem — one loop, one clock: decode ticks interleaved with distill.

The co-scheduler closes the paper's loop: the core model serves traffic
(`ServeEngine.tick`) while Phase-2 distillation rounds update it
(`LiveTrainer.step`), on one device budget.  The virtual clock is the
engine's tick counter; async plan streams carry event times that are
mapped onto it via ``ticks_per_time``, so a round becomes *runnable* only
once the serving clock reaches its simulated arrival — edge bias then
accumulates between swaps exactly as the paper's Fig. 5 forgetting story
describes, but observed on live traffic.

Swap protocol: when a round completes, the new core state is staged into
the engine's standby buffer and committed *between* ticks
(`ServeEngine.hot_swap`) — `tick()` reads the served params exactly once
at entry, so no in-flight request ever sees a torn update (property-tested
at every tick offset in the JAX package's ``tests/test_live.py``).
"""

from __future__ import annotations


class LiveSystem:
    """Co-schedule a :class:`~repro_torch.live.trainer.LiveTrainer` and a
    :class:`~repro_torch.serve.engine.ServeEngine`.

    Per loop iteration: one decode tick (when traffic is pending), then up
    to ``quantum`` distill microbatches (when the next round is runnable on
    the shared clock); a completed round hot-swaps the served params and
    appends a swap record — ``on_swap(system, record)`` can attach drift
    metrics (the bench evaluates NLL / teacher-shard accuracy there).

    ``serve_params`` maps the trainer's core state to the engine's served
    params (identity for :func:`repro_torch.live.lm.lm_adapter`, whose state *is*
    the Transformer params).  ``ticks_per_time`` converts async plan event
    time to ticks; ``None`` makes every round immediately runnable (the
    synchronous scheduler's plans carry no event time).
    """

    def __init__(self, trainer, engine, *, quantum=4, ticks_per_time=None,
                 serve_params=None, on_swap=None):
        self.trainer, self.engine = trainer, engine
        self.quantum = quantum
        self.ticks_per_time = ticks_per_time
        self.serve_params = serve_params or (lambda state: state)
        self.on_swap = on_swap
        #: One dict per committed swap: tick, round, swap ordinal (+ what
        #: ``on_swap`` adds).
        self.swap_records = []

    # -- scheduling ----------------------------------------------------------

    def _round_runnable(self, tick) -> bool:
        """A mid-round trainer keeps running; a new round starts only once
        the shared clock reaches its plan's event time."""
        if self.trainer.mid_round:
            return True
        plan = self.trainer.next_plan()
        if plan is None:
            return False
        t = getattr(plan, "time", None)
        if t is None or self.ticks_per_time is None:
            return True
        return t * self.ticks_per_time <= tick

    def _train_quantum(self):
        """Up to ``quantum`` distill microbatches; hot-swap on completion."""
        trainer = self.trainer
        before_rounds, before_state = trainer.rounds_done, trainer.state
        trainer.step(self.quantum)
        if trainer.rounds_done > before_rounds:
            rec = {"round": trainer.last_record.round,
                   "tick": self.engine.ticks}
            if trainer.state is not before_state:
                self.engine.hot_swap(self.serve_params(trainer.state))
                rec["swap"] = self.engine.swaps
            else:
                rec["swap"] = None   # withdraw round: nothing to publish
            if self.on_swap is not None:
                self.on_swap(self, rec)
            self.swap_records.append(rec)

    # -- the loop ------------------------------------------------------------

    def run(self, requests, log=None, resume=False):
        """Serve ``requests`` while driving the trainer's plan stream to
        completion; returns the finished requests.  The engine's queue may
        drain before the plan stream does (and vice versa) — idle decode
        ticks keep the shared clock advancing toward future plans.
        ``resume=True`` continues a session reopened by :meth:`restore`
        instead of beginning a fresh one."""
        eng, trainer = self.engine, self.trainer
        if not resume:
            eng.begin(requests, log=log)
        while eng.pending() or trainer.pending():
            if eng.pending():
                eng.tick()
            if trainer.pending():
                if self._round_runnable(eng.ticks):
                    self._train_quantum()
                elif not eng.pending():
                    eng.tick()   # idle tick: advance the clock to the plan
        return eng._finished

    # -- fused checkpoint ----------------------------------------------------

    def save(self, path, extra_meta=None):
        """Checkpoint the fused live state (trainer carry + engine slots/
        swap epoch + stream cursor) — call between loop iterations."""
        from repro_torch.checkpoint import io
        meta = dict(extra_meta or {})
        meta["swap_records"] = [dict(r) for r in self.swap_records]
        return io.save_live_state(path, trainer=self.trainer,
                                  engine=self.engine, extra_meta=meta)

    def restore(self, path, requests):
        """Restore a :meth:`save` checkpoint in place (fresh trainer/engine
        built from the same configs/seeds; ``requests`` is the same arrival
        stream the saved session was begun with) and return its meta."""
        from repro_torch.checkpoint import io
        meta = io.load_live_state(path, trainer=self.trainer,
                                  engine=self.engine, requests=requests)
        self.swap_records = [dict(r) for r in meta.get("swap_records", [])]
        # The served params are defined by the trainer's restored state
        # (state only changes at round completions, each of which swapped).
        self.engine.params = self.serve_params(self.trainer.state)
        return meta
