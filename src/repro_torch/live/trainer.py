"""LiveTrainer — the FL round loop as a resumable step iterator.

``FederatedKD.run``'s flat round loop, cut so that an outer loop can drive
Phase-2 microbatches itself:

    trainer = LiveTrainer(fl, key)
    while trainer.pending():
        trainer.step(max_steps=4)     # <= 4 KD microbatches

Each round runs as (Phase-1 edge training at ``start_round``) -> (a
``RoundStepper`` advanced ``max_steps`` microbatches per :meth:`step`
call) -> (round completion: metrics recording, state update).  The PyTorch
counterpart of the JAX package's ``repro/live/trainer.py``.

The trainer also owns the fused-checkpoint carry for its half of the live
system (round cursor, core-state history ring, mid-round stepper arrays);
see :func:`repro_torch.checkpoint.io.save_live_state`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.scheduler import max_retained_staleness


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
        self._prev_edges = None     # edge ids behind prev_edge_ds (checkpoint)
        self.cursor = 0             # next plan index
        self.rounds_done = 0
        self.last_record = None     # RoundMetrics of the last completed round
        self._plan = None           # in-flight round's plan
        self._stepper = None        # its RoundStepper (None for withdraw)
        self._pre_preds = None

    @property
    def mid_round(self):
        return self._plan is not None

    def next_plan(self):
        """The next not-yet-started plan (None when the stream is drained);
        the co-scheduler gates ``start_round`` on its ``time``."""
        if self.cursor < len(self.plans):
            return self.plans[self.cursor]
        return None

    def pending(self) -> bool:
        return self.mid_round or self.cursor < len(self.plans)

    def start_round(self, _replay=False):
        """Run the next plan's Phase 1 (edge training, seed
        ``cfg.seed + 31 * round``) and arm its Phase-2 stepper.
        ``_replay=True`` is the checkpoint-restore path: the core-state
        ring was already advanced when the round first started, so the
        append is skipped (inits and teacher training recompute from the
        restored state)."""
        fl, cfg = self.fl, self.cfg
        plan = self.plans[self.cursor]
        r = plan.round_idx
        if not _replay:
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
        self._prev_edges = list(edge_ids)
        self.last_record = rec
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

    # -- fused-checkpoint carry (repro_torch.checkpoint.io.save_live_state)

    def carry(self):
        """(arrays tree, JSON meta) capturing the trainer between steps:
        core state + w0 + history ring + previous-round predictions, the
        round cursor, recorded metrics/uplink logs, and, when mid-round,
        the stepper's full carry (student/opt/method state, stacked
        teachers, schedule position).  Keys and meta are the JAX
        package's, so either package restores the other's checkpoint."""
        fl = self.fl
        base = {"state": self.state, "w0": fl.w0,
                "core_log": list(self.core_log)}
        if self.prev_preds is not None:
            base["prev_preds"] = np.asarray(self.prev_preds)
        tree = {"trainer": base}
        meta = {"cursor": self.cursor, "rounds_done": self.rounds_done,
                "core_log_len": len(self.core_log),
                "prev_edges": self._prev_edges,
                "history": [rec.as_dict() for rec in fl.history],
                "uplink_log": list(fl.distill_engine.uplink_log),
                "round_started": self.mid_round}
        if self.mid_round and self._stepper is not None:
            st = self._stepper
            if st._full is not None:
                # A one-shot full-round stepper holds no arrays: restore
                # replays start_round from the restored state instead.
                meta["stepper"] = None
            else:
                tree["stepper"] = {"state": st.state, "opt": st.opt_state,
                                   "mstate": st.mstate, "tstack": st.tstack}
                meta["stepper"] = {"i": st.i, "epoch": st.epoch,
                                   "pos": st.pos,
                                   "mid_epoch": st._idx is not None}
        return tree, meta

    def restore(self, path, meta):
        """Inverse of :meth:`carry` (in place, from the fused checkpoint at
        ``path``): the trainer must be freshly constructed from the same
        config/seeds.  Values all come from the checkpoint; a mid-round
        stepper is rebuilt structurally by replaying ``start_round`` from
        the restored state (the same Phase 1), then its advanced arrays
        are overwritten."""
        from repro_torch.checkpoint import io
        from repro_torch.core.fl import RoundMetrics
        from repro_torch.data.pipeline import batches
        fl = self.fl
        like = {"trainer": {"state": self.state, "w0": fl.w0,
                            "core_log": [self.state] * meta["core_log_len"]}}
        if meta["prev_edges"] is not None:
            self.prev_edge_ds = fl._round_union(meta["prev_edges"])
            self._prev_edges = list(meta["prev_edges"])
            like["trainer"]["prev_preds"] = np.zeros(len(self.prev_edge_ds),
                                                     np.int64)
        tree = io.load_tree(path, like)["trainer"]
        self.state, fl.w0 = tree["state"], tree["w0"]
        self.core_log = list(tree["core_log"])
        if meta["prev_edges"] is not None:
            self.prev_preds = np.asarray(tree["prev_preds"])
        self.cursor = meta["cursor"]
        self.rounds_done = meta["rounds_done"]
        fl.history[:] = [RoundMetrics(**d) for d in meta["history"]]
        if meta["round_started"]:
            self.start_round(_replay=True)
            if meta.get("stepper") is not None and self._stepper is not None:
                st, sm = self._stepper, meta["stepper"]
                st_like = {"stepper": {"state": st.state, "opt": st.opt_state,
                                       "mstate": st.mstate,
                                       "tstack": st.tstack}}
                loaded = io.load_tree(path, st_like)["stepper"]
                st.state, st.opt_state = loaded["state"], loaded["opt"]
                st.mstate, st.tstack = loaded["mstate"], loaded["tstack"]
                st.i, st.epoch, st.pos = sm["i"], sm["epoch"], sm["pos"]
                if sm["mid_epoch"]:
                    # Rebuild the in-flight epoch's deterministic schedule
                    # (and its device copy, which the scan path indexes).
                    seed = self.cfg.seed + 997 * st.round_idx + st.epoch
                    st._idx = np.stack(list(batches(
                        fl.core_ds, self.cfg.batch_size, seed=seed, epochs=1,
                        indices_only=True)))
                    st._idx_dev = (torch.as_tensor(
                        st._idx, device=st.engine.device)
                        if self.cfg.scan else None)
        # The replayed start_round re-accounted its uplink bytes; the saved
        # log is the truth.
        fl.distill_engine.uplink_log[:] = list(meta["uplink_log"])
