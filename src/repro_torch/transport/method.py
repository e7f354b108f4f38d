"""TransportMethod — compose a codec around any registered DistillMethod.

The PyTorch counterpart of the JAX package's ``repro/transport/method.py``.
The wrapper is itself a :class:`~repro_torch.core.methods.DistillMethod`
(the engine's ``resolve_method`` passes instances through), so the whole
Phase-2 lifecycle — carry, cache gather, aux grads, finalize — runs
unchanged; only what the student *sees* of its teachers goes through the
codec.

Two execution paths, chosen by the codec:

**Streamed** (identity, topk, any filtered spec): the engine computes the
round's teacher logits per batch as usual and the codec's ``roundtrip``
re-encodes them in the step.  Identity's roundtrip returns its input
object untouched, so ``transport="identity"`` runs the very same
operations as no transport at all — the bit-for-bit baseline the bench and
the tests pin.

**Cached** (int8 / int4): each teacher's logits over the core set are
encoded ONCE per round (that is what the wire would carry) and the encoded
payload rides the engine's "cache" state group, so every step gathers its
batch's quantized codes.  The engine then computes no teacher logits in
the step.  On the kernel backend ("pallas") with one teacher the codes
feed :func:`repro_torch.kernels.ops.kd_loss_quant`, whose CUDA kernels
dequantize in registers — no f32 teacher tensor is made.  Off that path
the batch's rows are dequantized in PyTorch (only (R, B, V) at a time) and
handed to the inner method.
"""

from __future__ import annotations

import torch

from repro_torch.core.buffer import core_logits
from repro_torch.core.methods import DistillMethod
from repro_torch.transport.codecs import parse_codec
from repro_torch.tree import tree_leaves, tree_map

#: Key marking an engine "cache" tree as transport-wrapped.  The engine
#: gathers cache leaves by batch index on axis 0 generically, so the encoded
#: payload (leaves shaped (N, R, ...)) and the inner method's own cache ride
#: the same gather.
PAYLOAD_KEY = "__transport__"

#: Inner methods whose buffer term the dequant-fused kernel can take whole
#: (R=1, kernel backend): name -> how the buffer logits are produced.
_FUSED_BUFFER = {"kd": "none", "ema": "none",
                 "bkd": "frozen", "melting": "frozen",
                 "bkd_cached": "cache"}


def _has_payload(cache):
    return isinstance(cache, dict) and PAYLOAD_KEY in cache


class TransportMethod(DistillMethod):
    """``inner`` method observed through ``codec`` on the uplink."""

    def __init__(self, inner: DistillMethod, codec):
        codec = parse_codec(codec)
        self.inner = inner
        self.codec = codec
        self.name = f"{inner.name}@{codec.spec}"
        self.description = (f"{inner.name} with {codec.spec} uplink "
                            f"transport")
        self.supported_backends = inner.supported_backends
        self.learns_aux = inner.learns_aux
        self.full_round = inner.full_round

    # -- state plumbing -----------------------------------------------------

    def _split(self, mstate):
        """(inner-view mstate, payload-or-None)."""
        cache = mstate.get("cache")
        if _has_payload(cache):
            return dict(mstate, cache=cache["inner"]), cache[PAYLOAD_KEY]
        return mstate, None

    def _join(self, inner_mstate, payload):
        if payload is None:
            return inner_mstate
        return dict(inner_mstate,
                    cache={PAYLOAD_KEY: payload,
                           "inner": inner_mstate["cache"]})

    # -- round lifecycle ----------------------------------------------------

    def init_round(self, ctx, state, teachers):
        state, mstate = self.inner.init_round(ctx, state, teachers)
        if not self.codec.cacheable:
            return state, mstate
        # Encode once per round per teacher: the actual wire payload.
        payloads = [self.codec.encode(core_logits(ctx.adapter, t,
                                                  ctx.core_ds))
                    for t in teachers]
        # Teachers stack on axis 1 — axis 0 must stay the per-example axis
        # the engine gathers batch indices from.
        payload = tree_map(lambda *ls: torch.stack(ls, dim=1), *payloads)
        return state, self._join(mstate, payload)

    def on_epoch_start(self, ctx, state, mstate):
        inner_m, payload = self._split(mstate)
        return self._join(self.inner.on_epoch_start(ctx, state, inner_m),
                          payload)

    def finalize(self, ctx, state, mstate):
        inner_m, _ = self._split(mstate)
        return self.inner.finalize(ctx, state, inner_m)

    def distill_round(self, ctx, state, teachers):
        return self.inner.distill_round(ctx, state, teachers)

    # -- step hooks: pure delegation ----------------------------------------

    def wants_teacher_logits(self, cache):
        # The cached path reads its teachers from the payload.
        return not _has_payload(cache)

    def learned(self, step_state):
        return self.inner.learned(step_state)

    def wants_aux(self, adapter):
        return self.inner.wants_aux(adapter)

    def apply_aux_grads(self, ctx, grads, aux_grads, step_state):
        return self.inner.apply_aux_grads(ctx, grads, aux_grads, step_state)

    def post_step(self, ctx, step_state, new_params):
        return self.inner.post_step(ctx, step_state, new_params)

    # -- the loss -----------------------------------------------------------

    def _fused_buffer(self, ctx, x, frozen, inner_cache):
        kind = _FUSED_BUFFER[self.inner.name]
        if kind == "frozen":
            with torch.no_grad():
                return ctx.adapter.logits(frozen, x, False)[0]
        if kind == "cache":
            return inner_cache
        return None

    def loss(self, ctx, lg, tls, y, *, x, student_state, frozen, cache,
             learned, tstack):
        if _has_payload(cache):
            payload, inner_cache = cache[PAYLOAD_KEY], cache["inner"]
            r = tree_leaves(payload)[0].shape[1]
            if (ctx.backend == "pallas" and r == 1
                    and self.inner.name in _FUSED_BUFFER):
                from repro_torch.kernels import ops
                p1 = tree_map(lambda a: a[:, 0], payload)
                bl = self._fused_buffer(ctx, x, frozen, inner_cache)
                # int4 payloads are nibble-packed in memory; the kernel
                # takes the (B, V) int8 container, so unpack just this
                # batch's gathered rows (int8's unpack is the identity).
                codes = self.codec.transform.unpack_codes(
                    p1["codes"], lg.shape[-1])
                return ops.kd_loss_quant(y, lg, codes, p1["scale"],
                                         p1["zero"], bl, ctx.cfg.tau)
            dec = self.codec.decode_stacked(payload, vocab=lg.shape[-1])
            return self.inner.loss(ctx, lg, dec, y, x=x,
                                   student_state=student_state,
                                   frozen=frozen, cache=inner_cache,
                                   learned=learned, tstack=tstack)
        dec = self.codec.roundtrip(tls, student=lg)
        return self.inner.loss(ctx, lg, dec, y, x=x,
                               student_state=student_state, frozen=frozen,
                               cache=cache, learned=learned, tstack=tstack)
