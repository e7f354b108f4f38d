"""Edge→core transport codecs — what a teacher's logits cost on the uplink.

The PyTorch counterpart of the JAX package's ``repro/transport/codecs.py``,
with the same registry, specs, wire formats and byte accounting, so that
an uplink log is equal across the two packages.  The paper frames FL as
communication between the core and its edges; the uplink is a pluggable
object here, mirroring the ``DistillMethod`` strategy idiom of
``repro_torch.core.methods``:

    CODECS / register_codec / parse_codec / codec_names

A *codec spec* is a string like ``"int8"``, ``"topk:16"``, or a ``+``
composition ``"entropy:0.5+int8"``; :func:`parse_codec` resolves it to a
:class:`ComposedCodec` of at most one **transform** (how each kept row is
encoded) and at most one **filter** (which rows are uplinked at all):

    identity      the exact float32 logits (the accounting baseline)
    topk:k        top-k values + indices + a tail logsumexp per row
                  (the LogitCache compression generalized to transport)
    int8 / int4   per-row affine quantization: codes + (scale, zero) per row
    entropy:T     client-side example filtering (Mujtaba et al.): rows whose
                  teacher softmax entropy is below T nats are near-one-hot —
                  the label already carries them — and are dropped before
                  uplink; the KD term for a dropped row is exactly zero

Every codec provides a ``roundtrip`` (encode→decode of the logits the wire
would carry, as one tensor transform inside the Phase-2 step), an
``encode``/``decode`` pair over per-example payload tensors (the cached
path the Phase-2 engine stores in the method-state "cache" group), and
exact ``payload_bytes`` accounting.

Byte-accounting conventions (as in the JAX package): float32 values and
int32 indices are 4 bytes, int8 codes 1 byte, int4 codes are packed two per
byte on the wire (the container handed to the kernels stays int8), each
quantized row carries a float32 (scale, zero) pair, and a filter adds a
kept-row bitmap of ceil(N/8) bytes.
"""

from __future__ import annotations

import torch

from repro_torch.core.buffer import TAIL_MASS_FLOOR, reconstruct_logits
from repro_torch.tree import tree_map

#: head name -> Codec subclass.  Populated by :func:`register_codec`.
CODECS: dict = {}


def register_codec(cls):
    """Class decorator: register ``cls`` under ``cls.head`` (same contract
    as ``methods.register_method`` — duplicates are rejected, not shadowed)."""
    head = cls.head
    if not head or not isinstance(head, str):
        raise ValueError(f"{cls.__name__} must define a non-empty string "
                         f"`head` class attribute")
    if head in CODECS:
        raise ValueError(f"codec {head!r} is already registered "
                         f"({CODECS[head].__name__}); duplicate names are "
                         f"rejected — pick a new one")
    CODECS[head] = cls
    return cls


def codec_names() -> tuple:
    """Sorted registered codec heads (the CLI ``--transport`` vocabulary)."""
    return tuple(sorted(CODECS))


def parse_codec(spec) -> "ComposedCodec":
    """Parse a codec spec: ``head[:args]`` parts joined by ``+`` (at most
    one transform and one filter; a filter-only spec gets the identity
    transform).  An already-built :class:`ComposedCodec` passes through."""
    if isinstance(spec, ComposedCodec):
        return spec
    parts = [p.strip() for p in str(spec).split("+") if p.strip()]
    if not parts:
        raise ValueError(f"empty codec spec {spec!r}")
    transforms, filters = [], []
    for part in parts:
        head, _, args = part.partition(":")
        try:
            cls = CODECS[head]
        except KeyError:
            raise ValueError(f"unknown codec {head!r} in spec {spec!r}; "
                             f"registered codecs: {codec_names()}") from None
        codec = cls.from_args(args)
        (filters if codec.kind == "filter" else transforms).append(codec)
    if len(transforms) > 1:
        raise ValueError(f"codec spec {spec!r} names {len(transforms)} "
                         f"transforms; compose at most one with one filter")
    if len(filters) > 1:
        raise ValueError(f"codec spec {spec!r} names {len(filters)} filters; "
                         f"compose at most one with one transform")
    transform = transforms[0] if transforms else Identity()
    return ComposedCodec(transform, filters[0] if filters else None)


# ---------------------------------------------------------------------------
# The codec protocol.
# ---------------------------------------------------------------------------


class Codec:
    """One transport stage.  ``kind`` is "transform" (re-encodes each kept
    row) or "filter" (decides which rows are uplinked)."""

    #: Registry key and spec head.
    head: str = ""
    #: One-line description (``--help``).
    description: str = ""
    kind: str = "transform"
    #: The codec loses information (identity is the one exception).
    lossy: bool = True
    #: The Phase-2 engine may encode once per round and carry the encoded
    #: payload through the epoch (the dequant-fused kernel path).
    cacheable: bool = False

    @classmethod
    def from_args(cls, args: str) -> "Codec":
        """Build from the spec's ``:args`` suffix (empty for defaults)."""
        if args:
            raise ValueError(f"codec {cls.head!r} takes no arguments, "
                             f"got {args!r}")
        return cls()

    @property
    def spec(self) -> str:
        return self.head

    # -- transform API ------------------------------------------------------

    def encode(self, logits):
        """(..., V) logits -> payload dict of tensors with matching leading
        dims (what the wire carries)."""
        raise NotImplementedError

    def decode(self, payload, vocab=None):
        """Payload dict -> reconstructed (..., V) logits."""
        raise NotImplementedError

    def roundtrip(self, logits):
        """encode→decode as one tensor transform."""
        return self.decode(self.encode(logits), vocab=logits.shape[-1])

    def row_bytes(self, vocab: int) -> int:
        """Wire bytes per uplinked example row."""
        raise NotImplementedError

    # -- filter API ---------------------------------------------------------

    def kept_mask(self, logits):
        """(..., V) teacher logits -> boolean (...,) keep mask."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Transforms.
# ---------------------------------------------------------------------------


@register_codec
class Identity(Codec):
    head = "identity"
    description = ("exact float32 logits — the uncompressed baseline; "
                   "bit-for-bit identical training to no transport at all")
    lossy = False

    def encode(self, logits):
        return {"logits": logits}

    def decode(self, payload, vocab=None):
        return payload["logits"]

    def roundtrip(self, logits):
        return logits

    def row_bytes(self, vocab):
        return 4 * vocab


@register_codec
class TopK(Codec):
    head = "topk"
    description = ("top-k logit values + int32 indices + a tail logsumexp "
                   "per row; the decoded softmax matches the original on "
                   "the top-k support, the tail mass is spread uniformly")

    def __init__(self, k: int = 8):
        if k < 1:
            raise ValueError(f"topk k must be >= 1, got {k}")
        self.k = k

    @classmethod
    def from_args(cls, args):
        return cls(int(args)) if args else cls()

    @property
    def spec(self):
        return f"topk:{self.k}"

    def _k(self, vocab):
        # k = V would make the tail logsumexp log(0); keep one tail entry
        # (same clamp as buffer.precompute_logits).
        return min(self.k, vocab - 1)

    def encode(self, logits):
        k = self._k(logits.shape[-1])
        tv, ti = torch.topk(logits, k, dim=-1)
        full_lse = torch.logsumexp(logits, dim=-1)
        top_lse = torch.logsumexp(tv, dim=-1)
        diff = torch.exp(torch.clamp(top_lse - full_lse, max=0.0))
        tail = full_lse + torch.log(torch.clamp(1.0 - diff,
                                                min=TAIL_MASS_FLOOR))
        return {"top_vals": tv, "top_idx": ti.to(torch.int32),
                "tail_lse": tail}

    def decode(self, payload, vocab=None):
        tv, ti = payload["top_vals"], payload["top_idx"]
        tail = payload["tail_lse"]
        if vocab is None:
            raise ValueError("topk decode needs the vocab size")
        lead = tuple(tv.shape[:-1])
        k = tv.shape[-1]
        out = reconstruct_logits((tv.reshape(-1, k), ti.reshape(-1, k),
                                  tail.reshape(-1)), vocab)
        return out.reshape(lead + (vocab,))

    def row_bytes(self, vocab):
        k = self._k(vocab)
        return k * 4 + k * 4 + 4     # f32 values + i32 indices + f32 tail


def pack_nibbles(codes):
    """(..., V) int8 codes on [-8, 7] -> (..., ceil(V/2)) uint8, two codes
    per byte: +8 bias to [0, 15], even index in the low nibble, odd in the
    high (an odd V pads one zero nibble).  The in-memory container is
    exactly the accounted wire bytes."""
    u = (codes.to(torch.int32) + 8).to(torch.uint8)
    if u.shape[-1] % 2:
        u = torch.cat([u, u.new_zeros(u.shape[:-1] + (1,))], dim=-1)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_nibbles(packed, vocab):
    """Inverse of :func:`pack_nibbles` -> (..., vocab) int8 on [-8, 7]
    (the container the fused dequant kernel takes).  Bit operations on the
    payload's device: uint8 in, int8 out."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    inter = torch.stack([lo, hi], dim=-1).reshape(
        tuple(packed.shape[:-1]) + (-1,))
    return inter[..., :vocab] - 8


class _AffineQuant(Codec):
    """Per-row affine quantization shared by int8/int4: each row carries
    integer codes on a symmetric grid plus a float32 (scale, zero) pair
    reconstructing ``code * scale + zero``."""

    bits: int = 8
    cacheable = True

    @property
    def qmin(self):
        return -(2 ** (self.bits - 1))

    @property
    def qmax(self):
        return 2 ** (self.bits - 1) - 1

    def encode(self, logits):
        mn = torch.amin(logits, dim=-1)
        mx = torch.amax(logits, dim=-1)
        zero = (mx + mn) / 2.0
        scale = torch.clamp((mx - mn) / float(self.qmax - self.qmin),
                            min=1e-8)
        # torch.round and jnp.round both round half to even.
        q = torch.round((logits - zero[..., None]) / scale[..., None])
        q = torch.clamp(q, self.qmin, self.qmax).to(torch.int8)
        return {"codes": q, "scale": scale.float(), "zero": zero.float()}

    def unpack_codes(self, codes, vocab):
        """Payload codes -> the (..., vocab) int8 container the fused
        kernel consumes (identity for int8; int4 unpacks its nibbles)."""
        return codes

    def decode(self, payload, vocab=None):
        codes = payload["codes"]
        if vocab is not None:
            codes = self.unpack_codes(codes, vocab)
        return (codes.float() * payload["scale"][..., None]
                + payload["zero"][..., None])


@register_codec
class Int8(_AffineQuant):
    head = "int8"
    bits = 8
    description = ("per-row affine 8-bit quantization (codes + f32 "
                   "scale/zero per row); on the kernel backend the fused "
                   "KD kernels dequantize in registers")

    def row_bytes(self, vocab):
        return vocab + 8             # 1 byte/code + f32 (scale, zero)


@register_codec
class Int4(_AffineQuant):
    head = "int4"
    bits = 4
    description = ("per-row affine 4-bit quantization on a [-8, 7] grid, "
                   "nibble-packed two codes per uint8 byte in memory — the "
                   "container IS the accounted wire bytes; unpacked to int8 "
                   "only per batch for the kernels")

    def encode(self, logits):
        p = super().encode(logits)
        return dict(p, codes=pack_nibbles(p["codes"]))

    def unpack_codes(self, codes, vocab):
        return unpack_nibbles(codes, vocab)

    def decode(self, payload, vocab=None):
        if vocab is None:
            raise ValueError("int4 decode needs the vocab size to unpack "
                             "its nibble-packed codes")
        return super().decode(payload, vocab=vocab)

    def row_bytes(self, vocab):
        return (vocab + 1) // 2 + 8  # packed nibbles + f32 (scale, zero)


# ---------------------------------------------------------------------------
# Filters.
# ---------------------------------------------------------------------------


@register_codec
class EntropyFilter(Codec):
    head = "entropy"
    kind = "filter"
    description = ("client-side example filtering (Mujtaba et al. 2025): "
                   "rows whose teacher softmax entropy is below T nats are "
                   "dropped before uplink — near-one-hot teachers carry no "
                   "dark knowledge the label doesn't; their KD term is "
                   "exactly zero")

    def __init__(self, min_nats: float = 0.5):
        if min_nats < 0:
            raise ValueError(f"entropy threshold must be >= 0, "
                             f"got {min_nats}")
        self.min_nats = min_nats

    @classmethod
    def from_args(cls, args):
        return cls(float(args)) if args else cls()

    @property
    def spec(self):
        return f"entropy:{self.min_nats:g}"

    def kept_mask(self, logits):
        lp = torch.log_softmax(logits, dim=-1)
        h = -torch.sum(torch.exp(lp) * lp, dim=-1)
        return h >= self.min_nats


# ---------------------------------------------------------------------------
# Composition: at most one transform + one filter.
# ---------------------------------------------------------------------------


class ComposedCodec:
    """The resolved form of a codec spec: one transform and an optional
    filter.  The filter is applied to the *decoded* stream — a dropped
    row's teacher is replaced by the (detached) student itself, which makes
    its KL term exactly zero in value (and zero in gradient up to the
    float32 roundoff of the softmax normalization) without any per-method
    masking."""

    def __init__(self, transform: Codec, filter: Codec = None):
        self.transform = transform
        self.filter = filter

    @property
    def spec(self) -> str:
        if self.filter is None:
            return self.transform.spec
        return f"{self.filter.spec}+{self.transform.spec}"

    @property
    def lossy(self) -> bool:
        return self.transform.lossy or self.filter is not None

    @property
    def cacheable(self) -> bool:
        """Encode-once-per-round (the honest uplink semantics + the
        dequant-fused kernel) — only for pure quantizing transforms; a
        filter needs the live student logits at decode time."""
        return self.filter is None and self.transform.cacheable

    @property
    def needs_logits(self) -> bool:
        """Exact byte accounting needs the actual teacher logits (to count
        kept rows)."""
        return self.filter is not None

    def __repr__(self):
        return f"ComposedCodec({self.spec!r})"

    # -- streamed path ------------------------------------------------------

    def roundtrip(self, logits, student=None):
        """What the core decodes, as a tensor transform of the teacher
        logits (usable inside the Phase-2 step).  ``student`` (same trailing
        (B, V) shape) is required when a filter is composed."""
        dec = self.transform.roundtrip(logits)
        if self.filter is not None:
            if student is None:
                raise ValueError(
                    f"codec {self.spec!r} filters rows and needs the "
                    f"student logits to zero their KD term")
            kept = self.filter.kept_mask(logits)
            sub = student.detach().broadcast_to(logits.shape)
            dec = torch.where(kept[..., None], dec, sub)
        return dec

    # -- cached path --------------------------------------------------------

    def encode(self, logits):
        return self.transform.encode(logits)

    def decode(self, payload, vocab=None):
        return self.transform.decode(payload, vocab=vocab)

    def decode_stacked(self, payload, vocab=None):
        """Decode an engine-gathered payload whose leaves are (B, R, ...)
        (teachers stacked on axis 1) into (R, B, V) logits.  Every decode
        broadcasts over leading axes, so moving the teacher axis to the
        front is all the JAX package's vmap does here."""
        moved = tree_map(lambda a: a.movedim(1, 0), payload)
        return self.decode(moved, vocab=vocab)

    # -- accounting ---------------------------------------------------------

    def payload_bytes(self, n: int, vocab: int, logits=None) -> int:
        """Wire bytes for one teacher's uplink over an ``n``-example core
        set.  Filter codecs count the actually-kept rows from ``logits``
        (pass them) plus a ceil(n/8) kept-row bitmap; without logits the
        all-kept upper bound is returned."""
        rb = self.transform.row_bytes(vocab)
        if self.filter is None:
            return int(n) * int(rb)
        kept = (int(torch.sum(self.filter.kept_mask(logits)))
                if logits is not None else int(n))
        return kept * int(rb) + (int(n) + 7) // 8
