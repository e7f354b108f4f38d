"""The four assigned input shapes (a copy of ``repro.configs.shapes``).

Decode shapes lower `serve_step` (one token against a seq_len cache);
train/prefill lower the Phase-2 / prefill paths.  long_500k additionally
switches full-attention architectures to their sliding-window variant
(see registry.for_shape) — SSM/hybrid run it natively.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
