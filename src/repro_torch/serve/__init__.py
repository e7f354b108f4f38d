"""Serving subsystem of the port.

``engine``   ServeEngine over dense (full or ring) KV caches, the default,
             or the block-paged KV pool (``paged=True``): device-resident
             slot state, one host sync per tick, bucketed batched prefill,
             device-side sampling, params hot-swap.
``streams``  Named arrival-process scenarios and the Request record (a copy
             of the JAX package's module).
``paged``    Page allocator with refcounted prefix sharing (a copy of the
             JAX package's module).
"""

from repro_torch.serve.engine import (ServeEngine, bucket_length,
                                      make_admit_step, make_decode_tick,
                                      make_init_state, make_paged_admit_step,
                                      make_paged_decode_tick,
                                      make_prefill_step, make_sampler,
                                      make_serve_step, simulate)
from repro_torch.serve.paged import (Admission, PageAllocator, TRASH_PAGE,
                                     pages_for)
from repro_torch.serve.streams import (STREAMS, Request, build_stream,
                                       with_shared_prefix)

__all__ = [
    "ServeEngine", "Request", "STREAMS", "build_stream", "bucket_length",
    "make_admit_step", "make_decode_tick", "make_init_state",
    "make_paged_admit_step", "make_paged_decode_tick", "make_prefill_step",
    "make_sampler", "make_serve_step", "simulate",
    "with_shared_prefix", "Admission", "PageAllocator", "TRASH_PAGE",
    "pages_for",
]
