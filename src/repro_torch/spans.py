"""Spans: the port's phases by name, on the profiler's clock.

A span marks one layer's work where it happens::

    with spans.span("serve.admit", rows=3, prompt_tokens=4_100):
        ...

Tracing is off by default, and then a span costs one flag read: it enters
no ``record_function``, records nothing, makes no object of its own and
never synchronises (the caller still evaluates the counts it passes).  It
is on while a ``torch.profiler`` session records, and inside
:func:`recording` (per-phase numbers without the profiler).  There is no
other switch.

While it is on, each span

1. enters ``torch.profiler.record_function(name)``: under the profiler the
   phase appears by name as a ``user_annotation`` on the host row and as a
   ``gpu_user_annotation`` over the kernels it launched;
2. appends a record: name, id, the id of the span open around it on the
   same thread (``parent``, None at a thread's top level: the autograd
   thread's recompute spans on the card have none), host start and end
   (``time.perf_counter_ns``) and the ``counts`` it was given;
3. where CUDA is initialised, records a timing ``torch.cuda.Event`` pair
   on the current stream (none while the stream captures a graph).  The
   events are read only by :func:`recorded`, never in the program.

The record holds one session: a :func:`recording` block, or under the
profiler the spans from the first one opened after the record was last
read by :func:`recorded` (or after a :func:`recording` block ended).  It
keeps the first ``LIMIT`` spans of a session; later ones still annotate
the profiler's trace but are not recorded, and a warning says so once.

The kernel wrappers' ``.launches`` and the serving engine's counters
(``ticks``, ``decode_ticks``, ``prefix_stats()``) are counted always and
stay where they are; spans carry only counts taken at a span's boundary.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import warnings

import torch
from torch.autograd import profiler as _profiler

#: Spans a session keeps.
LIMIT = 1 << 16


class _Session:
    def __init__(self, closed=False):
        self.records = []
        self.closed = closed
        self.warned = False


_session = _Session(closed=True)
_recording = 0                     # depth of open recording() blocks
_ids = itertools.count(1)
_local = threading.local()
_OFF = contextlib.nullcontext()    # the span of tracing off


def span(name: str, **counts):
    """A context manager marking ``name``'s work; ``counts`` (numbers, or a
    list of request ids) are kept with the span's record."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, counts)


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "counts", "rec", "fn")

    def __init__(self, name, counts):
        self.name, self.counts = name, counts

    def __enter__(self):
        global _session
        if _session.closed:
            _session = _Session()
        stack = _stack()
        rec = {"name": self.name, "id": next(_ids),
               "parent": stack[-1]["id"] if stack else None,
               "counts": self.counts, "events": None}
        self.fn = _profiler.record_function(self.name)
        self.fn.__enter__()
        if (torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            rec["events"] = (start, torch.cuda.Event(enable_timing=True))
        records = _session.records
        if len(records) < LIMIT:
            records.append(rec)
        elif not _session.warned:
            _session.warned = True
            warnings.warn(f"spans: a session keeps its first {LIMIT} spans; "
                          "later ones are not recorded")
        stack.append(rec)
        self.rec = rec
        rec["t0_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec["t1_ns"] = time.perf_counter_ns()
        _stack().pop()
        if rec["events"] is not None:
            rec["events"][1].record()
        self.fn.__exit__(*exc)
        return False


@contextlib.contextmanager
def recording():
    """Trace inside this block without the profiler: a new session, read
    with :func:`recorded` (host and device ms of every span)."""
    global _session, _recording
    if not _recording:
        _session = _Session()
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1
        if not _recording:
            _session.closed = True


def recorded():
    """The latest session's finished spans, in the order they opened: dicts
    of ``name``, ``id``, ``parent``, ``t0_ns``, ``t1_ns``, ``host_ms``,
    ``device_ms`` (None without CUDA) and ``counts``.  Reading waits for
    each span's end event; outside :func:`recording` it closes the
    session, so the next span under the profiler starts a new one."""
    if not _recording:
        _session.closed = True
    out = []
    for rec in list(_session.records):
        if "t1_ns" not in rec:
            continue
        if "device_ms" not in rec:
            events = rec.pop("events")
            if events is None:
                rec["device_ms"] = None
            else:
                events[1].synchronize()
                rec["device_ms"] = events[0].elapsed_time(events[1])
        out.append({"name": rec["name"], "id": rec["id"],
                    "parent": rec["parent"], "t0_ns": rec["t0_ns"],
                    "t1_ns": rec["t1_ns"],
                    "host_ms": (rec["t1_ns"] - rec["t0_ns"]) * 1e-6,
                    "device_ms": rec["device_ms"],
                    "counts": dict(rec["counts"])})
    return out
