"""Runtime compile guard: ``trace_guard`` asserts compile bounds (the
port's counterpart of ``repro.analysis.sanitize``, same names and
signature).

The port runs eagerly, so what the JAX package's guard counts as jit
traces has two counterparts here.

* **per-function** — ``with trace_guard(fn, g, max_compiles=N):``.  A
  "compile" is a new call signature of a wrapped callable: the shapes,
  dtypes, devices (and DTensor placements) of its tensor arguments and
  its other arguments, the key a jit cache would have.  ``guard.wrap(fn)``
  (or :class:`SignatureCounter`) makes such a callable; it keeps its
  signatures for its life, so a guard counts the new ones seen inside it.
  An object that keeps its own count (``ServeEngine.prefill_compile_count``,
  the admission shapes the JAX engine would trace) is read instead.
* **global** — ``with trace_guard(max_compiles=0):`` with no functions.
  Counts, for the whole process, every ``nvcc`` build of a kernel
  (``repro_torch.kernels.build.build``), every frame ``torch.compile``
  compiles (``torch._dynamo``'s counters, read only when dynamo is already
  imported) and every CUDA graph capture: "this warm path builds and
  compiles nothing".

Violations raise ``RetraceError`` (an ``AssertionError`` subclass, so
pytest renders it as a failure).
"""

from __future__ import annotations

import sys
import threading

import torch

from repro_torch.kernels import build as _build

__all__ = ["RetraceError", "SignatureCounter", "trace_guard",
           "compiled_cache_size", "global_compile_events"]


class RetraceError(AssertionError):
    """A guarded region compiled more than its contract allows."""


# ---------------------------------------------------------------------------
# Global counter: nvcc builds, dynamo frames, CUDA graph captures.  The
# capture count comes from one process-wide wrapper of
# CUDAGraph.capture_begin, installed once; guards snapshot the sum.
# ---------------------------------------------------------------------------

_captures = 0
_installed = False
_install_lock = threading.Lock()


def _ensure_capture_hook() -> None:
    global _installed
    with _install_lock:
        if _installed:
            return
        graph_cls = torch.cuda.graphs.CUDAGraph
        begin = graph_cls.capture_begin

        def capture_begin(self, *args, **kwargs):
            global _captures
            _captures += 1
            return begin(self, *args, **kwargs)

        graph_cls.capture_begin = capture_begin
        _installed = True


def _dynamo_frames() -> int:
    dynamo = sys.modules.get("torch._dynamo")
    if dynamo is None:
        return 0
    return int(dynamo.utils.counters["frames"]["ok"])


def global_compile_events() -> int:
    """Monotonic count of kernel builds, ``torch.compile`` frames and CUDA
    graph captures in this process (captures since the hook went in)."""
    _ensure_capture_hook()
    return _build.compiles + _dynamo_frames() + _captures


# ---------------------------------------------------------------------------
# Per-function counting.
# ---------------------------------------------------------------------------


def _key(x):
    """The part of a call signature one argument contributes."""
    if isinstance(x, torch.Tensor):
        placed = getattr(x, "placements", None)
        return (type(x).__name__, tuple(x.shape), x.dtype, x.device.type,
                tuple(placed) if placed is not None else None)
    if isinstance(x, dict):
        return ("dict",) + tuple((k, _key(v)) for k, v in sorted(
            x.items(), key=lambda kv: str(kv[0])))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_key(v) for v in x)
    if isinstance(x, torch.Generator):
        return ("Generator", x.device.type)
    try:
        hash(x)
    except TypeError:
        return (type(x).__name__,)
    return x


class SignatureCounter:
    """A callable that counts the distinct call signatures of ``fn``
    (:func:`_key` of each argument) and calls it."""

    def __init__(self, fn):
        self._fn = fn
        self.signatures = set()

    @property
    def compiles(self) -> int:
        return len(self.signatures)

    def __call__(self, *args, **kwargs):
        self.signatures.add((_key(args), _key(kwargs)))
        return self._fn(*args, **kwargs)


def compiled_cache_size(fn) -> int:
    """Distinct signatures seen by a :class:`SignatureCounter`, or the
    count an object keeps itself (``ServeEngine.prefill_compile_count``)."""
    if isinstance(fn, SignatureCounter):
        return fn.compiles
    count = getattr(fn, "prefill_compile_count", None)
    if count is not None:
        return count()
    raise TypeError(
        f"{fn!r} keeps no compile count; wrap the callable with "
        f"guard.wrap(fn) (a SignatureCounter) and call the wrapper")


class trace_guard:
    """Context manager asserting a compile bound over a region.

    ``trace_guard(*counted, max_compiles=N)`` — per-function mode; with
    no functions, global zero-compile mode.  See the module docstring.
    """

    def __init__(self, *counted, max_compiles: int = 0):
        for fn in counted:
            compiled_cache_size(fn)  # raises TypeError on an uncounted one
        self._fns = list(counted)
        self.max_compiles = int(max_compiles)
        self._start = None
        self._global_start = None

    def wrap(self, fn) -> SignatureCounter:
        """A counting wrapper of ``fn``, guarded by this guard: call the
        wrapper where ``fn`` was called."""
        counter = SignatureCounter(fn)
        self._fns.append(counter)
        if self._start is not None:
            self._start.append(counter.compiles)
        return counter

    def compiles(self) -> int:
        """Compilations observed since __enter__."""
        if self._fns:
            return sum(compiled_cache_size(fn) - s
                       for fn, s in zip(self._fns, self._start))
        return global_compile_events() - self._global_start

    def __enter__(self):
        if self._fns:
            self._start = [compiled_cache_size(fn) for fn in self._fns]
        else:
            self._global_start = global_compile_events()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        seen = self.compiles()
        if seen > self.max_compiles:
            if self._fns:
                detail = ", ".join(
                    f"{getattr(getattr(f, '_fn', f), '__name__', repr(f))}:"
                    f"+{compiled_cache_size(f) - s}"
                    for f, s in zip(self._fns, self._start))
                raise RetraceError(
                    f"trace_guard: {seen} compilation(s) in guarded region, "
                    f"contract allows {self.max_compiles} ({detail}); a "
                    f"callable is being re-traced — check for new argument "
                    f"shapes/dtypes or wrappers rebuilt per call")
            raise RetraceError(
                f"trace_guard: {seen} backend compile event(s) in a region "
                f"contracted to {self.max_compiles}; a kernel build, "
                f"torch.compile frame or CUDA graph capture ran (global "
                f"mode counts every one in the process)")
        return False
