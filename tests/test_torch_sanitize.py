"""The port's compile guard (``repro_torch.analysis.sanitize.trace_guard``):
the JAX package's ``tests/test_sanitize.py`` cases on the port's counters,
and the reference's compile contracts held on the port.

Per-function mode counts new call signatures of a ``SignatureCounter``
(the key a jit cache would have); global mode counts the process's kernel
builds, ``torch.compile`` frames (``backend="eager"``: no C++ compiler
needed) and CUDA graph captures.  The contracts: a warm serving engine's
admission and tick take no new signature, dense and paged (the JAX
package's ``tests/test_serve_engine.py`` bucket bound and warm run), and
planning a 1000-edge fleet timeline compiles nothing
(``tests/test_fleet.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.sanitize import (RetraceError,  # noqa: E402
                                           SignatureCounter,
                                           compiled_cache_size,
                                           global_compile_events,
                                           trace_guard)
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.fleet import FleetSimulator  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve.engine import bucket_length  # noqa: E402


def test_guard_passes_within_bound():
    f = SignatureCounter(lambda x: x * 2 + 1)
    with trace_guard(f, max_compiles=1) as guard:
        for _ in range(5):
            f(torch.arange(4.0))
    assert guard.compiles() == 1


def test_guard_zero_bound_on_warm_function():
    f = SignatureCounter(lambda x: x - 3)
    f(torch.arange(4.0))  # warm
    with trace_guard(f, max_compiles=0) as guard:
        for _ in range(3):
            f(torch.arange(4.0))
    assert guard.compiles() == 0


def test_seeded_retrace_regression_is_caught():
    # The deliberate regression: a fresh argument shape every iteration.
    f = SignatureCounter(lambda x: x * 2)
    with pytest.raises(RetraceError, match="re-traced"):
        with trace_guard(f, max_compiles=1):
            for i in range(3):
                f(torch.zeros((i + 1,)))


def test_retrace_error_is_an_assertion():
    assert issubclass(RetraceError, AssertionError)


def test_guard_sums_over_multiple_functions():
    f = SignatureCounter(lambda x: x + 1)
    g = SignatureCounter(lambda x: x - 1)
    with trace_guard(f, g, max_compiles=2):
        f(torch.arange(3.0))
        g(torch.arange(3.0))
    with pytest.raises(RetraceError):
        with trace_guard(f, g, max_compiles=0):
            f(torch.arange(7.0))  # new shape on a guarded fn


@pytest.mark.parametrize("first, second", [
    ((torch.zeros(3),), (torch.zeros(3, dtype=torch.float64),)),
    ((torch.zeros(3), 1), (torch.zeros(3), 2)),
    (({"w": torch.zeros(2)},), ({"w": torch.zeros(3)},)),
], ids=["dtype", "python scalar", "nested shape"])
def test_a_signature_is_shape_dtype_and_the_other_arguments(first, second):
    f = SignatureCounter(lambda *a: a)
    f(*first)
    f(*first)
    assert f.compiles == 1
    f(*second)
    assert f.compiles == 2


def test_wrap_counts_signatures_of_an_unwrapped_fn():
    guard = trace_guard(max_compiles=2)
    f = guard.wrap(lambda x: x + 1)
    with guard:
        f(torch.zeros(3))
        f(torch.zeros(3))   # seen
        f(torch.zeros(4))   # a second signature
    assert guard.compiles() == 2

    guard2 = trace_guard(max_compiles=1)
    g = guard2.wrap(lambda x: x * 2)
    with pytest.raises(RetraceError):
        with guard2:
            g(torch.zeros(3))
            g(torch.zeros(4))


def test_uncounted_callable_is_rejected():
    with pytest.raises(TypeError, match="wrap"):
        trace_guard(lambda x: x)
    with pytest.raises(TypeError):
        compiled_cache_size(print)


def test_global_mode_zero_compile_on_warm_path():
    f = torch.compile(lambda x: torch.sum(x * x), backend="eager")
    x = torch.arange(8.0)
    f(x)  # warm everything this region will touch
    before = global_compile_events()
    with trace_guard(max_compiles=0):
        for _ in range(4):
            f(x)
    assert global_compile_events() == before


def test_global_mode_catches_any_compile():
    f = torch.compile(lambda x: x * 5 + 2, backend="eager")
    with pytest.raises(RetraceError, match="backend compile"):
        with trace_guard(max_compiles=0):
            f(torch.arange(6.0))


def test_global_mode_counts_kernel_builds(tmp_path, monkeypatch):
    """Every nvcc run of ``build.build`` counts; a library already built
    does not (a stand-in compiler writes the output file)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RetraceError, match="kernel build"):
        with trace_guard(max_compiles=0):
            build.build("rglru")
    with trace_guard(max_compiles=0):
        build.build("rglru")            # built: no nvcc run


def test_exception_in_region_propagates_without_masking():
    f = SignatureCounter(lambda x: x)
    with pytest.raises(KeyError):
        with trace_guard(f, max_compiles=0):
            raise KeyError("inner")


@pytest.mark.gpu
def test_global_mode_counts_cuda_graph_captures():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the GPU machine)")
    x = torch.ones(4, device="cuda")
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RetraceError, match="capture"):
        with trace_guard(max_compiles=0):
            with torch.cuda.graph(g):
                x.mul_(2)


# -- the reference's compile contracts on the port -----------------------------


def _prompt(rng, cfg, n):
    return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_warm_engine_admit_and_tick_compile_nothing(paged):
    """At most log2(max_prompt) + 1 admission signatures (one a length
    bucket), exactly the buckets the lengths map to; a warm second run of
    the same bucket mix takes no new admission or tick signature."""
    cfg = registry.get_smoke_config("granite-3-2b")
    params = Transformer.init(cfg, 0, device="cpu")
    rng = np.random.default_rng(17)
    lengths = [3, 5, 9, 12, 17, 33, 47, 60]
    bound = int(np.log2(max(lengths))) + 1

    def mk_reqs():
        return [Request(rid=i, arrival=3 * i, prompt=_prompt(rng, cfg, n),
                        max_new=2)
                for i, n in enumerate(lengths)]

    kw = dict(paged=True, page_size=16) if paged else {}
    engine = ServeEngine(cfg, params, slots=2, max_len=80, device="cpu", **kw)
    engine._admit_fn = admit = SignatureCounter(engine._admit_fn)
    engine._tick_fn = tick = SignatureCounter(engine._tick_fn)
    with trace_guard(admit, max_compiles=bound):
        engine.run(mk_reqs(), log=None)
    got = engine.prefill_compile_count()
    assert got <= bound, (got, bound)
    assert got == admit.compiles == len({bucket_length(n) for n in lengths})
    engine.reset()
    with trace_guard(admit, tick, engine, max_compiles=0), \
            trace_guard(max_compiles=0):
        engine.run(mk_reqs(), log=None)


def test_fleet_simulation_is_compile_free():
    """The vectorized fleet simulator is numpy: planning a 1000-edge
    timeline builds, compiles and captures nothing."""
    sim = FleetSimulator(1000, profiles="heavy_tail", trigger="window:8",
                         seed=3)
    sim.plans(12)  # warm any lazy imports outside the guarded region
    with trace_guard(max_compiles=0):
        FleetSimulator(1000, profiles="heavy_tail", trigger="window:8",
                       seed=3).plans(12)
