"""The PyTorch port's frozen legacy serving loop (``repro_torch.serve.legacy``)
against the JAX package's, its pinned defects, engine-vs-legacy parity,
``ServeEngine.prefill_compile_count`` against the JAX engine's jit cache,
and the port's ``serve_bench``.

The legacy loop is a baseline with known defects (shared ``ptick``,
``max_new=1`` emitting two tokens, the per-slot cache write on the leading
cache axis): the port keeps every one, so it must emit the JAX loop's
tokens even where both are wrong.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch.mesh import make_test_mesh, mesh_context  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import legacy as jlegacy  # noqa: E402
from repro_torch.benchmarks import serve_bench  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serve import Request, ServeEngine, build_stream  # noqa: E402
from repro_torch.serve import legacy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(tail_only=True, ring=False):
    """Granite SMOKE in both packages; ``tail_only`` reshapes it so that
    no layer is stacked (the only configs where the legacy cache write is
    well defined)."""
    out = []
    for reg in (jregistry, registry):
        cfg = reg.get_smoke_config("granite-3-2b")
        if tail_only:
            cfg = dataclasses.replace(cfg, block_pattern=("attn",) * 3)
        if ring:
            cfg = dataclasses.replace(cfg, sliding_window=8, ring_cache=True)
        out.append(cfg)
    return out


def _params(jcfg, seed=0):
    with mesh_context(make_test_mesh()):
        jparams, _ = JTransformer.init(jcfg, jax.random.key(seed))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")


def _reqs(vocab, spec, seed=3):
    """Requests from (arrival, prompt length, max_new) triples."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, arrival=a, prompt=rng.integers(0, vocab - 1, n),
                    max_new=m) for i, (a, n, m) in enumerate(spec)]


def _quiet(*a):
    pass


def sequential_decode(cfg, params, prompt, max_new, max_len):
    """One request alone, exact-length prefill and one position at a time:
    the ground truth every batching scheme must reproduce."""
    with torch.inference_mode():
        toks = torch.as_tensor(prompt, dtype=torch.int32)[None, :]
        lg, cache = Transformer.prefill(cfg, params, {"tokens": toks},
                                        max_len)
        out = [int(torch.argmax(lg[0, -1]))]
        pos = len(prompt)
        while len(out) < max_new and pos < max_len - 1:
            tok = torch.tensor([[out[-1]]], dtype=torch.int32)
            lgs, cache = Transformer.decode_step(cfg, params, cache, tok, pos)
            out.append(int(torch.argmax(lgs[0, -1])))
            pos += 1
    return out


# -- the legacy loop against the JAX one ------------------------------------

STAGGERED = ((0, 6, 10), (2, 11, 8), (3, 7, 1), (3, 9, 5), (9, 4, 6))


@pytest.mark.parametrize("tail_only", [True, False],
                         ids=["tail_only", "stacked"])
def test_legacy_matches_jax_token_for_token(tail_only):
    """Staggered arrivals (the shared-``ptick`` case), a ``max_new=1``
    request and slot reuse on three slots: the port's loop emits the JAX
    loop's tokens on the tail-only config, and on the stacked one, where
    both garble the admitted cache the same way (a slot index past the
    layer count writes nothing in either)."""
    jcfg, cfg = _cfgs(tail_only)
    jparams, params = _params(jcfg)
    want = jlegacy.simulate(jcfg, jparams, _reqs(cfg.vocab_size, STAGGERED),
                            3, 40, make_test_mesh(), log=_quiet)
    got = legacy.simulate(cfg, params, _reqs(cfg.vocab_size, STAGGERED), 3,
                          40, log=_quiet)
    assert [(r.rid, r.out, r.done_at) for r in got] == \
        [(r.rid, r.out, r.done_at) for r in want]


# -- the defects, pinned as in the JAX package's tests ----------------------


def test_legacy_loop_has_the_shared_ptick_bug():
    _, cfg = _cfgs()
    _, params = _params(_cfgs()[0])
    reqs = _reqs(cfg.vocab_size, ((0, 6, 10), (2, 11, 8)))
    want = {r.rid: sequential_decode(cfg, params, r.prompt, r.max_new, 48)
            for r in reqs}
    finished = legacy.simulate(cfg, params, reqs, 2, 48, log=_quiet)
    assert [r.rid for r in finished if r.out != want[r.rid]], (
        "legacy loop token-exact under staggered admission: the shared-ptick "
        "defect pin no longer holds")
    engine = ServeEngine(cfg, params, slots=2, max_len=48, device="cpu")
    done = engine.run(_reqs(cfg.vocab_size, ((0, 6, 10), (2, 11, 8))))
    assert {r.rid: r.out for r in done} == want


def test_legacy_max_new_one_emits_two_tokens():
    _, cfg = _cfgs()
    _, params = _params(_cfgs()[0])
    finished = legacy.simulate(cfg, params, _reqs(cfg.vocab_size,
                                                  ((0, 7, 1),)), 1, 32,
                               log=_quiet)
    assert len(finished[0].out) == 2
    engine = ServeEngine(cfg, params, slots=1, max_len=32, device="cpu")
    assert len(engine.run(_reqs(cfg.vocab_size, ((0, 7, 1),)))[0].out) == 1


def test_legacy_layered_cache_admission_bug():
    """On a stacked config the per-slot cache write lands on the layer
    axis: even one request in one slot decodes from a garbled cache."""
    jcfg, cfg = _cfgs(tail_only=False)
    assert cfg.n_super > 1
    _, params = _params(jcfg)
    req = _reqs(cfg.vocab_size, ((0, 8, 6),))
    want = sequential_decode(cfg, params, req[0].prompt, 6, 32)
    finished = legacy.simulate(cfg, params, req, 1, 32, log=_quiet)
    assert finished[0].out != want, (
        "legacy loop correct on a stacked cache: the defect pin no longer "
        "holds")


# -- engine vs legacy, where the legacy loop is correct ---------------------


@pytest.mark.parametrize("ring", [False, True])
def test_engine_parity_vs_legacy(ring):
    """Every wave admitted on one tick with equal prompt lengths and
    budgets (so ``ptick`` is each slot's true position), on the tail-only
    config: the engine is token-exact against the legacy loop; two waves
    on three slots reuse slots, and the ring variant wraps its window."""
    jcfg, cfg = _cfgs(ring=ring)
    _, params = _params(jcfg)
    spec = ((0, 10, 5),) * 6
    legacy_out = legacy.simulate(cfg, params, _reqs(cfg.vocab_size, spec,
                                                    seed=11), 3, 32,
                                 log=_quiet)
    engine = ServeEngine(cfg, params, slots=3, max_len=32, device="cpu")
    engine_out = engine.run(_reqs(cfg.vocab_size, spec, seed=11))
    assert len(legacy_out) == len(engine_out) == 6
    assert {r.rid: r.out for r in engine_out} == \
        {r.rid: r.out for r in legacy_out}


# -- prefill_compile_count against the JAX engine's jit cache ---------------


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_compile_count_equals_jax(paged):
    """One admission a tick over prompt lengths in four buckets (dense),
    and a shared-prefix stream whose hits admit at a second prefix depth
    (paged): the port's count of distinct admission shapes equals the JAX
    engine's jit cache entries, and a reset engine serving the stream
    again adds none."""
    jcfg, cfg = _cfgs(tail_only=False)
    jparams, params = _params(jcfg)
    kw = dict(slots=2, max_len=80)
    if paged:
        kw.update(paged=True, page_size=16)
        mk = lambda: build_stream("poisson", 6,  # noqa: E731
                                  vocab=cfg.vocab_size, seed=4,
                                  prompt_max=20, out_max=2,
                                  shared_prefix=16)
    else:
        mk = lambda: _reqs(cfg.vocab_size, [  # noqa: E731
            (3 * i, n, 2) for i, n in enumerate((3, 5, 9, 12, 17, 33, 60))])
    with mesh_context(make_test_mesh()):
        jengine = JServeEngine(jcfg, jparams, **kw)
        jengine.run(mk(), log=None)
        want = jengine.prefill_compile_count()
    engine = ServeEngine(cfg, params, device="cpu", **kw)
    engine.run(mk())
    assert engine.prefill_compile_count() == want
    if paged:   # misses at depth 0 and hits at depth 1 both admitted
        assert {npp for _, npp in engine._admit_shapes} == {0, 1}
    else:       # one shape a bucket: 8, 16, 32, 64
        assert want == 4
    engine.reset()
    engine.run(mk())
    assert engine.prefill_compile_count() == want


# -- the bench --------------------------------------------------------------

#: The reference bench's report keys (``benchmarks/serve_bench.py``).
REPORT_KEYS = {"config", "legacy", "engine", "speedup_tok_s", "streams",
               "prefill_compiles", "paged"}
CONFIG_KEYS = {"smoke", "arch", "requests", "slots", "max_len", "prompt_max",
               "out_max", "seed", "page_size", "backend"}
PAGED_KEYS = {"page_size", "skew", "residency", "worst_reduction_x",
              "prefix", "tokens_match_all_streams"}
STAT_KEYS = {"requests", "tokens", "seconds", "tok_per_sec", "ttft_p50_ms",
             "ttft_p99_ms", "itl_p50_ms", "itl_p99_ms"}


def test_serve_bench_smoke_runs_on_cpu(tmp_path):
    out = tmp_path / "serve.json"
    rc = serve_bench.main(["--smoke", "--device", "cpu", "--requests", "6",
                           "--out", str(out)])
    report = json.loads(out.read_text())
    assert set(report) == REPORT_KEYS
    assert set(report["config"]) == CONFIG_KEYS
    assert set(report["paged"]) == PAGED_KEYS
    assert set(report["legacy"]) == set(report["engine"]) == STAT_KEYS
    assert set(report["streams"]) == {"poisson", "bursty", "diurnal",
                                      "heavy_tail"}
    assert report["config"]["backend"] == "cpu"
    # The gates the port must meet; the speedup gate measures a JAX effect
    # (retracing) and is reported, as the exit code is.
    assert report["paged"]["tokens_match_all_streams"]
    assert report["paged"]["worst_reduction_x"] >= 4.0
    assert (report["prefill_compiles"]["count"]
            <= report["prefill_compiles"]["bound"])
    assert rc == (0 if serve_bench.passes(report, True) else 1)
