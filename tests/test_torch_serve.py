"""The PyTorch port's paged serving engine against the JAX package.

Greedy serving is compared token by token: the port's
``ServeEngine(paged=True, device="cpu")`` and the JAX
``ServeEngine(paged=True)`` serve the same numpy-seeded streams from the
same parameters (carried over by ``repro_torch.interop``) and must emit the
same tokens and prefix-cache counters.  Also: the copied numpy-only modules
stay equal to their JAX originals, the port never imports JAX or the JAX
package, and a CUDA entry point raises when there is no card.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch.mesh import make_test_mesh, mesh_context  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import build_stream as jbuild_stream  # noqa: E402
from repro.serve.paged import PageAllocator as JPageAllocator  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.paged_decode import paged_decode  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.checkpoint import save_tree  # noqa: E402
from repro_torch.serve import (PageAllocator, ServeEngine, build_stream,  # noqa: E402
                               make_sampler, simulate)
from repro_torch.serve.legacy import simulate as legacy_simulate  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's and torch's CPU thread pools contend in one process, and these
    small tensors gain nothing from more than one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """One JAX and one port engine on Granite SMOKE, same parameters; reset
    between streams, and prefill buckets of 32 and 64 only, so the JAX side
    compiles few executables (bucket padding is invisible to the tokens)."""
    jcfg = jregistry.get_smoke_config("granite-3-2b")
    cfg = registry.get_smoke_config("granite-3-2b")
    mesh = make_test_mesh()
    init = jax.jit(lambda key: JTransformer.init(jcfg, key)[0])  # eager values
    with mesh_context(mesh):
        jparams = init(jax.random.key(0))
        jengine = JServeEngine(jcfg, jparams, slots=3, max_len=64, paged=True,
                               page_size=8, min_bucket=32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    engine = ServeEngine(cfg, params, slots=3, max_len=64, paged=True,
                         page_size=8, min_bucket=32, device="cpu")
    return mesh, jengine, engine, cfg


@pytest.mark.parametrize("stream,shared_prefix", [("poisson", 0),
                                                  ("bursty", 0),
                                                  ("bursty", 20)])
def test_engine_tokens_and_prefix_stats_match_jax(engines, stream,
                                                   shared_prefix):
    mesh, jengine, engine, cfg = engines
    reqs = lambda: build_stream(stream, 8, vocab=cfg.vocab_size, seed=29,  # noqa: E731
                                prompt_max=24, out_max=8,
                                shared_prefix=shared_prefix)
    with mesh_context(mesh):
        jengine.reset()
        want = {r.rid: r.out for r in jengine.run(reqs(), log=None)}
    engine.reset()
    finished = engine.run(reqs(), log=None)
    assert {r.rid: r.out for r in finished} == want
    assert engine.prefix_stats() == jengine.prefix_stats()
    assert engine.resident_cache_bytes() == jengine.resident_cache_bytes()
    if shared_prefix:
        assert engine.prefix_stats()["hits"] > 0
        assert any(r.prefix_pages == shared_prefix // 8 for r in finished)


def test_engine_reset_reproduces_and_counts_decode_ticks(engines):
    _, _, engine, cfg = engines
    reqs = lambda: build_stream("heavy_tail", 5, vocab=cfg.vocab_size,  # noqa: E731
                                seed=3, prompt_max=20, out_max=6)
    engine.reset()
    first = {r.rid: r.out for r in engine.run(reqs())}
    ticks = engine.decode_ticks
    engine.reset()
    assert engine.decode_ticks == 0
    assert {r.rid: r.out for r in engine.run(reqs())} == first
    assert engine.decode_ticks == ticks > 0
    assert all(t < cfg.vocab_size for out in first.values() for t in out)


def test_topk_sampler_stays_in_the_top_k():
    gen = torch.Generator().manual_seed(0)
    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((64, 100)).astype(np.float32))
    draws = torch.stack([make_sampler("topk", 1.0, 5)(logits, gen)
                         for _ in range(20)])                   # (20, 64)
    allowed = torch.topk(logits, 5, dim=-1).indices               # (64, 5)
    assert (draws.long()[..., None] == allowed[None]).any(-1).all()
    assert len(torch.unique(draws[:, 0])) > 1
    # at a tiny temperature top-k sampling is greedy
    cold = make_sampler("topk", 1e-4, 5)(logits, gen)
    assert torch.equal(cold, make_sampler("greedy")(logits, gen))


def test_page_allocator_copy_matches_jax():
    rng = np.random.default_rng(11)
    mine, theirs = PageAllocator(12, 4), JPageAllocator(12, 4)
    system = list(rng.integers(0, 50, size=9))
    live = []
    for step in range(40):
        if live and rng.random() < 0.4:
            i = int(rng.integers(len(live)))
            a, b = live.pop(i)
            mine.release(a)
            theirs.release(b)
        else:
            prompt = system[:int(rng.integers(1, 10))] + list(
                rng.integers(0, 50, size=int(rng.integers(0, 6))))
            total = len(prompt) + int(rng.integers(0, 8))
            a, b = mine.admit(prompt, total), theirs.admit(prompt, total)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.as_meta() == b.as_meta()
                live.append((a, b))
        if step == 25:
            mine.bump_epoch()
            theirs.bump_epoch()
        assert mine.snapshot() == theirs.snapshot()
    mine.check_invariants()


@pytest.mark.parametrize("name", ["poisson", "bursty", "diurnal", "heavy_tail"])
def test_build_stream_copy_matches_jax(name):
    kw = dict(vocab=300, seed=5, prompt_max=30, out_max=9, shared_prefix=12)
    mine, theirs = build_stream(name, 9, **kw), jbuild_stream(name, 9, **kw)
    assert [(r.rid, r.arrival, r.max_new) for r in mine] == \
        [(r.rid, r.arrival, r.max_new) for r in theirs]
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.prompt, b.prompt)


def _port_sources():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                f"{path.name}:{node.lineno} imports {name}")


def test_import_scan_covers_every_port_package():
    """The scan above reaches every subpackage of the port, the uplink
    transport included, and the smoke script."""
    root = REPO / "src" / "repro_torch"
    scanned = {p.relative_to(root).parts[0] for p in _port_sources()
               if root in p.parents}
    packages = {p.name for p in root.iterdir()
                if p.is_dir() and (p / "__init__.py").exists()}
    assert {"transport", "kernels", "core", "serve", "live",
            "checkpoint"} <= packages <= scanned
    assert {"codecs.py", "method.py", "__init__.py"} <= {
        p.name for p in _port_sources() if root / "transport" in p.parents}
    assert REPO / "chip_smoke.py" in _port_sources()


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = registry.get_smoke_config("granite-3-2b")
    with pytest.raises(RuntimeError, match="cuda"):
        Transformer.init(cfg, 0)
    params = Transformer.init(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, params, slots=1, max_len=16, paged=True)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_cli.main(["--requests", "1"])
    assert paged_decode.launches == 0


def test_unported_paths_raise(tmp_path, capsys):
    """What still raises: serving on a mesh (slice 9, sharding), padded
    prefill on recurrent sub-blocks and an encoder-only engine (both as in
    the JAX package).  The engines' carry/restore (slice 6) and the CLI's
    --legacy loop, which raised until they were ported, now run."""
    cfg = registry.get_smoke_config("granite-3-2b")
    params = Transformer.init(cfg, 0, device="cpu")
    for paged in (False, True):
        engine = ServeEngine(cfg, params, slots=1, max_len=16, paged=paged,
                             device="cpu")
        engine.begin([])
        tree, meta = engine.carry()
        path = str(tmp_path / f"engine_{paged}.npz")
        save_tree(path, {"engine": tree}, meta)
        engine.restore(path, meta, [])
        assert meta["queue_total"] == 0 and not engine.pending()
    finished = serve_cli.main(["--device", "cpu", "--legacy", "--requests",
                               "2", "--slots", "2", "--max-len", "48"])
    assert len(finished) == 2
    assert "legacy on cpu" in capsys.readouterr().out
    for sim in (simulate, legacy_simulate):
        with pytest.raises(NotImplementedError, match="slice 9"):
            sim(cfg, params, [], 1, 16, mesh=object())
    hybrid = dataclasses.replace(cfg, block_pattern=("rglru", "attn"))
    with pytest.raises(ValueError, match="recurrent"):
        Transformer.prefill(hybrid, params, {"tokens": torch.zeros(
            (1, 4), dtype=torch.int32)}, 16, lengths=torch.ones(1))
    # hubert-xlarge is encoder-only: it loads, and serving it is refused
    # as the JAX package refuses it.
    hubert = registry.get_smoke_config("hubert-xlarge")
    with pytest.raises(ValueError, match="encoder-only arch has no decode"):
        ServeEngine(hubert, Transformer.init(hubert, 0, device="cpu"),
                    slots=1, max_len=16, device="cpu")
    for arch in ("kimi-k2-1t-a32b", "phi3.5-moe-42b-a6.6b"):  # MoE: ported
        assert registry.get_config(arch).mlp == "moe"


def test_serve_cli_runs_on_cpu(capsys):
    finished = serve_cli.main(["--device", "cpu", "--requests", "3",
                               "--slots", "2", "--max-len", "48", "--paged",
                               "--shared-prefix", "16"])
    assert len(finished) == 3
    assert "prefix hits" in capsys.readouterr().out


def test_chip_smoke_defines_each_top_level_name_once():
    """A later ``def`` or assignment of the same name silently replaces the
    earlier one for every phase that calls it (two phases once shared a
    helper name this way)."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = [t.id for node in tree.body if isinstance(node, ast.Assign)
             for t in node.targets if isinstance(t, ast.Name)]
    names += [node.name for node in tree.body
              if isinstance(node, (ast.FunctionDef, ast.ClassDef))]
    assert sorted(n for n in set(names) if names.count(n) > 1) == []
