"""The port's meshed paths against its unmeshed ones and the JAX package.

``simulate(mesh=...)`` (the engine, dense and paged, and the legacy loop)
on a one-rank gloo ``DeviceMesh`` serves the same tokens as ``mesh=None``
and as the JAX ``simulate`` under its ``make_test_mesh()``, on Granite
SMOKE in f32.  On two gloo ranks (two processes), where the rules do
shard, a (1, 2) mesh splits the kv heads, experts, channels and the
dense cache's sequence over "model" and a (2, 1) mesh the batch rows and
MoE groups over "data": meshed serving gives the unmeshed tokens, and
the LLM Phase-2 step the unmeshed loss and gradients (within 1e-4 of each
leaf's largest magnitude; f32 sums taken in another order).  Vectorized
Phase 1 on two ranks trains each rank's block of edges and all-gathers
them: bit for bit the unsharded run; with an edge count the data axis
does not divide, every rank trains every edge.  Each test makes and
destroys its own process group.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch.mesh import make_test_mesh as jmake_test_mesh  # noqa: E402
from repro.launch.mesh import mesh_context as jmesh_context  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
from repro.serve import build_stream as jbuild_stream  # noqa: E402
from repro.serve import legacy as jlegacy  # noqa: E402
from repro.serve import simulate as jsimulate  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import (free_port, make_test_mesh,  # noqa: E402
                                     mesh_context)
from repro_torch.serve import build_stream, simulate  # noqa: E402
from repro_torch.serve import legacy  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS, MAX_LEN = 3, 48


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo (1, 1) mesh, its process group destroyed after the
    module (test files share pytest-xdist workers)."""
    torch.set_num_threads(1)
    m = make_test_mesh(device="cpu")
    yield m
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def granite():
    """Granite SMOKE (f32) in both packages from one JAX-initialised set of
    weights."""
    jcfg = jregistry.get_smoke_config("granite-3-2b")
    with jmesh_context(jmake_test_mesh()):
        jparams, _ = JTransformer.init(jcfg, jax.random.key(0))
    return (jcfg, jparams, registry.get_smoke_config("granite-3-2b"),
            params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"))


def _stream(build, vocab):
    return build("poisson", 5, vocab=vocab, seed=4, prompt_max=14, out_max=6)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_meshed_engine_equals_unmeshed_and_jax(mesh, granite, paged):
    jcfg, jparams, cfg, params = granite
    kw = dict(paged=paged, page_size=8) if paged else {}
    want = jsimulate(jcfg, jparams, _stream(jbuild_stream, cfg.vocab_size),
                     SLOTS, MAX_LEN, mesh=jmake_test_mesh(), log=None, **kw)
    plain = simulate(cfg, params, _stream(build_stream, cfg.vocab_size),
                     SLOTS, MAX_LEN, log=None, device="cpu", **kw)
    got = simulate(cfg, params, _stream(build_stream, cfg.vocab_size),
                   SLOTS, MAX_LEN, mesh=mesh, log=None, device="cpu", **kw)
    key = lambda rs: [(r.rid, r.out, r.done_at) for r in rs]  # noqa: E731
    assert key(got) == key(plain) == key(want)
    assert rules.get_active_mesh_or_none() is None


def test_meshed_legacy_loop_equals_unmeshed_and_jax(mesh, granite):
    jcfg, jparams, cfg, params = granite
    jcfg = dataclasses.replace(jcfg, block_pattern=("attn",) * 3)
    cfg = dataclasses.replace(cfg, block_pattern=("attn",) * 3)
    with jmesh_context(jmake_test_mesh()):
        jparams, _ = JTransformer.init(jcfg, jax.random.key(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    quiet = lambda *a: None  # noqa: E731
    want = jlegacy.simulate(jcfg, jparams, _stream(jbuild_stream,
                                                   cfg.vocab_size),
                            SLOTS, MAX_LEN, jmake_test_mesh(), log=quiet)
    plain = legacy.simulate(cfg, params, _stream(build_stream, cfg.vocab_size),
                            SLOTS, MAX_LEN, log=quiet)
    got = legacy.simulate(cfg, params, _stream(build_stream, cfg.vocab_size),
                          SLOTS, MAX_LEN, mesh=mesh, log=quiet)
    key = lambda rs: [(r.rid, r.out, r.done_at) for r in rs]  # noqa: E731
    assert key(got) == key(plain) == key(want)


def test_meshed_state_is_placed_and_constrain_is_a_no_op_without_a_mesh(
        mesh, granite):
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.serve.engine import make_init_state
    _, _, cfg, _ = granite
    x = torch.ones(2, 3)
    assert rules.constrain(x, ("batch", None)) is x
    with mesh_context(mesh):
        tokens, caches, pos, budget, active = make_init_state(
            cfg, SLOTS, MAX_LEN, "cpu")()
        y = rules.constrain(x, ("batch", None))
    assert isinstance(y, DTensor) and y.placements == (Replicate(),) * 2
    leaf = caches["blocks"]["b0"]["k"]
    assert isinstance(leaf, DTensor) and isinstance(pos, DTensor)
    assert tuple(leaf.shape) == (cfg.n_super, SLOTS, MAX_LEN, cfg.kv_heads,
                                 cfg.hd)


_PHASE1 = textwrap.dedent('''
    import sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    rank, port, out, n = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                          int(sys.argv[4]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    from repro_torch.core import fl, vectorized
    from repro_torch.examples import quickstart
    from repro_torch.launch.mesh import mesh_context
    calls = []
    sharded = vectorized._train_sharded
    vectorized._train_sharded = lambda *a: (calls.append(1), sharded(*a))[1]
    adapter, core, edges, test = quickstart.setup()
    f = fl.FederatedKD(adapter, fl.FLConfig(num_edges=n, edge_epochs=1,
                                            batch_size=64),
                       core, edges[:n], test, device="cpu")
    init = adapter.init(torch.Generator().manual_seed(0), "cpu")
    mesh = DeviceMesh("cpu", torch.arange(2).reshape(2, 1),
                      mesh_dim_names=("data", "model"))
    with mesh_context(mesh):
        got = f.train_round_edges([init] * n, list(range(n)), seed=5)
    torch.save({"states": got, "sharded": len(calls)}, f"{out}/{rank}.pt")
    dist.destroy_process_group()
''')


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


@pytest.mark.parametrize("edges", [4, 3], ids=["sharded", "replicated"])
def test_vectorized_phase1_on_two_ranks_equals_unsharded(tmp_path, edges):
    from repro_torch.core import fl
    from repro_torch.examples import quickstart
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _PHASE1, str(r), port,
                               str(tmp_path), str(edges)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in (0, 1)]
    adapter, core, edges_ds, test = quickstart.setup()
    f = fl.FederatedKD(adapter, fl.FLConfig(num_edges=edges, edge_epochs=1,
                                            batch_size=64),
                       core, edges_ds[:edges], test, device="cpu")
    init = adapter.init(torch.Generator().manual_seed(0), "cpu")
    want = f.train_round_edges([init] * edges, list(range(edges)), seed=5)
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out.decode()[-3000:]
    for r in (0, 1):
        res = torch.load(tmp_path / f"{r}.pt")
        assert res["sharded"] == (1 if edges == 4 else 0)
        for g, w in zip(res["states"], want):
            for a, b in zip(_leaves(g), _leaves(w)):
                assert torch.equal(a, b)


_TWO_RANKS = textwrap.dedent('''
    import contextlib, sys, time, traceback
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    serve_cases, train_cases = sys.argv[4].split(","), sys.argv[5].split(",")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import registry
    from repro_torch.launch import specs, steps
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import adamw
    from repro_torch.serve import build_stream, simulate
    from repro_torch.sharding import local
    from repro_torch.sharding.rules import tree_map_axes

    sharded = set()   # per-rank functions that ran on a split input
    run_local = local.run_local
    def counting(fn, mesh, outp, args, inp, grads=None):
        if any(p.is_shard() for pl in inp for p in pl):
            sharded.add(fn.__qualname__)
        return run_local(fn, mesh, outp, args, inp, grads)
    local.run_local = counting

    def mesh_of(shape):
        d, m = map(int, shape.split("x"))
        return DeviceMesh("cpu", torch.arange(2).reshape(d, m),
                          mesh_dim_names=("data", "model"))

    def serve(arch, kind, mesh):
        cfg = registry.get_smoke_config(arch)
        kw = dict(paged=True, page_size=8) if kind == "paged" else {}
        reqs = build_stream("poisson", 5, vocab=cfg.vocab_size, seed=4,
                            prompt_max=14, out_max=6)
        # max_len 24: a request's positions cross into the second rank's
        # half of a sequence-sharded cache
        rs = simulate(cfg, Transformer.init(cfg, 0, device="cpu"), reqs, 4,
                      24, mesh=mesh, log=None, device="cpu", **kw)
        return [(r.rid, r.out, r.done_at) for r in rs]

    def flat(tree, pre=""):
        if not isinstance(tree, dict):
            return {pre: local.full(tree).clone()}
        return {k: v for key in tree for k, v in
                flat(tree[key], f"{pre}/{key}").items()}

    def phase2(arch, mesh):
        cfg = registry.get_smoke_config(arch)
        nets = [Transformer.init(cfg, i, device="cpu") for i in range(3)]
        g = torch.Generator().manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab_size, (4, 16), generator=g,
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        if mesh is not None:
            tree = Transformer.specs(cfg)
            nets = [tree_map_axes(lambda ax, p: distribute_tensor(
                p, mesh, specs.named_sharding(ax, p.shape, mesh)[1]),
                tree, n) for n in nets]
            batch = {k: distribute_tensor(batch[k], mesh, pl)
                     for k, (_, pl) in
                     specs.batch_shardings(batch, mesh).items()}
        grads = []
        update = steps.update_in_place
        steps.update_in_place = lambda opt, g_, *a: (grads.append(flat(g_)),
                                                    update(opt, g_, *a))[1]
        opt = adamw(1e-3)
        step = steps.make_phase2_step(cfg, opt, buffer_mode="clone")
        try:
            with (mesh_context(mesh) if mesh is not None
                  else contextlib.nullcontext()):
                _, _, m = step(nets[0], nets[1], nets[2],
                               opt.init(nets[0]), batch, 0)
        finally:
            steps.update_in_place = update
        return {"loss": local.full(m["loss"]).item(), "grads": grads[0]}

    res = {}
    for what, cases in (("serve", serve_cases), ("train", train_cases)):
        for case in cases:
            *job, shape = case.split(":")
            sharded.clear()
            t = time.perf_counter()
            try:
                fn = serve if what == "serve" else phase2
                got = fn(*job, mesh_of(shape))
                want = fn(*job, None) if rank == 0 else None
                res[what, case] = {"got": got, "want": want,
                                   "sharded": set(sharded)}
            except Exception:
                res[what, case] = traceback.format_exc()
            print(case, round(time.perf_counter() - t, 2), flush=True)
    torch.save(res, f"{out}/{rank}.pt")
    dist.destroy_process_group()
''')

# case -> the per-rank functions that must have run on a split input
_SERVE = {
    "granite-3-2b:dense:1x2": {"write_slots.<locals>.write",
                               "_grouped.<locals>.run",
                               "_heads.<locals>.<lambda>"},
    "granite-3-2b:paged:1x2": {"write_pages.<locals>.write",
                               "_grouped.<locals>.run"},
    "phi3.5-moe-42b-a6.6b:dense:1x2": {"_ffn", "_grouped.<locals>.run"},
    "mamba2-370m:dense:1x2": {"_step", "_conv1d"},
    "granite-3-2b:dense:2x1": {"write_slots.<locals>.write",
                               "_grouped.<locals>.run"},
    "granite-3-2b:paged:2x1": {"_grouped.<locals>.run"},
}
_TRAIN = {
    "granite-3-2b:1x2": {"_heads.<locals>.<lambda>",
                         "attend_full.<locals>.local"},
    "phi3.5-moe-42b-a6.6b:1x2": {"_ffn"},
    "phi3.5-moe-42b-a6.6b:2x1": {"_ffn", "_combine.<locals>.<lambda>"},
    "mamba2-370m:1x2": {"forward.<locals>.scan", "_conv1d"},
    "mamba2-370m:2x1": {"forward.<locals>.scan"},
    "recurrentgemma-9b:1x2": {"rglru_scan_reference",
                              "_gates.<locals>.local"},
}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results for every case of ``_SERVE`` and ``_TRAIN``
    (rank 0's also unmeshed), from one pair of gloo processes."""
    out = tmp_path_factory.mktemp("two_ranks")
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANKS, str(r), port,
                               str(out), ",".join(_SERVE), ",".join(_TRAIN)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in (0, 1)]
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log.decode()[-3000:]
    return [torch.load(out / f"{r}.pt", weights_only=False) for r in (0, 1)]


def _case(two_ranks, what, case):
    r0, r1 = (r[what, case] for r in two_ranks)
    for r in (r0, r1):
        assert not isinstance(r, str), r
    return r0, r1


@pytest.mark.parametrize("case", list(_SERVE))
def test_two_rank_meshed_serving_equals_unmeshed(two_ranks, case):
    r0, r1 = _case(two_ranks, "serve", case)
    assert r0["got"] == r1["got"] == r0["want"]
    assert _SERVE[case] <= r0["sharded"], r0["sharded"]


@pytest.mark.parametrize("case", list(_TRAIN))
def test_two_rank_meshed_phase2_gradients_equal_unmeshed(two_ranks, case):
    r0, r1 = _case(two_ranks, "train", case)
    want = r0["want"]
    for got in (r0["got"], r1["got"]):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
        assert got["grads"].keys() == want["grads"].keys()
        for k, w in want["grads"].items():
            err = (got["grads"][k] - w).abs().max() / w.abs().max()
            assert err < 1e-4, (k, err.item())
    assert _TRAIN[case] <= r0["sharded"], r0["sharded"]
