"""The PyTorch port's live system against the JAX package's, and fused
live checkpoints across the packages, on the CPU.

One carried initial state (the JAX init, ``interop.params_from_numpy``)
starts both packages' ``LiveSystem`` on the JAX test's setting (Granite
SMOKE with three attention layers, f32, 2 bkd rounds, quantum 1, a
5-request poisson stream on 2 slots):

* the port's run against the JAX run: swap ticks and records and every
  greedy token equal, final state and history within the stated
  tolerance (the packages' f32 arithmetic differs by ~1e-6);
* a JAX-written checkpoint (mid-round, mid-epoch, mid-stream) restored and
  resumed in the port reaches the JAX uninterrupted result, and a
  port-written one restored and resumed in the JAX package reaches it too.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402

from repro import live as jlive  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.core import fl as jfl  # noqa: E402
from repro.launch.mesh import make_test_mesh, mesh_context  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import build_stream as jbuild_stream  # noqa: E402
from repro_torch.checkpoint import io  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.fl import FederatedKD, FLConfig  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.live import (LiveSystem, LiveTrainer, lm_adapter,  # noqa: E402
                              lm_fl_data)
from repro_torch.serve import ServeEngine, build_stream  # noqa: E402

#: Final core state: |port - JAX| <= ATOL + RTOL |JAX| leaf by leaf.  Two
#: rounds of f32 training from one start; the packages' products differ by
#: ~1e-7 (2.2e-7 at most measured on the uninterrupted run).
ATOL, RTOL = 1e-5, 1e-4
#: History: the float metrics (accuracies, forget score) to rounding; the
#: rest of each record equal.  Measured equal.
ACC_TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(reg):
    cfg = reg.get_smoke_config("granite-3-2b")
    return dataclasses.replace(cfg, block_pattern=("attn",) * 3)


FLKW = dict(num_edges=2, rounds=2, method="bkd", core_epochs=1, edge_epochs=1,
            kd_epochs=2, batch_size=8, seed=0)


def _stream(build, vocab):
    return build("poisson", 5, vocab=vocab, seed=3, prompt_max=10, out_max=4)


@pytest.fixture(scope="module")
def setting():
    jcfg, cfg = _cfg(jregistry), _cfg(registry)
    mesh = make_test_mesh()
    with mesh_context(mesh):
        jinit, _ = JTransformer.init(jcfg, jax.random.key(0))
    return jcfg, cfg, mesh, jax.tree.map(np.asarray, jinit)


def _jax_system(setting):
    jcfg, _, _, init = setting
    core, edges, test, _ = jlive.lm_fl_data(jcfg, num_edges=2, seq_len=8,
                                            n_seqs=96, seed=0)
    adapter = dataclasses.replace(jlive.lm_adapter(jcfg),
                                  init=lambda key: jax.tree.map(
                                      jax.numpy.asarray, init))
    fl = jfl.FederatedKD(adapter, jfl.FLConfig(**FLKW), core, edges, test)
    trainer = jlive.LiveTrainer(fl, jax.random.key(0), log=None)
    engine = JServeEngine(jcfg, trainer.state, slots=2, max_len=32)
    return jlive.LiveSystem(trainer, engine, quantum=1)


def _port_system(setting):
    _, cfg, _, init = setting
    core, edges, test, _ = lm_fl_data(cfg, num_edges=2, seq_len=8,
                                      n_seqs=96, seed=0)
    adapter = dataclasses.replace(
        lm_adapter(cfg), init=lambda gen, device: params_from_numpy(init,
                                                                    device))
    fl = FederatedKD(adapter, FLConfig(**FLKW), core, edges, test,
                     device="cpu")
    trainer = LiveTrainer(fl, 0, log=None)
    engine = ServeEngine(cfg, trainer.state, slots=2, max_len=32,
                         device="cpu")
    return LiveSystem(trainer, engine, quantum=1)


def _save_mid_round(system, stream, path):
    eng, tr = system.engine, system.trainer
    eng.begin(stream, log=None)
    while eng.pending() or tr.pending():
        if eng.pending():
            eng.tick()
        if tr.pending():
            system._train_quantum()
        st = tr._stepper
        if (tr.mid_round and st is not None and st.i > 0
                and st._idx is not None):
            system.save(path)
            return
    raise AssertionError("schedule too short to hit a mid-epoch save point")


def _result(system, finished):
    """What a run is held to: tokens, clock, swaps, state, history."""
    state = system.trainer.state
    state = (params_to_numpy(state) if _is_torch(state)
             else jax.tree.map(np.asarray, state))
    return {"tokens": {r.rid: list(r.out) for r in finished},
            "ticks": system.engine.ticks,
            "swap_log": list(system.engine.swap_log),
            "swap_records": [dict(r) for r in system.swap_records],
            "state": state,
            "history": [h.as_dict() for h in system.trainer.fl.history]}


def _is_torch(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return isinstance(tree, torch.Tensor)


def _assert_reaches(got, want):
    for key in ("tokens", "ticks", "swap_log", "swap_records"):
        assert got[key] == want[key], key
    flat_g = io._flatten_with_path(got["state"])
    flat_w = io._flatten_with_path(want["state"])
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                   err_msg="/".join(path))
    assert len(got["history"]) == len(want["history"])
    for g, w in zip(got["history"], want["history"]):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(g[k], float):
                assert abs(g[k] - w[k]) <= ACC_TOL, k
            else:
                assert g[k] == w[k], k


@pytest.fixture(scope="module")
def jax_run(setting):
    """The JAX uninterrupted run."""
    jcfg, _, mesh, _ = setting
    with mesh_context(mesh):
        system = _jax_system(setting)
        finished = system.run(_stream(jbuild_stream, jcfg.vocab_size),
                              log=None)
    return _result(system, finished)


def test_live_system_matches_jax(setting, jax_run):
    _, cfg, _, _ = setting
    system = _port_system(setting)
    finished = system.run(_stream(build_stream, cfg.vocab_size), log=None)
    got = _result(system, finished)
    assert len(got["swap_records"]) == 2
    _assert_reaches(got, jax_run)


def test_jax_checkpoint_resumes_in_the_port(setting, jax_run, tmp_path):
    jcfg, cfg, mesh, _ = setting
    path = str(tmp_path / "jax_live.npz")
    with mesh_context(mesh):
        _save_mid_round(_jax_system(setting),
                        _stream(jbuild_stream, jcfg.vocab_size), path)
    meta = io.load_meta(path)
    assert meta["trainer"]["stepper"]["mid_epoch"]
    with np.load(path) as data:
        assert "engine/generator" not in data.files   # the JAX format
    system = _port_system(setting)
    reqs = _stream(build_stream, cfg.vocab_size)
    system.restore(path, reqs)
    finished = system.run(reqs, log=None, resume=True)
    _assert_reaches(_result(system, finished), jax_run)


def test_port_checkpoint_resumes_in_jax(setting, jax_run, tmp_path):
    jcfg, cfg, mesh, _ = setting
    path = str(tmp_path / "port_live.npz")
    _save_mid_round(_port_system(setting),
                    _stream(build_stream, cfg.vocab_size), path)
    with mesh_context(mesh):
        system = _jax_system(setting)
        reqs = _stream(jbuild_stream, jcfg.vocab_size)
        system.restore(path, reqs)
        finished = system.run(reqs, log=None, resume=True)
    _assert_reaches(_result(system, finished), jax_run)
