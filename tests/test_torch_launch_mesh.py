"""The launch CLIs under a mesh (``launch.mesh.cli_mesh``).

On two gloo ranks started by ``torchrun`` (``python -m
torch.distributed.run --standalone --nproc-per-node 2``, one launch a CLI,
every case of that CLI in one worker), where ``make_test_mesh`` gives a
(1, 2) mesh that shards kv heads, experts, channels and the vocabulary
over "model":

* ``launch.serve``: granite dense, ``--paged`` and ``--legacy``,
  phi3.5-moe and mamba2-370m serve the unmeshed CLI's tokens, and only
  rank 0 prints;
* ``launch.train``: granite ``bkd``, ``kd``, ``fedavg``, ``ema``,
  ``melting`` (its buffer re-cloned), ``--transport int8``, ``--sim
  async:heavy_tail`` and phi3.5-moe ``bkd`` print the
  unmeshed CLI's losses and final NLL within 2e-4 (one unit of the last
  printed digit either side; the f32 sums are taken in another order);
  ``--loss-backend pallas`` on a (2, 1) mesh runs the fused KD loss's
  per-rank rows function (``ops._mean_on_shards``) on split rows.

Against the JAX package, the JAX CLIs run in a subprocess on two CPU
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=2``, their
``make_test_mesh`` a (1, 2) mesh) from the port's seed-0 weights: granite
serving gives the port's two-rank tokens, granite ``bkd`` training the
port's two-rank final NLL within 2e-4 (f32).

In this process: the choice rule — ``torchrun``'s environment gives a
mesh of the world, ``--mesh`` a one-rank mesh, neither no mesh, ``--full``
on a 256-rank world the production mesh — and a group the CLI made is
destroyed when it returns.  Everything runs at SMOKE.
"""

import contextlib
import io
import json
import os
import pickle
import re
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the JAX side runs in a subprocess

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.interop import params_to_numpy  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRINT_TOL = 2e-4
NUMBER = re.compile(r"(loss|kd|domain)[=:] ?(-?\d+\.\d+)")
TRAIN_ARGV = ["--rounds", "2", "--edges", "2", "--steps-per-phase", "2",
              "--batch", "2", "--seq", "16"]
GRANITE = ["--arch", "granite-3-2b"]
PHI = ["--arch", "phi3.5-moe-42b-a6.6b"]

# name -> (argv, run on a (2, 1) mesh)
SERVE = {
    "granite-dense": (GRANITE, False),
    "granite-paged": (GRANITE + ["--paged"], False),
    "granite-legacy": (GRANITE + ["--legacy"], False),
    "phi3.5-moe-dense": (PHI, False),
    "mamba2-dense": (["--arch", "mamba2-370m"], False),
}
TRAIN = {
    "granite-bkd": (GRANITE + TRAIN_ARGV + ["--method", "bkd"], False),
    "granite-kd": (GRANITE + TRAIN_ARGV + ["--method", "kd"], False),
    "granite-fedavg": (GRANITE + TRAIN_ARGV + ["--method", "fedavg"], False),
    "granite-ema": (GRANITE + TRAIN_ARGV + ["--method", "ema"], False),
    "granite-melting": (GRANITE + TRAIN_ARGV + ["--method", "melting"],
                        False),
    "granite-int8": (GRANITE + TRAIN_ARGV + ["--transport", "int8"], False),
    "granite-async": (GRANITE + TRAIN_ARGV + ["--sim", "async:heavy_tail"],
                      False),
    "phi3.5-moe-bkd": (PHI + TRAIN_ARGV + ["--method", "bkd"], False),
    "granite-pallas-rows": (GRANITE + TRAIN_ARGV
                            + ["--loss-backend", "pallas"], True),
}

_WORKER = textwrap.dedent('''
    import contextlib, io, json, os, sys, time, traceback
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch import mesh as mesh_mod, serve, train
    from repro_torch.sharding import local
    torch.set_num_threads(1)
    cli, out, cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    rank = int(os.environ["RANK"])
    # one group for every case, joined as a CLI joins it (env://): each
    # CLI call finds it and runs on it without making or destroying one
    assert mesh_mod.started_by_torchrun() and mesh_mod.init_group("cpu")

    seen = []   # (per-rank function, ran on a split input)
    run_local = local.run_local
    def counting(fn, mesh, outp, args, inp, grads=None):
        seen.append((fn.__qualname__,
                     any(p.is_shard() for pl in inp for p in pl)))
        return run_local(fn, mesh, outp, args, inp, grads)
    local.run_local = counting

    test_mesh = mesh_mod.make_test_mesh
    def rows_mesh(devices=8, *, device):
        return DeviceMesh(device, torch.arange(2).reshape(2, 1),
                          mesh_dim_names=("data", "model"))

    main = serve.main if cli == "serve" else train.main
    res = {}
    for name, (argv, rows) in cases.items():
        seen.clear()
        mesh_mod.make_test_mesh = rows_mesh if rows else test_mesh
        buf = io.StringIO()
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                got = main(argv + ["--device", "cpu"])
            res[name] = {
                "out": buf.getvalue(), "seen": list(seen),
                "tokens": ([(r.rid, r.out, r.done_at) for r in got]
                           if cli == "serve" else None)}
        except Exception:
            res[name] = traceback.format_exc()
        print(rank, name, round(time.perf_counter() - t, 2), flush=True)
    torch.save(res, f"{out}/{cli}_{rank}.pt")
    dist.destroy_process_group()
''')

_JAX = textwrap.dedent('''
    import json, pickle, sys
    import jax, jax.numpy as jnp
    from repro.launch import serve, train
    from repro.models.transformer import Transformer
    weights, out = sys.argv[1], sys.argv[2]
    serve_argv, train_argv = json.loads(sys.argv[3]), json.loads(sys.argv[4])
    with open(weights, "rb") as fh:
        w = pickle.load(fh)
    Transformer.init = staticmethod(
        lambda cfg, key: (jax.tree.map(jnp.asarray, w), None))
    assert len(jax.devices()) == 2, jax.devices()
    got = serve.main(serve_argv)
    import io, contextlib
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(train_argv)
    with open(out, "w") as fh:
        json.dump({"tokens": [(r.rid, r.out, r.done_at) for r in got],
                   "train_out": buf.getvalue()}, fh)
''')


def _start(cmd, log, **env):
    """``cmd`` started with its output to the file ``log``."""
    with open(log, "w") as fh:
        return subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT,
                                env=dict(os.environ, PYTHONPATH=os.path.join(
                                    REPO, "src"), **env))


def _torchrun(worker, cli, cases, out):
    return _start([sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc-per-node", "2", str(worker), cli,
                   str(out), json.dumps(cases)],
                  out / f"{cli}.log", OMP_NUM_THREADS="1")


def _numbers(out):
    """(name, value) of every number the driver printed, in order."""
    return [(m.group(1), float(m.group(2))) for m in NUMBER.finditer(out)]


def _unmeshed(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = main(argv + ["--device", "cpu"])
    return got, buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' two-rank results (rank 0 and rank 1), the unmeshed
    CLIs' results in this process, and the JAX CLIs' on two devices, all
    started together."""
    tmp = tmp_path_factory.mktemp("launch_mesh")
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    cfg = registry.get_smoke_config("granite-3-2b")
    with open(tmp / "granite.pkl", "wb") as fh:
        pickle.dump(params_to_numpy(Transformer.init(cfg, 0, device="cpu")),
                    fh)
    procs = [_torchrun(worker, "serve", SERVE, tmp),
             _torchrun(worker, "train", TRAIN, tmp)]
    procs.append(_start(
        [sys.executable, "-c", _JAX, str(tmp / "granite.pkl"),
         str(tmp / "jax.json"), json.dumps(SERVE["granite-dense"][0]),
         json.dumps(TRAIN["granite-bkd"][0])], tmp / "jax.log",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        JAX_PLATFORMS="cpu"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = {"serve": {k: _unmeshed(serve.main, a)
                           for k, (a, _) in SERVE.items()},
                 "train": {k: _unmeshed(train.main, a)
                           for k, (a, _) in TRAIN.items()}}
    finally:
        torch.set_num_threads(n)
    for p, log in zip(procs, ("serve", "train", "jax")):
        try:
            p.wait(timeout=400)
        finally:
            if p.poll() is None:     # torchrun stops its workers on SIGTERM
                p.terminate()
                p.wait(timeout=60)
        assert p.returncode == 0, (tmp / f"{log}.log").read_text()[-4000:]
    meshed = {cli: [torch.load(tmp / f"{cli}_{r}.pt", weights_only=False)
                    for r in (0, 1)] for cli in ("serve", "train")}
    with open(tmp / "jax.json") as fh:
        jax_res = json.load(fh)
    return meshed, plain, jax_res


def _ranks(runs, cli, name):
    r0, r1 = (r[name] for r in runs[0][cli])
    for r in (r0, r1):
        assert not isinstance(r, str), r
    return r0, r1


@pytest.mark.parametrize("name", list(SERVE))
def test_two_rank_serve_cli_equals_unmeshed(runs, name):
    r0, r1 = _ranks(runs, "serve", name)
    got, out = runs[1]["serve"][name]
    want = [(r.rid, r.out, r.done_at) for r in got]
    assert [tuple(t) for t in r0["tokens"]] == want
    assert [tuple(t) for t in r1["tokens"]] == want
    assert "mesh {'data': 1, 'model': 2}" in r0["out"]
    assert "mesh" not in out
    assert r1["out"] == ""                    # only rank 0 prints
    assert any(split for _, split in r0["seen"])


@pytest.mark.parametrize("name", list(TRAIN))
def test_two_rank_train_cli_equals_unmeshed(runs, name):
    r0, r1 = _ranks(runs, "train", name)
    _, out = runs[1]["train"][name]
    mine, want = _numbers(r0["out"]), _numbers(out)
    assert [k for k, _ in mine] == [k for k, _ in want], (r0["out"], out)
    assert len(mine) >= 4
    for (key, a), (_, b) in zip(mine, want):
        assert abs(a - b) <= PRINT_TOL, (key, a, b, r0["out"], out)
    shape = "{'data': 2, 'model': 1}" if TRAIN[name][1] else \
        "{'data': 1, 'model': 2}"
    assert f"mesh={shape}" in r0["out"]
    for line in ("aggregated", "transport="):
        assert [ln for ln in r0["out"].splitlines() if line in ln] == \
            [ln for ln in out.splitlines() if line in ln]
    stale = re.compile(r"edge \d+ trained( stale=\S+)?( t=\S+)?,")
    assert stale.findall(r0["out"]) == stale.findall(out)
    assert r1["out"] == ""                    # only rank 0 prints


def test_two_rank_pallas_loss_runs_on_each_ranks_rows(runs):
    r0, r1 = _ranks(runs, "train", "granite-pallas-rows")
    rows = [split for fn, split in r0["seen"]
            if fn == "_mean_on_shards.<locals>.rows"]
    # 2 rounds x 2 Phase-2 steps, one loss chunk (--seq 16): one call a
    # step's forward and none more (no checkpoint recompute at one chunk)
    assert rows == [True] * 4, r0["seen"]


def test_two_rank_serve_cli_equals_the_jax_cli(runs):
    r0, _ = _ranks(runs, "serve", "granite-dense")
    assert [tuple(t) for t in r0["tokens"]] == \
        [tuple(t) for t in runs[2]["tokens"]]


def test_two_rank_train_cli_final_nll_equals_the_jax_cli(runs):
    r0, _ = _ranks(runs, "train", "granite-bkd")
    mine, theirs = _numbers(r0["out"]), _numbers(runs[2]["train_out"])
    assert [k for k, _ in mine] == [k for k, _ in theirs]
    assert mine[-1][0] == "domain"
    assert abs(mine[-1][1] - theirs[-1][1]) <= PRINT_TOL, (mine, theirs)


# -- the choice rule, in this process ------------------------------------------


@pytest.fixture
def no_group():
    """No process group before or after the test (test files share
    pytest-xdist workers)."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _torchrun_env(monkeypatch):
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(mesh_mod.free_port())}.items():
        monkeypatch.setenv(k, v)


def test_torchrun_gives_a_mesh_of_the_world(monkeypatch, no_group):
    _torchrun_env(monkeypatch)
    assert mesh_mod.started_by_torchrun()
    with mesh_mod.cli_mesh(full=False, requested=False, device="cpu") as m:
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert m.mesh_dim_names == ("data", "model") and m.size() == 1
    assert not dist.is_initialized()          # the CLI's group is gone


def test_mesh_flag_gives_a_one_rank_mesh_and_neither_gives_none(
        monkeypatch, no_group):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not mesh_mod.started_by_torchrun()
    with mesh_mod.cli_mesh(full=True, requested=False, device="cpu") as m:
        assert m is None and not dist.is_initialized()
    with mesh_mod.cli_mesh(full=True, requested=True, device="cpu") as m:
        assert tuple(m.shape) == (1, 1)        # --full on one rank: a test mesh
    assert not dist.is_initialized()


def test_full_on_a_256_rank_world_gives_the_production_mesh(no_group):
    from repro_torch.launch.dryrun import fake_group
    assert fake_group(256)
    with mesh_mod.cli_mesh(full=True, requested=True, device="cpu") as m:
        assert tuple(m.shape) == (16, 16)
        assert m.mesh_dim_names == ("data", "model")
    assert dist.is_initialized()              # not the CLI's group: kept
    with mesh_mod.cli_mesh(full=False, requested=True, device="cpu") as m:
        assert tuple(m.shape) == (128, 2)      # a test mesh of the world


def test_mesh_flag_serves_the_unmeshed_tokens(no_group, capsys):
    argv = ["--device", "cpu", "--requests", "4"]
    want = [(r.rid, r.out) for r in serve.main(argv)]
    got = [(r.rid, r.out) for r in serve.main(argv + ["--mesh"])]
    assert got == want
    assert "mesh {'data': 1, 'model': 1}" in capsys.readouterr().out
    assert not dist.is_initialized()


def test_rank0_print_is_print_without_a_mesh():
    assert mesh_mod.rank0_print(None) is print
