"""The port's LLM driver (``repro_torch.launch.train.main``) against the JAX
package's (``repro.launch.train.main``) on granite's SMOKE config on the
CPU, from one JAX-initialised start state (``Transformer.init``
monkeypatched in both packages to the carried parameters): each method the
driver runs (bkd, kd, melting with its re-clones, ema, fedavg, and bkd
with int8 uplink transport) over two rounds of three AdamW steps a phase.

Both drivers print each phase's loss and the final NLL with four decimals;
every printed number is held within 2e-4 (one unit of the last printed
digit on either side; the f32 losses themselves agree to about 1e-6) and
the transport summary line is equal.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the GPU machine has no JAX: nothing to compare

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.mesh import make_test_mesh, mesh_context  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

ARCH = "granite-3-2b"
ARGV = ["--arch", ARCH, "--rounds", "2", "--edges", "2",
        "--steps-per-phase", "3", "--batch", "2", "--seq", "16"]
PRINT_TOL = 2e-4
NUMBER = re.compile(r"(loss|kd|domain)[=:] ?(-?\d+\.\d+)")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg = jregistry.get_smoke_config(ARCH)
    with mesh_context(make_test_mesh()):
        init = jax.jit(lambda key: JTransformer.init(jcfg, key)[0])
        return jax.tree.map(np.asarray, init(jax.random.key(4)))


def _numbers(out):
    """(name, value) of every number the driver printed, in order."""
    return [(m.group(1), float(m.group(2))) for m in NUMBER.finditer(out)]


def _run_both(weights, argv, monkeypatch, capsys):
    monkeypatch.setattr(JTransformer, "init", staticmethod(
        lambda cfg, key: (jax.tree.map(jnp.asarray, weights), None)))
    monkeypatch.setattr(Transformer, "init", staticmethod(
        lambda cfg, seed=0, *, device="cuda": params_from_numpy(weights,
                                                                device)))
    capsys.readouterr()
    jtrain.main(ARGV + argv)
    want = capsys.readouterr().out
    train.main(ARGV + argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    return got, want


@pytest.mark.parametrize("argv", [
    ["--method", "bkd"], ["--method", "kd"], ["--method", "melting"],
    ["--method", "ema"], ["--method", "fedavg"],
    ["--method", "bkd", "--transport", "int8"],
    ["--method", "bkd", "--loss-backend", "pallas",
     "--scenario", "alternate"]],
    ids=["bkd", "kd", "melting", "ema", "fedavg", "bkd-int8",
         "bkd-pallas-alternate"])
def test_per_round_losses_match_the_jax_driver(weights, argv, monkeypatch,
                                               capsys):
    got, want = _run_both(weights, argv, monkeypatch, capsys)
    mine, theirs = _numbers(got), _numbers(want)
    assert [k for k, _ in mine] == [k for k, _ in theirs], (got, want)
    assert len(mine) >= 4
    for (key, a), (_, b) in zip(mine, theirs):
        assert abs(a - b) <= PRINT_TOL, (key, a, b, got, want)
    for line in ("aggregated", "withdrawn", "transport="):
        assert [l for l in got.splitlines() if line in l] == \
            [l for l in want.splitlines() if line in l]
    stale = re.compile(r"edge \d+ trained( stale=\S+)?,")
    assert stale.findall(got) == stale.findall(want)
