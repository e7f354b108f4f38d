"""The port's mesh dry-run (``repro_torch.launch.dryrun``), its sweep, the
roofline report and the op-trace tools, on the CPU against fake process
groups (nothing is allocated: every shard is a meta tensor).

SMOKE combos of train, prefill and decode run on the 16 x 16 mesh and give
the reference's JSON layout; the collective counter reads known
redistributions (all-gather, all-reduce at twice its payload,
reduce-scatter, all-to-all); a sharded matmul's per-device flops are 1/16
of the global ones; the roofline report renders a port dump and a
reference-format dump alike; the sweep's combo list is the reference's;
the op-trace histogram reads a probe.  Each test makes and destroys its own
process group.
"""

import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.benchmarks import hlo_tools, roofline  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun, sweep  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, mesh_context  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]

# The keys of the reference's run_one result (src/repro/launch/dryrun.py).
KEYS = {"arch", "shape", "mesh", "buffer_mode", "topk", "devices", "lower_s",
        "compile_s", "per_device", "roofline", "model_flops_per_device",
        "useful_flops_ratio", "params_total", "params_active", "bottleneck"}
PER_DEVICE = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
              "flops", "bytes_accessed", "collective_bytes",
              "collective_by_kind"}


@pytest.fixture
def smoke(monkeypatch):
    """Every combo at its arch's SMOKE config (2-4 layers, narrow)."""
    monkeypatch.setattr(registry, "for_shape",
                        lambda arch, shape: registry.get_smoke_config(arch))


@pytest.fixture
def mesh16():
    dryrun.fake_group(256)
    yield make_production_mesh()
    dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape", [("granite-3-2b", "train_4k"),
                                        ("granite-3-2b", "prefill_32k"),
                                        ("granite-3-2b", "decode_32k"),
                                        ("kimi-k2-1t-a32b", "decode_32k")])
def test_smoke_combos_give_the_reference_layout(smoke, arch, shape):
    res = dryrun.run_one(arch, shape, verbose=False)
    assert not dist.is_initialized()   # the group it made is gone
    assert set(res) == KEYS | {"param_bytes_per_device"}
    assert set(res["per_device"]) == PER_DEVICE
    assert set(res["roofline"]) == {"compute_s", "memory_s", "collective_s"}
    assert set(res["per_device"]["collective_by_kind"]) == set(
        dryrun._COLLECTIVES)
    assert res["devices"] == 256 and res["mesh"] == "16x16"
    pd = res["per_device"]
    assert pd["flops"] > 0 and pd["bytes_accessed"] > 0
    assert pd["peak_bytes"] == pd["argument_bytes"] + pd["temp_bytes"]
    assert res["bottleneck"] == max(res["roofline"],
                                    key=res["roofline"].get)
    json.dumps(res)


def test_collective_counter_reads_known_redistributions(mesh16):
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = mesh16
    local = torch.empty((4, 8), device="meta")      # f32, 128 bytes a shard
    counter = dryrun.DeviceCounter()
    with counter.mode():
        x = DTensor.from_local(local, mesh, [Shard(0), Replicate()],
                               run_check=False)
        x.redistribute(mesh, [Replicate(), Replicate()])         # all-gather
        part = torch.empty((32, 8), device="meta")      # 1024 bytes
        p = DTensor.from_local(part, mesh, [Partial(), Replicate()],
                               run_check=False)
        p.redistribute(mesh, [Replicate(), Replicate()])         # all-reduce
        p.redistribute(mesh, [Shard(0), Replicate()])        # reduce-scatter
        funcol.all_to_all_single(part, [2] * 16, [2] * 16, (mesh, 0))
    c = counter.coll
    assert c["all-gather"] == 16 * 4 * 8 * 4
    assert c["all-reduce"] == 2.0 * 32 * 8 * 4
    assert c["reduce-scatter"] == 32 * 8 * 4 / 16
    assert c["all-to-all"] == 32 * 8 * 4
    assert counter.flops == 0


def test_sharded_matmul_flops_are_a_sixteenth(mesh16):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    x = DTensor.from_local(torch.empty((16, 512), device="meta"), mesh16,
                           [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty((512, 1024), device="meta"), mesh16,
                           [Replicate(), Replicate()], run_check=False)
    counter = dryrun.DeviceCounter()
    with mesh_context(mesh16), counter.mode():
        y = x @ w
    assert tuple(y.shape) == (256, 1024)
    with FlopCounterMode(display=False) as fc:    # counts the global op
        torch.empty((256, 512), device="meta") @ torch.empty(
            (512, 1024), device="meta")
    assert counter.flops * 16 == fc.get_total_flops() == 2 * 256 * 512 * 1024


def test_roofline_renders_port_and_reference_dumps_alike(smoke, tmp_path,
                                                         capsys):
    port = dryrun.run_one("granite-3-2b", "decode_32k", verbose=False)
    ref = {"arch": "ref-arch", "shape": "train_4k", "mesh": "16x16",
           "buffer_mode": "clone", "topk": None, "devices": 256,
           "lower_s": 1.0, "compile_s": 2.0,
           "per_device": {"argument_bytes": 10, "output_bytes": 0,
                          "temp_bytes": 5, "peak_bytes": 15, "flops": 1.0,
                          "bytes_accessed": 2.0, "collective_bytes": 3.0,
                          "collective_by_kind": {}},
           "roofline": {"compute_s": 0.001, "memory_s": 0.002,
                        "collective_s": 0.004},
           "model_flops_per_device": 1.0, "useful_flops_ratio": 0.5,
           "params_total": 1, "params_active": 1,
           "bottleneck": "collective_s"}
    for name, r in (("port.json", port), ("ref.json", ref),
                    ("_summary.json", [])):
        (tmp_path / name).write_text(json.dumps(r))
    rows = roofline.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert [r["arch"] for r in rows] == ["granite-3-2b", "ref-arch"]
    assert "| ref-arch | train_4k | 16x16 | 1.0 | 2.0 | 4.0 | **collective**" \
        in out
    assert f"| granite-3-2b | decode_32k | 16x16 | " in out
    assert "roofline_ref-arch_train_4k_16x16,4000,bottleneck=collective_s" \
        in out
    assert "roofline_granite-3-2b_decode_32k_16x16," in out


def test_sweep_combo_list_equals_the_reference():
    jsweep = pytest.importorskip("repro.launch.sweep")
    # the same combos; the two registries list their archs in other orders
    assert sorted(sweep.combo_list()) == sorted(jsweep.combo_list())
    assert len(sweep.combo_list()) == 76
    assert [(a, s) for a, s, mp in sweep.combo_list() if not mp] == \
        dryrun.ALL_DEFAULT_COMBOS
    assert len(dryrun.ALL_DEFAULT_COMBOS) == 38


def test_sweep_logs_a_failure_and_exits_one(tmp_path, monkeypatch):
    monkeypatch.setattr(sweep, "combo_list",
                        lambda: [("no-such-arch", "train_4k", False)])
    assert sweep.main(["--out", str(tmp_path), "-j", "1"]) == 1
    assert (tmp_path / "no-such-arch_train_4k_16x16.FAILED.log").exists()
    summary = json.loads((tmp_path / "_summary.json").read_text())
    assert summary[0][:2] == ["no-such-arch_train_4k_16x16", "FAILED"]


def test_hlo_tools_histograms_a_probe(smoke, capsys):
    trace = hlo_tools.main(["--arch", "granite-3-2b", "--shape",
                            "decode_32k", "--layers", "1", "--top", "5"])
    assert not dist.is_initialized()
    hist = hlo_tools.op_histogram(trace, 5)
    assert len(hist) == 5 and all(b > 0 for _, b in hist)
    colls = hlo_tools.biggest_collectives(trace, 3)
    assert colls and all(kind in dryrun._COLLECTIVES
                         for _, kind, _, _, _ in colls)
    assert "== largest collectives ==" in capsys.readouterr().out
    assert set(hlo_tools.ar_dtype_mix(trace)) <= {"float32", "bfloat16"}


def test_only_the_dry_run_uses_the_fake_process_group():
    import importlib
    importlib.import_module("torch.testing._internal.distributed.fake_pg")
    users = [p.relative_to(REPO).as_posix()
             for p in (REPO / "src" / "repro_torch").rglob("*.py")
             if "torch.testing._internal" in p.read_text()]
    assert users == ["src/repro_torch/launch/dryrun.py"]
