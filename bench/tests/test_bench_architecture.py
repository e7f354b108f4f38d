"""A configuration brings its own architecture: the module its ``reference``
key names states the parameter tree, the widths and the FLOP counts and
holds the plain reference, and the runners, the weight draw and the counts
reach it only through ``spec.architecture``.

The counts and the tree are pinned at the two configurations' full sizes
(the values the harness counted before the counts went through the
module); a stub module that wraps the dense decoder and records its calls
shows that whole tiny runs go through the module; a module for serving
only is refused by a Phase-2 cell at set-up."""

import ast
import math
import textwrap

import bench_tiny
import pytest
import torch

from benchlib import flops, spec, weights
from benchlib.record import Run
from benchlib.trace import Trace
from runners import phase2, serve

CPU = torch.device("cpu")
DENSE = "reference/dense_decoder.py"
ALL = ("dims", "leaf_specs", "forward_flops", "prefill_flops",
       "decode_token_flops", "served_logit_gaps", "follow_steps")


def full_config(name):
    return spec.read_json(spec.BENCH / "configs" / f"{name}.json")


@pytest.mark.parametrize("name, step, prefill, decode, leaves", [
    ("granite-3-2b", 221283929292800.0, 7667176058880.0, 5558251520, 12),
    ("qwen3-14b", 1180434851430400.0, 40559943024640.0, 29208739840, 14)])
def test_counts_through_the_module(name, step, prefill, decode, leaves):
    conf = full_config(name)
    arch = spec.architecture(conf, *ALL[2:])
    assert conf["reference"] == DENSE
    k = weights.dims(conf)
    assert k == arch.dims(conf) and k["attn_layers"] == k["layers"] == 40
    assert flops.phase2_step_flops(k, 4, 2048, True,
                                   arch.forward_flops) == step
    assert arch.prefill_flops(k, 1500) == prefill
    assert arch.decode_token_flops(k, 1500) == decode
    assert len(weights.leaf_specs(conf)) == leaves


def test_granite_tree():
    sd, sf = 1 / math.sqrt(2048), 1 / math.sqrt(8192)
    b = ("blocks", "b0")
    want = [(("embed", "table"), (49408, 2048), 0.02),
            (b + ("ln1", "scale"), (40, 2048), "ones"),
            (b + ("mixer", "wq"), (40, 2048, 32, 64), sd),
            (b + ("mixer", "wk"), (40, 2048, 8, 64), sd),
            (b + ("mixer", "wv"), (40, 2048, 8, 64), sd),
            (b + ("mixer", "wo"), (40, 32, 64, 2048), sd),
            (b + ("ln2", "scale"), (40, 2048), "ones"),
            (b + ("mlp", "up", "w"), (40, 2048, 8192), sd),
            (b + ("mlp", "gate", "w"), (40, 2048, 8192), sd),
            (b + ("mlp", "down", "w"), (40, 8192, 2048), sf),
            (("ln_f", "scale"), (2048,), "ones"),
            (("unembed", "w"), (2048, 49408), sd)]
    assert weights.leaf_specs(full_config("granite-3-2b")) == want


def write_stub(tmp_path, functions):
    """A module that wraps the dense decoder's ``functions`` and records
    each call in ``CALLS``."""
    path = tmp_path / "recording_decoder.py"
    path.write_text(textwrap.dedent(f"""\
        from benchlib import spec

        BASE = spec.architecture({{"reference": {DENSE!r}}})
        CALLS = []


        def _wrap(name):
            def call(*args, **kwargs):
                CALLS.append(name)
                return getattr(BASE, name)(*args, **kwargs)
            return call


        for _name in {tuple(functions)!r}:
            globals()[_name] = _wrap(_name)
        """))
    return str(path)


def stub_cell(name, tmp_path, functions=ALL):
    cell = bench_tiny.tiny_cell(name)
    cell.config["reference"] = write_stub(tmp_path, functions)
    return cell, spec.architecture(cell)


def test_phase2_run_goes_through_the_module(tmp_path):
    """The stub's run reads what the dense decoder's own run reads."""
    cell, stub = stub_cell("granite-3-2b.phase2-bkd", tmp_path)
    rec, _, checks = phase2.run(cell, 2**31 + 41, 0.05, False, CPU, 0.0)
    assert {"dims", "leaf_specs", "forward_flops",
            "follow_steps"} <= set(stub.CALLS)
    cell.config["reference"] = DENSE
    want, _, want_checks = phase2.run(cell, 2**31 + 41, 0.05, False, CPU,
                                      0.0)
    assert checks == want_checks
    assert rec.dims == want.dims
    assert rec.step_flops == want.step_flops > 0


def test_serve_run_goes_through_the_module(tmp_path):
    cell, stub = stub_cell("qwen3-14b.serve-longprompt", tmp_path)
    cell.traffic.update(output_len={"dist": "strata", "lo": 2, "hi": 5},
                        blocks=1000)
    rec, ok, checks = serve.run(cell, 2**31 + 42, 0.3, False, CPU, 0.0)
    assert ok, checks
    assert {"dims", "leaf_specs", "prefill_flops", "decode_token_flops",
            "served_logit_gaps"} <= set(stub.CALLS)
    assert "follow_steps" not in stub.CALLS
    k = stub.BASE.dims(cell.config)
    assert rec.flops == sum(
        sum(stub.BASE.prefill_flops(k, p) for p in t["prompts"])
        + sum(stub.BASE.decode_token_flops(k, c) for c in t["rows"])
        for t in rec.ticks) > 0


def test_serving_only_module_refused_by_a_phase2_cell(tmp_path):
    serving = [f for f in ALL if f != "follow_steps"]
    cell, stub = stub_cell("granite-3-2b.phase2-kd", tmp_path, serving)
    with pytest.raises(ValueError, match="follow_steps"):
        phase2.run(cell, 2**31 + 43, 0.05, False, CPU, 0.0)
    # refused before anything was drawn or counted
    assert "leaf_specs" not in stub.CALLS
    assert "forward_flops" not in stub.CALLS


def test_no_shared_file_names_an_architecture():
    """Nothing under ``runners/`` or ``benchlib/``, nor ``calibrate.py``,
    imports the reference package or names one of its modules."""
    stems = {p.stem for p in (spec.BENCH / "reference").glob("*.py")
             if p.stem != "__init__"}
    assert "dense_decoder" in stems
    files = (sorted((spec.BENCH / "runners").glob("*.py"))
             + sorted((spec.BENCH / "benchlib").glob("*.py"))
             + [spec.BENCH / "calibrate.py"])
    for f in files:
        text = f.read_text()
        assert not [s for s in stems if s in text], f
        for node in ast.walk(ast.parse(text)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            assert not [n for n in names
                        if n.split(".")[0] == "reference"], f


def serve_run(dims):
    """A traced serving run: two ticks over 1,000 and 3,000 cache rows of
    8 slots, 40 ``swa_decode`` calls a tick of 10 us each."""
    run = Run(kind="serve", dims=dims, traffic={"engine": {"slots": 8}})
    run.trace_ticks = [{"rows": [1000]}, {"rows": [1500, 1500]}]
    run.trace = Trace(window_s=1.0, busy_s=0.5, idle_gaps={},
                      kernels={"swa_split_kernel": [1e-5] * 80})
    return run


def test_decode_roofline_counts_attention_layers():
    reader = spec.metric_reader("decode_attn_roofline.serve")
    k = {"layers": 40, "attn_layers": 40, "n": 8, "h": 40, "hd": 128}
    got = reader.read(serve_run(k))
    want = 40 * (flops.swa_decode_bound(1000, 8, 8, 5, 128, 2)
                 + flops.swa_decode_bound(3000, 8, 8, 5, 128, 2))
    assert got == pytest.approx(100 * want / 8e-4)
    # half the blocks run attention: half the least time on the same
    # kernels' time
    assert reader.read(serve_run(dict(k, attn_layers=20))) == (
        pytest.approx(got / 2))
