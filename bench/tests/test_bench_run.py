"""``bench/run.py`` refuses to run without a card, and the manifest keeps
to the benchmark's manifest format."""

import json
import re
import subprocess
import sys

import bench_tiny  # noqa: F401
import pytest
import torch

from benchlib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_no_card_no_result():
    """No fallback to the CPU: exit code 2 and nothing on stdout."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, str(spec.BENCH / "run.py"), "--workload",
         "granite-3-2b.phase2-bkd", "--seed", str(2**31 + 11), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=spec.ROOT)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_manifest_format():
    m = spec.load_manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["bench"] and 1 <= m["run_seconds"] <= 51
    names = [c["name"] for c in m["configs"]]
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and NAME.match(c["name"])
        assert (spec.ROOT / c["file"]).is_file()
        conf = spec.read_json(spec.ROOT / c["file"])
        assert conf["source"] == c["source"]
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    cells = [w["name"] for w in m["workloads"]]
    assert len(set(cells)) == len(cells)
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["name"])
        cell = spec.cell(w["name"], m)
        assert {x["name"] for x in cell.end_to_end} - {"setup_s"}
        assert cell.per_layer and cell.limits
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
        reader = spec.metric_reader(x["name"])
        assert reader.UNIT == x["unit"] and reader.SOURCE == x["source"]
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] == "host_clock"
    for x in m["per_layer"]:
        assert x["moves"] in e2e and x["layer"] == spec.metric_reader(
            x["name"]).LAYER
        assert set(x["workloads"]) <= set(cells)
    assert len(json.dumps(m)) < 64 * 1024
