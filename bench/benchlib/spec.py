"""The benchmark's data: the manifest (``BENCHMARK.json``), one file a
configuration, one a traffic mix, one a cell's correctness limits, and one
reader a metric, each found by its name; and one architecture module a
configuration, found by the path in its ``reference`` key.

A cell names a configuration and a traffic mix; nothing here knows any of
them by name, so a new cell, configuration, architecture, mix or metric is
a new file.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads``, with everything its files hold."""

    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict          # the configuration file as run
    traffic: dict         # the traffic file
    limits: dict          # the cell's correctness limits
    end_to_end: list      # manifest metric entries this cell reports
    per_layer: list


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """A metric with a ``workloads`` key is reported in those cells; one
    without it in every cell (end to end) or in every cell that reports
    the end-to-end metric it moves (per layer)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name: str, manifest: dict | None = None) -> Cell:
    """The cell ``name`` of the manifest, its files read."""
    manifest = manifest or load_manifest()
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r}; known: {sorted(entries)}")
    w = entries[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if _reports(m, name, names)]
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                chips=w["chips"], config=read_json(ROOT / conf["file"]),
                traffic=read_json(BENCH / "workloads" / f"{w['traffic']}.json"),
                limits=read_json(BENCH / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """The module ``metrics/<name>.py``: its ``read(run)`` returns the
    metric's value, or None where the run holds nothing to read."""
    return _load(BENCH / "metrics" / f"{name}.py", f"bench_metric_{name}")


_ARCHITECTURES = {}


def architecture(cell_or_conf, *needs: str):
    """The architecture module of a configuration (or of a cell's): the
    file its ``reference`` key names, relative to ``bench/``, loaded once
    a process.  It provides ``dims``, ``leaf_specs``, the FLOP counts and
    the plain reference (the docstrings under ``reference/`` say what each
    takes and returns); ``needs`` names further functions the caller
    runs, and a module without one of them is refused here, at set-up.
    The module is handed the yardstick's formulas as its ``flops``
    attribute, so that it imports nothing but torch and the standard
    library."""
    conf = getattr(cell_or_conf, "config", cell_or_conf)
    path = (BENCH / conf["reference"]).resolve()
    if path not in _ARCHITECTURES:
        from benchlib import flops
        module = _load(path, f"bench_arch_{path.stem}")
        module.flops = flops
        _ARCHITECTURES[path] = module
    module = _ARCHITECTURES[path]
    missing = [f for f in ("dims", "leaf_specs") + needs
               if not callable(getattr(module, f, None))]
    if missing:
        raise ValueError(f"architecture module {conf['reference']} has no "
                         f"{', '.join(missing)}")
    return module
