"""The readers of the program's spans on hand-made span records: None on a
run without a trace, on a run of the other kind and where no span was
recorded, and the value each metric's docstring defines on a record whose
numbers are chosen by hand."""

import bench_tiny  # noqa: F401
import pytest

from benchlib import spec
from benchlib.record import Run

PHASE2 = ["forward_ms.phase2", "backward_ms.phase2", "optimizer_ms.phase2",
          "attention_fwd_ms.phase2"]
SERVE = ["prefill_useful.serve", "prefill_ms.serve", "decode_issue_ms.serve",
         "decode_wait_ms.serve"]


def s(name, id, parent=None, host_ms=0.0, device_ms=None, **counts):
    return {"name": name, "id": id, "parent": parent, "t0_ns": 0,
            "t1_ns": int(host_ms * 1e6), "host_ms": host_ms,
            "device_ms": device_ms, "counts": counts}


def phase2_record():
    """Two steps: forward 10 + 12, backward 20 + 22, optimizer 1 + 3 ms,
    attention 2 ms in each of four calls a step."""
    rec = []
    for k, (f, b, o) in enumerate([(10.0, 20.0, 1.0), (12.0, 22.0, 3.0)]):
        base = 100 * k
        rec += [s("phase2.step", base, device_ms=f + b + o),
                s("phase2.forward", base + 1, base, device_ms=f),
                s("attention", base + 2, base + 1, device_ms=2.0),
                s("attention", base + 3, base + 1, device_ms=2.0),
                s("attention", base + 4, base + 1, device_ms=2.0),
                s("phase2.backward", base + 5, base, device_ms=b),
                s("attention", base + 6, None, device_ms=2.0),
                s("phase2.optimizer", base + 7, base, device_ms=o)]
    return rec


def serve_record():
    """Three ticks: one admits two groups (positions 64 and 32, real tokens
    19 and 4) and decodes; two only decode (issue 50 and 70 ms, reads 2 and
    6 ms); the admitting tick's decode (issue 90, read 1) is left out."""
    return [
        s("serve.tick", 1, host_ms=3000.0),
        s("serve.admit", 2, 1, prompt_tokens=19, positions=64, rows=3,
          rids=[0, 1, 2]),
        s("serve.prefill", 3, 2, device_ms=1500.0),
        s("serve.admit", 4, 1, prompt_tokens=4, positions=32, rows=1,
          rids=[3]),
        s("serve.prefill", 5, 4, device_ms=500.0),
        s("serve.decode", 6, 1, host_ms=90.0),
        s("serve.decode_read", 7, 1, host_ms=1.0),
        s("serve.tick", 8, host_ms=60.0),
        s("serve.decode", 9, 8, host_ms=50.0),
        s("serve.decode_read", 10, 8, host_ms=2.0),
        s("serve.tick", 11, host_ms=80.0),
        s("serve.decode", 12, 11, host_ms=70.0),
        s("serve.decode_read", 13, 11, host_ms=6.0),
        s("serve.prefill", 14, 99, device_ms=900.0)]


WANT = {"forward_ms.phase2": 11.0, "backward_ms.phase2": 21.0,
        "optimizer_ms.phase2": 2.0, "attention_fwd_ms.phase2": 8.0,
        "prefill_useful.serve": 100 * 23 / 96, "prefill_ms.serve": 900.0,
        "decode_issue_ms.serve": 60.0, "decode_wait_ms.serve": 4.0}


def run_of(kind, traced):
    run = Run(kind=kind, dims={}, traffic={})
    if traced:
        run.trace = object()
    return run


@pytest.fixture
def record(monkeypatch):
    from repro_torch import spans
    held = []
    monkeypatch.setattr(spans, "recorded", lambda: list(held))
    return held


@pytest.mark.parametrize("name", PHASE2 + SERVE)
def test_reader(name, record):
    reader = spec.metric_reader(name)
    kind, other = (("phase2", "serve") if name in PHASE2
                   else ("serve", "phase2"))
    record += phase2_record() + serve_record()
    assert reader.read(run_of(kind, traced=False)) is None
    assert reader.read(run_of(other, traced=True)) is None
    assert reader.read(run_of(kind, traced=True)) == pytest.approx(WANT[name])
    record.clear()
    assert reader.read(run_of(kind, traced=True)) is None


@pytest.mark.parametrize("name", PHASE2 + ["prefill_ms.serve"])
def test_no_device_times_no_value(name, record):
    """Spans recorded without CUDA carry no device ms: no device metric."""
    reader = spec.metric_reader(name)
    kind = "phase2" if name in PHASE2 else "serve"
    record += [dict(x, device_ms=None)
               for x in phase2_record() + serve_record()]
    assert reader.read(run_of(kind, traced=True)) is None


@pytest.mark.parametrize("name", PHASE2 + SERVE)
def test_a_program_without_spans(name, monkeypatch):
    """On a program that has no ``repro_torch.spans`` a reader returns None
    and does not raise."""
    import sys

    import repro_torch
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    monkeypatch.delattr(repro_torch, "spans", raising=False)
    with pytest.raises(ImportError):
        from repro_torch import spans  # noqa: F401
    kind = "phase2" if name in PHASE2 else "serve"
    assert spec.metric_reader(name).read(run_of(kind, traced=True)) is None
