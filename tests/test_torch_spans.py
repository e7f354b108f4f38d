"""The port's spans (``repro_torch.spans``): off by default, where they
enter no ``record_function`` and record nothing; on under
``torch.profiler`` and inside ``spans.recording()``, where the Phase-2
step, the attention and the serving engine's admission and decode appear
by name in the record and in the profiler's trace.  Also the engine's
per-token stamps, which ``launch/serve.py::summarize`` reads."""

import json

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch import optim, spans
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.launch.serve import summarize
from repro_torch.models.transformer import Transformer
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import bucket_length
from repro_torch.serve.streams import Request

PHASES = ["phase2.forward", "phase2.backward", "phase2.optimizer"]


@pytest.fixture(scope="module")
def cfg():
    return registry.get_smoke_config("granite-3-2b")


def _phase2(cfg, buffer_mode="clone"):
    """A SMOKE Phase-2 step and its arguments (fresh trees: the step updates
    the student and the optimizer state in place)."""
    opt = optim.adamw(3e-4)
    step = steps.make_phase2_step(cfg, opt, buffer_mode=buffer_mode,
                                  loss_chunk=16)
    student = Transformer.init(cfg, 0, device="cpu")
    teacher = Transformer.init(cfg, 1, device="cpu")
    buffer = (Transformer.init(cfg, 0, device="cpu")
              if buffer_mode == "clone" else None)
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen)
    batch = {"tokens": ids[:, :-1].contiguous(),
             "labels": ids[:, 1:].contiguous()}
    return lambda: step(student, teacher, buffer, opt.init(student), batch, 0)


def _engine(cfg, slots=4):
    params = Transformer.init(cfg, 0, device="cpu")
    return ServeEngine(cfg, params, slots=slots, max_len=64, device="cpu")


def _requests(lengths_arrivals, max_new=3):
    rng = np.random.default_rng(0)
    return [Request(rid=i, arrival=a, max_new=max_new,
                    prompt=rng.integers(0, 500, size=n).astype(np.int32))
            for i, (n, a) in enumerate(lengths_arrivals)]


def _empty_session():
    with spans.recording():
        pass
    assert spans.recorded() == []


class _Counting:
    """Stands in for ``record_function`` and counts its construction."""

    calls = 0

    def __init__(self, name, args=None):
        type(self).calls += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_off_records_nothing_and_enters_no_record_function(cfg, monkeypatch):
    monkeypatch.setattr(autograd_profiler, "record_function", _Counting)
    _empty_session()
    assert spans.span("a") is spans.span("b", n=1)   # one shared no-op
    _phase2(cfg)()
    engine = _engine(cfg)
    engine.begin(_requests([(5, 0), (9, 0)]))
    engine.tick()
    engine.tick()
    assert _Counting.calls == 0
    assert spans.recorded() == []


@pytest.mark.parametrize("buffer_mode,forwards", [("clone", 3), ("none", 2)])
def test_phase2_step_under_the_profiler(cfg, buffer_mode, forwards, tmp_path):
    """One ``phase2.step`` whose children are the forward, the backward and
    the optimizer in that order; one ``attention`` span a layer for each
    forward and for the backward's remat recompute; every span a
    ``user_annotation`` of the Chrome trace inside the step's interval."""
    run = _phase2(cfg, buffer_mode)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    rec = spans.recorded()
    (step,) = [s for s in rec if s["name"] == "phase2.step"]
    assert step["parent"] is None
    children = [s for s in rec if s["parent"] == step["id"]]
    assert [s["name"] for s in children] == PHASES
    backward = children[1]
    attention = [s for s in rec if s["name"] == "attention"]
    assert len(attention) == cfg.num_layers * (forwards + 1)
    # on the CPU autograd recomputes on the calling thread
    assert sum(s["parent"] == backward["id"]
               for s in attention) == cfg.num_layers
    assert {s["name"] for s in rec} == {"phase2.step", "attention", *PHASES}
    for s in rec:
        assert s["device_ms"] is None and s["host_ms"] > 0
        assert step["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= step["t1_ns"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    (outer,) = [e for e in notes if e["name"] == "phase2.step"]
    counts = {}
    for e in notes:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
        assert outer["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    want = {}
    for s in rec:
        want[s["name"]] = want.get(s["name"], 0) + 1
    assert counts == want


def test_admission_counts_and_tick_spans(cfg):
    """Three prompts admitted together at the bucket of the longest, a
    fourth alone later: each ``serve.admit`` counts the real prompt tokens
    and slots x bucket positions, and holds one ``serve.prefill``; every
    tick that decoded holds ``serve.decode`` then ``serve.decode_read``."""
    engine = _engine(cfg, slots=4)
    reqs = _requests([(5, 0), (11, 0), (3, 0), (20, 2)], max_new=6)
    with spans.recording():
        finished = engine.run(reqs)
    rec = spans.recorded()
    admits = [s for s in rec if s["name"] == "serve.admit"]
    assert [s["counts"] for s in admits] == [
        {"rows": 3, "prompt_tokens": 19, "positions": 4 * bucket_length(11),
         "rids": [0, 1, 2]},
        {"rows": 1, "prompt_tokens": 20, "positions": 4 * bucket_length(20),
         "rids": [3]}]
    ticks = [s for s in rec if s["name"] == "serve.tick"]
    assert len(ticks) == engine.ticks
    tick_ids = {s["id"] for s in ticks}
    assert all(s["parent"] in tick_ids for s in admits)
    for a in admits:
        assert [s["name"] for s in rec
                if s["parent"] == a["id"]] == ["serve.prefill"]
    decodes = 0
    for t in ticks:
        names = [s["name"] for s in rec if s["parent"] == t["id"]
                 and s["name"] != "serve.admit"]
        assert names in ([], ["serve.decode", "serve.decode_read"])
        decodes += bool(names)
    assert decodes == engine.decode_ticks
    for r in finished:
        assert len(r.t_tokens) == len(r.out) == r.max_new
        assert r.t_tokens[0] == r.t_first and r.t_tokens[-1] == r.t_done
        assert r.t_tokens == sorted(r.t_tokens)


def test_summarize_takes_every_gap():
    """ITL percentiles over every gap between a request's token stamps, not
    over each request's mean gap."""
    a = Request(rid=0, arrival=0, prompt=np.zeros(3, np.int32), max_new=4,
                out=[1, 2, 3, 4], t_enqueue=0.0, t_first=0.0, t_done=10.0,
                t_tokens=[0.0, 1.0, 2.0, 10.0])
    b = Request(rid=1, arrival=0, prompt=np.zeros(3, np.int32), max_new=2,
                out=[1, 2], t_enqueue=0.0, t_first=1.0, t_done=1.5,
                t_tokens=[1.0, 1.5])
    c = Request(rid=2, arrival=0, prompt=np.zeros(3, np.int32), max_new=1,
                out=[1], t_enqueue=0.0, t_first=2.0, t_done=2.0,
                t_tokens=[2.0])
    stats = summarize([a, b, c], 10.0)
    gaps = [1.0, 1.0, 8.0, 0.5]
    assert stats["itl_p50_ms"] == round(float(np.percentile(gaps, 50)) * 1e3,
                                        3) == 1000.0
    assert stats["itl_p99_ms"] == round(float(np.percentile(gaps, 99)) * 1e3,
                                        3) == 7790.0
    assert stats["ttft_p50_ms"] == 1000.0
    assert summarize([c], 1.0)["itl_p99_ms"] is None


def test_nesting_counts_and_an_exception():
    with spans.recording():
        with spans.span("a", n=2):
            with spans.span("b"):
                pass
            with pytest.raises(KeyError):
                with spans.span("c"):
                    raise KeyError("x")
        with spans.span("d"):
            pass
    rec = spans.recorded()
    a, b, c, d = rec
    assert [s["name"] for s in rec] == ["a", "b", "c", "d"]
    assert (a["parent"], b["parent"], c["parent"], d["parent"]) == (
        None, a["id"], a["id"], None)
    assert a["counts"] == {"n": 2} and b["counts"] == {}
    assert a["t0_ns"] <= b["t0_ns"] <= b["t1_ns"] <= c["t0_ns"] <= a["t1_ns"]
    assert all(s["host_ms"] >= 0 and s["device_ms"] is None for s in rec)


def test_a_session_is_the_latest_one():
    """Under the profiler a session runs from the first span after the last
    read; a ``recording()`` block is a session of its own; reading inside
    one keeps it open."""
    for names in (["x", "y"], ["z"]):
        with profile(activities=[ProfilerActivity.CPU]):
            for n in names:
                with spans.span(n):
                    pass
        assert [s["name"] for s in spans.recorded()] == names
        assert [s["name"] for s in spans.recorded()] == names
    with spans.recording():
        with spans.span("p"):
            pass
        assert [s["name"] for s in spans.recorded()] == ["p"]
        with spans.recording():
            with spans.span("q"):
                pass
    assert [s["name"] for s in spans.recorded()] == ["p", "q"]
    with spans.span("off"):
        pass
    assert [s["name"] for s in spans.recorded()] == ["p", "q"]


def test_a_session_keeps_its_first_spans(monkeypatch):
    monkeypatch.setattr(spans, "LIMIT", 3)
    with spans.recording():
        with pytest.warns(UserWarning, match="first 3 spans"):
            for i in range(5):
                with spans.span(f"s{i}"):
                    pass
    assert [s["name"] for s in spans.recorded()] == ["s0", "s1", "s2"]
