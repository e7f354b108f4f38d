"""Device ms a traced Phase-2 step spends in the plain attention's
forwards: the program's ``attention`` spans (one a call of
``nn/attention.py::_attend_full``: the student's, the teacher's and the
buffer's forwards and the blocks' remat recompute), timed by their CUDA
event pairs, summed over the traced steps and divided by the
``phase2.step`` spans.  The attention's own backward is not in it."""

UNIT = "ms"
SOURCE = "device_trace"
LAYER = "model, attention"
MOVES = "phase2_tokens_per_s"


def read(run):
    if run.kind != "phase2" or run.trace is None:
        return None
    try:
        from repro_torch import spans
    except ImportError:     # a program without spans
        return None
    rec = spans.recorded()
    steps = sum(s["name"] == "phase2.step" for s in rec)
    ms = [s["device_ms"] for s in rec if s["name"] == "attention"]
    if not steps or not ms or None in ms:
        return None
    return sum(ms) / steps
