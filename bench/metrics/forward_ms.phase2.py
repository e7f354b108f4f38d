"""Device ms a traced Phase-2 step spends in its forward (the student's,
the teacher's and the buffer's, and the chunked loss's): the program's
``phase2.forward`` spans, timed by their CUDA event pairs, summed over the
traced steps and divided by the ``phase2.step`` spans."""

UNIT = "ms"
SOURCE = "device_trace"
LAYER = "Phase-2 step"
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
    ms = [s["device_ms"] for s in rec if s["name"] == "phase2.forward"]
    if not steps or not ms or None in ms:
        return None
    return sum(ms) / steps
