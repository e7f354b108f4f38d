"""Share of the positions the traced admissions' prefills computed that
held a real prompt token: 100 x the ``prompt_tokens`` over the
``positions`` (slots x padded length) that the program's ``serve.admit``
spans count."""

UNIT = "%"
SOURCE = "program_counter"
LAYER = "model step"
MOVES = "ttft_p50_ms"


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    try:
        from repro_torch import spans
    except ImportError:     # a program without spans
        return None
    admits = [s["counts"] for s in spans.recorded()
              if s["name"] == "serve.admit"]
    positions = sum(c["positions"] for c in admits)
    if not positions:
        return None
    return 100 * sum(c["prompt_tokens"] for c in admits) / positions
