"""The KD kernels' arithmetic bodies, read from their SASS.

Builds ``csrc/kd_loss.cu`` and disassembles it (``cuobjdump -sass``).  In
each bf16, with-buffer instance (exact and quant teacher) the shortest of
the basic blocks holding the most ``MUFU.EX2`` is the body: in
``kd_stats_block_kernel`` one chunk's tile of 16 columns a lane, in
``kd_grad_kernel`` (the vector body of the default launch) one 16-byte
vector's 8 logits, from its loaded registers to its store (the loads, the
row data and the index steps are outside it).  Prints its instructions and
ex2 a logit and the two compute floors they set at the LLM shape (512 x
49,155): warp instructions over 4 schedulers an SM, and ex2 over 16 MUFU
lanes an SM, at the card's largest SM clock.  Needs the card and the
toolkit:

    PYTHONPATH=src python -m repro_torch.benchmarks.kd_sass
"""

from __future__ import annotations

import subprocess

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import kd_loss as kd_mod

ROWS, V = 512, 49155
# Fragments of the mangled names: T = __nv_bfloat16, kBuffer = true (and for
# the backward W = 8: the LLM shape's launch), and the logits a body.
_BWD = "Lb1ELi8E"
_TILE = kd_mod.plan(ROWS, V).tile  # the forward's columns a lane a chunk
KERNELS = {"kd_stats_fwd": (("kd_stats_block_kernel", "13__nv_bfloat16",
                             "ExactTeacher", "Lb1E"), _TILE),
           "kd_quant_stats_fwd": (("kd_stats_block_kernel", "13__nv_bfloat16",
                                   "QuantTeacher", "Lb1E"), _TILE),
           "kd_grad_bwd": (("kd_grad_kernel", "13__nv_bfloat16",
                            "ExactTeacher", _BWD), 8),
           "kd_quant_grad_bwd": (("kd_grad_kernel", "13__nv_bfloat16",
                                  "QuantTeacher", _BWD), 8)}


def _blocks(sass: str, parts) -> list[list[str]]:
    """The basic blocks (lists of opcodes) of the function whose mangled
    name holds every fragment of ``parts``."""
    blocks, fn, cur = [], None, []
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            blocks.append(cur)
            cur = []
        elif fn and all(k in fn for k in parts):
            text = line.strip()
            if text.startswith(".L_"):
                blocks.append(cur)
                cur = []
            elif text.startswith("/*") and ";" in text:
                op = text.split("*/", 1)[1].split(";")[0].strip()
                cur.append(op)
                if " BRA" in f" {op}" or "EXIT" in op or "BAR.SYNC" in op:
                    blocks.append(cur)
                    cur = []
    blocks.append(cur)
    return [b for b in blocks if b]


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60)
    mhz = float(clock.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = kbuild.build("kd_loss")
    out = subprocess.run([kbuild.toolkit_bin("cuobjdump"), "-sass", str(lib)],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    for name, (parts, tile) in KERNELS.items():
        blocks = _blocks(out.stdout, parts)
        if not blocks:
            raise SystemExit(f"no SASS function matches {parts}")
        ex2 = max(sum("MUFU.EX2" in op for op in b) for b in blocks)
        body = min((b for b in blocks
                    if sum("MUFU.EX2" in op for op in b) == ex2), key=len)
        per_logit, ex2_logit = len(body) / tile, ex2 / tile
        issue_ms = per_logit * ROWS * V / (32 * 4 * sms * mhz * 1e6) * 1e3
        mufu_ms = ex2_logit * ROWS * V / (16 * sms * mhz * 1e6) * 1e3
        print(f"{name} bf16 with buffer: body {len(body)} instructions, "
              f"{ex2} MUFU.EX2 for {tile} columns = {per_logit:.2f} "
              f"instructions and {ex2_logit:.2f} ex2 a logit; floors at "
              f"{ROWS} x {V} ({sms} SMs, {mhz:.0f} MHz): issue "
              f"{issue_ms:.5f} ms, MUFU {mufu_ms:.5f} ms")


if __name__ == "__main__":
    main()
