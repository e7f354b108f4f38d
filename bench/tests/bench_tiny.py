"""Tiny copies of the benchmark's cells for the CPU tests: the cell's own
files with the widths and depth of the program's SMOKE configurations
and short traffic, so that a whole run (set-up, window, reference) takes
seconds on the CPU."""

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import spec  # noqa: E402

# The SMOKE widths (repro_torch.configs.granite_3_2b.SMOKE and
# qwen3_14b.SMOKE share them) with a vocabulary that needs padding, and a
# quarter of them for whole runs, which each test repeats a few times.
SMOKE = dict(d=256, ff=512, hd=64)
RUN = dict(d=64, ff=128, hd=16)


def tiny_config(conf, d=256, ff=512, hd=64):
    c = copy.deepcopy(conf)
    c.update(hidden_size=d, intermediate_size=ff, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=hd,
             vocab_size=500)
    if "attention_multiplier" in c:
        c["attention_multiplier"] = hd ** -0.5
    c["program"].update(num_layers=2, d_model=d, num_heads=4, kv_heads=2,
                        head_dim=hd, d_ff=ff, vocab_size=500, q_chunk=16)
    return c


def tiny_cell(name):
    cell = spec.cell(name)
    cell.config = tiny_config(cell.config, **RUN)
    if cell.traffic["runner"] == "phase2":
        cell.traffic = dict(cell.traffic, batch=2, seq=32, loss_chunk=16,
                            trace_steps=1)
    else:
        cell.traffic = dict(
            cell.traffic, engine={"slots": 2, "max_len": 96, "paged": False},
            clients=2, blocks=8,
            prompt_len={"dist": "strata", "lo": 17, "hi": 30},
            output_len={"dist": "strata", "lo": 16, "hi": 40},
            trace_ticks=4, check={"requests": 4})
    return cell
