"""Run the port's dry-run matrix, or the FL scenario matrix, as parallel
subprocesses (``repro.launch.sweep``).

    PYTHONPATH=src python -m repro_torch.launch.sweep \
        --out experiments/dryrun -j 4
    PYTHONPATH=src python -m repro_torch.launch.sweep --scenarios \\
        --out experiments/scenarios -j 2 --device cpu

Default mode: each (arch x shape x mesh) combo runs
``repro_torch.launch.dryrun`` in its own process (a process holds one
default process group, and the dry-run's is a fake one of 256 or 512
ranks), writing one JSON per combo, a ``<tag>.FAILED.log`` per failure and
``_summary.json``; the exit code is 1 when a combo failed.

``--scenarios`` mode: every named scenario runs through
``repro_torch.launch.train`` (the two-level ``hier_*`` streams through
``repro_torch.benchmarks.scenarios``, which the LLM driver refuses), one
subprocess and one log per scenario, on ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def combo_list():
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import SHAPES
    out = []
    for a in registry.list_archs():
        for s in SHAPES:
            if registry.skip_reason(a, s) is None:
                for mp in (False, True):
                    out.append((a, s, mp))
    return out


def _repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


def _run_subprocess(tag, cmd, outdir, save_stdout_to=None, timeout=None):
    """Shared combo runner: a subprocess from the repo root with
    PYTHONPATH=src, a .FAILED.log on failure (a time-out included), and a
    (tag, status, seconds) result."""
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    t0 = time.time()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=_repo_root(), timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc = "timeout"
        out = (e.stdout or b"").decode() if isinstance(e.stdout, bytes) \
            else (e.stdout or "")
        err = f"timed out after {timeout} s"
    dt = time.time() - t0
    if rc != 0:
        with open(os.path.join(outdir, tag + ".FAILED.log"), "w") as f:
            f.write(out[-4000:] + "\n==stderr==\n" + err[-8000:])
        return (tag, "FAILED", dt)
    if save_stdout_to is not None:
        with open(save_stdout_to, "w") as f:
            f.write(out)
    return (tag, "ok", dt)


def run_combo(arch, shape, multi_pod, outdir, extra=(), timeout=None):
    tag = f"{arch}_{shape}_{'2x16x16' if multi_pod else '16x16'}".replace(
        "/", "-")
    out = os.path.join(outdir, tag + ".json")
    if os.path.exists(out):
        return (tag, "cached", 0.0)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", out, *extra]
    if multi_pod:
        cmd.append("--multi-pod")
    return _run_subprocess(tag, cmd, outdir, timeout=timeout)


def scenario_list():
    from repro_torch.core.scheduler import SCENARIOS
    return sorted(SCENARIOS)


def run_scenario(name, outdir, rounds, steps, method, loss_backend="auto",
                 transport="none", device="cuda", timeout=None):
    from repro_torch.core.scheduler import HIER_SCENARIOS
    tag = f"scenario_{name}_{method}"
    if loss_backend != "auto":
        tag += f"_{loss_backend}"
    if transport != "none":
        tag += f"_{transport.replace(':', '').replace('+', '-')}"
    out = os.path.join(outdir, tag + ".log")
    if os.path.exists(out):
        return (tag, "cached", 0.0)
    if name in HIER_SCENARIOS:
        # Two-level region/core streams need the CPU-scale orchestrator
        # (the flat R=1 LLM driver refuses them).
        cmd = [sys.executable, "-m", "repro_torch.benchmarks.scenarios",
               "--scenario", name, "--method", method, "--rounds",
               str(rounds), "--edges", "6", "--transport", transport,
               "--device", device]
    else:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--scenario",
               name, "--method", method, "--rounds", str(rounds), "--edges",
               "2", "--steps-per-phase", str(steps), "--loss-backend",
               loss_backend, "--transport", transport, "--device", device]
    return _run_subprocess(tag, cmd, outdir, save_stdout_to=out,
                           timeout=timeout)


def main(argv=None):
    from repro_torch.core.methods import method_names, resolve_method

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("-j", type=int, default=6)
    ap.add_argument("--timeout", type=int, default=7200,
                    help="seconds one subprocess may take (kimi-k2's "
                         "train_4k at 2 x 16 x 16 runs about an hour)")
    ap.add_argument("--scenarios", action="store_true",
                    help="sweep FL round-scheduling scenarios instead of "
                         "the dry-run matrix")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps-per-phase", type=int, default=10)
    ap.add_argument("--method", default="bkd", choices=list(method_names()),
                    help="FL method forwarded to repro_torch.launch.train in "
                         "--scenarios mode")
    ap.add_argument("--loss-backend", default="auto",
                    choices=["auto", "jnp", "pallas"],
                    help="Phase-2 loss backend forwarded to "
                         "repro_torch.launch.train in --scenarios mode")
    ap.add_argument("--transport", default="none",
                    help="uplink codec spec forwarded to the scenario "
                         "drivers in --scenarios mode")
    ap.add_argument("--device", default="cuda",
                    help="device of the --scenarios drivers")
    args = ap.parse_args(argv)
    if args.scenarios and not resolve_method(args.method).llm_driver:
        ap.error(f"--method {args.method} is CPU-scale only; the scenario "
                 f"sweep drives repro_torch.launch.train")
    if args.transport != "none":
        from repro_torch.transport import parse_codec
        try:
            parse_codec(args.transport)
        except ValueError as e:
            ap.error(str(e))
    os.makedirs(args.out, exist_ok=True)
    results = []
    with ThreadPoolExecutor(args.j) as ex:
        if args.scenarios:
            names = scenario_list()
            print(f"{len(names)} scenarios -> {args.out} ({args.j} workers)")
            futs = [ex.submit(run_scenario, n, args.out, args.rounds,
                              args.steps_per_phase, args.method,
                              args.loss_backend, args.transport, args.device,
                              args.timeout)
                    for n in names]
        else:
            combos = combo_list()
            print(f"{len(combos)} combos -> {args.out} ({args.j} workers)")
            futs = [ex.submit(run_combo, a, s, mp, args.out, (),
                              args.timeout)
                    for a, s, mp in combos]
        for f in futs:
            tag, status, dt = f.result()
            print(f"[{status:6s}] {tag} ({dt:.0f}s)", flush=True)
            results.append((tag, status, dt))
    fails = [r for r in results if r[1] == "FAILED"]
    print(f"done: {len(results) - len(fails)} ok, {len(fails)} failed")
    with open(os.path.join(args.out, "_summary.json"), "w") as f:
        json.dump(results, f, indent=2)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
