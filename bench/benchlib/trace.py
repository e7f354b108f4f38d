"""Reading a ``torch.profiler`` trace of a short steady sub-window: the
device's busy time, each kernel's time, and the idle gaps with what the host
was doing in them.

The trace is written as a Chrome trace to the run's temporary directory,
read once and deleted.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import defaultdict

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict           # kernel name -> [seconds of each launch]
    idle_gaps: dict         # what the host was doing -> idle seconds

    def seconds(self, *substrings):
        """Device seconds and launch count of the kernels whose name holds
        any of ``substrings``."""
        t, n = 0.0, 0
        for name, durs in self.kernels.items():
            if any(s in name for s in substrings):
                t += sum(durs)
                n += len(durs)
        return t, n

    def breakdown(self, top=10):
        ops = sorted(((k, sum(v)) for k, v in self.kernels.items()),
                     key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


def record(fn):
    """Run ``fn()`` inside one ``bench.window`` annotation under the
    profiler, synchronise, and return (fn's result, :class:`Trace`)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, summarize(events)


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events) -> Trace:
    """The :class:`Trace` of Chrome trace events (times in microseconds)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("trace has no bench.window annotation")
    w0 = win[0]["ts"]
    w1 = w0 + win[0]["dur"]
    tid = win[0]["tid"]
    kernels = defaultdict(list)
    busy = []
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if b > a:
                busy.append((a, b))
                kernels[e["name"]].append(e["dur"] * 1e-6)
    merged = _merge(busy)
    busy_s = sum(b - a for a, b in merged) * 1e-6
    host = sorted((e for e in xs if e.get("cat") in HOST_CATS
                   and e.get("tid") == tid and e.get("name") != WINDOW),
                  key=lambda e: e["ts"])
    edges = [w0] + [t for ab in merged for t in ab] + [w1]
    gaps = defaultdict(float)
    spans = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    for (a, b), name in zip(spans, _host_at(host, [(a + b) / 2
                                                   for a, b in spans])):
        gaps[name] += (b - a) * 1e-6
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
                 kernels=dict(kernels), idle_gaps=dict(gaps))


def _host_at(host, times):
    """For each of the increasing ``times``: the innermost host event on
    the main thread that spans it, prefixed by the outermost annotation
    around it; "python" where the thread was in none.  One sweep: events
    on one thread nest, so the open ones form a stack."""
    names, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i]["ts"] <= t:
            e = host[i]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
            stack.pop()
        live = [e for e in stack if e["ts"] + e["dur"] >= t]
        if not live:
            names.append("python")
            continue
        outer = next((e["name"] for e in live
                      if e.get("cat") == "user_annotation"), None)
        inner = live[-1]["name"]
        names.append(f"{outer}/{inner}" if outer and outer != inner
                     else inner)
    return names
