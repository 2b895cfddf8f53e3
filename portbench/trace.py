"""A traced stretch of steps under ``torch.profiler`` and what is read
from its trace: the device operations with their intervals, the busy
time (the union of every kernel, copy and memset interval), the idle gaps
between them labelled by what the host was doing, and the breakdown the
result line carries.

Spans are the benchmark's own: ``record_function`` around its calls into
the program (``portbench.fit_batch``, ``portbench.handoff``,
``portbench.readback``) and around the whole stretch
(``portbench.window``), which also ends with a device synchronisation.
The trace is written to the run's temporary directory, read and
deleted."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: most entries of each breakdown list
TOP = 10


def span(name: str):
    """A benchmark span (a no-op outside a profiler)."""
    return torch.profiler.record_function(f"portbench.{name}")


def run_traced(step: Callable[[int], None], steps: int) -> Dict:
    """``step(i)`` for i < ``steps`` under the profiler, then a device
    synchronisation, all inside the window span; returns
    :func:`summarize` of its trace."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            for i in range(steps):
                step(i)
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events, steps)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float,
                                                                float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _top_level(spans: List[Tuple[float, float, str]]):
    """The outermost of nested host intervals, sorted by start."""
    out = []
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        if out and a < out[-1][1]:
            continue
        out.append((a, b, name))
    return out


def _at(level, starts, t):
    """The name of the interval of ``level`` (sorted, disjoint, starting
    at ``starts``) that holds ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and level[i][0] <= t < level[i][1]:
        return level[i][2]
    return None


def _latest(levels, t):
    """Of the host operations running at ``t`` on any thread (each
    thread's outermost), the one that started last: what the host was
    doing when the device went idle (the autograd engine runs the
    backward's operations on a thread of its own)."""
    best = None
    for level, starts in levels:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and level[i][0] <= t < level[i][1] and \
                (best is None or level[i][0] > best[0]):
            best = level[i]
    return best[2] if best else None


def summarize(events: List[Dict], steps: int) -> Dict:
    """Everything the per-layer readers and the breakdown take from a
    chrome trace of :func:`run_traced` (times in seconds)."""
    window = next(e for e in events if e.get("name") == WINDOW and
                  e.get("ph") == "X" and e.get("cat") == "user_annotation")
    w0, w1 = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    tid = window.get("tid")
    device = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b > a:
            device.append((e["cat"], e["name"], a, b))
    busy = _union([(a, b) for _, _, a, b in device])
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events if e.get("ph") == "X" and e.get("tid") == tid
             and e.get("cat") == "user_annotation" and e["name"] != WINDOW
             and e["name"].startswith("portbench.")]
    spans = _top_level(spans)
    span_at = [s[0] for s in spans]
    threads = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            threads[e.get("tid")].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    levels = []
    for ops in threads.values():
        level = _top_level(ops)
        levels.append((level, [o[0] for o in level]))
    gaps, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    idle = defaultdict(float)
    for a, b in gaps:
        where = (_at(spans, span_at, a) or "outside spans").replace(
            "portbench.", "")
        op = _latest(levels, a)
        idle[f"{where}: {op}" if op else where] += (b - a) * 1e-6
    by_op = defaultdict(float)
    for cat, name, a, b in device:
        by_op[name if cat == "kernel" else f"[{cat}] {name}"] += \
            (b - a) * 1e-6
    kernels = [(name, (b - a) * 1e-6) for cat, name, a, b in device
               if cat == "kernel"]
    return {
        "steps": steps,
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernels": kernels,
        "breakdown": {
            "device_ops": [[n[:160], s] for n, s in sorted(
                by_op.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[n[:160], s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:TOP]]},
    }
