"""One benchmark cell's training on one CUDA card (by default ResNet-50
at B 1024): the step's time with the PyTorch profiler off and on, and,
where the program has the training step's phase spans, the traced steps'
device time, kernel launches, host time and device idle time by phase
(``observability/tracing.py::phase_times``), each ``dl4j.fit.*`` phase
with the time of the spans nested in it (``phases_a_step``), and those
nested spans' own split (``nested_a_step``, e.g. SwinV2's
``dl4j.swin.*``) where the program has them.

    python3 scripts/perf_fit_phases.py [--root CHECKOUT] [--steps 24] \
        [--seed N] [--out FILE] [--cell resnet50-train-b1024]

The net and its batches are the benchmark's: the cell's configuration
under its traffic (``resnet50`` under ``images_b1024``: a ring of 4 host
batches of 1024 float32 noise images handed to ``fit_batch`` as numpy
arrays), the loss read back every 10 steps. ``--root`` is the
checkout whose program and benchmark are imported (default: this one),
so that two commits can be compared on one card in one call: run the
script for each root in the order A, B, B, A. A step's time is the
interval between CUDA events recorded after consecutive steps; the
medians are of ``--steps`` such intervals untraced, traced, and untraced
again. Writes one JSON document to ``--out`` (and prints it)."""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

CELL = "resnet50-train-b1024"


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def _host_ms(events, steps):
    """Host ms a step inside each ``dl4j.`` span of the main thread, and
    ``dl4j.fit``'s own (its time less its phases')."""
    spans = [e for e in events if e.get("cat") == "user_annotation" and
             str(e.get("name", "")).startswith("dl4j.")]
    if not spans:
        return {}
    tid = min(spans, key=lambda e: float(e["ts"]))["tid"]
    out = {}
    for e in spans:
        if e["tid"] == tid:
            out[e["name"]] = out.get(e["name"], 0.0) + float(e["dur"])
    own = out.get("dl4j.fit", 0.0) - sum(
        v for k, v in out.items() if k.startswith("dl4j.fit."))
    out = {k: v * 1e-3 / steps for k, v in sorted(out.items())}
    out["dl4j.fit (own)"] = own * 1e-3 / steps
    return out


def fold_nested(times, events):
    """``tracing.phase_times``' result by innermost span, split in two:
    each ``dl4j.fit.*`` phase (and the rest) with the time of the spans
    nested in it added, and those nested spans (``dl4j.swin.*``) apart.
    A nested span belongs to the phase that holds its first start: a
    layer opens its spans inside one phase, the forward."""
    fit = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
           for e in events if e.get("cat") == "user_annotation" and
           str(e.get("name", "")).startswith("dl4j.fit.")]
    owner = {}
    for e in sorted((e for e in events
                     if e.get("cat") == "user_annotation"),
                    key=lambda e: float(e["ts"])):
        name = str(e.get("name", ""))
        if name in times and name.startswith("dl4j.") and \
                not name.startswith("dl4j.fit") and name not in owner:
            ts = float(e["ts"])
            owner[name] = next((p for a, b, p in fit if a <= ts < b),
                               "dl4j.fit")
    phases = {k: dict(v) for k, v in times.items() if k not in owner}
    for name, parent in owner.items():
        into = phases.setdefault(parent, dict.fromkeys(times[name], 0))
        for key, value in times[name].items():
            into[key] += value
    return phases, {k: times[k] for k in owner}


def _union_ms(events, w):
    """The union of the device intervals inside window ``w`` (host µs),
    in ms: the busy time, worked out apart from ``phase_times``."""
    total, end = 0.0, w[0]
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in events if e.get("ph") == "X" and
                       e.get("cat") in ("kernel", "gpu_memcpy",
                                        "gpu_memset")):
        a, b = max(a, end), min(b, w[1])
        if b > a:
            total += b - a
            end = b
    return total * 1e-3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--warm", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out")
    ap.add_argument("--cell", default=CELL)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from deeplearning4j_tpu_torch.kernels import cuda_lib
    from deeplearning4j_tpu_torch.observability import tracing
    from deeplearning4j_tpu_torch.ops.dataset import DataSet
    from portbench import feeds, harness, train

    cuda_lib.build(cuda_lib.ENTRIES)
    cell = harness.resolve(args.cell)
    cfg, traffic = cell["config"], cell["traffic"]
    device = torch.device("cuda", 0)
    ring = feeds.make_ring(cfg, traffic, args.seed, device)
    net = train.build_program(cfg, device)
    every = traffic["readback_every"]
    at = 0

    def steps(n):
        """``n`` + 1 steps; the ms between consecutive steps' ends."""
        nonlocal at
        marks = []
        torch.cuda.synchronize()
        for i in range(n + 1):
            net.fit_batch(DataSet(*ring[at % len(ring)]))
            at += 1
            if at % every == 0:
                float(net.score_value)
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]

    steps(args.warm)
    untraced = steps(args.steps)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("perf.window"):
            traced = steps(args.steps)
    untraced_again = steps(args.steps)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    window = next(e for e in events if e.get("name") == "perf.window" and
                  e.get("cat") == "user_annotation")
    w = (float(window["ts"]), float(window["ts"]) + float(window["dur"]))
    n = args.steps + 1
    out = {"cell": args.cell, "root": root, "card": _card(),
           "torch": torch.__version__,
           "cuda": torch.version.cuda, "seed": args.seed,
           "steps": args.steps,
           "step_ms": {name: {"median": statistics.median(ms),
                              "all": [round(x, 3) for x in ms]}
                       for name, ms in (("untraced", untraced),
                                        ("traced", traced),
                                        ("untraced_again",
                                         untraced_again))},
           "traced_steps": n, "window_ms_a_step": (w[1] - w[0]) * 1e-3 / n,
           "busy_union_ms_a_step": _union_ms(events, w) / n}
    if hasattr(tracing, "phase_times"):
        phases, nested = fold_nested(tracing.phase_times(events, window=w),
                                     events)
        pageable = [e for e in events
                    if e.get("cat") == "gpu_memcpy" and
                    "Pageable" in e.get("name", "")]
        in_input = tracing.phase_times(
            [e for e in events if e.get("cat") in tracing.LAUNCH_CATS or
             e.get("cat") == "user_annotation"] + pageable, window=w)
        busy = sum(v["device_s"] for v in phases.values())
        out.update({
            "busy_ms_a_step": busy * 1e3 / n,
            "launches_a_step": sum(v["launches"]
                                   for v in phases.values()) / n,
            "phases_a_step": {
                k: {"device_ms": v["device_s"] * 1e3 / n,
                    "idle_ms": v["idle_s"] * 1e3 / n,
                    "launches": v["launches"] / n}
                for k, v in sorted(phases.items())},
            "nested_a_step": {
                k: {"device_ms": v["device_s"] * 1e3 / n,
                    "idle_ms": v["idle_s"] * 1e3 / n,
                    "launches": v["launches"] / n}
                for k, v in sorted(nested.items())
                if v["device_s"] or v["launches"]},
            "host_ms_a_step": _host_ms(events, n),
            "pageable_ms_a_step": sum(
                v["device_s"] for v in in_input.values()) * 1e3 / n,
            "pageable_in_input_ms_a_step": in_input.get(
                "dl4j.fit.input", {"device_s": 0.0})["device_s"] * 1e3 / n,
        })
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    print(text, flush=True)


if __name__ == "__main__":
    main()
