"""How ``torch.profiler`` records the port's kernels, which are launched
through ctypes outside PyTorch's dispatcher (card only).

Profiles one batch-norm forward + backward wrapper call (two kernels,
``bn_train_fwd`` / ``bn_train_bwd`` at the ResNet-50 site 6272 x 512,
bf16) in many back-to-back sessions of one process, and for each session
prints: the kernel records ``prof.events()`` shows, the raw device
records of the kineto trace, the CUDA runtime launch calls of the CPU
trace (``cudaLaunchKernel`` / ``cudaLaunchCooperativeKernel`` /
``cuLaunchKernel``), and where the device records sit against the trace's
start and end. Three ways of opening the window, in turns:

- ``bare``: the window opens and ``fn`` runs at once (how the card tests
  counted kernels up to now);
- ``spin``: a spin kernel (``torch.cuda._sleep``) runs first inside the
  window, so ``fn``'s kernels start well after the window opened;
- ``host``: the host waits 2 ms inside the window before ``fn``.

Run from the repository root on the card::

    python -m deeplearning4j_tpu_torch.tools.profiler_probe --sessions 40
"""

from __future__ import annotations

import argparse
import json
import time

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernelExC",
                "cuLaunchCooperativeKernel")


def _inputs(m=6272, c=512, seed=9):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")
    mu = r(c)
    x = (r(m, c) * (0.5 + r(c).abs()) + mu).bfloat16()
    return x, r(m, c).bfloat16(), 0.5 + r(c).abs(), 0.1 * r(c), \
        mu + 0.1 * r(c)


def _session(fn, how: str) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        if how == "spin":
            torch.cuda._sleep(1_000_000)
        elif how == "host":
            time.sleep(0.002)
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    names = [e.name for e in prof.events() if e.device_type == cuda]
    res = prof.profiler.kineto_results
    start = res.trace_start_ns() if hasattr(res, "trace_start_ns") else \
        res.trace_start_us() * 1000
    raw = [e for e in res.events() if e.device_type() == cuda]
    launches = [e.name() for e in res.events()
                if e.device_type() != cuda and e.name() in LAUNCH_CALLS]
    offs = sorted(round((e.start_ns() - start) / 1e3, 1) for e in raw)
    return {"events": sum("dl4j_bn" in n for n in names),
            "other": [n for n in names if "dl4j_bn" not in n and
                      "sleep" not in n and "spin" not in n],
            "raw_device": len(raw), "launch_calls": len(launches),
            "device_start_us": offs[:4]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_probe needs a CUDA card")
    from ..kernels import batchnorm as bnk
    x, dy, gamma, beta, shift = _inputs()

    def fn():
        y, mean, _, rstd = bnk.bn_train_fwd(x, gamma, beta, shift, 1e-5)
        bnk.bn_train_bwd(dy, x, gamma, mean, rstd)

    fn()                                    # build and plan outside
    torch.cuda.synchronize()
    rows = {how: [] for how in ("bare", "spin", "host")}
    for i in range(args.sessions):
        for how in rows:
            rows[how].append(_session(fn, how))
    summary = {}
    for how, rs in rows.items():
        short = [i for i, r in enumerate(rs) if r["events"] != 2]
        summary[how] = {
            "sessions": len(rs), "short_sessions": short,
            "events_in_short": [rs[i]["events"] for i in short],
            "launch_calls_in_short": [rs[i]["launch_calls"] for i in short],
            "raw_device_in_short": [rs[i]["raw_device"] for i in short],
            "other_kernels": sorted({n for r in rs for n in r["other"]}),
            "first": rs[0], "min_device_start_us": min(
                (r["device_start_us"][0] for r in rs
                 if r["device_start_us"]), default=None)}
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0),
                      "profiler_probe": summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
