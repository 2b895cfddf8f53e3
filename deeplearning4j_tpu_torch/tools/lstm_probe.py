"""Where a step of the LSTM recurrence's cluster route goes, on one card, and
how build-time variants of the kernel compare.

Usage, from the repository root on a machine with one Hopper GPU and nvcc::

    python3 -m deeplearning4j_tpu_torch.tools.lstm_probe \\
        [--parent DIR] [--variant NAME=FLAGS ...]

It times B6 (``csrc/lstm.cu``, bf16) at the char-RNN's shape (T 128, N 64,
H 512, peepholes) and at N 200 (CUDA events, the median of 20 samples of
10 back-to-back launches), in turns within the call, for:

- ``current``: the library as the port builds it;
- ``parent``: ``lstm.cu`` of another tree's ``csrc/`` directory
  (``--parent DIR``, a tree whose ``lstm_recurrence_fwd`` takes the route
  pointer), built with the same nvcc flags into ``build/probe/lstm/parent``;
- each ``--variant NAME=FLAGS``: the same source built with extra nvcc
  flags (``-D`` defines, e.g. ``-DDL4J_LSTM_CLUSTER=0`` for bf16 on the
  cooperative route) into ``build/probe/lstm/NAME``.

The order is current, variants, variants reversed, current, so a drift of
the card's clocks shows as a gap between two readings of one library.
Each library's output is checked against the plain version first.

It then builds ``lstm.cu`` with the cluster kernel's ``// probe: <phase>``
comments turned into ``clock64()`` stamps, each warp summing its cycles
per phase (``PHASES``: the wait for the cluster's slices of h_{t-1}; the
products up to their completion, with the next step's inputs requested;
the gate math with h_t staged; the push of h_t to the cluster's CTAs,
with y[t] written; the prologue up to the first step) into a device
array read after one launch. The stamps perturb the code they measure, so
the shares say where a warp's time goes, not what the kernel takes.

It prints the card's name and power limit, then one JSON line per shape
with each library's time, route and error, and one with each phase's
share of the warps' cycles and its cycles per step."""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..kernels import cuda_lib
from ..kernels import lstm as lk
from .attention_bwd_probe import _time_ms

PHASES = ["wait", "products", "gates", "exchange", "prologue"]
PROBE_DIR = cuda_lib.BUILD_DIR.parent / "probe" / "lstm"
#: the headers lstm.cu includes, copied beside the stamped source
HEADERS = ("attention_common.cuh", "hopper_common.cuh")
#: (T, N, H) of the timed cases
SHAPES = [(128, 64, 512), (128, 200, 512)]

STAMPS = r"""
__device__ unsigned long long g_probe[NPHASES];

extern "C" int probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
}

extern "C" int probe_reset() {
  unsigned long long zero[NPHASES] = {};
  return (int)cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
}

#define PROBE_MARK(next)                                   \
  {                                                        \
    const long long now_ = clock64();                      \
    _Pragma("unroll") for (int k_ = 0; k_ < NPHASES; ++k_) \
        if (k_ == pcur_) pacc_[k_] += now_ - pt_;          \
    pt_ = now_;                                            \
    pcur_ = next;                                          \
  }
""".replace("NPHASES", str(len(PHASES)))


def instrumented(src: str) -> str:
    """``src`` with its ``// probe: <phase>`` comments as stamps: ``begin``
    declares the counters (the cycles before the first phase count as the
    prologue), ``done`` adds a warp's counters (lane 0's) to ``g_probe``.
    The stamps are placed after the source's includes."""
    n, first = len(PHASES), len(PHASES) - 1

    def mark(m):
        name = m.group(1)
        if name == "begin":
            return (f"long long pt_ = clock64(), pacc_[{n}] = {{}};\n"
                    f"  int pcur_ = {first};")
        if name == "done":
            return (f"PROBE_MARK({first});\n  if ((threadIdx.x & 31) == 0)\n"
                    f"    for (int k_ = 0; k_ < {n}; ++k_) atomicAdd("
                    f"&g_probe[k_], (unsigned long long)pacc_[k_]);")
        return f"PROBE_MARK({PHASES.index(name)});"
    body = re.sub(r"// probe: (\w+)", mark, src)
    cut = body.index("namespace dl4j_lstm")
    return body[:cut] + STAMPS + body[cut:]


def _nvcc(out: Path, src: Path, flags=()):
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *flags, "-o", str(out),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _declare(lib):
    for entry, argtypes in cuda_lib.ENTRIES["lstm"].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build(parent, variants):
    """The stamped library and {name: CDLL} of the current library, the
    parent's and the variants, every nvcc started together."""
    csrc = cuda_lib.CSRC
    stamped_dir = PROBE_DIR / "stamped"
    stamped_dir.mkdir(parents=True, exist_ok=True)
    for name in HEADERS:
        (stamped_dir / name).write_text((csrc / name).read_text())
    (stamped_dir / "lstm_probe.cu").write_text(
        instrumented((csrc / "lstm.cu").read_text()))
    procs = {"stamped": (stamped_dir / "liblstm_probe.so",)}
    procs["stamped"] += (_nvcc(procs["stamped"][0],
                               stamped_dir / "lstm_probe.cu"),)
    sources = [("parent", Path(parent), ())] if parent else []
    for spec in variants:
        name, _, flags = spec.partition("=")
        sources.append((name, csrc, tuple(flags.split())))
    for name, src_dir, flags in sources:
        so = PROBE_DIR / name / "liblstm.so"
        procs[name] = (so, _nvcc(so, src_dir / "lstm.cu", flags))
    libs = {}
    for name, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        for line in (out + err).splitlines():
            if "lstm_cluster_kernel" in line or "registers" in line:
                print(f"  {name}: {line.strip()}")
        libs[name] = _declare(ctypes.CDLL(str(so)))
    stamped = libs.pop("stamped")
    for fn in ("probe_read", "probe_reset"):
        getattr(stamped, fn).restype = ctypes.c_int
    return stamped, {"current": cuda_lib.load("lstm"), **libs}


def _case(t, n, h, seed):
    """bf16 (xw_t, R, h0, c0, peepholes) on the card, scaled as
    chip_smoke.py's LSTM checks are."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    xw, r = rnd(t, n, 4 * h), rnd(h, 4 * h) / h ** 0.5
    h0, c0 = rnd(n, h) * 0.5, rnd(n, h) * 0.5
    peep = tuple(rnd(h) * 0.1 for _ in range(3))
    cast = lambda x: x.to(torch.bfloat16)
    return cast(xw), cast(r), cast(h0), cast(c0), tuple(map(cast, peep))


def _launch(lib, case):
    """One launch of ``lib``'s lstm_recurrence_fwd on ``case``; returns
    ((y_t, hT, cT), route name)."""
    xw, r, h0, c0, (pi, pf, po) = case
    t, n, h4 = xw.shape
    h = h4 // 4
    y = torch.empty((n, t, h), dtype=xw.dtype, device=xw.device)
    y_t = y.transpose(0, 1)
    ht, ct = torch.empty_like(h0), torch.empty_like(c0)
    route = ctypes.c_int(-1)
    rc = lib.lstm_recurrence_fwd(
        xw.data_ptr(), r.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        pi.data_ptr(), pf.data_ptr(), po.data_ptr(), None, y.data_ptr(),
        ht.data_ptr(), ct.data_ptr(), xw.stride(0), xw.stride(1),
        y_t.stride(0), y_t.stride(1), t, n, h, 2,
        torch.cuda.current_stream().cuda_stream, ctypes.byref(route))
    if rc:
        raise RuntimeError(f"lstm_recurrence_fwd failed: CUDA error {rc}")
    return (y_t, ht, ct), lk.ROUTES[route.value]


def split(stamped, case):
    """Each phase's share of the warps' cycles and its cycles per step (a
    warp's mean), from one stamped launch after a warm one."""
    _launch(stamped, case)
    torch.cuda.synchronize()
    if stamped.probe_reset():
        raise RuntimeError("probe_reset failed")
    _, route = _launch(stamped, case)
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * len(PHASES))()
    if stamped.probe_read(out):
        raise RuntimeError("probe_read failed")
    cyc = np.array(out[:], dtype=np.float64)
    plan = lk.lstm_plan(case[0].shape[1], case[1].shape[0], torch.bfloat16)
    warps = plan["ctas"] * 4
    t = case[0].shape[0]
    return {"route": route,
            "share": {p: round(float(c / cyc.sum()), 4)
                      for p, c in zip(PHASES, cyc)},
            "cycles_per_step": {p: round(float(c / warps / t), 1)
                                for p, c in zip(PHASES, cyc)
                                if p != "prologue"},
            "prologue_cycles": round(float(cyc[-1] / warps), 1)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another tree's csrc/ directory")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAGS: lstm.cu with extra nvcc flags")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lstm_probe: no CUDA device", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    stamped, libs = build(args.parent, args.variant)
    order = list(libs) + list(libs)[::-1]
    for t, n, h in SHAPES:
        case = _case(t, n, h, 1)
        want = lk.lstm_recurrence_plain(*case[:4], case[4])
        row = {"shape": f"T {t}, N {n}, H {h}, bf16, peepholes",
               "card": card, "order": order, "ms": {}, "route": {},
               "max_abs": {}, "plan": lk.lstm_plan(n, h, torch.bfloat16)}
        for name, lib in libs.items():
            got, row["route"][name] = _launch(lib, case)
            torch.cuda.synchronize()
            row["max_abs"][name] = max(
                (a.float() - b.float()).abs().max().item()
                for a, b in zip(got, want))
        for name in order:
            row["ms"].setdefault(name, []).append(
                _time_ms(lambda: _launch(libs[name], case)))
        print(json.dumps(row))
        print(json.dumps({"shape": row["shape"],
                          "warp_cycle_split": split(stamped, case)}))


if __name__ == "__main__":
    main()
