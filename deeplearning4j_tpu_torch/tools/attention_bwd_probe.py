"""Where the bf16 attention backward's time goes, on one card, and how it
compares with an earlier tree's kernels.

Usage, from the repository root on a machine with one Hopper GPU and nvcc::

    python3 -m deeplearning4j_tpu_torch.tools.attention_bwd_probe \\
        [--parent DIR] [--variant NAME=FLAGS ...]

It times B2 (``shortseq_attention_bwd``), B4 (``flash_attention_bwd_dq``)
and B5 (``flash_attention_bwd_dkv``) at ``chip_smoke.py`` phase 3's shapes
(CUDA events, the median of 20 samples of 10 back-to-back launches; host
microseconds per enqueued launch, tensor-map encoding included), in turns
within the call, for:

- ``current``: the libraries of ``csrc/`` as the port builds them;
- ``parent``: ``shortseq_attention_bwd.cu`` and ``flash_backward.cu`` of
  another tree's ``csrc/`` directory (``--parent DIR``), built with the same
  nvcc flags into ``build/probe/parent``;
- each ``--variant NAME=FLAGS``: the current sources built with extra nvcc
  flags (``-D`` defines) into ``build/probe/NAME``.

The order is parent, current, variants, current, parent, so a drift of
the card's clocks during the call shows as a gap between the two readings
of one library. Each library's gradients are checked against the plain
backward first.

It then builds ``csrc/attention_bwd_core.cuh`` (bf16) with its
``// probe: <phase>`` comments turned into ``clock64()`` stamps, each
consumer warp summing its cycles per phase (``PHASES``: waiting for a
ring stage, S (and dP's issue) up to S's completion, the p pass with dV's
issue, dP's completion, the ds pass with the last product's issue, the
gradient products' completion, releasing the stage, the epilogue, and the
prologue up to the resident tiles' arrival) per role into a device array
read after one launch. The stamps perturb the code they measure, so the
shares say where a warp's time goes, not what the kernel takes.

It prints the card's name and power limit, then one JSON line per shape
with each library's time and error, and one per role with each phase's
share of the warps' cycles."""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..kernels import cuda_lib
from ..kernels.shortseq_attention import (attention_bwd_plain,
                                          attention_fwd_plain, row_delta)

PHASES = ["wait", "s", "p", "dp", "ds", "grads", "release", "epilogue",
          "prologue"]
ROLES = ["dkv", "dq"]
PROBE_DIR = cuda_lib.BUILD_DIR.parent / "probe"
#: the backward sources the stamped core needs beside it
HEADERS = ("attention_common.cuh", "hopper_common.cuh",
           "attention_bwd_common.cuh")
#: (library, C entry) of B2, B4 and B5
ENTRIES = {"B2": ("shortseq_attention_bwd", "shortseq_attention_bwd"),
           "B4": ("flash_backward", "flash_attention_bwd_dq"),
           "B5": ("flash_backward", "flash_attention_bwd_dkv")}
#: the gradients each kernel writes (dq, dk, dv) and its roles' code in
#: probe_bwd (the core's BwdRoles: dkv 0, dq 1, both 2)
WRITES = {"B2": (True, True, True), "B4": (True, False, False),
          "B5": (False, True, True)}
ROLE_CODE = {"B2": 2, "B4": 1, "B5": 0}

ENTRY = r"""
extern "C" int probe_bwd(int roles, const void* q, const void* k,
                         const void* v, const void* kmask, const void* dout,
                         const void* lse, const void* delta, void* dq,
                         void* dk, void* dv, int bh, int h, int t, int d,
                         int causal, float scale, void* stream) {
  using namespace dl4j;
  const BwdArgs a{q, k, v, static_cast<const float*>(kmask), dout,
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, dk, dv, h, t, d,
                  causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (roles == kRolesBoth)
    return (int)dispatch_bwd_core<__nv_bfloat16, kRolesBoth>(a, bh, s);
  if (roles == kRolesDq)
    return (int)dispatch_bwd_core<__nv_bfloat16, kRolesDq>(a, bh, s);
  return (int)dispatch_bwd_core<__nv_bfloat16, kRolesDkv>(a, bh, s);
}
"""

STAMPS = r"""
__device__ unsigned long long g_probe[NROLES * NPHASES];

extern "C" int probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
}

extern "C" int probe_reset() {
  unsigned long long zero[NROLES * NPHASES] = {};
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
""".replace("NPHASES", str(len(PHASES))).replace("NROLES", str(len(ROLES)))


def instrumented(core: str) -> str:
    """The core with its ``// probe: <phase>`` comments as stamps:
    ``begin`` declares a role's counters (the cycles before the first
    phase count as the prologue), ``done <role>`` adds a warp's counters
    (lane 0's) to the role's row of ``g_probe``."""
    n, first = len(PHASES), len(PHASES) - 1

    def mark(m):
        name, role = m.group(1), m.group(2)
        if name == "begin":
            return (f"long long pt_ = clock64(), pacc_[{n}] = {{}};\n"
                    f"  int pcur_ = {first};")
        if name == "done":
            row = ROLES.index(role) * n
            return (f"PROBE_MARK({first});\n  if ((threadIdx.x & 31) == 0)\n"
                    f"    for (int k_ = 0; k_ < {n}; ++k_) atomicAdd("
                    f"&g_probe[{row} + k_], (unsigned long long)pacc_[k_]);")
        return f"PROBE_MARK({PHASES.index(name)});"
    return re.sub(r"// probe: (\w+)(?: (\w+))?", mark, core)


def _nvcc(out: Path, src: Path, flags=()):
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *flags, "-o", str(out),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(procs):
    """Wait for every nvcc of ``procs`` ({name: (so, proc)}); raise with
    its stderr if one failed, print each kernel's register line."""
    libs = {}
    for name, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        for line in (out + err).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def build(parent, variants):
    """Build the stamped core, the parent tree's B2 / B4 / B5 libraries and
    the variants, all nvcc processes started together. Returns the stamped
    library and {tree: {library name: CDLL}} with "current" first."""
    csrc = cuda_lib.CSRC
    stamped_dir = PROBE_DIR / "stamped"
    stamped_dir.mkdir(parents=True, exist_ok=True)
    for name in HEADERS:
        (stamped_dir / name).write_text((csrc / name).read_text())
    core = (csrc / "attention_bwd_core.cuh").read_text()
    (stamped_dir / "probe_bwd.cu").write_text(STAMPS + instrumented(core) +
                                              ENTRY)
    so = stamped_dir / "libprobe_bwd.so"
    procs = {"stamped": (so, _nvcc(so, stamped_dir / "probe_bwd.cu"))}
    trees = {}
    if parent is not None:
        trees["parent"] = (Path(parent), ())
    for spec in variants:
        name, _, flags = spec.partition("=")
        trees[name] = (csrc, tuple(flags.split()))
    for tree, (src_dir, flags) in trees.items():
        for lib in ("shortseq_attention_bwd", "flash_backward"):
            so = PROBE_DIR / tree / f"lib{lib}.so"
            procs[f"{tree}/{lib}"] = (so, _nvcc(so, src_dir / f"{lib}.cu",
                                                flags))
    done = _finish(procs)
    stamped = done.pop("stamped")
    stamped.probe_bwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + \
        [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    stamped.probe_bwd.restype = ctypes.c_int
    libs = {"current": {lib: cuda_lib.load(lib) for lib, _ in
                        ENTRIES.values()}}
    for name, lib in done.items():
        tree, libname = name.split("/")
        libs.setdefault(tree, {})[libname] = lib
    for tree in libs.values():
        for libname, entry in ENTRIES.values():
            fn = getattr(tree[libname], entry)
            fn.argtypes = cuda_lib.ENTRIES[libname][entry]
            fn.restype = ctypes.c_int
    return stamped, libs


def _case(b, h, t, d, lengths, masked, seed):
    """bf16 inputs of one backward call on the card: q, k, v, dO, the key
    mask (or None), the plain forward's o and lse, and δ."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b * h, t, d, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    mask = None
    if masked:
        lengths = np.asarray(lengths)
        mask = torch.from_numpy((np.arange(t)[None, :] < lengths[:, None])
                                .astype(np.float32)).cuda()
    o, lse = attention_fwd_plain(q, k, v, mask, h, True)
    return q, k, v, do, mask, lse, row_delta(do, o)


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(fn, case, h, grads):
    q, k, v, do, mask, lse, delta = case
    bh, t, d = q.shape
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(_ptr(x) for x in grads), bh, h, t, d, 1, 2, d ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"probe launch failed: CUDA error {rc}")


def _rel_err(case, h, grads, live):
    """Worst relative L2 of the gradients the call wrote against the plain
    backward, on live batch rows."""
    q, k, v, do, mask, lse, delta = case
    want = attention_bwd_plain(q, k, v, mask, h, True, None, lse, do, delta)
    torch.cuda.synchronize()
    errs = [((x[live].float() - y[live].float()).norm() /
             y[live].float().norm()).item()
            for x, y in zip(grads, want) if x is not None]
    return max(errs)


def _time_ms(fn, reps=20, batch=10):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def _host_us(fn, n=200):
    """Host time per enqueued call (no synchronisation inside)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def shapes():
    """chip_smoke.py phase 3's backward shapes: (kernel, label, b, h, t,
    lengths, masked)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(2, 513, 32)
    lens[0], lens[1] = 1, 0
    return [
        ("B2", "B2 train (B 32, H 12, T 512, D 64, unmasked)", 32, 12, 512,
         [512] * 32, False),
        ("B2", "B2 ragged (B 32, T 512, lengths 0..512)", 32, 12, 512, lens,
         True),
        ("B4", "B4 (B 4, H 12, T 2048, D 64, unmasked)", 4, 12, 2048,
         [2048] * 4, False),
        ("B4", "B4 ragged (B 4, T 577)", 4, 12, 577, [577, 300, 1, 0], True),
        ("B5", "B5 (B 4, H 12, T 2048, D 64, unmasked)", 4, 12, 2048,
         [2048] * 4, False),
        ("B5", "B5 ragged (B 4, T 577)", 4, 12, 577, [577, 300, 1, 0], True),
    ]


def split(stamped, case, h, roles, grads):
    """Each role's share of its consumer warps' cycles by phase, from one
    stamped launch."""
    q, k, v, do, mask, lse, delta = case
    bh, t, d = q.shape

    def run():
        rc = stamped.probe_bwd(roles, q.data_ptr(), k.data_ptr(),
                               v.data_ptr(), _ptr(mask), do.data_ptr(),
                               lse.data_ptr(), delta.data_ptr(),
                               *(_ptr(x) for x in grads), bh, h, t, d, 1,
                               d ** -0.5,
                               torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"stamped launch failed: CUDA error {rc}")
    run()                                     # warm
    torch.cuda.synchronize()
    if stamped.probe_reset():
        raise RuntimeError("probe_reset failed")
    run()
    torch.cuda.synchronize()
    n = len(PHASES)
    out = (ctypes.c_ulonglong * (len(ROLES) * n))()
    if stamped.probe_read(out):
        raise RuntimeError("probe_read failed")
    cyc = np.array(out[:], dtype=np.float64).reshape(len(ROLES), n)
    return {role: {"warp_cycles": float(row.sum()),
                   "share": {p: round(float(c / row.sum()), 4)
                             for p, c in zip(PHASES, row)}}
            for role, row in zip(ROLES, cyc) if row.sum() > 0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another tree's csrc/ directory")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAGS: the current sources with extra nvcc "
                         "flags")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_bwd_probe: no CUDA device", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    stamped, libs = build(args.parent, args.variant)
    # parent, current, variants, then back: parent last
    others = [n for n in libs if n != "parent"]
    order = others + others[::-1]
    if "parent" in libs:
        order = ["parent"] + order + ["parent"]
    for kernel, label, b, h, t, lengths, masked in shapes():
        case = _case(b, h, t, 64, lengths, masked, 1)
        live = torch.from_numpy(np.repeat(np.asarray(lengths) > 0, h)).cuda()
        libname, entry = ENTRIES[kernel]
        grads = tuple(torch.empty_like(case[0]) if w else None
                      for w in WRITES[kernel])
        row = {"shape": label, "card": card, "order": order, "ms": {},
               "host_us_per_launch": {}, "rel_l2": {}}
        for name in dict.fromkeys(order):
            fn = getattr(libs[name][libname], entry)
            _launch(fn, case, h, grads)
            row["rel_l2"][name] = _rel_err(case, h, grads, live)
        for name in order:
            fn = getattr(libs[name][libname], entry)
            row["ms"].setdefault(name, []).append(
                _time_ms(lambda: _launch(fn, case, h, grads)))
        for name in dict.fromkeys(order):
            fn = getattr(libs[name][libname], entry)
            row["host_us_per_launch"][name] = _host_us(
                lambda: _launch(fn, case, h, grads))
        print(json.dumps(row))
        print(json.dumps({"shape": label, "warp_cycle_split":
                          split(stamped, case, h, ROLE_CODE[kernel],
                                grads)}))


if __name__ == "__main__":
    main()
