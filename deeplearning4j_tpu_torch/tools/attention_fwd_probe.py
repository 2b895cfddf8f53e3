"""Where the bf16 attention forward's time goes, on one card.

Usage: ``python3 -m deeplearning4j_tpu_torch.tools.attention_fwd_probe``
from the repository root, on a machine with one Hopper GPU and nvcc.

It copies ``csrc/attention_fwd_core.cuh`` (the kernel of B1 and B3) into
``build/probe/`` twice and compiles each with nvcc for sm_90a:

- as it is, to check it against the plain version (a sweep of tile edges,
  then the main-path shapes) and time it at B1's and B3's main-path shapes
  (CUDA events, the median of 20 samples of 10 back-to-back launches; host
  microseconds per enqueued launch, tensor-map encoding included);
- with the source's ``// probe: <phase>`` comments turned into
  ``clock64()`` stamps, each consumer warp summing its cycles per phase
  (``PHASES``: waiting for a K or V tile, S = Q K^T, the masked online
  softmax with the rescale of O, P V, releasing the stage, the epilogue,
  and the prologue up to Q's arrival) into a device array read after one
  launch.

It prints the card's name and power limit, the sweep's worst errors, and
per shape one JSON line with the errors and times and one with each
phase's share of the warps' cycles. The stamps perturb the code they
measure, so the shares say where a warp's time goes, not what the kernel
takes."""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..kernels import cuda_lib
from ..kernels.shortseq_attention import attention_fwd_plain

PHASES = ["wait", "scores", "softmax", "pv", "end", "epilogue", "prologue"]
PROBE_DIR = cuda_lib.BUILD_DIR.parent / "probe"

ENTRY = r"""
extern "C" int probe_fwd(const void* q, const void* k, const void* v,
                         const void* kmask, void* o, void* lse, int bh, int h,
                         int t, int d, int causal, int dtype, float scale,
                         void* stream) {
  using namespace dl4j;
  const FwdArgs a{q, k, v, static_cast<const float*>(kmask), o,
                  static_cast<float*>(lse), h, t, d, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == kBF16 ? (int)dispatch_fwd<__nv_bfloat16>(a, bh, s)
                        : (int)dispatch_fwd<__half>(a, bh, s);
}
"""

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


def _instrumented(core: str) -> str:
    """The core with its ``// probe: <phase>`` comments as stamps; the
    cycles before the first mark count as the prologue."""
    n, first = len(PHASES), len(PHASES) - 1
    decl = "extern __shared__ __align__(1024) uint8_t fwd_smem[];"
    core = core.replace(decl, decl + f"\n  long long pt_ = clock64(), "
                        f"pacc_[{n}] = {{}};\n  int pcur_ = {first};")

    def mark(m):
        name = m.group(1)
        if name == "done":
            return (f"PROBE_MARK({first});\n  if ((threadIdx.x & 31) == 0)\n"
                    f"    for (int k_ = 0; k_ < {n}; ++k_) "
                    "atomicAdd(&g_probe[k_], (unsigned long long)pacc_[k_]);")
        return f"PROBE_MARK({PHASES.index(name)});"
    return re.sub(r"// probe: (\w+)", mark, core)


def build():
    """nvcc both probe libraries (in parallel); returns their paths."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    csrc = cuda_lib.CSRC
    core = (csrc / "attention_fwd_core.cuh").read_text()
    for header in ("attention_common.cuh", "hopper_common.cuh"):
        (PROBE_DIR / header).write_text((csrc / header).read_text())
    srcs = {
        "plain": core + ENTRY,
        "stamped": STAMPS + _instrumented(core) + ENTRY,
    }
    procs = {}
    for name, text in srcs.items():
        cu = PROBE_DIR / f"probe_{name}.cu"
        cu.write_text(text)
        so = PROBE_DIR / f"libprobe_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} probe:\n{err}")
        for line in (out + err).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        lib = ctypes.CDLL(str(so))
        lib.probe_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
            + [ctypes.c_float, ctypes.c_void_p]
        lib.probe_fwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _case(b, h, t, d, lengths, masked, seed, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b * h, t, d, generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    mask = None
    if masked:
        lengths = np.asarray(lengths)
        mask = torch.from_numpy((np.arange(t)[None, :] < lengths[:, None])
                                .astype(np.float32)).cuda()
    return q, k, v, mask


def _launch(lib, q, k, v, mask, h, causal=True):
    bh, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(bh, t, device="cuda")
    rc = lib.probe_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       None if mask is None else mask.data_ptr(),
                       o.data_ptr(), lse.data_ptr(), bh, h, t, d,
                       int(causal), 2 if q.dtype == torch.bfloat16 else 1,
                       d ** -0.5, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"probe launch failed: CUDA error {rc}")
    return o, lse


def _errors(lib, q, k, v, mask, h, causal, live):
    """max-abs of o and lse against the plain version on live rows."""
    o, lse = _launch(lib, q, k, v, mask, h, causal)
    o_p, lse_p = attention_fwd_plain(q, k, v, mask, h, causal)
    torch.cuda.synchronize()
    if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
        return float("inf"), float("inf")
    return ((o[live].float() - o_p[live].float()).abs().max().item(),
            (lse[live] - lse_p[live]).abs().max().item())


def sweep(lib):
    """The kernel against the plain version at the tile edges (T 1, 63, 65,
    577), D 8 / 64 / 128, bf16 and f16, causal and not, with a prefix key
    mask and a fully masked batch row; returns the worst errors."""
    eo = el = 0.0
    for t in (1, 63, 65, 577):
        for d in (8, 64, 128):
            for dtype in (torch.bfloat16, torch.float16):
                q, k, v, mask = _case(3, 2, t, d, [t, max(t // 2, 1), 0],
                                      True, t + d, dtype)
                for causal in (True, False):
                    o_e, l_e = _errors(lib, q, k, v, mask, 2, causal,
                                       slice(0, 4))
                    eo, el = max(eo, o_e), max(el, l_e)
    return {"o_max_abs": eo, "lse_max_abs": el}


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


def main():
    if not torch.cuda.is_available():
        print("attention_fwd_probe: no CUDA device", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    libs = build()
    print(json.dumps({"sweep_worst_errors": sweep(libs["plain"])}))
    rng = np.random.default_rng(0)
    lens = rng.integers(2, 513, 32)
    lens[0], lens[1] = 1, 0
    shapes = {
        # chip_smoke.py phase 3's shapes
        "B1 ragged (B 32, H 12, T 512, D 64)": (32, 12, 512, 64, lens, True),
        "B1 train (B 32, T 512, unmasked)": (32, 12, 512, 64, [512] * 32,
                                             False),
        "B3 (B 4, H 12, T 2048, D 64)": (4, 12, 2048, 64,
                                         [2048, 1536, 777, 1], True),
    }
    for what, (b, h, t, d, lengths, masked) in shapes.items():
        q, k, v, mask = _case(b, h, t, d, lengths, masked, 1)
        live = torch.from_numpy(np.repeat(np.asarray(lengths) > 0, h)).cuda()
        lib = libs["plain"]
        run = lambda: _launch(lib, q, k, v, mask, h)
        err_o, err_l = _errors(lib, q, k, v, mask, h, True, live)
        print(json.dumps({"shape": what, "card": card, "ms": _time_ms(run),
                          "host_us_per_launch": _host_us(run),
                          "o_max_abs": err_o, "lse_max_abs": err_l}))
        lib = libs["stamped"]
        _launch(lib, q, k, v, mask, h)    # warm
        torch.cuda.synchronize()
        if lib.probe_reset():
            raise RuntimeError("probe_reset failed")
        _launch(lib, q, k, v, mask, h)
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * len(PHASES))()
        if lib.probe_read(out):
            raise RuntimeError("probe_read failed")
        cyc = np.array(out[:], dtype=np.float64)
        share = {p: round(float(c / cyc.sum()), 4)
                 for p, c in zip(PHASES, cyc)}
        print(json.dumps({"shape": what, "warp_cycle_share": share,
                          "warp_cycles": float(cyc.sum())}))


if __name__ == "__main__":
    main()
