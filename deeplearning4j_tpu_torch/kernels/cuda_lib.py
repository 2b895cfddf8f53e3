"""Build, load and call the port's CUDA kernels.

Each ``csrc/<name>.cu`` exports plain C functions and is compiled at first
use by nvcc (``-gencode arch=compute_90a,code=sm_90a``) into
``build/kernels/lib<name>-<hash>.so`` under the repository root, then
loaded with ctypes. The hash covers the sources, so an edited kernel is
rebuilt and never loaded stale. Nothing here falls back: without CUDA, or
when nvcc fails, the loader raises (with nvcc's stderr).

:func:`record_compile` is the counting seam ``analysis.CompileAudit``
reads: every nvcc run and every ctypes load is recorded as ``(kind,
library, source hash)`` in one ordered process log,
:func:`compile_events`, whose builds also give :func:`nvcc_runs`; it
changes nothing about when a build runs or whether it raises."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: forward entries: (q, k, v, kmask, o, lse, bh, h, t, d, causal, dtype,
#: scale, stream)
_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
    [ctypes.c_float, ctypes.c_void_p]
#: backward entries: (q, k, v, kmask, do, lse, delta, dq, dk, dv, bh, h, t,
#: d, causal, dtype, scale, stream); an output an entry does not write may
#: be null
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + \
    [ctypes.c_float, ctypes.c_void_p]
#: the biased forward: (q, k, v, bias, o, lse, bh, h, t, d, np, dtype,
#: scale, stream)
_BIAS_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
    [ctypes.c_float, ctypes.c_void_p]
#: the biased backward: (q, k, v, bias, do, lse, delta, dq, dk, dv, dbias,
#: bh, h, t, d, np, ng, dtype, scale, stream)
_BIAS_BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + \
    [ctypes.c_float, ctypes.c_void_p]
#: each kernel library's C entry points and their argtypes
ENTRIES = {
    "shortseq_attention": {"shortseq_attention_fwd": _FWD_ARGTYPES,
                           "shortseq_attention_bias_fwd": _BIAS_FWD_ARGTYPES},
    "flash_forward": {"flash_attention_fwd": _FWD_ARGTYPES},
    "shortseq_attention_bwd": {
        "shortseq_attention_bwd": _BWD_ARGTYPES,
        "shortseq_attention_bias_bwd": _BIAS_BWD_ARGTYPES},
    "flash_backward": {"flash_attention_bwd_dq": _BWD_ARGTYPES,
                       "flash_attention_bwd_dkv": _BWD_ARGTYPES},
    # (xw, r, h0, c0, pi, pf, po, mask, y, hT, cT, xw_st, xw_sn, y_st,
    # y_sn, t, n, h, dtype, gate, cell, scratch, stream, route*) and (n,
    # h, dtype, gate, cell, out[9])
    "lstm": {"lstm_recurrence_fwd_act": [ctypes.c_void_p] * 11 +
             [ctypes.c_longlong] * 4 + [ctypes.c_int] * 6 +
             [ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_int)],
             "lstm_plan_act": [ctypes.c_int] * 5 +
             [ctypes.POINTER(ctypes.c_longlong)]},
    # (x, res, gamma, beta, shift, y, stats, scratch, plan, m, c, dtype,
    # gdtype, variant, eps, stream), (dy, x, y, gamma, beta, mean, rstd, dx,
    # dres, dgb, scratch, plan, m, c, dtype, gdtype, variant, stream) and
    # (m, c, dtype, variant, plan*)
    # (sidx, perm, updates, weights, partial, bounds, table, n, rows, d,
    # lr, bf16, stream)
    "segment_update": {"segment_update_f32": [ctypes.c_void_p] * 7 +
                       [ctypes.c_longlong] * 2 +
                       [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                        ctypes.c_void_p]},
    "batchnorm": {"batchnorm_fwd": [ctypes.c_void_p] * 9 +
                  [ctypes.c_longlong] + [ctypes.c_int] * 4 +
                  [ctypes.c_float, ctypes.c_void_p],
                  "batchnorm_bwd": [ctypes.c_void_p] * 12 +
                  [ctypes.c_longlong] + [ctypes.c_int] * 4 +
                  [ctypes.c_void_p],
                  "batchnorm_plan": [ctypes.c_longlong] +
                  [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)],
                  # the general route: (x, res, gamma, beta, shift, y,
                  # stats, scratch, m, c, gx, dtype, gdtype, variant, eps,
                  # stream) and (dy, x, y, gamma, beta, mean, rstd, dx,
                  # dres, dgb, scratch, m, c, gx, dtype, gdtype, variant,
                  # stream)
                  "batchnorm_gen_fwd": [ctypes.c_void_p] * 8 +
                  [ctypes.c_longlong] + [ctypes.c_int] * 5 +
                  [ctypes.c_float, ctypes.c_void_p],
                  "batchnorm_gen_bwd": [ctypes.c_void_p] * 11 +
                  [ctypes.c_longlong] + [ctypes.c_int] * 5 +
                  [ctypes.c_void_p],
                  # across shards: (x, dy, y, gamma, beta, center, rstd,
                  # partial, m, c, gx, dtype, gdtype, variant, stream),
                  # (partial, m, c, g, gamma, beta, shift, stats, dgb,
                  # coef, dtype, gdtype, variant, eps, stream) and (x, res,
                  # dy, y, gamma, beta, mean, rstd, coef, out, dres, m, c,
                  # dtype, gdtype, variant, stream)
                  "batchnorm_xs_stats": [ctypes.c_void_p] * 8 +
                  [ctypes.c_longlong] + [ctypes.c_int] * 5 +
                  [ctypes.c_void_p],
                  "batchnorm_xs_finalize": [ctypes.c_void_p,
                                            ctypes.c_longlong] +
                  [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 +
                  [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p],
                  "batchnorm_xs_apply": [ctypes.c_void_p] * 11 +
                  [ctypes.c_longlong] + [ctypes.c_int] * 4 +
                  [ctypes.c_void_p]},
}
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_EVENTS_LOCK = threading.Lock()
#: every build and load of this process, in order: ("build" | "load",
#: library, source hash)
_EVENTS: List[Tuple[str, str, str]] = []


def record_compile(kind: str, name: str, digest: str) -> None:
    """Record one nvcc build (``kind`` "build") or ctypes load ("load")
    of library ``name`` under source hash ``digest``."""
    with _EVENTS_LOCK:
        _EVENTS.append((kind, name, digest))


def compile_events() -> List[Tuple[str, str, str]]:
    """Every (kind, library, source hash) recorded so far."""
    with _EVENTS_LOCK:
        return list(_EVENTS)


def nvcc_runs() -> int:
    """nvcc processes this process has started (a serving engine rebuilt
    around a loaded decoder, as a supervisor restart is, adds none)."""
    return sum(kind == "build" for kind, _, _ in compile_events())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the port's "
                       "CUDA kernels are compiled at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _digest(path: Path) -> str:
    """The source hash in a library path from :func:`_lib_path`."""
    return path.stem.rsplit("-", 1)[-1]


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA kernels need a CUDA device; none is "
                           "available (CPU tensors take the plain PyTorch "
                           "version instead)")


def build(names: Iterable[str]) -> Dict[str, Dict]:
    """Compile every missing library among ``names`` with one nvcc process
    each, all started together, and wait for all of them. Returns, per
    library built, ``{"seconds": nvcc wall time, "log": nvcc's output}``;
    raises with nvcc's stderr when any build fails."""
    _require_cuda()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out, time.perf_counter())
        record_compile("build", name, _digest(out))
    failures, logs = [], {}
    for name, (proc, tmp, out, t0) in procs.items():
        stdout, stderr = proc.communicate()
        logs[name] = {"seconds": time.perf_counter() - t0,
                      "log": stdout + stderr}
        if proc.returncode != 0:
            failures.append(f"--- nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` (built first if needed), with its entry
    points' argtypes and restype declared."""
    _require_cuda()
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            # the nvcc wait under _LOCK is deliberate: one build per
            # library per process, and a second caller must wait for it
            build([name])   # graftlint: disable=GL010
            path = _lib_path(name)
            lib = ctypes.CDLL(str(path))
            record_compile("load", name, _digest(path))
            for entry, argtypes in ENTRIES[name].items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def check_attention_args(q3, k3, v3, key_mask, h: int, max_t=None) -> None:
    """Raise on anything the attention kernels do not take: q/k/v must be
    contiguous [BH, T, D] CUDA tensors of one float dtype on one device,
    D a positive multiple of 8 (the wrappers zero-pad any other D first:
    ``shortseq_attention.padded_fwd``); the key mask a
    contiguous f32 [BH / h, T] on the same device."""
    if q3.device.type != "cuda":
        raise ValueError(f"kernel inputs must be CUDA tensors, got "
                         f"{q3.device}")
    if q3.dtype not in _DTYPE_CODE:
        raise ValueError(f"attention kernels take float32/float16/bfloat16, "
                         f"got {q3.dtype}")
    for x in (k3, v3):
        if x.shape != q3.shape or x.dtype != q3.dtype or \
                x.device != q3.device:
            raise ValueError("q, k, v must share shape, dtype and device")
    if q3.dim() != 3:
        raise ValueError(f"expected [BH, T, D] inputs, got {tuple(q3.shape)}")
    bh, t, d = q3.shape
    if d % 8 or d < 8:
        raise ValueError(f"head dim {d} must be a positive multiple of 8")
    if max_t is not None and t > max_t:
        raise ValueError(f"T={t} > {max_t}")
    if h < 1 or bh % h or bh > 65535:
        raise ValueError(f"B*H={bh} must be a multiple of H={h} and <= "
                         "65535")
    if not all(x.is_contiguous() for x in (q3, k3, v3)):
        raise ValueError("q, k, v must be contiguous")
    if any(x.data_ptr() % 16 for x in (q3, k3, v3)):
        raise ValueError("q, k, v must start 16-byte aligned (the kernels "
                         "stage rows in 16-byte vectors)")
    if key_mask is not None:
        if key_mask.dtype != torch.float32 or \
                tuple(key_mask.shape) != (bh // h, t) or \
                key_mask.device != q3.device or \
                not key_mask.is_contiguous():
            raise ValueError(f"key mask must be a contiguous float32 "
                             f"[{bh // h}, {t}] tensor on {q3.device}")


def check_attention_bwd_args(q3, k3, v3, key_mask, h: int, do, lse, delta,
                             max_t=None) -> None:
    """:func:`check_attention_args`, and dO like q; lse and δ contiguous
    f32 [BH, T] on q's device."""
    check_attention_args(q3, k3, v3, key_mask, h, max_t)
    if do.shape != q3.shape or do.dtype != q3.dtype or \
            do.device != q3.device or not do.is_contiguous() or \
            do.data_ptr() % 16:
        raise ValueError("dO must be a contiguous, 16-byte aligned tensor "
                         "of q's shape, dtype and device")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.dtype != torch.float32 or tuple(x.shape) != q3.shape[:2] or \
                x.device != q3.device or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{list(q3.shape[:2])} tensor on {q3.device}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def launch_attention(name: str, q3, k3, v3, key_mask, h: int,
                     causal: bool, scale=None):
    """Allocate (o, lse) and launch kernel ``name`` on the current stream
    (no synchronisation); raises if the launch is refused. ``scale``
    multiplies the logits (1/√D of q's D by default)."""
    bh, t, d = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q3.device)
    with torch.cuda.device(q3.device):
        entry = next(iter(ENTRIES[name]))   # the library's plain forward
        fn = getattr(load(name), entry)
        rc = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), _ptr(key_mask),
                o.data_ptr(), lse.data_ptr(), bh, h, t, d, int(causal),
                _DTYPE_CODE[q3.dtype],
                float(d) ** -0.5 if scale is None else float(scale),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return o, lse


def launch_attention_bwd(name: str, entry: str, q3, k3, v3, key_mask,
                         h: int, causal: bool, do, lse, delta,
                         outputs=("dq", "dk", "dv"), scale=None):
    """Allocate the gradients named in ``outputs`` (each like q) and launch
    backward entry ``entry`` of library ``name`` on the current stream (no
    synchronisation); raises if the launch is refused. Returns the
    allocated gradients in (dq, dk, dv) order."""
    bh, t, d = q3.shape
    grads = {g: torch.empty_like(q3) for g in outputs}
    with torch.cuda.device(q3.device):
        fn = getattr(load(name), entry)
        rc = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), _ptr(key_mask),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                _ptr(grads.get("dq")), _ptr(grads.get("dk")),
                _ptr(grads.get("dv")), bh, h, t, d, int(causal),
                _DTYPE_CODE[q3.dtype],
                float(d) ** -0.5 if scale is None else float(scale),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return tuple(grads[g] for g in ("dq", "dk", "dv") if g in grads)


def check_attention_bias_args(q3, bias, h: int) -> None:
    """Raise on what the biased kernels do not take beyond
    :func:`check_attention_args`: bf16 / f16 inputs of D <= 128 (their
    wgmma core), a contiguous f32 bias [P, h, T, T] on q's device, and
    rows that are whole (image, P, h) groups."""
    bh, t, d = q3.shape
    if q3.dtype not in (torch.float16, torch.bfloat16):
        raise ValueError(f"the biased attention kernels take float16 / "
                         f"bfloat16, got {q3.dtype}")
    if d > 128:
        raise ValueError(f"the biased attention kernels take D <= 128, "
                         f"got {d}")
    if bias.dim() != 4 or tuple(bias.shape[1:]) != (h, t, t) or \
            bias.dtype != torch.float32 or bias.device != q3.device or \
            not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous float32 [P, {h}, {t}, "
                         f"{t}] tensor on {q3.device}, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if bh % (bias.shape[0] * h):
        raise ValueError(f"B*H={bh} rows must be whole groups of P={bias.shape[0]} "
                         f"blocks of H={h} heads")


def launch_attention_bias(q3, k3, v3, bias, h: int, scale: float):
    """Allocate (o, lse) and launch the biased short-sequence forward on
    the current stream (no synchronisation); raises if the launch is
    refused."""
    bh, t, d = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q3.device)
    with torch.cuda.device(q3.device):
        fn = load("shortseq_attention").shortseq_attention_bias_fwd
        rc = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), bias.data_ptr(),
                o.data_ptr(), lse.data_ptr(), bh, h, t, d, bias.shape[0],
                _DTYPE_CODE[q3.dtype], float(scale),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"shortseq_attention_bias_fwd kernel launch "
                           f"failed: CUDA error {rc}")
    return o, lse


def launch_attention_bias_bwd(q3, k3, v3, bias, h: int, do, lse, delta,
                              scale: float, groups: int = 1):
    """Allocate dq, dk, dv (each like q) and dbias's ``groups`` partial
    sums [groups, *bias.shape] f32 and launch the biased short-sequence
    backward on the current stream (no synchronisation); raises if the
    launch is refused. Returns (dq, dk, dv, dbias summed over the
    groups)."""
    bh, t, d = q3.shape
    dq, dk, dv = (torch.empty_like(q3) for _ in range(3))
    dbias = torch.empty((groups, *bias.shape), dtype=torch.float32,
                        device=bias.device)
    with torch.cuda.device(q3.device):
        fn = load("shortseq_attention_bwd").shortseq_attention_bias_bwd
        rc = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), bias.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                dbias.data_ptr(), bh, h, t, d, bias.shape[0], groups,
                _DTYPE_CODE[q3.dtype], float(scale),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"shortseq_attention_bias_bwd kernel launch "
                           f"failed: CUDA error {rc}")
    return dq, dk, dv, dbias[0] if groups == 1 else dbias.sum(0)
