"""Build, load and call the port's CUDA kernels.

Each ``csrc/<name>.cu`` exports plain C functions and is compiled at first
use by nvcc (``-gencode arch=compute_90a,code=sm_90a``) into
``build/kernels/lib<name>-<hash>.so`` under the repository root, then
loaded with ctypes. The hash covers the sources, so an edited kernel is
rebuilt and never loaded stale. Nothing here falls back: without CUDA, or
when nvcc fails, the loader raises (with nvcc's stderr)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

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
#: each kernel library's C entry points and their argtypes
ENTRIES = {
    "shortseq_attention": {"shortseq_attention_fwd": _FWD_ARGTYPES},
    "flash_forward": {"flash_attention_fwd": _FWD_ARGTYPES},
    "shortseq_attention_bwd": {"shortseq_attention_bwd": _BWD_ARGTYPES},
    "flash_backward": {"flash_attention_bwd_dq": _BWD_ARGTYPES,
                       "flash_attention_bwd_dkv": _BWD_ARGTYPES},
    # (xw, r, h0, c0, pi, pf, po, mask, y, hT, cT, xw_st, xw_sn, y_st,
    # y_sn, t, n, h, dtype, stream, route*) and (n, h, dtype, out[8])
    "lstm": {"lstm_recurrence_fwd": [ctypes.c_void_p] * 11 +
             [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4 +
             [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)],
             "lstm_plan": [ctypes.c_int] * 3 +
             [ctypes.POINTER(ctypes.c_longlong)]},
}
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


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
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for entry, argtypes in ENTRIES[name].items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def check_attention_args(q3, k3, v3, key_mask, h: int, max_t=None) -> None:
    """Raise on anything the attention kernels do not take: q/k/v must be
    contiguous [BH, T, D] CUDA tensors of one float dtype on one device,
    D a multiple of 8 and at most 128; the key mask a contiguous f32
    [BH / h, T] on the same device."""
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
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"head dim {d} must be a multiple of 8 in [8, 128]")
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
                     causal: bool):
    """Allocate (o, lse) and launch kernel ``name`` on the current stream
    (no synchronisation); raises if the launch is refused."""
    bh, t, d = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q3.device)
    with torch.cuda.device(q3.device):
        (entry,) = ENTRIES[name]
        fn = getattr(load(name), entry)
        rc = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), _ptr(key_mask),
                o.data_ptr(), lse.data_ptr(), bh, h, t, d, int(causal),
                _DTYPE_CODE[q3.dtype], float(d) ** -0.5,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return o, lse


def launch_attention_bwd(name: str, entry: str, q3, k3, v3, key_mask,
                         h: int, causal: bool, do, lse, delta,
                         outputs=("dq", "dk", "dv")):
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
                _DTYPE_CODE[q3.dtype], float(d) ** -0.5,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return tuple(grads[g] for g in ("dq", "dk", "dv") if g in grads)
