"""ctypes binding for the native parameter-server core
(``csrc/param_server.cpp``, the port's copy of the JAX package's
``native/param_server.cpp``): a C++ aggregation store and TCP listener, so
concurrent pushes of large flattened parameter vectors run without the
GIL. Same surface as :class:`.param_server.InMemoryParameterServer` (and
``ParameterServerNode`` with ``serve=True``).

The library is built at first use with g++ into
``build/native/libdl4j_ps-<hash>.so`` under the repository root (the hash
covers the source, so an edited source is rebuilt, never loaded stale);
when that fails, :class:`NativeParameterServer` raises ImportError.

Wire protocol (the native TCP front-end): 1-byte opcode ('P' push / 'G'
get / 'Q' quit) + u64 little-endian length + raw little-endian f32
payload; 'G' answers with an 'R' frame. :class:`NativeParameterServerClient`
speaks it from Python."""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import socket
import struct
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "param_server.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")
_LOG = logging.getLogger(__name__)
_load_lock = threading.Lock()
_lib = None


def _lib_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libdl4j_ps-{digest}.so"


def _build(path: Path) -> None:
    """g++ the source into ``path`` through a temporary file and an atomic
    rename (concurrent builds never load a half-written library)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        _LOG.info("building the native parameter server: %s", path)
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load_lib():
    global _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not path.exists():
            try:
                # the g++ wait under _load_lock is deliberate: one build
                # per process, and a second caller must wait for it
                _build(path)   # graftlint: disable=GL010
            except (OSError, subprocess.SubprocessError) as e:
                _LOG.warning("native parameter server did not build: %s", e)
                return None
        lib = ctypes.CDLL(str(path))
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.ps_create.restype = ctypes.c_void_p
        lib.ps_create.argtypes = [f32p, ctypes.c_int64, ctypes.c_double,
                                  ctypes.c_int, ctypes.c_int]
        lib.ps_port.restype = ctypes.c_int
        lib.ps_port.argtypes = [ctypes.c_void_p]
        lib.ps_push.restype = None
        lib.ps_push.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64]
        lib.ps_pull.restype = None
        lib.ps_pull.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64]
        lib.ps_pushes.restype = ctypes.c_int64
        lib.ps_pushes.argtypes = [ctypes.c_void_p]
        lib.ps_destroy.restype = None
        lib.ps_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load_lib() is not None


def _as_f32(vector) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(vector, dtype=np.float32))


class NativeParameterServer:
    """Native aggregation store, optionally serving the TCP protocol on an
    ephemeral loopback port (``serve=True``; ``host`` / ``port``)."""

    def __init__(self, initial: np.ndarray, alpha: Optional[float] = None,
                 num_workers: int = 1, serve: bool = False, port: int = 0):
        lib = _load_lib()
        if lib is None:
            raise ImportError("the native parameter-server library did not "
                              "build (no C++ toolchain?); use "
                              "parallel.param_server instead")
        self._lib = lib
        init = _as_f32(initial).ravel()
        self._n = init.size
        a = float(alpha) if alpha is not None else 1.0 / max(1, num_workers)
        self._h = lib.ps_create(
            init.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._n, a, int(port), 1 if serve else 0)
        if not self._h:
            raise OSError("ps_create failed (bind error?)")
        self.host = "127.0.0.1"
        self.port = lib.ps_port(self._h) if serve else 0
        self._closed = False

    @property
    def pushes(self) -> int:
        return int(self._lib.ps_pushes(self._h))

    def push(self, vector: np.ndarray) -> None:
        v = _as_f32(vector).ravel()
        if v.size != self._n:
            raise ValueError(f"push size {v.size} != server {self._n}")
        self._lib.ps_push(
            self._h, v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._n)

    def pull(self) -> np.ndarray:
        out = np.empty(self._n, np.float32)
        self._lib.ps_pull(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._n)
        return out

    # reference naming (ParameterServerClient.pushNDArray / getNDArray)
    push_ndarray = push
    get_ndarray = pull

    def shutdown(self):
        if not self._closed:
            self._closed = True
            self._lib.ps_destroy(self._h)

    close = shutdown

    def __del__(self):
        if not getattr(self, "_closed", True):
            self.shutdown()


class NativeParameterServerClient:
    """Python client for the native TCP protocol (raw-f32 framing). One
    connection carries alternating request / response frames, so each
    round trip holds the lock."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()

    # Socket I/O under the lock is the PROTOCOL (GL010-annotated): one
    # shared connection carries alternating request/response frames, so
    # each round-trip is one critical section by design — same contract
    # as ParameterServerClient.
    def push_ndarray(self, vector: np.ndarray) -> None:
        payload = _as_f32(vector).tobytes()
        with self._lock:
            self._sock.sendall(   # graftlint: disable=GL010
                b"P" + struct.pack("<Q", len(payload)) + payload)

    def get_ndarray(self) -> np.ndarray:
        with self._lock:
            self._sock.sendall(   # graftlint: disable=GL010
                b"G" + struct.pack("<Q", 0))
            hdr = self._recv_exact(9)   # graftlint: disable=GL010
            if hdr[0:1] != b"R":
                raise ConnectionError("bad response frame")
            (ln,) = struct.unpack("<Q", hdr[1:])
            return np.frombuffer(
                self._recv_exact(ln),   # graftlint: disable=GL010
                dtype=np.float32).copy()

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n:
            c = self._sock.recv(min(n, 1 << 20))
            if not c:
                raise ConnectionError("peer closed")
            chunks.append(c)
            n -= len(c)
        return b"".join(chunks)

    def close(self):
        try:
            with self._lock:
                self._sock.sendall(   # graftlint: disable=GL010
                    b"Q" + struct.pack("<Q", 0))
        except OSError:
            pass
        self._sock.close()
