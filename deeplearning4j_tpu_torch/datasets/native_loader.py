"""ctypes binding for the native data loader (``csrc/dataloader.cpp``, the
port's copy of the JAX package's ``native/dataloader.cpp``): CSV and IDX
record readers with a background prefetch ring that shuffles (C++
``mt19937_64``, reseeded with seed + 1 each epoch) and assembles batches
while the train step runs.

The library is built at first use with g++ into
``build/native/libdl4j_loader-<hash>.so`` under the repository root (the
hash covers the source, so an edited source is rebuilt, never loaded
stale; a temporary file and an atomic rename keep concurrent builds from
loading a half-written library). A failed build raises
:class:`NativeBuildError` with g++'s stderr; :func:`native_available`
asks without raising. Batches are host numpy ``DataSet``s, as the Python
iterators give: the trainer or ``AsyncDataSetIterator(device=)`` stages
them on the card."""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from ..ops.dataset import DataSet
from .iterators import DataSetIterator

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")
_LOG = logging.getLogger(__name__)
_load_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    """g++ did not build the native loader; the message holds its stderr."""


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha1(Path(source).read_bytes()).hexdigest()[:12]
    return Path(build_dir) / f"libdl4j_loader-{digest}.so"


def build_library(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """The shared library of ``source`` in ``build_dir``, built with g++
    unless it is there already. Raises NativeBuildError on failure."""
    path = library_path(source, build_dir)
    if path.exists():
        return path
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=build_dir, suffix=".so.tmp")
    os.close(fd)
    try:
        _LOG.info("building the native data loader: %s", path)
        try:
            r = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(source)],
                               capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise NativeBuildError(f"g++ could not run on {source}: {e}") \
                from e
        if r.returncode != 0:
            raise NativeBuildError(
                f"g++ failed (exit {r.returncode}) on {source}:\n{r.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    lib.csv_loader_create.restype = ctypes.c_void_p
    lib.csv_loader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_char]
    lib.idx_loader_create.restype = ctypes.c_void_p
    lib.idx_loader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_uint64]
    for fn in ("loader_num_examples", "loader_feature_cols",
               "loader_label_cols", "loader_next"):
        getattr(lib, fn).restype = ctypes.c_int64
    lib.loader_num_examples.argtypes = [ctypes.c_void_p]
    lib.loader_feature_cols.argtypes = [ctypes.c_void_p]
    lib.loader_label_cols.argtypes = [ctypes.c_void_p]
    lib.loader_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_float)]
    lib.loader_reset.restype = None
    lib.loader_reset.argtypes = [ctypes.c_void_p]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _load_lib():
    """The bound library, built on first use; raises NativeBuildError."""
    global _lib
    with _load_lock:
        if _lib is None:
            # the g++ wait under _load_lock is deliberate: one build per
            # process, and a second caller must wait for it
            _lib = _bind(build_library())   # graftlint: disable=GL010
        return _lib


def native_available() -> bool:
    """Whether the native loader builds and loads here."""
    try:
        _load_lib()
    except NativeBuildError as e:
        _LOG.warning("native data loader unavailable: %s", e)
        return False
    return True


class _NativeIteratorBase(DataSetIterator):
    async_supported = False   # the native ring prefetches already

    def __init__(self, handle, batch_size: int):
        self._lib = _load_lib()
        self._h = handle
        self._bs = int(batch_size)
        self._fc = self._lib.loader_feature_cols(self._h)
        self._lc = self._lib.loader_label_cols(self._h)
        self._n = self._lib.loader_num_examples(self._h)

    def __iter__(self):
        lib = self._lib
        f32p = ctypes.POINTER(ctypes.c_float)
        while True:
            # fresh arrays a batch: the ring copies straight into them
            fbuf = np.empty((self._bs, self._fc), np.float32)
            lbuf = np.empty((self._bs, max(self._lc, 1)), np.float32)
            n = lib.loader_next(self._h, fbuf.ctypes.data_as(f32p),
                                lbuf.ctypes.data_as(f32p))
            if n == 0:
                lib.loader_reset(self._h)   # rearm for the next epoch
                return
            yield DataSet(fbuf[:n], lbuf[:n] if self._lc else None)

    def batch_size(self) -> int:
        return self._bs

    def total_examples(self) -> int:
        return int(self._n)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.loader_destroy(self._h)
            self._h = None


class NativeCSVDataSetIterator(_NativeIteratorBase):
    """CSV → DataSet batches through the native reader (the
    RecordReaderDataSetIterator over a CSVRecordReader)."""

    def __init__(self, path, batch_size: int, label_index: int = -1,
                 num_classes: int = 0, shuffle: bool = True, seed: int = 0,
                 skip_lines: int = 0, delimiter: str = ","):
        lib = _load_lib()
        h = lib.csv_loader_create(str(path).encode(), batch_size,
                                  label_index, num_classes,
                                  1 if shuffle else 0, seed, skip_lines,
                                  delimiter.encode()[:1])
        if not h:
            raise IOError(f"cannot load CSV {path}")
        super().__init__(h, batch_size)


class NativeMnistDataSetIterator(_NativeIteratorBase):
    """IDX files (plain, not gzipped) → flattened DataSet batches through
    the native reader."""

    def __init__(self, images_path, labels_path, batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        lib = _load_lib()
        h = lib.idx_loader_create(str(images_path).encode(),
                                  str(labels_path).encode(), batch_size,
                                  1 if shuffle else 0, seed)
        if not h:
            raise IOError(f"cannot load IDX {images_path}")
        super().__init__(h, batch_size)
