"""MNIST and Iris iterators (the JAX package's ``datasets/mnist.py``).

There is no download. The IDX files are parsed when they are on disk
(``MNIST_DIR``, ``~/.mnist`` or ``./data/mnist``; plain or ``.gz``);
otherwise a deterministic synthetic stand-in (10 glyph prototypes and
noise) with the same shapes is generated. Every draw is numpy's, in the
JAX package's order, so the arrays and the shuffled batches are bitwise
the JAX package's for the same files and seeds.

Features are [N, 28, 28, 1] float32 in [0, 1] (NHWC) or flat [N, 784];
labels one-hot [N, 10]. Batches are host numpy ``DataSet``s: the trainer
or ``AsyncDataSetIterator(device=)`` stages them on the card."""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..ops.dataset import DataSet
from .iterators import DataSetIterator

NUM_EXAMPLES_TRAIN = 60000
NUM_EXAMPLES_TEST = 10000


def _find_mnist_dir() -> Optional[Path]:
    candidates = []
    if os.environ.get("MNIST_DIR"):
        candidates.append(Path(os.environ["MNIST_DIR"]))
    candidates += [Path.home() / ".mnist", Path("data/mnist")]
    for c in candidates:
        if (c / "train-images-idx3-ubyte").exists() or \
                (c / "train-images-idx3-ubyte.gz").exists():
            return c
    return None


def _read_idx(path: Path) -> np.ndarray:
    """An IDX file (big-endian dims after a magic whose low byte is the
    rank) as a uint8 array."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _idx_paths(train: bool) -> Optional[Tuple[Path, Path]]:
    """(images, labels) IDX paths of the found MNIST directory, plain
    files first."""
    d = _find_mnist_dir()
    if d is None:
        return None
    prefix = "train" if train else "t10k"
    for suffix in ("", ".gz"):
        ipath = d / f"{prefix}-images-idx3-ubyte{suffix}"
        lpath = d / f"{prefix}-labels-idx1-ubyte{suffix}"
        if ipath.exists() and lpath.exists():
            return ipath, lpath
    return None


def _load_real(train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    paths = _idx_paths(train)
    if paths is None:
        return None
    imgs, labels = (_read_idx(p) for p in paths)
    return imgs.astype(np.float32) / 255.0, labels.astype(np.int64)


_GLYPH_CACHE = {}


def _synthetic(n: int, train: bool, seed: int = 123) -> \
        Tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST stand-in: 10 fixed glyph prototypes + noise."""
    key = seed
    if key not in _GLYPH_CACHE:
        protos = np.zeros((10, 28, 28), np.float32)
        for c in range(10):
            # blobby class-specific strokes: a few random thick segments
            canvas = np.zeros((28, 28), np.float32)
            cg = np.random.default_rng(seed * 100 + c)
            for _ in range(4):
                x0, y0 = cg.integers(4, 24, 2)
                dx, dy = cg.integers(-3, 4, 2)
                for t in range(10):
                    x = int(np.clip(x0 + t * dx / 3, 0, 27))
                    y = int(np.clip(y0 + t * dy / 3, 0, 27))
                    canvas[max(0, x - 1):x + 2, max(0, y - 1):y + 2] = 1.0
            protos[c] = canvas
        _GLYPH_CACHE[key] = protos
    protos = _GLYPH_CACHE[key]
    rng = np.random.default_rng(seed + (0 if train else 1))
    labels = rng.integers(0, 10, n)
    imgs = protos[labels] * rng.uniform(0.7, 1.0, (n, 1, 1)).astype(np.float32)
    imgs = np.clip(imgs + rng.normal(0, 0.15, (n, 28, 28)), 0, 1)
    return imgs.astype(np.float32), labels


class MnistDataSetIterator(DataSetIterator):
    """MnistDataSetIterator(batch, num_examples, train, shuffle, seed,
    flatten); ``is_synthetic`` says whether the IDX files were found."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 train: bool = True, shuffle: bool = True, seed: int = 6,
                 flatten: bool = False):
        self._bs = int(batch_size)
        self.train = train
        self.flatten = flatten
        real = _load_real(train)
        self.is_synthetic = real is None
        if real is not None:
            imgs, labels = real
        else:
            n = num_examples or (NUM_EXAMPLES_TRAIN if train
                                 else NUM_EXAMPLES_TEST)
            n = min(n, 10000)  # synthetic sets stay small
            imgs, labels = _synthetic(n, train)
        if num_examples:
            imgs, labels = imgs[:num_examples], labels[:num_examples]
        self._images = imgs
        self._labels = labels
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        n = len(self._images)
        order = self._rng.permutation(n) if self._shuffle else np.arange(n)
        for i in range(0, n - n % self._bs or n, self._bs):
            idx = order[i:i + self._bs]
            feats = self._images[idx]
            feats = feats.reshape(len(idx), -1) if self.flatten \
                else feats[..., None]
            labels = np.eye(10, dtype=np.float32)[self._labels[idx]]
            yield DataSet(feats, labels)

    def batch_size(self) -> int:
        return self._bs

    def total_examples(self) -> int:
        return len(self._images)


class IrisDataSetIterator(DataSetIterator):
    """The 3-cluster Iris structure from the published per-class feature
    means and stds, deterministic by seed (no CSV is fetched)."""

    _MEANS = np.array([[5.01, 3.42, 1.46, 0.24],
                       [5.94, 2.77, 4.26, 1.33],
                       [6.59, 2.97, 5.55, 2.03]], np.float32)
    _STDS = np.array([[0.35, 0.38, 0.17, 0.11],
                      [0.52, 0.31, 0.47, 0.20],
                      [0.64, 0.32, 0.55, 0.27]], np.float32)

    def __init__(self, batch_size: int = 150, num_examples: int = 150,
                 seed: int = 42):
        rng = np.random.default_rng(seed)
        per = max(1, num_examples // 3)
        feats, labels = [], []
        for c in range(3):
            feats.append(rng.normal(self._MEANS[c], self._STDS[c],
                                    (per, 4)).astype(np.float32))
            labels.append(np.full(per, c))
        self.features = np.concatenate(feats)
        self.labels = np.concatenate(labels)
        order = rng.permutation(len(self.features))
        self.features, self.labels = self.features[order], self.labels[order]
        self._bs = int(batch_size)

    def __iter__(self):
        for i in range(0, len(self.features), self._bs):
            f = self.features[i:i + self._bs]
            lab = np.eye(3, dtype=np.float32)[self.labels[i:i + self._bs]]
            yield DataSet(f, lab)

    def batch_size(self) -> int:
        return self._bs

    def total_examples(self) -> int:
        return len(self.features)
