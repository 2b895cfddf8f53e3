"""CIFAR-10, LFW and Curves iterators (the JAX package's
``datasets/fetchers.py``).

As in ``mnist.py``: real data is parsed when it is on disk, otherwise a
deterministic synthetic stand-in with the same shapes is generated
(``is_synthetic``); that is a data source, not a device fallback. Every
draw is numpy's in the JAX package's order, so arrays and batches are
bitwise the JAX package's for the same files and seeds.

- CIFAR-10: the binary batches (1 label byte + 3072 planar RGB bytes a
  record) from ``CIFAR_DIR`` / ``~/.cifar`` / ``./data/cifar-10-batches-bin``;
  features [N, 32, 32, 3] float32 in [0, 1] (NHWC), labels one-hot [N, 10].
- LFW: a directory of per-person subfolders of ``.jpg`` images
  (``LFW_DIR``; needs pillow); the stand-in draws per-identity blob
  prototypes.
- Curves: 28x28 images of random cubic Bezier strokes for the deep
  autoencoder benchmark; labels are the features."""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..ops.dataset import DataSet
from .iterators import DataSetIterator

_LOG = logging.getLogger(__name__)


# ------------------------------------------------------------------ CIFAR-10
def _find_dir(env: str, names: List[str]) -> Optional[Path]:
    candidates = []
    if os.environ.get(env):
        candidates.append(Path(os.environ[env]))
    candidates += [Path.home() / names[0], *map(Path, names[1:])]
    for c in candidates:
        if c.is_dir():
            return c
    return None


def _load_cifar_real(train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    d = _find_dir("CIFAR_DIR", [".cifar", "data/cifar-10-batches-bin"])
    if d is None:
        return None
    files = [d / f"data_batch_{i}.bin" for i in range(1, 6)] if train \
        else [d / "test_batch.bin"]
    if not all(f.exists() for f in files):
        return None
    feats, labels = [], []
    for f in files:
        raw = np.frombuffer(f.read_bytes(), dtype=np.uint8)
        rec = raw.reshape(-1, 3073)
        labels.append(rec[:, 0].astype(np.int64))
        # stored CHW planar per record -> NHWC
        imgs = rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        feats.append(imgs.astype(np.float32) / 255.0)
    return np.concatenate(feats), np.concatenate(labels)


_CIFAR_PROTOS = {}


def _synthetic_images(n: int, classes: int, hw: int, channels: int,
                      seed: int, train: bool) \
        -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional blob prototypes + noise (deterministic)."""
    key = (classes, hw, channels, seed)
    if key not in _CIFAR_PROTOS:
        protos = np.zeros((classes, hw, hw, channels), np.float32)
        for c in range(classes):
            cg = np.random.default_rng(seed * 1000 + c)
            canvas = np.zeros((hw, hw, channels), np.float32)
            for _ in range(5):
                cy, cx = cg.integers(hw // 4, 3 * hw // 4, 2)
                r = int(cg.integers(2, hw // 4))
                col = cg.uniform(0.3, 1.0, channels)
                yy, xx = np.ogrid[:hw, :hw]
                mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
                canvas[mask] = col
            protos[c] = canvas
        _CIFAR_PROTOS[key] = protos
    protos = _CIFAR_PROTOS[key]
    rng = np.random.default_rng(seed + (0 if train else 1))
    labels = rng.integers(0, classes, n)
    imgs = protos[labels] * rng.uniform(
        0.7, 1.0, (n, 1, 1, 1)).astype(np.float32)
    imgs = np.clip(imgs + rng.normal(0, 0.1, imgs.shape), 0, 1)
    return imgs.astype(np.float32), labels


class _ArrayBackedIterator(DataSetIterator):
    def __init__(self, feats, labels, num_classes, batch_size, shuffle, seed):
        self._f, self._l = feats, labels
        self._nc = num_classes
        self._bs = int(batch_size)
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        n = len(self._f)
        order = self._rng.permutation(n) if self._shuffle else np.arange(n)
        stop = n - n % self._bs or n
        for i in range(0, stop, self._bs):
            idx = order[i:i + self._bs]
            yield DataSet(self._f[idx],
                          np.eye(self._nc, dtype=np.float32)[self._l[idx]])

    def batch_size(self) -> int:
        return self._bs

    def total_examples(self) -> int:
        return len(self._f)


class CifarDataSetIterator(_ArrayBackedIterator):
    """CifarDataSetIterator(batch, num_examples, train, shuffle, seed)."""

    NUM_CLASSES = 10

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 train: bool = True, shuffle: bool = True, seed: int = 6):
        real = _load_cifar_real(train)
        self.is_synthetic = real is None
        if real is not None:
            feats, labels = real
        else:
            n = min(num_examples or (50000 if train else 10000), 10000)
            if num_examples and num_examples > n:
                _LOG.warning(
                    "CIFAR synthetic stand-in capped at %d examples (%d "
                    "requested); place the binary batches in CIFAR_DIR for "
                    "the full dataset", n, num_examples)
            feats, labels = _synthetic_images(n, 10, 32, 3, 321, train)
        if num_examples:
            feats, labels = feats[:num_examples], labels[:num_examples]
        super().__init__(feats, labels, 10, batch_size, shuffle, seed)


# ----------------------------------------------------------------------- LFW
def _load_lfw_real(hw: int) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    d = _find_dir("LFW_DIR", [".lfw", "data/lfw"])
    if d is None:
        return None
    people = sorted(p for p in d.iterdir() if p.is_dir())
    if not people:
        return None
    try:
        from PIL import Image      # optional: only to decode real images
    except ImportError:
        return None
    feats, labels = [], []
    for li, person in enumerate(people):
        for img in sorted(person.glob("*.jpg")):
            arr = np.asarray(Image.open(img).resize((hw, hw)),
                             dtype=np.float32) / 255.0
            feats.append(arr if arr.ndim == 3 else arr[..., None])
            labels.append(li)
    return np.stack(feats), np.asarray(labels), len(people)


class LFWDataSetIterator(_ArrayBackedIterator):
    """Face images labelled by identity."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 image_size: int = 64, num_identities: int = 10,
                 shuffle: bool = True, seed: int = 6):
        real = _load_lfw_real(image_size)
        self.is_synthetic = real is None
        if real is not None:
            feats, labels, num_identities = real
        else:
            n = min(num_examples or 1000, 2000)
            if num_examples and num_examples > n:
                _LOG.warning(
                    "LFW synthetic stand-in capped at %d examples (%d "
                    "requested); point LFW_DIR at the real dataset for "
                    "more", n, num_examples)
            feats, labels = _synthetic_images(
                n, num_identities, image_size, 3, 777, True)
        if num_examples:
            feats, labels = feats[:num_examples], labels[:num_examples]
        self.num_identities = num_identities
        super().__init__(feats, labels, num_identities, batch_size, shuffle,
                         seed)


# -------------------------------------------------------------------- Curves
class CurvesDataSetIterator(DataSetIterator):
    """28x28 images of smooth random curves, the deep-autoencoder
    benchmark: the labels are the features."""

    HW = 28

    def __init__(self, batch_size: int, num_examples: int = 1000,
                 seed: int = 12):
        rng = np.random.default_rng(seed)
        imgs = np.zeros((num_examples, self.HW, self.HW), np.float32)
        t = np.linspace(0.0, 1.0, 64)
        for i in range(num_examples):
            # a random cubic Bezier stroke rasterized with thickness 1
            pts = rng.uniform(3, self.HW - 3, (4, 2))
            b = ((1 - t) ** 3)[:, None] * pts[0] + \
                (3 * (1 - t) ** 2 * t)[:, None] * pts[1] + \
                (3 * (1 - t) * t ** 2)[:, None] * pts[2] + \
                (t ** 3)[:, None] * pts[3]
            xi = np.clip(b[:, 0].astype(int), 0, self.HW - 1)
            yi = np.clip(b[:, 1].astype(int), 0, self.HW - 1)
            imgs[i, xi, yi] = 1.0
        self._f = imgs.reshape(num_examples, -1)
        self._bs = int(batch_size)

    def __iter__(self):
        n = len(self._f)
        stop = n - n % self._bs or n
        for i in range(0, stop, self._bs):
            f = self._f[i:i + self._bs]
            yield DataSet(f, f.copy())   # autoencoder: target == input

    def batch_size(self) -> int:
        return self._bs

    def total_examples(self) -> int:
        return len(self._f)
