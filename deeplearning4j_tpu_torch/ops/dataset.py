"""DataSet / MultiDataSet containers and normalizers (the JAX package's
``ops/dataset.py``, numpy only; the port keeps its own copy).

Feature / label arrays with optional mask arrays for variable-length
sequences, plus NormalizerStandardize, NormalizerMinMaxScaler and
ImagePreProcessingScaler with fit / transform / revert and
``to_bytes`` / ``from_bytes`` (the checkpoint's ``normalizer.bin`` slot).
Containers hold host-side numpy arrays; device placement happens at the
train-step boundary."""

from __future__ import annotations

import dataclasses
import io
import json
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class DataSet:
    """One minibatch: features [N, ...], labels [N, ...], optional masks."""
    features: np.ndarray
    labels: Optional[np.ndarray] = None
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_test_and_train(self, n_train: int):
        a = DataSet(self.features[:n_train],
                    None if self.labels is None else self.labels[:n_train],
                    None if self.features_mask is None else self.features_mask[:n_train],
                    None if self.labels_mask is None else self.labels_mask[:n_train])
        b = DataSet(self.features[n_train:],
                    None if self.labels is None else self.labels[n_train:],
                    None if self.features_mask is None else self.features_mask[n_train:],
                    None if self.labels_mask is None else self.labels_mask[n_train:])
        return a, b

    def shuffle(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        perm = rng.permutation(self.num_examples())
        self.features = self.features[perm]
        if self.labels is not None:
            self.labels = self.labels[perm]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[perm]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[perm]

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        n = self.num_examples()
        out = []
        for i in range(0, n, batch_size):
            sl = slice(i, min(i + batch_size, n))
            out.append(DataSet(
                self.features[sl],
                None if self.labels is None else self.labels[sl],
                None if self.features_mask is None else self.features_mask[sl],
                None if self.labels_mask is None else self.labels_mask[sl]))
        return out

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        feats = np.concatenate([d.features for d in datasets], axis=0)
        labels = None
        if datasets[0].labels is not None:
            labels = np.concatenate([d.labels for d in datasets], axis=0)
        fm = None
        if datasets[0].features_mask is not None:
            fm = np.concatenate([d.features_mask for d in datasets], axis=0)
        lm = None
        if datasets[0].labels_mask is not None:
            lm = np.concatenate([d.labels_mask for d in datasets], axis=0)
        return DataSet(feats, labels, fm, lm)


@dataclasses.dataclass
class MultiDataSet:
    """Multi-input/multi-output minibatch for ComputationGraph training."""
    features: List[np.ndarray]
    labels: List[np.ndarray]
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])


# --- normalizers --------------------------------------------------------------

class DataNormalizer:
    """Base: fit(iterator-or-DataSet), transform/revert in place, serde."""
    kind = "base"

    def fit(self, data) -> "DataNormalizer":
        raise NotImplementedError

    def transform(self, ds: DataSet) -> DataSet:
        raise NotImplementedError

    def revert_features(self, f: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def pre_process(self, ds: DataSet) -> DataSet:
        return self.transform(ds)

    # serialization (the ``normalizer.bin`` slot of the checkpoint zip)
    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        state = {k: v for k, v in self.__dict__.items()}
        arrays = {k: v for k, v in state.items() if isinstance(v, np.ndarray)}
        scalars = {k: v for k, v in state.items() if not isinstance(v, np.ndarray)}
        np.savez(buf, __meta__=np.frombuffer(
            json.dumps({"kind": self.kind, "scalars": scalars}).encode(), dtype=np.uint8),
            **arrays)
        return buf.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "DataNormalizer":
        with np.load(io.BytesIO(data)) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            kinds = {c.kind: c for c in
                     (NormalizerStandardize, NormalizerMinMaxScaler,
                      ImagePreProcessingScaler)}
            obj = kinds[meta["kind"]]()
            obj.__dict__.update(meta["scalars"])
            for k in z.files:
                if k != "__meta__":
                    obj.__dict__[k] = z[k]
        return obj


def _feature_axes(f: np.ndarray):
    # statistics per feature channel: axis 0 (+ trailing spatial/time axes)
    if f.ndim <= 2:
        return (0,)
    if f.ndim == 3:          # [N, C, T] time series
        return (0, 2)
    return (0,) + tuple(range(2, f.ndim))  # [N, C, H, W]


class NormalizerStandardize(DataNormalizer):
    """Zero-mean unit-variance per feature (reference NormalizerStandardize)."""
    kind = "standardize"

    def __init__(self, fit_labels: bool = False):
        self.fit_labels = bool(fit_labels)
        self.mean = None
        self.std = None
        self.label_mean = None
        self.label_std = None

    def fit(self, data):
        ds = _as_dataset(data)
        ax = _feature_axes(ds.features)
        self.mean = np.asarray(ds.features, np.float64).mean(axis=ax)
        self.std = np.asarray(ds.features, np.float64).std(axis=ax) + 1e-8
        if self.fit_labels and ds.labels is not None:
            lax_ = _feature_axes(ds.labels)
            self.label_mean = np.asarray(ds.labels, np.float64).mean(axis=lax_)
            self.label_std = np.asarray(ds.labels, np.float64).std(axis=lax_) + 1e-8
        return self

    def _bshape(self, arr, stat):
        shape = [1] * arr.ndim
        shape[1 if arr.ndim > 1 else 0] = -1
        return np.asarray(stat, np.float32).reshape(shape)

    def transform(self, ds: DataSet) -> DataSet:
        f = (ds.features - self._bshape(ds.features, self.mean)) / \
            self._bshape(ds.features, self.std)
        labels = ds.labels
        if self.fit_labels and labels is not None and self.label_mean is not None:
            labels = (labels - self._bshape(labels, self.label_mean)) / \
                self._bshape(labels, self.label_std)
        return DataSet(f.astype(np.float32), labels, ds.features_mask, ds.labels_mask)

    def revert_features(self, f: np.ndarray) -> np.ndarray:
        return f * self._bshape(f, self.std) + self._bshape(f, self.mean)

    def revert_labels(self, y: np.ndarray) -> np.ndarray:
        if self.label_mean is None:
            return y
        return y * self._bshape(y, self.label_std) + self._bshape(y, self.label_mean)


class NormalizerMinMaxScaler(DataNormalizer):
    """Scale features to [min_range, max_range] (reference NormalizerMinMaxScaler)."""
    kind = "minmax"

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self.fmin = None
        self.fmax = None

    def fit(self, data):
        ds = _as_dataset(data)
        ax = _feature_axes(ds.features)
        self.fmin = np.asarray(ds.features, np.float64).min(axis=ax)
        self.fmax = np.asarray(ds.features, np.float64).max(axis=ax)
        return self

    def _bshape(self, arr, stat):
        shape = [1] * arr.ndim
        shape[1 if arr.ndim > 1 else 0] = -1
        return np.asarray(stat, np.float32).reshape(shape)

    def transform(self, ds: DataSet) -> DataSet:
        lo = self._bshape(ds.features, self.fmin)
        hi = self._bshape(ds.features, self.fmax)
        scaled = (ds.features - lo) / np.maximum(hi - lo, 1e-8)
        f = scaled * (self.max_range - self.min_range) + self.min_range
        return DataSet(f.astype(np.float32), ds.labels, ds.features_mask,
                       ds.labels_mask)

    def revert_features(self, f: np.ndarray) -> np.ndarray:
        lo = self._bshape(f, self.fmin)
        hi = self._bshape(f, self.fmax)
        return (f - self.min_range) / (self.max_range - self.min_range) * \
            np.maximum(hi - lo, 1e-8) + lo


class ImagePreProcessingScaler(DataNormalizer):
    """Scale pixel values from [0, max_pixel] to [min, max]
    (reference ImagePreProcessingScaler; default [0,255]→[0,1])."""
    kind = "image"

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0,
                 max_pixel: float = 255.0):
        self.min_range = float(min_range)
        self.max_range = float(max_range)
        self.max_pixel = float(max_pixel)

    def fit(self, data):
        return self  # stateless

    def transform(self, ds: DataSet) -> DataSet:
        f = ds.features / self.max_pixel * (self.max_range - self.min_range) \
            + self.min_range
        return DataSet(f.astype(np.float32), ds.labels, ds.features_mask,
                       ds.labels_mask)

    def revert_features(self, f: np.ndarray) -> np.ndarray:
        return (f - self.min_range) / (self.max_range - self.min_range) * self.max_pixel


def _as_dataset(data) -> DataSet:
    """Accept a DataSet or an iterator of DataSets (merged for fitting stats)."""
    if isinstance(data, DataSet):
        return data
    batches = list(data)
    if hasattr(data, "reset"):
        data.reset()
    return DataSet.merge(batches)
