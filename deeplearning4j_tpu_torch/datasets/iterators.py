"""DataSet iterators (the JAX package's ``datasets/iterators.py``): the
``DataSetIterator`` contract, a list of ready batches, batches cut from a
(features, labels) array pair, and :func:`as_iterator`.

Synchronous only: the JAX package's ``AsyncDataSetIterator`` (a producer
thread that also starts the host→device copy) is not ported, so ``fit``
pulls each batch on the training thread."""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from ..ops.dataset import DataSet, MultiDataSet


class DataSetIterator:
    """Iterable over DataSet minibatches, with ``reset``."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self):
        pass

    def batch_size(self) -> int:
        return 0

    def total_examples(self) -> int:
        return 0


class ListDataSetIterator(DataSetIterator):
    """Iterate a list of ready DataSets."""

    def __init__(self, batches: Sequence[DataSet]):
        self._batches = list(batches)

    def __iter__(self):
        return iter(self._batches)

    def batch_size(self) -> int:
        return self._batches[0].num_examples() if self._batches else 0

    def total_examples(self) -> int:
        return sum(b.num_examples() for b in self._batches)


class ArrayDataSetIterator(DataSetIterator):
    """Minibatches of ``batch_size`` rows of a (features, labels) pair and
    its optional masks, reshuffled each pass when ``shuffle`` (numpy's
    generator from ``seed``, as the JAX package draws it)."""

    def __init__(self, features: np.ndarray, labels: Optional[np.ndarray],
                 batch_size: int = 32, shuffle: bool = False, seed: int = 0,
                 features_mask: Optional[np.ndarray] = None,
                 labels_mask: Optional[np.ndarray] = None):
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        self.features_mask = features_mask
        self.labels_mask = labels_mask
        self._bs = int(batch_size)
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        n = self.features.shape[0]
        order = self._rng.permutation(n) if self._shuffle else np.arange(n)
        pick = lambda a, idx: None if a is None else a[idx]
        for i in range(0, n, self._bs):
            idx = order[i:i + self._bs]
            yield DataSet(self.features[idx], pick(self.labels, idx),
                          pick(self.features_mask, idx),
                          pick(self.labels_mask, idx))

    def batch_size(self) -> int:
        return self._bs

    def total_examples(self) -> int:
        return int(self.features.shape[0])


def as_iterator(data) -> DataSetIterator:
    """A DataSet or MultiDataSet, a list or tuple of them, or an iterator,
    as a DataSetIterator."""
    if isinstance(data, DataSetIterator):
        return data
    if isinstance(data, (DataSet, MultiDataSet)):
        return ListDataSetIterator([data])
    if isinstance(data, (list, tuple)):
        return ListDataSetIterator(list(data))
    raise TypeError(f"Cannot iterate {type(data)} as DataSets")
