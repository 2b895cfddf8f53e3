"""DataSet iterators (the JAX package's ``datasets/iterators.py``): the
``DataSetIterator`` contract, a list of ready batches, batches cut from a
(features, labels) array pair, :class:`AsyncDataSetIterator` (a producer
thread with a bounded queue that also makes the host→device copy, so the
next batch's copy overlaps the current train step),
:class:`MultipleEpochsIterator`, :class:`SamplingDataSetIterator` and
:func:`as_iterator`."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..ops.dataset import DataSet, MultiDataSet
from ..ops.platform import resolve_device
from ..ops.transfer import host_tensor, stage_to_device


class DataSetIterator:
    """Iterable over DataSet minibatches, with ``reset``. ``fit`` wraps an
    iterator in :class:`AsyncDataSetIterator` unless it says
    ``async_supported = False``."""
    async_supported = True

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


class AsyncDataSetIterator(DataSetIterator):
    """Background prefetch: a producer thread pulls batches from ``source``,
    copies each to ``device`` (``None`` means the card) and puts it on a
    queue of at most ``prefetch`` batches. ``stage_dtype`` (e.g.
    ``torch.bfloat16`` for a bf16 net) casts floating features and labels
    on the host before the copy, halving its bytes; integer ids and the
    masks keep their dtype. A batch that cannot reach the device is an
    error, not a host batch: the producer's exception, like the source's,
    is raised on the consumer's side. A consumer that stops early stops
    the producer."""
    async_supported = False  # don't double-wrap

    def __init__(self, source: DataSetIterator, prefetch: int = 2,
                 device_put: bool = True, stage_dtype=None, device=None):
        self.source = source
        self.prefetch = max(1, int(prefetch))
        self.device_put = device_put
        self.stage_dtype = stage_dtype
        self.device = resolve_device(device) if device_put else None

    def _to_device(self, ds: DataSet) -> DataSet:
        sd, dev = self.stage_dtype, self.device

        def put(a, stage):
            if a is None:
                return None
            t = host_tensor(a)
            cast = stage and sd is not None and t.is_floating_point()
            return stage_to_device(t, dev, sd if cast else None)

        return DataSet(put(ds.features, True), put(ds.labels, True),
                       put(ds.features_mask, False),
                       put(ds.labels_mask, False))

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        end, stop = object(), threading.Event()
        err: List[BaseException] = []

        def offer(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for ds in self.source:
                    if not offer(self._to_device(ds) if self.device_put
                                 else ds):
                        return
            except BaseException as e:  # raised on the consumer side
                err.append(e)
            finally:
                offer(end)

        t = threading.Thread(target=producer, daemon=True,
                             name="async-dataset-iterator")
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
            t.join()

    def reset(self):
        self.source.reset()

    def batch_size(self) -> int:
        return self.source.batch_size()


class MultipleEpochsIterator(DataSetIterator):
    """Replays ``source`` ``epochs`` times, resetting it after each."""

    def __init__(self, epochs: int, source: DataSetIterator):
        self.epochs = int(epochs)
        self.source = source

    def __iter__(self):
        for _ in range(self.epochs):
            for ds in self.source:
                yield ds
            self.source.reset()


class SamplingDataSetIterator(DataSetIterator):
    """``samples_per_epoch`` examples drawn with replacement from ``ds`` in
    minibatches of ``batch_size`` (numpy's generator from ``seed``, so the
    batches are the JAX package's)."""

    def __init__(self, ds: DataSet, batch_size: int, samples_per_epoch: int,
                 seed: int = 0):
        self.ds = ds
        self._bs = int(batch_size)
        self._total = int(samples_per_epoch)
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        emitted = 0
        n = self.ds.num_examples()
        while emitted < self._total:
            take = min(self._bs, self._total - emitted)
            idx = self._rng.integers(0, n, take)
            yield DataSet(
                self.ds.features[idx],
                None if self.ds.labels is None else self.ds.labels[idx])
            emitted += take

    def batch_size(self) -> int:
        return self._bs


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
