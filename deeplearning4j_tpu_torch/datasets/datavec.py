"""DataVec record readers and the iterators over them (the JAX package's
``datasets/datavec.py``): CSV and in-memory collection readers,
``RecordReaderDataSetIterator`` (a label column to one-hot, or
regression columns), ``SequenceRecordReaderDataSetIterator`` ([N, T, C]
with masks for ragged sequences) and ``RecordReaderMultiDataSetIterator``
(named inputs and outputs from several readers). Readers are host-side
parsers; ``native_loader.NativeCSVDataSetIterator`` is the C++ reader of
the same CSV files."""

from __future__ import annotations

import csv as _csv
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops.dataset import DataSet, MultiDataSet
from .iterators import DataSetIterator


class RecordReader:
    """Iterable over records (lists of values)."""

    def __iter__(self):
        raise NotImplementedError

    def reset(self):
        pass


class CSVRecordReader(RecordReader):
    def __init__(self, path, skip_lines: int = 0, delimiter: str = ","):
        self.path = Path(path)
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def __iter__(self):
        with open(self.path, newline="", encoding="utf-8") as f:
            reader = _csv.reader(f, delimiter=self.delimiter)
            for i, row in enumerate(reader):
                if i < self.skip_lines or not row:
                    continue
                yield [float(x) if x else 0.0 for x in row]


class CollectionRecordReader(RecordReader):
    def __init__(self, records: Sequence[Sequence[float]]):
        self.records = [list(r) for r in records]

    def __iter__(self):
        return iter(self.records)


class CollectionSequenceRecordReader(RecordReader):
    """Sequences of records: [[timestep record, ...], ...]."""

    def __init__(self, sequences):
        self.sequences = [[list(r) for r in seq] for seq in sequences]

    def __iter__(self):
        return iter(self.sequences)


class RecordReaderDataSetIterator(DataSetIterator):
    """Records → DataSet minibatches: classification (the label column
    one-hot) or regression (columns label_index..label_index_to)."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1, num_classes: int = 0,
                 label_index_to: Optional[int] = None,
                 regression: bool = False):
        self.reader = reader
        self._bs = int(batch_size)
        self.label_index = label_index
        self.num_classes = num_classes
        self.label_index_to = label_index_to
        self.regression = regression or (label_index_to is not None) or \
            (num_classes == 0 and label_index >= 0)

    def _convert(self, batch: List[List[float]]) -> DataSet:
        arr = np.asarray(batch, np.float32)
        li = self.label_index
        if li < 0:
            return DataSet(arr)
        lt = self.label_index_to if self.label_index_to is not None else li
        label_cols = list(range(li, lt + 1))
        feat_cols = [c for c in range(arr.shape[1]) if c not in label_cols]
        feats = arr[:, feat_cols]
        if self.regression:
            labels = arr[:, label_cols]
        else:
            ids = arr[:, li].astype(np.int64)
            labels = np.eye(self.num_classes, dtype=np.float32)[ids]
        return DataSet(feats, labels)

    def __iter__(self):
        batch: List[List[float]] = []
        for record in self.reader:
            batch.append(record)
            if len(batch) == self._bs:
                yield self._convert(batch)
                batch = []
        if batch:
            yield self._convert(batch)
        self.reader.reset()

    def batch_size(self) -> int:
        return self._bs


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequence records → [N, T, C] DataSets, zero-padded at the end with
    features and labels masks for variable lengths."""

    def __init__(self, reader, batch_size: int, label_index: int = -1,
                 num_classes: int = 0, regression: bool = False):
        self.reader = reader
        self._bs = int(batch_size)
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression

    def _convert(self, seqs) -> DataSet:
        t_max = max(len(s) for s in seqs)
        n = len(seqs)
        width = len(seqs[0][0])
        li = self.label_index
        feat_width = width - (1 if li >= 0 else 0)
        label_width = self.num_classes if (li >= 0 and not self.regression) \
            else (1 if li >= 0 else 0)
        feats = np.zeros((n, t_max, feat_width), np.float32)
        labels = np.zeros((n, t_max, max(label_width, 1)), np.float32)
        mask = np.zeros((n, t_max), np.float32)
        for i, seq in enumerate(seqs):
            for t, rec in enumerate(seq):
                rec = list(rec)
                if li >= 0:
                    lab = rec.pop(li)
                    if self.regression:
                        labels[i, t, 0] = lab
                    else:
                        labels[i, t, int(lab)] = 1.0
                feats[i, t] = rec
                mask[i, t] = 1.0
        if li < 0:
            return DataSet(feats, None, features_mask=mask)
        return DataSet(feats, labels, features_mask=mask,
                       labels_mask=mask.copy())

    def __iter__(self):
        batch = []
        for seq in self.reader:
            batch.append(seq)
            if len(batch) == self._bs:
                yield self._convert(batch)
                batch = []
        if batch:
            yield self._convert(batch)
        self.reader.reset()


class RecordReaderMultiDataSetIterator(DataSetIterator):
    """Named multi-input / multi-output MultiDataSets from several readers,
    built with :class:`RecordReaderMultiDataSetIterator.Builder`."""

    class Builder:
        def __init__(self, batch_size: int):
            self._bs = batch_size
            self._readers: Dict[str, RecordReader] = {}
            self._inputs: List = []
            self._outputs: List = []

        def add_reader(self, name: str, reader: RecordReader):
            self._readers[name] = reader
            return self

        def add_input(self, name: str, col_from: int = 0,
                      col_to: Optional[int] = None):
            self._inputs.append((name, col_from, col_to))
            return self

        def add_output_one_hot(self, name: str, column: int,
                               num_classes: int):
            self._outputs.append((name, column, num_classes))
            return self

        def add_output(self, name: str, col_from: int = 0,
                       col_to: Optional[int] = None):
            self._outputs.append((name, col_from, col_to, "regression"))
            return self

        def build(self) -> "RecordReaderMultiDataSetIterator":
            return RecordReaderMultiDataSetIterator(
                self._bs, self._readers, self._inputs, self._outputs)

    def __init__(self, batch_size, readers, inputs, outputs):
        self._bs = batch_size
        self.readers = readers
        self.inputs = inputs
        self.outputs = outputs

    @staticmethod
    def _columns(rows, c0, c1):
        arr = np.asarray(rows, np.float32)
        c1 = arr.shape[1] - 1 if c1 is None else c1
        return arr[:, c0:c1 + 1]

    def __iter__(self):
        iters = {name: iter(r) for name, r in self.readers.items()}
        while True:
            rows: Dict[str, List] = {name: [] for name in self.readers}
            try:
                for _ in range(self._bs):
                    for name, it in iters.items():
                        rows[name].append(next(it))
            except StopIteration:
                pass
            if not any(rows.values()) or not rows[next(iter(rows))]:
                for r in self.readers.values():
                    r.reset()
                return
            feats = [self._columns(rows[name], c0, c1)
                     for name, c0, c1 in self.inputs]
            labels = []
            for spec in self.outputs:
                if len(spec) == 3:
                    name, col, ncls = spec
                    arr = np.asarray(rows[name], np.float32)
                    labels.append(np.eye(ncls, dtype=np.float32)[
                        arr[:, col].astype(np.int64)])
                else:
                    name, c0, c1, _ = spec
                    labels.append(self._columns(rows[name], c0, c1))
            yield MultiDataSet(feats, labels)
