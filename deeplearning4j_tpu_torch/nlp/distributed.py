"""Distributed embedding training (reference dl4j-spark-nlp(+java8):
SparkSequenceVectors / SparkWord2Vec training over partitions with the
VoidParameterServer push/pull plane, SparkSequenceVectors.java:292-294;
SURVEY.md §2.4, §3.5).

The Aeron PS role is played by the same host-side parameter-server plane the
DP trainers use (parallel/param_server.py): workers train a local copy of
the lookup table on their corpus partition and push the flattened
syn0|syn1 vector; the server soft-averages (HOGWILD-tolerant, exactly the
staleness model the reference runs). Vocab is built once on the driver and
broadcast — matching the reference's two-phase vocab-then-train flow.

The counterpart of the JAX package's ``nlp/distributed.py``: each worker's
tables live on the Word2Vec's ``device`` (a ``device=`` keyword among
``w2v_kwargs``; ``None`` is the CUDA card), the pushed vectors on the
host."""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..cluster.rdd import DistributedDataSet
from ..parallel.param_server import InMemoryParameterServer
from .word2vec import Word2Vec


class DistributedWord2Vec:
    """Word2Vec over a partitioned corpus with async parameter averaging."""

    def __init__(self, num_workers: int = 2, push_frequency: int = 1,
                 alpha: Optional[float] = None, **w2v_kwargs):
        self.num_workers = int(num_workers)
        self.push_frequency = max(1, int(push_frequency))
        self.alpha = alpha
        self.w2v_kwargs = w2v_kwargs
        self.model: Optional[Word2Vec] = None
        self.server: Optional[InMemoryParameterServer] = None

    # ------------------------------------------------------------- plumbing
    @staticmethod
    def _flatten(model: Word2Vec) -> np.ndarray:
        tables = [t for t in (model.lookup.syn0, model.lookup.syn1,
                              model.lookup.syn1neg) if t is not None]
        return np.concatenate([t.detach().cpu().numpy().ravel()
                               for t in tables])

    @staticmethod
    def _unflatten(model: Word2Vec, flat: np.ndarray) -> None:
        offset = 0

        def take(template):
            nonlocal offset
            n = int(np.prod(template.shape))
            out = torch.tensor(
                flat[offset:offset + n].reshape(template.shape),
                dtype=torch.float32, device=template.device)
            offset += n
            return out

        model.lookup.syn0 = take(model.lookup.syn0)
        if model.lookup.syn1 is not None:
            model.lookup.syn1 = take(model.lookup.syn1)
        if model.lookup.syn1neg is not None:
            model.lookup.syn1neg = take(model.lookup.syn1neg)

    # ------------------------------------------------------------------ fit
    def fit(self, sequences: Sequence[List[str]],
            num_partitions: Optional[int] = None) -> Word2Vec:
        driver = Word2Vec(**self.w2v_kwargs)
        driver.build_vocab(sequences)    # phase 1: driver vocab + lookup
        self.server = InMemoryParameterServer(
            self._flatten(driver), alpha=self.alpha,
            num_workers=self.num_workers)

        data = DistributedDataSet.from_datasets(
            list(sequences), num_partitions or self.num_workers,
            num_executors=self.num_workers)

        def train_partition(partition: List[List[str]]):
            # broadcast analog: fresh worker shares the driver vocab/Huffman
            worker = copy.copy(driver)
            worker.lookup = copy.copy(driver.lookup)
            self._unflatten(worker, self.server.pull())
            chunk = max(1, len(partition) // self.push_frequency)
            for start in range(0, len(partition), chunk):
                worker.fit(partition[start:start + chunk])
                self.server.push(self._flatten(worker))
                self._unflatten(worker, self.server.pull())
            return len(partition)

        counts = data.map_partitions(train_partition)
        self._unflatten(driver, self.server.pull())
        self.model = driver
        self.trained_sequences = sum(counts)
        return driver
