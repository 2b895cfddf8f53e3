"""Partitioned dataset with Spark-RDD execution semantics (the JAX
package's ``cluster/rdd.py``; the reference's BaseSparkTest runs Spark
``local[n]``).

A :class:`DistributedDataSet` is a list of partitions (each a list of
DataSets). ``map_partitions`` runs a function over every partition on an
executor thread pool; a failed task is *recomputed from its source
partition* up to ``max_task_retries`` times (Spark's lineage
recomputation). ``aggregate`` tree-reduces partition results the way
ParameterAveragingTrainingMaster.java:860 does with ElementAdd /
ElementCombine functions."""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence


class DistributedDataSet:
    def __init__(self, partitions: Sequence[list], num_executors: int = 4,
                 max_task_retries: int = 3):
        self.partitions: List[list] = [list(p) for p in partitions]
        self.num_executors = max(1, int(num_executors))
        self.max_task_retries = int(max_task_retries)

    # --------------------------------------------------------- constructors
    @classmethod
    def from_datasets(cls, datasets, num_partitions: int = 4, **kw):
        datasets = list(datasets)
        n = max(1, min(num_partitions, len(datasets)))
        parts = [datasets[i::n] for i in range(n)]
        return cls(parts, **kw)

    @property
    def num_partitions(self) -> int:
        return len(self.partitions)

    def count(self) -> int:
        return sum(len(p) for p in self.partitions)

    # ------------------------------------------------------------ transforms
    def repartition(self, n: int, seed: Optional[int] = None) \
            -> "DistributedDataSet":
        flat = [d for p in self.partitions for d in p]
        if seed is not None:
            random.Random(seed).shuffle(flat)
        n = max(1, n)
        return DistributedDataSet([flat[i::n] for i in range(n)],
                                  self.num_executors, self.max_task_retries)

    def random_split(self, num_splits: int, seed: int = 0) \
            -> List["DistributedDataSet"]:
        """Split into roughly equal sub-datasets (one per averaging round —
        the reference's ``SplitDataSetsFunction`` path)."""
        flat = [d for p in self.partitions for d in p]
        random.Random(seed).shuffle(flat)
        num_splits = max(1, num_splits)
        out = []
        for i in range(num_splits):
            chunk = flat[i::num_splits]
            if chunk:
                out.append(DistributedDataSet.from_datasets(
                    chunk, self.num_partitions, num_executors=
                    self.num_executors,
                    max_task_retries=self.max_task_retries))
        return out

    # ------------------------------------------------------------- execution
    def map_partitions(self, fn: Callable[[list], object],
                       fault_injector: Optional[Callable[[int, int], None]]
                       = None) -> List[object]:
        """Run ``fn(partition)`` per partition on the executor pool.

        ``fault_injector(partition_index, attempt)`` may raise to simulate a
        lost task; the task is then recomputed (fresh attempt) up to
        ``max_task_retries`` times before the job fails — Spark's lineage
        recomputation contract.
        """

        def run_task(idx_part):
            idx, part = idx_part
            last = None
            for attempt in range(self.max_task_retries + 1):
                try:
                    if fault_injector is not None:
                        fault_injector(idx, attempt)
                    return fn(part)
                except Exception as e:          # noqa: BLE001 — retry any task failure
                    last = e
            raise RuntimeError(
                f"task for partition {idx} failed after "
                f"{self.max_task_retries + 1} attempts") from last

        with ThreadPoolExecutor(max_workers=self.num_executors) as pool:
            return list(pool.map(run_task, enumerate(self.partitions)))

    def aggregate(self, zero, seq_op: Callable, comb_op: Callable,
                  results: Optional[List] = None):
        """Tree-aggregate (ElementAdd/ElementCombine analog). When
        ``results`` is given those are combined directly; otherwise each
        partition is folded with ``seq_op(zero, partition)`` first. Pairwise
        tree reduction keeps the combine order deterministic."""
        level = list(results) if results is not None else \
            [seq_op(zero, p) for p in self.partitions]
        if not level:
            return zero
        while len(level) > 1:
            nxt = [comb_op(level[i], level[i + 1])
                   for i in range(0, len(level) - 1, 2)]
            if len(level) % 2:
                nxt.append(level[-1])
            level = nxt
        return level[0]
