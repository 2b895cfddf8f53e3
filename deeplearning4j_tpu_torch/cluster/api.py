"""Cluster training SPI (the JAX package's ``cluster/api.py``; reference
spark/api/TrainingMaster.java:28, TrainingWorker.java,
WorkerConfiguration.java, TrainingHook.java, Repartition.java,
RDDTrainingApproach)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class Repartition(enum.Enum):
    """When to repartition the distributed dataset before a split
    (reference spark/api/Repartition.java)."""
    NEVER = "never"
    ALWAYS = "always"
    NUM_PARTITIONS_WORKERS_DIFFERS = "differs"


class RepartitionStrategy(enum.Enum):
    BALANCED = "balanced"
    SPARK_DEFAULT = "default"


class RDDTrainingApproach(enum.Enum):
    """Direct = iterate in-memory partitions; Export = write minibatch files
    once, stream them back per epoch (the reference's default for re-used
    RDDs, ParameterAveragingTrainingMaster export path)."""
    DIRECT = "direct"
    EXPORT = "export"


@dataclass
class WorkerConfiguration:
    # None = train on the dataset's existing minibatches unchanged;
    # a number = re-batch each split to that size before fitting
    batch_size_per_worker: Optional[int] = None
    prefetch_num_batches: int = 2
    collect_training_stats: bool = False
    max_batches_per_worker: Optional[int] = None


class TrainingHook:
    """Pre/post hooks around each worker minibatch (reference
    spark/api/TrainingHook.java) — the seam the dl4j-spark-parameterserver
    module uses to push gradients into a PS."""

    def pre_update(self, dataset, model) -> None:  # pragma: no cover - hook
        pass

    def post_update(self, dataset, model) -> None:  # pragma: no cover - hook
        pass


class TrainingWorker:
    """Executor-side contract (reference spark/api/TrainingWorker.java)."""

    def get_initial_model(self):
        raise NotImplementedError

    def process_minibatch(self, dataset, model, is_last: bool):
        raise NotImplementedError

    def get_final_result(self, model):
        raise NotImplementedError


class TrainingMaster:
    """Driver-side contract (reference spark/api/TrainingMaster.java:28)."""

    def execute_training(self, network, data) -> None:
        raise NotImplementedError

    def get_worker(self, network) -> TrainingWorker:
        raise NotImplementedError

    def set_collect_training_stats(self, flag: bool) -> None:
        raise NotImplementedError

    def get_training_stats(self):
        raise NotImplementedError

    def add_hook(self, hook: TrainingHook) -> None:
        raise NotImplementedError
