"""Cluster training layer (the JAX package's ``cluster/``; reference
deeplearning4j-scaleout/spark): the TrainingMaster SPI driving a local
partitioned-dataset executor (Spark ``local[n]``: a thread pool with task
retry). Each worker fits a clone of the net on the net's device, and the
master averages their parameters (and updater state) per split."""

from .api import (RDDTrainingApproach, Repartition, RepartitionStrategy,
                  TrainingHook, TrainingMaster, TrainingWorker,
                  WorkerConfiguration)
from .network import ClusterComputationGraph, ClusterDl4jMultiLayer
from .param_averaging import (ParameterAveragingTrainingMaster,
                              ParameterAveragingTrainingWorker)
from .rdd import DistributedDataSet
from .stats import ClusterTrainingStats, PhaseTimer

__all__ = [
    "ClusterComputationGraph", "ClusterDl4jMultiLayer",
    "ClusterTrainingStats", "DistributedDataSet",
    "ParameterAveragingTrainingMaster", "ParameterAveragingTrainingWorker",
    "PhaseTimer", "RDDTrainingApproach", "Repartition",
    "RepartitionStrategy", "TrainingHook", "TrainingMaster",
    "TrainingWorker", "WorkerConfiguration",
]
