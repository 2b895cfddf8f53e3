"""Cluster training layer (the JAX package's ``cluster/``; reference
deeplearning4j-scaleout/spark): the TrainingMaster SPI driving a local
partitioned-dataset executor (Spark ``local[n]``: a thread pool with task
retry). Each worker fits a clone of the net on the net's device, and the
master averages their parameters (and updater state) per split. The ML
pipeline stages (``ml_pipeline.py``) and the scikit-learn estimator
(``DL4JClassifier``, loaded on first use) wrap the port's nets."""

from .api import (RDDTrainingApproach, Repartition, RepartitionStrategy,
                  TrainingHook, TrainingMaster, TrainingWorker,
                  WorkerConfiguration)
from .network import ClusterComputationGraph, ClusterDl4jMultiLayer
from .param_averaging import (ParameterAveragingTrainingMaster,
                              ParameterAveragingTrainingWorker)
from .rdd import DistributedDataSet
from .stats import ClusterTrainingStats, PhaseTimer
from .ml_pipeline import (Pipeline, PipelineStage, NetworkClassifier,
                          NormalizerStage)

__all__ = [
    "DL4JClassifier", "ClusterComputationGraph", "ClusterDl4jMultiLayer",
    "ClusterTrainingStats", "DistributedDataSet",
    "ParameterAveragingTrainingMaster", "ParameterAveragingTrainingWorker",
    "PhaseTimer", "RDDTrainingApproach", "Repartition",
    "RepartitionStrategy", "TrainingHook", "TrainingMaster",
    "TrainingWorker", "WorkerConfiguration", "Pipeline", "PipelineStage",
    "NetworkClassifier", "NormalizerStage",
]


def __getattr__(name):
    # lazy: sklearn (and scipy behind it) load only for DL4JClassifier's
    # users, not at every cluster-package import
    if name == "DL4JClassifier":
        from .sklearn_compat import DL4JClassifier
        return DL4JClassifier
    raise AttributeError(name)
