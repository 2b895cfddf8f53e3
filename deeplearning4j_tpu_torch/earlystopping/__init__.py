"""Early stopping: the configuration, termination conditions, model
savers, the held-out score calculator and the trainer."""

from .core import (EarlyStoppingConfiguration, EarlyStoppingResult,
                   EarlyStoppingTrainer, DataSetLossCalculator,
                   MaxEpochsTerminationCondition,
                   ScoreImprovementEpochTerminationCondition,
                   BestScoreEpochTerminationCondition,
                   MaxTimeIterationTerminationCondition,
                   MaxScoreIterationTerminationCondition,
                   InvalidScoreIterationTerminationCondition,
                   InMemoryModelSaver, LocalFileModelSaver)

__all__ = [
    "EarlyStoppingConfiguration", "EarlyStoppingResult",
    "EarlyStoppingTrainer", "DataSetLossCalculator",
    "MaxEpochsTerminationCondition",
    "ScoreImprovementEpochTerminationCondition",
    "BestScoreEpochTerminationCondition",
    "MaxTimeIterationTerminationCondition",
    "MaxScoreIterationTerminationCondition",
    "InvalidScoreIterationTerminationCondition",
    "InMemoryModelSaver", "LocalFileModelSaver",
]
