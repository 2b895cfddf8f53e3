"""Evaluation suite (the JAX package's ``eval/``: classification,
regression, ROC and metadata evaluation). numpy only: the port keeps its
own copy of each module and imports nothing of the JAX package."""

from .evaluation import Evaluation
from .regression import RegressionEvaluation
from .roc import ROC, ROCBinary, ROCMultiClass, EvaluationBinary
from .meta import Prediction, EvaluationWithMetadata

__all__ = ["Evaluation", "RegressionEvaluation", "ROC", "ROCBinary",
           "ROCMultiClass", "EvaluationBinary", "Prediction",
           "EvaluationWithMetadata"]
