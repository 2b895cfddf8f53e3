"""Evaluation with per-example record metadata (reference eval/meta/:
Prediction + IEvaluation metadata support — list which source records were
misclassified, confusion cell members; SURVEY.md §2.1 eval suite)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np


@dataclass
class Prediction:
    """One example's outcome (reference org.deeplearning4j.eval.meta
    .Prediction): actual/predicted class plus caller-supplied record
    metadata (e.g. source file/line from a RecordReader)."""
    actual: int
    predicted: int
    metadata: Any = None


class EvaluationWithMetadata:
    """Wraps Evaluation, additionally recording per-example Predictions so
    errors can be traced back to source records."""

    def __init__(self, evaluation=None):
        from .evaluation import Evaluation
        self.evaluation = evaluation or Evaluation()
        self.predictions: List[Prediction] = []

    def eval(self, labels: np.ndarray, outputs: np.ndarray,
             metadata: Optional[List] = None, mask=None):
        self.evaluation.eval(labels, outputs, mask=mask)
        labels = np.asarray(labels)
        outputs = np.asarray(outputs)
        actual = labels.argmax(-1)       # [N] or [N, T]
        pred = outputs.argmax(-1)
        if actual.ndim == 2:
            # time series: metadata indexes records (rows), mask drops padded
            # timesteps — mirror Evaluation's own masking so the recorded
            # predictions agree with its counts
            keep = np.ones(actual.shape, bool) if mask is None \
                else np.asarray(mask) > 0
            for i in range(actual.shape[0]):
                md = metadata[i] if metadata is not None and \
                    i < len(metadata) else None
                for t in range(actual.shape[1]):
                    if keep[i, t]:
                        self.predictions.append(
                            Prediction(int(actual[i, t]), int(pred[i, t]),
                                       md))
            return
        for j, (a, p) in enumerate(zip(actual.ravel(), pred.ravel())):
            md = metadata[j] if metadata is not None and j < len(metadata) \
                else None
            self.predictions.append(Prediction(int(a), int(p), md))

    # ---------------------------------------------------------- meta queries
    def get_prediction_errors(self) -> List[Prediction]:
        return [p for p in self.predictions if p.actual != p.predicted]

    def get_predictions_by_actual_class(self, cls: int) -> List[Prediction]:
        return [p for p in self.predictions if p.actual == cls]

    def get_predictions_by_predicted_class(self, cls: int) \
            -> List[Prediction]:
        return [p for p in self.predictions if p.predicted == cls]

    def get_predictions(self, actual: int, predicted: int) \
            -> List[Prediction]:
        """Members of one confusion-matrix cell."""
        return [p for p in self.predictions
                if p.actual == actual and p.predicted == predicted]

    def accuracy(self) -> float:
        return self.evaluation.accuracy()

    def stats(self) -> str:
        return self.evaluation.stats()
