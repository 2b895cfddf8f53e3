"""Regression evaluation (reference eval/RegressionEvaluation.java):
per-column MSE, MAE, RMSE, R², correlation, relative squared error."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class RegressionEvaluation:
    def __init__(self, column_names: Optional[List[str]] = None):
        self.column_names = column_names
        self._labels = []
        self._preds = []

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            n, t, c = labels.shape
            labels = labels.reshape(n * t, c)
            predictions = predictions.reshape(n * t, c)
            if mask is not None:
                keep = np.asarray(mask).reshape(n * t) > 0
                labels, predictions = labels[keep], predictions[keep]
        self._labels.append(labels)
        self._preds.append(predictions)

    def _all(self):
        return np.concatenate(self._labels), np.concatenate(self._preds)

    def num_columns(self) -> int:
        return self._labels[0].shape[1] if self._labels else 0

    def mean_squared_error(self, col: int) -> float:
        y, p = self._all()
        return float(np.mean((y[:, col] - p[:, col]) ** 2))

    def mean_absolute_error(self, col: int) -> float:
        y, p = self._all()
        return float(np.mean(np.abs(y[:, col] - p[:, col])))

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int) -> float:
        y, p = self._all()
        ss_res = np.sum((y[:, col] - p[:, col]) ** 2)
        ss_tot = np.sum((y[:, col] - y[:, col].mean()) ** 2)
        return float(1.0 - ss_res / ss_tot) if ss_tot > 0 else 0.0

    def pearson_correlation(self, col: int) -> float:
        y, p = self._all()
        if np.std(y[:, col]) == 0 or np.std(p[:, col]) == 0:
            return 0.0
        return float(np.corrcoef(y[:, col], p[:, col])[0, 1])

    def relative_squared_error(self, col: int) -> float:
        y, p = self._all()
        num = np.sum((y[:, col] - p[:, col]) ** 2)
        den = np.sum((y[:, col] - y[:, col].mean()) ** 2)
        return float(num / den) if den > 0 else 0.0

    def average_mean_squared_error(self) -> float:
        return float(np.mean([self.mean_squared_error(c)
                              for c in range(self.num_columns())]))

    def average_r_squared(self) -> float:
        return float(np.mean([self.r_squared(c)
                              for c in range(self.num_columns())]))

    def stats(self) -> str:
        names = self.column_names or [f"col{i}" for i in
                                      range(self.num_columns())]
        lines = ["================ Regression Evaluation ================",
                 f"{'column':>10} {'MSE':>12} {'MAE':>12} {'RMSE':>12} "
                 f"{'R^2':>8}"]
        for c in range(self.num_columns()):
            lines.append(
                f"{names[c][:10]:>10} {self.mean_squared_error(c):>12.6f} "
                f"{self.mean_absolute_error(c):>12.6f} "
                f"{self.root_mean_squared_error(c):>12.6f} "
                f"{self.r_squared(c):>8.4f}")
        return "\n".join(lines)
