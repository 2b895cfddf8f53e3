"""ROC evaluation (reference eval/ROC.java, ROCBinary.java,
ROCMultiClass.java): threshold sweep → TPR/FPR curve, AUC (trapezoidal),
precision/recall curve. ``threshold_steps=0`` uses exact (all distinct score)
thresholds, matching the reference's exact mode."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _auc(x: np.ndarray, y: np.ndarray) -> float:
    order = np.argsort(x)
    return float(np.trapezoid(y[order], x[order]))


class ROC:
    """Binary ROC: labels [N] or [N,1] in {0,1}, or one-hot [N,2] (class 1 =
    positive), probabilities likewise."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = int(threshold_steps)
        self._scores: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 2 and labels.shape[1] == 2:
            labels = labels[:, 1]
            predictions = predictions[:, 1]
        labels = labels.reshape(-1)
        predictions = predictions.reshape(-1)
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            labels, predictions = labels[keep], predictions[keep]
        self._labels.append(labels)
        self._scores.append(predictions)

    def _curve(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        y = np.concatenate(self._labels)
        s = np.concatenate(self._scores)
        if self.threshold_steps > 0:
            thresholds = np.linspace(0, 1, self.threshold_steps + 1)
        else:
            thresholds = np.unique(np.concatenate([[0.0, 1.0], s]))
        pos = max(np.sum(y > 0.5), 1)
        neg = max(np.sum(y <= 0.5), 1)
        # counts of s >= t for every threshold at once: the scores sorted
        # once, a prefix count of positives, a binary search a threshold
        # (a NaN score is >= no threshold; a NaN threshold takes none)
        keep = ~np.isnan(s)
        order = np.argsort(s[keep], kind="stable")
        ranked = s[keep][order]
        positives = np.concatenate([[0], np.cumsum((y[keep] > 0.5)[order])])
        below = np.searchsorted(ranked, thresholds, side="left")
        at_or_above = len(ranked) - below
        tp = positives[-1] - positives[below]
        fp = at_or_above - tp
        undefined = np.isnan(thresholds)
        tp[undefined], fp[undefined] = 0, 0
        return thresholds, fp / neg, tp / pos

    def calculate_auc(self) -> float:
        _, fpr, tpr = self._curve()
        return _auc(fpr, tpr)

    def get_roc_curve(self):
        """[(threshold, fpr, tpr)]."""
        t, fpr, tpr = self._curve()
        return list(zip(t.tolist(), fpr.tolist(), tpr.tolist()))

    def calculate_auprc(self) -> float:
        y = np.concatenate(self._labels)
        s = np.concatenate(self._scores)
        order = np.argsort(-s)
        y = y[order]
        tp = np.cumsum(y > 0.5)
        precision = tp / (np.arange(len(y)) + 1)
        recall = tp / max(np.sum(y > 0.5), 1)
        return _auc(recall, precision)


class ROCBinary:
    """Per-output-column binary ROC for multi-label nets (reference ROCBinary)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._rocs: Dict[int, ROC] = {}

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        for c in range(labels.shape[-1]):
            self._rocs.setdefault(c, ROC(self.threshold_steps)).eval(
                labels[..., c], predictions[..., c], mask)

    def calculate_auc(self, col: int) -> float:
        return self._rocs[col].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc()
                              for r in self._rocs.values()]))


class ROCMultiClass:
    """One-vs-all ROC per class (reference ROCMultiClass)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._rocs: Dict[int, ROC] = {}

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        for c in range(labels.shape[-1]):
            self._rocs.setdefault(c, ROC(self.threshold_steps)).eval(
                labels[..., c], predictions[..., c], mask)

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc()
                              for r in self._rocs.values()]))


class EvaluationBinary:
    """Per-column (multi-label) binary evaluation at a decision threshold
    (reference EvaluationBinary: per-label tp/fp/tn/fn counters, counts,
    MCC, FPR/FNR, averages, stats table, merge)."""

    def __init__(self, threshold: float = 0.5,
                 label_names: Optional[list] = None):
        self.threshold = float(threshold)
        self.label_names = label_names
        self.tp = None
        self.fp = None
        self.tn = None
        self.fn = None

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        labels = np.asarray(labels) > 0.5
        preds = np.asarray(predictions) >= self.threshold
        if labels.ndim == 1:
            labels, preds = labels[:, None], preds[:, None]
        if self.tp is None:
            n = labels.shape[-1]
            self.tp = np.zeros(n, np.int64)
            self.fp = np.zeros(n, np.int64)
            self.tn = np.zeros(n, np.int64)
            self.fn = np.zeros(n, np.int64)
        flat_l = labels.reshape(-1, labels.shape[-1])
        flat_p = preds.reshape(-1, preds.shape[-1])
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            flat_l, flat_p = flat_l[keep], flat_p[keep]
        self.tp += np.sum(flat_l & flat_p, axis=0)
        self.fp += np.sum(~flat_l & flat_p, axis=0)
        self.tn += np.sum(~flat_l & ~flat_p, axis=0)
        self.fn += np.sum(flat_l & ~flat_p, axis=0)

    def accuracy(self, col: int = 0) -> float:
        total = self.tp[col] + self.fp[col] + self.tn[col] + self.fn[col]
        return (self.tp[col] + self.tn[col]) / total if total else 0.0

    def precision(self, col: int = 0) -> float:
        d = self.tp[col] + self.fp[col]
        return self.tp[col] / d if d else 0.0

    def recall(self, col: int = 0) -> float:
        d = self.tp[col] + self.fn[col]
        return self.tp[col] / d if d else 0.0

    def f1(self, col: int = 0) -> float:
        p, r = self.precision(col), self.recall(col)
        return 2 * p * r / (p + r) if p + r else 0.0

    # ------------------------------------------------ counts + extra metrics
    def num_labels(self) -> int:
        return 0 if self.tp is None else len(self.tp)

    def total_count(self, col: int = 0) -> int:
        """Observations recorded for a label (reference totalCount)."""
        return int(self.tp[col] + self.fp[col] + self.tn[col] + self.fn[col])

    def true_positives(self, col: int = 0) -> int:
        return int(self.tp[col])

    def true_negatives(self, col: int = 0) -> int:
        return int(self.tn[col])

    def false_positives(self, col: int = 0) -> int:
        return int(self.fp[col])

    def false_negatives(self, col: int = 0) -> int:
        return int(self.fn[col])

    def false_positive_rate(self, col: int = 0) -> float:
        d = self.fp[col] + self.tn[col]
        return self.fp[col] / d if d else 0.0

    def false_negative_rate(self, col: int = 0) -> float:
        d = self.fn[col] + self.tp[col]
        return self.fn[col] / d if d else 0.0

    def matthews_correlation(self, col: int = 0) -> float:
        tp, tn = float(self.tp[col]), float(self.tn[col])
        fp, fn = float(self.fp[col]), float(self.fn[col])
        denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return float((tp * tn - fp * fn) / denom) if denom else 0.0

    def g_measure(self, col: int = 0) -> float:
        return float(np.sqrt(self.precision(col) * self.recall(col)))

    def average_accuracy(self) -> float:
        n = self.num_labels()
        return float(np.mean([self.accuracy(i) for i in range(n)])) \
            if n else 0.0

    def average_precision(self) -> float:
        n = self.num_labels()
        return float(np.mean([self.precision(i) for i in range(n)])) \
            if n else 0.0

    def average_recall(self) -> float:
        n = self.num_labels()
        return float(np.mean([self.recall(i) for i in range(n)])) if n else 0.0

    def average_f1(self) -> float:
        n = self.num_labels()
        return float(np.mean([self.f1(i) for i in range(n)])) if n else 0.0

    def get_label_name(self, col: int) -> str:
        names = self.label_names
        return names[col] if names and col < len(names) else f"label_{col}"

    def stats(self) -> str:
        """Per-label table (reference EvaluationBinary.stats)."""
        lines = ["================ EvaluationBinary ================",
                 f" Threshold: {self.threshold}",
                 " label: count / acc / precision / recall / f1 / mcc"]
        for i in range(self.num_labels()):
            lines.append(
                f"   {self.get_label_name(i):>10}: {self.total_count(i):>7} "
                f"/ {self.accuracy(i):.4f} / {self.precision(i):.4f} / "
                f"{self.recall(i):.4f} / {self.f1(i):.4f} / "
                f"{self.matthews_correlation(i):.4f}")
        lines.append(f" Average: acc {self.average_accuracy():.4f}, "
                     f"precision {self.average_precision():.4f}, "
                     f"recall {self.average_recall():.4f}, "
                     f"f1 {self.average_f1():.4f}")
        return "\n".join(lines)

    def merge(self, other: "EvaluationBinary"):
        if other.tp is None:
            return self
        if self.tp is None:
            self.tp = other.tp.copy()
            self.fp = other.fp.copy()
            self.tn = other.tn.copy()
            self.fn = other.fn.copy()
        else:
            self.tp += other.tp
            self.fp += other.fp
            self.tn += other.tn
            self.fn += other.fn
        return self
