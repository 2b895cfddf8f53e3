"""Classification evaluation (reference eval/Evaluation.java, 1,110 LoC):
confusion matrix, accuracy, per-class + aggregate precision/recall/F1/MCC/
G-measure, false-positive/negative rates, top-N accuracy, per-class stats
table + text report (stats/confusionToString), incremental eval and count
maps. Mask-aware for time-series output (per-timestep classification with
labels_mask)."""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

#: default edge-case return when a rate's denominator is zero
#: (reference DEFAULT_EDGE_VALUE = 0.0)
DEFAULT_EDGE_VALUE = 0.0


class Evaluation:
    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[Union[List[str], Dict[int, str]]] = None,
                 top_n: int = 1):
        if isinstance(labels, dict):
            n = max(labels) + 1
            labels = [labels.get(i, str(i)) for i in range(n)]
            num_classes = num_classes or n
        self.num_classes = num_classes
        self.label_names = labels
        self.top_n = top_n
        self.confusion: Optional[np.ndarray] = None
        self.top_n_correct = 0
        self.total = 0

    def _ensure(self, n: int):
        """Create the confusion matrix, or grow it when a class index beyond
        the current size arrives (incremental eval; the reference grows its
        ConfusionMatrix dynamically)."""
        if self.confusion is None:
            self.num_classes = max(self.num_classes or 0, n) or n
            self.confusion = np.zeros((self.num_classes, self.num_classes),
                                      np.int64)
        elif n > self.num_classes:
            grown = np.zeros((n, n), np.int64)
            grown[:self.num_classes, :self.num_classes] = self.confusion
            self.confusion = grown
            self.num_classes = n

    def _cm(self) -> np.ndarray:
        """Confusion matrix view that is safe before any data arrives."""
        if self.confusion is None:
            k = self.num_classes or 0
            return np.zeros((k, k), np.int64)
        return self.confusion

    # ------------------------------------------------------------------ eval
    def eval(self, labels, predictions=None, mask: Optional[np.ndarray] = None):
        """Batch form: labels/predictions [N, C] one-hot/probabilities, or
        [N, T, C] (flattened with optional [N, T] mask). Incremental form
        (reference eval(int predictedIdx, int actualIdx) — note the
        reversed argument order there; here ``eval(actual, predicted)``):
        two ints add one observation."""
        if isinstance(labels, (int, np.integer)) and \
                isinstance(predictions, (int, np.integer)):
            self._ensure(max(labels, predictions) + 1)
            self.confusion[labels, predictions] += 1
            self.total += 1
            if labels == predictions:
                self.top_n_correct += 1
            return
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if np.issubdtype(labels.dtype, np.integer) and \
                labels.ndim == predictions.ndim and \
                labels.shape[-1] == 1 and predictions.shape[-1] != 1:
            # classic DL4J column-vector id format ([N, 1] / [N, T, 1]) —
            # the same trailing-singleton shape the fused-CE training gate
            # accepts (nn/multilayer.py sparse_shaped); squeeze to ids so
            # fit-then-evaluate works with one label array
            labels = labels[..., 0]
        if predictions.shape[-1] == 1 and \
                np.issubdtype(labels.dtype, np.integer) and \
                labels.ndim == predictions.ndim - 1:
            # [N] (or [N, T]) integer ids against single-column sigmoid
            # predictions: binary at 0.5, same as the column-label form
            # below — the sparse-argmax path would build a 1x1 confusion
            labels = labels[..., None]
        if np.issubdtype(labels.dtype, np.integer) and \
                labels.ndim == predictions.ndim - 1:
            # sparse class-id labels ([N] or [N, T]) — the fused-CE label
            # format (kernels/fused_ce.py); ids are the actuals directly
            c = predictions.shape[-1]
            actual = labels.reshape(-1)
            predictions = predictions.reshape(-1, c)
            if mask is not None:
                m = np.asarray(mask)
                if labels.ndim == 2 and m.size == labels.shape[0]:
                    # per-example mask over [N, T] ids: broadcast across T,
                    # same rule as the fused-CE training path
                    m = np.broadcast_to(m.reshape(-1, 1), labels.shape)
                keep = m.reshape(-1) > 0
                actual = actual[keep]
                predictions = predictions[keep]
            self._ensure(c)
            pred = np.argmax(predictions, axis=-1)
            np.add.at(self.confusion, (actual, pred), 1)
            self.total += len(actual)
            if self.top_n > 1:
                topk = np.argsort(-predictions, axis=-1)[:, :self.top_n]
                self.top_n_correct += int(np.sum(topk == actual[:, None]))
            else:
                self.top_n_correct += int(np.sum(actual == pred))
            return
        if predictions.shape[-1] == 1 and labels.shape[-1] == 1:
            # single-column (sigmoid) predictions: binary decision at 0.5
            # (the reference's single-output Evaluation semantics) — argmax
            # over a singleton axis would silently call everything class 0
            actual = (labels.reshape(-1) >= 0.5).astype(np.int64)
            pred = (predictions.reshape(-1) >= 0.5).astype(np.int64)
            if mask is not None:
                keep = np.asarray(mask).reshape(-1) > 0
                actual = actual[keep]
                pred = pred[keep]
            self._ensure(2)
            np.add.at(self.confusion, (actual, pred), 1)
            self.total += len(actual)
            self.top_n_correct += int(np.sum(actual == pred))
            return
        if labels.ndim == 3:
            n, t, c = labels.shape
            labels = labels.reshape(n * t, c)
            predictions = predictions.reshape(n * t, c)
            if mask is not None:
                keep = np.asarray(mask).reshape(n * t) > 0
                labels = labels[keep]
                predictions = predictions[keep]
        elif mask is not None:
            # per-example mask on [N, C] labels (e.g. zero-weight padded
            # rows): masked rows are excluded, same contract as the loss
            m = np.asarray(mask).reshape(-1)
            if m.shape[0] == labels.shape[0]:
                keep = m > 0
                labels = labels[keep]
                predictions = predictions[keep]
        self._ensure(labels.shape[-1])
        actual = np.argmax(labels, axis=-1)
        pred = np.argmax(predictions, axis=-1)
        np.add.at(self.confusion, (actual, pred), 1)
        self.total += len(actual)
        if self.top_n > 1:
            topk = np.argsort(-predictions, axis=-1)[:, :self.top_n]
            self.top_n_correct += int(np.sum(topk == actual[:, None]))
        else:
            self.top_n_correct += int(np.sum(actual == pred))

    def add_to_confusion(self, actual: int, predicted: int, count: int = 1):
        """Direct confusion increment (reference addToConfusion)."""
        self._ensure(max(actual, predicted) + 1)
        self.confusion[actual, predicted] += count

    # ------------------------------------------------- counts (per class)
    def true_positives(self, c: Optional[int] = None):
        """tp count for class c, or a class→count map (reference
        truePositives())."""
        if c is None:
            return {i: self.true_positives(i) for i in range(self.num_classes or 0)}
        return int(self._cm()[c, c])

    def true_negatives(self, c: Optional[int] = None):
        if c is None:
            return {i: self.true_negatives(i) for i in range(self.num_classes or 0)}
        return int(np.sum(self._cm()) - np.sum(self._cm()[c, :])
                   - np.sum(self._cm()[:, c]) + self._cm()[c, c])

    def false_positives(self, c: Optional[int] = None):
        if c is None:
            return {i: self.false_positives(i)
                    for i in range(self.num_classes or 0)}
        return int(np.sum(self._cm()[:, c]) - self._cm()[c, c])

    def false_negatives(self, c: Optional[int] = None):
        if c is None:
            return {i: self.false_negatives(i)
                    for i in range(self.num_classes or 0)}
        return int(np.sum(self._cm()[c, :]) - self._cm()[c, c])

    def positive(self) -> Dict[int, int]:
        """Actual-positive count per class (reference positive())."""
        return {i: int(np.sum(self._cm()[i, :]))
                for i in range(self.num_classes or 0)}

    def negative(self) -> Dict[int, int]:
        """Actual-negative count per class (reference negative())."""
        tot = int(np.sum(self._cm()))
        return {i: tot - int(np.sum(self._cm()[i, :]))
                for i in range(self.num_classes or 0)}

    def class_count(self, c: int) -> int:
        """Number of examples whose actual class is c (reference
        classCount)."""
        return int(np.sum(self._cm()[c, :]))

    def get_class_label(self, c: int) -> str:
        names = self.label_names
        return names[c] if names and c < len(names) else str(c)

    def get_num_row_counter(self) -> int:
        return self.total

    # ------------------------------------------------------------- metrics
    def accuracy(self) -> float:
        if self.total == 0:
            return 0.0
        return float(np.trace(self._cm())) / self.total

    def top_n_accuracy(self) -> float:
        return self.top_n_correct / self.total if self.total else 0.0

    def precision(self, c: Optional[int] = None,
                  edge_case: float = DEFAULT_EDGE_VALUE) -> float:
        if c is not None:
            tp, fp = self.true_positives(c), self.false_positives(c)
            return tp / (tp + fp) if tp + fp else edge_case
        vals = [self.precision(i) for i in range(self.num_classes or 0)
                if np.sum(self._cm()[:, i]) +
                np.sum(self._cm()[i, :]) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, c: Optional[int] = None,
               edge_case: float = DEFAULT_EDGE_VALUE) -> float:
        if c is not None:
            tp, fn = self.true_positives(c), self.false_negatives(c)
            return tp / (tp + fn) if tp + fn else edge_case
        vals = [self.recall(i) for i in range(self.num_classes or 0)
                if np.sum(self._cm()[i, :]) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def false_positive_rate(self, c: Optional[int] = None,
                            edge_case: float = DEFAULT_EDGE_VALUE) -> float:
        """fp / (fp + tn) (reference falsePositiveRate)."""
        if c is not None:
            fp, tn = self.false_positives(c), self.true_negatives(c)
            return fp / (fp + tn) if fp + tn else edge_case
        return float(np.mean([self.false_positive_rate(i)
                              for i in range(self.num_classes)])) \
            if self.num_classes else 0.0

    def false_negative_rate(self, c: Optional[int] = None,
                            edge_case: float = DEFAULT_EDGE_VALUE) -> float:
        """fn / (fn + tp) (reference falseNegativeRate)."""
        if c is not None:
            fn, tp = self.false_negatives(c), self.true_positives(c)
            return fn / (fn + tp) if fn + tp else edge_case
        return float(np.mean([self.false_negative_rate(i)
                              for i in range(self.num_classes)])) \
            if self.num_classes else 0.0

    def false_alarm_rate(self) -> float:
        """(FPR + FNR) / 2 (reference falseAlarmRate)."""
        return (self.false_positive_rate() + self.false_negative_rate()) / 2

    def f1(self, c: Optional[int] = None) -> float:
        p, r = self.precision(c), self.recall(c)
        return 2 * p * r / (p + r) if p + r else 0.0

    def f_beta(self, beta: float, c: Optional[int] = None) -> float:
        """F_beta score (reference fBeta)."""
        p, r = self.precision(c), self.recall(c)
        b2 = beta * beta
        denom = b2 * p + r
        return (1 + b2) * p * r / denom if denom else 0.0

    def g_measure(self, c: Optional[int] = None) -> float:
        """sqrt(precision * recall) (reference gMeasure)."""
        p, r = self.precision(c), self.recall(c)
        return float(np.sqrt(p * r))

    def matthews_correlation(self, c: Optional[int] = None) -> float:
        """Matthews correlation coefficient, one-vs-all per class or
        macro-averaged (reference matthewsCorrelation)."""
        if c is None:
            vals = [self.matthews_correlation(i)
                    for i in range(self.num_classes or 0)]
            return float(np.mean(vals)) if vals else 0.0
        tp = self.true_positives(c)
        tn = self.true_negatives(c)
        fp = self.false_positives(c)
        fn = self.false_negatives(c)
        denom = np.sqrt(float(tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return float((tp * tn - fp * fn) / denom) if denom else 0.0

    # ------------------------------------------------------------ reporting
    def confusion_to_string(self) -> str:
        """Formatted confusion matrix (reference confusionToString)."""
        if self.confusion is None:
            return "<no data>"
        names = [self.get_class_label(i) for i in range(self.num_classes)]
        w = max(6, max(len(n) for n in names) + 1)
        # the row-label column is wider than the data columns so the
        # "Predicted:"/"Actual:" literals never push headers out of line
        w0 = max(len("Predicted:"), max(len(n) for n in names) + 1)
        lines = ["Predicted:".rjust(w0) + "".join(n.rjust(w) for n in names)]
        lines.append("Actual:".rjust(w0))
        for i, row in enumerate(self._cm()):
            lines.append(names[i].rjust(w0) +
                         "".join(str(v).rjust(w) for v in row))
        return "\n".join(lines)

    def stats(self, suppress_warnings: bool = False,
              include_per_class: bool = True) -> str:
        lines = ["==================== Evaluation ===================="]
        lines.append(f" Examples:  {self.total}")
        lines.append(f" Accuracy:  {self.accuracy():.4f}")
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n}:    {self.top_n_accuracy():.4f}")
        lines.append(f" Precision: {self.precision():.4f}")
        lines.append(f" Recall:    {self.recall():.4f}")
        lines.append(f" F1 Score:  {self.f1():.4f}")
        lines.append(f" MCC:       {self.matthews_correlation():.4f}")
        lines.append(f" G-measure: {self.g_measure():.4f}")
        if not suppress_warnings and self.confusion is not None:
            never_pred = [self.get_class_label(i)
                          for i in range(self.num_classes or 0)
                          if np.sum(self._cm()[:, i]) == 0
                          and np.sum(self._cm()[i, :]) > 0]
            if never_pred:
                lines.append(" Warning: classes were never predicted by the "
                             "model: " + ", ".join(never_pred))
        if include_per_class and self.confusion is not None:
            lines.append("")
            lines.append(" Per-class statistics "
                         "(label: count / precision / recall / f1 / mcc):")
            for i in range(self.num_classes):
                lines.append(
                    f"   {self.get_class_label(i):>10}: "
                    f"{self.class_count(i):>7} / "
                    f"{self.precision(i):.4f} / {self.recall(i):.4f} / "
                    f"{self.f1(i):.4f} / {self.matthews_correlation(i):.4f}")
        lines.append("")
        lines.append(" Confusion matrix (rows=actual, cols=predicted):")
        lines.append(self.confusion_to_string())
        return "\n".join(lines)

    def merge(self, other: "Evaluation"):
        if other.confusion is None:
            return self
        self._ensure(other.num_classes)
        oc = other.confusion
        if oc.shape[0] < self.num_classes:      # pad the smaller operand
            grown = np.zeros((self.num_classes, self.num_classes), np.int64)
            grown[:oc.shape[0], :oc.shape[1]] = oc
            oc = grown
        self.confusion += oc
        self.total += other.total
        self.top_n_correct += other.top_n_correct
        return self
