"""Early stopping (the JAX package's ``earlystopping/core.py``): a fit
loop that scores the network on held-out data after each epoch, keeps the
best model through a saver, and stops on epoch or iteration termination
conditions."""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path
from typing import List, Optional

from ..datasets.iterators import as_iterator
from ..utils.serializer import restore_model, write_model


class DataSetLossCalculator:
    """The held-out loss: each batch's ``net.score`` weighted by its
    examples, averaged over all of them (summed with ``average=False``)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        total, count = 0.0, 0
        for ds in self.iterator:
            total += net.score(ds) * ds.num_examples()
            count += ds.num_examples()
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        return total / max(count, 1) if self.average else total


# --- termination conditions ---------------------------------------------------

class MaxEpochsTerminationCondition:
    """Stop after ``max_epochs`` epochs."""

    def __init__(self, max_epochs: int):
        self.max_epochs = int(max_epochs)

    def terminate(self, epoch: int, score: float, best_score: float) -> bool:
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition:
    """Stop after ``patience`` epochs without an improvement of more than
    ``min_improvement``."""

    def __init__(self, patience: int, min_improvement: float = 0.0):
        self.patience = int(patience)
        self.min_improvement = float(min_improvement)
        self._best = math.inf
        self._since = 0

    def terminate(self, epoch: int, score: float, best_score: float) -> bool:
        if score < self._best - self.min_improvement:
            self._best = score
            self._since = 0
            return False
        self._since += 1
        return self._since > self.patience


class BestScoreEpochTerminationCondition:
    """Stop once the score is at or below ``target``."""

    def __init__(self, target: float):
        self.target = float(target)

    def terminate(self, epoch: int, score: float, best_score: float) -> bool:
        return score <= self.target


class MaxTimeIterationTerminationCondition:
    """Stop once ``max_seconds`` have passed since the first check."""

    def __init__(self, max_seconds: float):
        self.max_seconds = float(max_seconds)
        self._start = None

    def start(self):
        self._start = time.monotonic()

    def terminate(self, iteration: int, score: float) -> bool:
        if self._start is None:
            self.start()
        return time.monotonic() - self._start > self.max_seconds


class MaxScoreIterationTerminationCondition:
    """Stop when a step's score exceeds ``max_score``."""

    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def terminate(self, iteration: int, score: float) -> bool:
        return score > self.max_score


class InvalidScoreIterationTerminationCondition:
    """Stop on a NaN or infinite step score."""

    def terminate(self, iteration: int, score: float) -> bool:
        return math.isnan(score) or math.isinf(score)


# --- model savers -------------------------------------------------------------

class InMemoryModelSaver:
    """Keeps clones of the best and latest models."""

    def __init__(self):
        self.best = None
        self.latest = None

    def save_best_model(self, net, score: float):
        self.best = net.clone()

    def save_latest_model(self, net, score: float):
        self.latest = net.clone()

    def get_best_model(self):
        return self.best

    def get_latest_model(self):
        return self.latest


class LocalFileModelSaver:
    """Writes ``<directory>/bestModel.zip`` and ``latestModel.zip``
    checkpoints (the zip the JAX package's ``ModelSerializer`` reads) and
    restores them onto ``device`` (``None`` means the card) in
    ``compute_dtype``."""

    def __init__(self, directory, device=None, compute_dtype=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.device = device
        self.compute_dtype = compute_dtype

    def save_best_model(self, net, score: float):
        write_model(net, self.dir / "bestModel.zip")

    def save_latest_model(self, net, score: float):
        write_model(net, self.dir / "latestModel.zip")

    def _load(self, name):
        path = self.dir / name
        return restore_model(path, self.device, self.compute_dtype) \
            if path.exists() else None

    def get_best_model(self):
        return self._load("bestModel.zip")

    def get_latest_model(self):
        return self._load("latestModel.zip")


@dataclasses.dataclass
class EarlyStoppingConfiguration:
    score_calculator: DataSetLossCalculator = None
    model_saver: object = dataclasses.field(default_factory=InMemoryModelSaver)
    epoch_terminations: List = dataclasses.field(default_factory=list)
    iteration_terminations: List = dataclasses.field(default_factory=list)
    evaluate_every_n_epochs: int = 1
    save_last_model: bool = False


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: str
    termination_details: str
    score_vs_epoch: dict
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: object


class EarlyStoppingTrainer:
    """Epochs of training, each followed by held-out scoring, saving and
    the epoch termination conditions (checked every epoch, with the latest
    score); the iteration conditions are checked after every update."""

    def __init__(self, config: EarlyStoppingConfiguration, net, train_data):
        self.config = config
        self.net = net
        self.train_data = train_data

    def _fit_epoch(self) -> Optional[str]:
        """Train one epoch; return the name of the iteration termination
        condition that fired, or None. Subclasses override the training
        while :meth:`fit`'s scoring, saving and epoch terminations stay."""
        cfg = self.config
        for ds in as_iterator(self.train_data):
            if self.net.conf.backprop_type == "truncated_bptt" and \
                    ds.features.ndim == 3:
                self.net._fit_tbptt(ds)
            else:
                self.net._fit_batch(ds)
            if cfg.iteration_terminations:
                score = float(self.net.score_value)
                for cond in cfg.iteration_terminations:
                    if cond.terminate(self.net.iteration, score):
                        return type(cond).__name__
        return None

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        if not cfg.epoch_terminations and not cfg.iteration_terminations:
            raise ValueError("EarlyStoppingConfiguration needs at least one "
                             "termination condition (the loop would never "
                             "exit)")
        best_score, best_epoch = math.inf, -1
        scores = {}
        epoch = 0
        reason, details = "MaxEpochs", ""
        score = math.inf
        while True:
            stop_cond = self._fit_epoch()
            if stop_cond is not None:
                reason, details = "IterationTermination", stop_cond
                break
            if epoch % cfg.evaluate_every_n_epochs == 0:
                score = cfg.score_calculator.calculate_score(self.net) \
                    if cfg.score_calculator else float(self.net.score_value)
                scores[epoch] = score
                if score < best_score:
                    best_score, best_epoch = score, epoch
                    cfg.model_saver.save_best_model(self.net, score)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(self.net, score)
            terminated = False
            for cond in cfg.epoch_terminations:
                if cond.terminate(epoch, score, best_score):
                    reason = "EpochTermination"
                    details = type(cond).__name__
                    terminated = True
                    break
            if terminated:
                break
            epoch += 1
        best = cfg.model_saver.get_best_model() or self.net
        return EarlyStoppingResult(
            termination_reason=reason, termination_details=details,
            score_vs_epoch=scores, best_model_epoch=best_epoch,
            best_model_score=best_score, total_epochs=epoch + 1,
            best_model=best)
