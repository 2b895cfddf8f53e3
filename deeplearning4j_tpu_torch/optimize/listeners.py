"""Training listeners (reference optimize/api/IterationListener +
optimize/listeners/*; SURVEY.md §2.1): the hook bus fired by the solver after
every parameter update (StochasticGradientDescent.java:67-68) and around
epochs/forward/backward (TrainingListener)."""

from __future__ import annotations

import time
from typing import List, Optional


class IterationListener:
    def iteration_done(self, model, iteration: int):
        pass


class TrainingListener(IterationListener):
    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass

    def on_forward_pass(self, model, activations):
        pass

    def on_backward_pass(self, model):
        pass


class ScoreIterationListener(IterationListener):
    """Print score every N iterations (reference ScoreIterationListener)."""

    def __init__(self, print_iterations: int = 10, log=print):
        self.n = max(1, int(print_iterations))
        self.log = log

    def iteration_done(self, model, iteration: int):
        if iteration % self.n == 0:
            self.log(f"Score at iteration {iteration} is {model.score_value}")


class PerformanceListener(IterationListener):
    """Throughput reporting (reference PerformanceListener.java:112-115:
    samples/sec and batches/sec per iteration), extended with an optional
    model-FLOPs estimate for MFU reporting on TPU."""

    def __init__(self, frequency: int = 1, report_samples: bool = True,
                 log=print, flops_per_example: Optional[float] = None,
                 peak_flops: Optional[float] = None):
        self.frequency = max(1, int(frequency))
        self.report_samples = report_samples
        self.log = log
        self.flops_per_example = flops_per_example
        self.peak_flops = peak_flops
        self._last_time = None
        self._last_iter = None
        self._samples_since = 0
        self.last_samples_per_sec = float("nan")
        self.last_batches_per_sec = float("nan")
        self.last_mfu = float("nan")

    def record_batch(self, num_examples: int):
        self._samples_since += int(num_examples)

    def iteration_done(self, model, iteration: int):
        now = time.perf_counter()
        if self._last_time is None:
            self._last_time, self._last_iter = now, iteration
            self._samples_since = 0
            return
        if (iteration - self._last_iter) % self.frequency:
            return
        dt = max(now - self._last_time, 1e-9)
        batches = iteration - self._last_iter
        self.last_batches_per_sec = batches / dt
        if self._samples_since:
            self.last_samples_per_sec = self._samples_since / dt
        msg = (f"iteration {iteration}; batches/sec: "
               f"{self.last_batches_per_sec:.2f}")
        if self._samples_since and self.report_samples:
            msg += f"; samples/sec: {self.last_samples_per_sec:.2f}"
        if self.flops_per_example and self.peak_flops and self._samples_since:
            achieved = self.last_samples_per_sec * self.flops_per_example
            self.last_mfu = achieved / self.peak_flops
            msg += f"; MFU: {100 * self.last_mfu:.1f}%"
        self.log(msg)
        self._last_time, self._last_iter = now, iteration
        self._samples_since = 0


class CollectScoresIterationListener(IterationListener):
    """Accumulate (iteration, score) pairs (reference CollectScoresIterationListener)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, int(frequency))
        self.scores: List = []

    def iteration_done(self, model, iteration: int):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, model.score_value))


class ParamAndGradientIterationListener(IterationListener):
    """Track parameter norms per iteration (reference
    ParamAndGradientIterationListener, slimmed: norms only)."""

    def __init__(self):
        self.param_norms: List = []

    def iteration_done(self, model, iteration: int):
        import numpy as np
        flat = model.params_flat()
        self.param_norms.append((iteration, float(np.linalg.norm(flat))))
