"""Early stopping on top of ParallelWrapper (the JAX package's
``parallel/early_stopping_parallel.py``; reference
EarlyStoppingParallelTrainer.java).

The serial :class:`EarlyStoppingTrainer` with its epoch hook replaced:
each epoch trains data-parallel over the mesh through
:class:`~.wrapper.ParallelWrapper`, and the iteration terminations are
checked once per epoch, after it."""

from __future__ import annotations

from ..earlystopping.core import (EarlyStoppingConfiguration,
                                  EarlyStoppingTrainer)
from .wrapper import ParallelWrapper


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    def __init__(self, config: EarlyStoppingConfiguration, net, train_data,
                 mesh=None, averaging_frequency: int = 1,
                 average_updaters: bool = True):
        super().__init__(config, net, train_data)
        self.wrapper = ParallelWrapper(
            net, mesh=mesh, averaging_frequency=averaging_frequency,
            average_updaters=average_updaters)

    def _fit_epoch(self):
        self.wrapper.fit(self.train_data, num_epochs=1)
        for cond in self.config.iteration_terminations:
            if cond.terminate(self.net.iteration,
                              float(self.net.score_value)):
                return type(cond).__name__
        return None
