"""Training listeners (the JAX package's ``optimize/listeners.py``, the
port's own copy): the hook bus a model fires after every parameter
update. The JAX package's line-search solvers are not ported."""

from .listeners import (CollectScoresIterationListener, IterationListener,
                        ParamAndGradientIterationListener,
                        PerformanceListener, ScoreIterationListener,
                        TrainingListener)

__all__ = ["IterationListener", "TrainingListener", "ScoreIterationListener",
           "PerformanceListener", "CollectScoresIterationListener",
           "ParamAndGradientIterationListener"]
