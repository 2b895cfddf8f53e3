"""Solvers and training listeners (the JAX package's ``optimize/``, the
port's own copies): the full-batch line-search solvers, and the hook bus
a model fires after every parameter update."""

from .solvers import (Solver, LineGradientDescent, ConjugateGradient, LBFGS,
                      backtrack_line_search)
from .listeners import (CollectScoresIterationListener, IterationListener,
                        ParamAndGradientIterationListener,
                        PerformanceListener, ScoreIterationListener,
                        TrainingListener)

__all__ = ["Solver", "LineGradientDescent", "ConjugateGradient", "LBFGS",
           "backtrack_line_search", "IterationListener", "TrainingListener",
           "ScoreIterationListener", "PerformanceListener",
           "CollectScoresIterationListener",
           "ParamAndGradientIterationListener"]
