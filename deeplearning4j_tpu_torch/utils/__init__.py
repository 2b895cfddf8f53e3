"""Loading weights carried across from the JAX package."""

from .serializer import (graph_from_numpy, params_from_numpy,
                         restore_computation_graph)

__all__ = ["graph_from_numpy", "params_from_numpy",
           "restore_computation_graph"]
