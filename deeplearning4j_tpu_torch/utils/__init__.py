"""Checkpoints shared with the JAX package, and weights carried across."""

from .serializer import (graph_from_numpy, network_from_numpy,
                         params_from_numpy, restore_computation_graph,
                         restore_model, restore_multi_layer_network,
                         write_model)

__all__ = ["graph_from_numpy", "network_from_numpy", "params_from_numpy",
           "restore_computation_graph", "restore_model",
           "restore_multi_layer_network", "write_model"]
