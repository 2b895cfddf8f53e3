"""Checkpoints shared with the JAX package, and weights carried across."""

from .serializer import (ModelGuesser, ModelSerializer, graph_from_numpy,
                         network_from_numpy, params_from_numpy,
                         restore_computation_graph, restore_model,
                         restore_multi_layer_network, restore_normalizer,
                         write_model)

__all__ = ["ModelGuesser", "ModelSerializer", "graph_from_numpy",
           "network_from_numpy", "params_from_numpy",
           "restore_computation_graph", "restore_model",
           "restore_multi_layer_network", "restore_normalizer",
           "write_model"]
