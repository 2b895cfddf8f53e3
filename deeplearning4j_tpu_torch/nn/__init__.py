"""Network core: configuration, layers, vertices, MultiLayerNetwork,
ComputationGraph and the helper registry."""

from .multilayer import MultiLayerNetwork

__all__ = ["MultiLayerNetwork"]
