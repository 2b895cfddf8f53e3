"""Network core: configuration, layers, vertices, MultiLayerNetwork,
ComputationGraph and the helper registry."""

from .conf import (InputType, NeuralNetConfiguration, MultiLayerConfiguration,
                   layers)
from .multilayer import MultiLayerNetwork
from .helpers import register_helper, get_helper, disable_helper, enable_helper

__all__ = ["InputType", "NeuralNetConfiguration", "MultiLayerConfiguration",
           "layers", "MultiLayerNetwork", "register_helper", "get_helper",
           "disable_helper", "enable_helper"]
