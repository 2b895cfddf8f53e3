"""Configuration tier: builder, serde, input types, layer configs."""

from .input_type import InputType
from .config import (ListBuilder, MultiLayerConfiguration,
                     NeuralNetConfiguration)

__all__ = ["InputType", "NeuralNetConfiguration", "ListBuilder",
           "MultiLayerConfiguration"]
