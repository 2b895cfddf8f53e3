"""Configuration tier: builder, serde, input types, layer configs."""

from .input_type import InputType
from .config import NeuralNetConfiguration

__all__ = ["InputType", "NeuralNetConfiguration"]
