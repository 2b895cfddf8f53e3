"""Configuration tier: the configuration classes, serde, input types,
preprocessors, layer configs."""

from .input_type import InputType
from .config import (NeuralNetConfiguration, ListBuilder,
                     MultiLayerConfiguration, GLOBAL_DEFAULTS)
from .preprocessors import (InputPreProcessor, CnnToFeedForwardPreProcessor,
                            FeedForwardToCnnPreProcessor,
                            FeedForwardToRnnPreProcessor,
                            RnnToFeedForwardPreProcessor,
                            CnnToRnnPreProcessor, RnnToCnnPreProcessor,
                            auto_preprocessor)
from .serde import register_config, to_jsonable, from_jsonable
from . import layers

__all__ = [
    "InputType", "NeuralNetConfiguration", "ListBuilder",
    "MultiLayerConfiguration", "GLOBAL_DEFAULTS", "InputPreProcessor",
    "CnnToFeedForwardPreProcessor", "FeedForwardToCnnPreProcessor",
    "FeedForwardToRnnPreProcessor", "RnnToFeedForwardPreProcessor",
    "CnnToRnnPreProcessor", "RnnToCnnPreProcessor", "auto_preprocessor",
    "register_config", "to_jsonable", "from_jsonable", "layers",
]
