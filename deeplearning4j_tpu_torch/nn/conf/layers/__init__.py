"""Layer configurations on the transformer-LM path."""

from .base import LayerConf, FeedForwardLayerConf
from .feedforward import RnnOutputLayer
from .attention import (SelfAttentionLayer, LayerNormalization,
                        TransformerFeedForward, TokenAndPositionEmbedding)

__all__ = [
    "LayerConf", "FeedForwardLayerConf", "RnnOutputLayer",
    "SelfAttentionLayer", "LayerNormalization", "TransformerFeedForward",
    "TokenAndPositionEmbedding",
]
