"""Layer configurations: dense and output heads, the transformer LM's
layers and the recurrent family."""

from .base import LayerConf, FeedForwardLayerConf, BaseRecurrentLayerConf
from .feedforward import DenseLayer, OutputLayer, RnnOutputLayer
from .attention import (SelfAttentionLayer, LayerNormalization,
                        TransformerFeedForward, TokenAndPositionEmbedding)
from .recurrent import GravesLSTM, LSTM, GravesBidirectionalLSTM

__all__ = [
    "LayerConf", "FeedForwardLayerConf", "BaseRecurrentLayerConf",
    "DenseLayer", "OutputLayer", "RnnOutputLayer",
    "SelfAttentionLayer", "LayerNormalization", "TransformerFeedForward",
    "TokenAndPositionEmbedding", "GravesLSTM", "LSTM",
    "GravesBidirectionalLSTM",
]
