"""Layer configurations: the feed-forward family (dense, output and loss
heads, activation, dropout, embedding, autoencoder, RBM, center loss),
the variational autoencoder, the convolutional family, the transformer
LM's layers, SwinV2's layers and the recurrent family."""

from .base import LayerConf, FeedForwardLayerConf, BaseRecurrentLayerConf
from .feedforward import (ActivationLayer, AutoEncoder,
                          CenterLossOutputLayer, DenseLayer, DropoutLayer,
                          EmbeddingLayer, LossLayer, OutputLayer, RBM,
                          RnnOutputLayer)
from .convolution import (ConvolutionLayer, Convolution1DLayer,
                          SubsamplingLayer, Subsampling1DLayer,
                          BatchNormalization, LocalResponseNormalization,
                          ZeroPaddingLayer, GlobalPoolingLayer)
from .attention import (SelfAttentionLayer, LayerNormalization,
                        TransformerFeedForward, TokenAndPositionEmbedding)
from .swin import ChannelLayerNorm, PatchMerging, SwinV2Block
from .recurrent import GravesLSTM, LSTM, GravesBidirectionalLSTM
from .variational import VariationalAutoencoder

__all__ = [
    "LayerConf", "FeedForwardLayerConf", "BaseRecurrentLayerConf",
    "DenseLayer", "OutputLayer", "RnnOutputLayer", "LossLayer",
    "ActivationLayer", "DropoutLayer", "EmbeddingLayer", "AutoEncoder", "RBM",
    "CenterLossOutputLayer", "VariationalAutoencoder",
    "ConvolutionLayer", "Convolution1DLayer", "SubsamplingLayer",
    "Subsampling1DLayer", "BatchNormalization", "LocalResponseNormalization",
    "ZeroPaddingLayer", "GlobalPoolingLayer",
    "SelfAttentionLayer", "LayerNormalization", "TransformerFeedForward",
    "TokenAndPositionEmbedding", "SwinV2Block", "PatchMerging",
    "ChannelLayerNorm", "GravesLSTM", "LSTM",
    "GravesBidirectionalLSTM",
]
