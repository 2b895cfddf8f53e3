"""The transformer LM (configuration, training batches), its KV-cache
decoder and the slot engine (slab or paged, with the prefix cache,
speculative decoding, and the scheduling and resilience tier); the
GravesLSTM character RNN; the convolutional nets ResNet-50, LeNet and
VGG16 (with ImageNet labels and Keras-imported pretrained weights); the
SwinV2 image transformer."""

from .char_rnn import CharacterIterator, char_rnn_conf
from .lenet import lenet_conf
from .resnet import resnet_conf, resnet50_conf, resnet_tiny_conf
from .swin import swinv2_conf
from .transformer import (generate, lm_batch, lm_batch_sparse,
                          transformer_lm_conf)
from .generation import (TransformerDecoder, SlotGenerationEngine,
                         GenerationRequest)
from .paging import PageAllocator, prefix_route_key
from .vgg16 import (ImageNetLabels, TrainedModels, VGG16ImagePreProcessor,
                    vgg16_conf)

__all__ = ["char_rnn_conf", "CharacterIterator",
           "transformer_lm_conf", "lm_batch", "lm_batch_sparse", "generate",
           "TransformerDecoder",
           "SlotGenerationEngine", "GenerationRequest",
           "PageAllocator", "prefix_route_key",
           "lenet_conf", "resnet_conf", "resnet50_conf", "resnet_tiny_conf",
           "vgg16_conf", "VGG16ImagePreProcessor", "ImageNetLabels",
           "TrainedModels", "swinv2_conf"]
