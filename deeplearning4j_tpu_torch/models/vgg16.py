"""VGG16 (the JAX package's ``models/vgg16.py``): the VGG16 / VGG16NoTop
configurations (the same JSON), the ImageNet mean-subtracting image
preprocessor, ``ImageNetLabels`` (a labels JSON on disk) and
``TrainedModels`` (pretrained weights from a Keras HDF5 file on disk,
through the port's Keras importer). Nothing is downloaded."""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np

from ..nn.conf.config import MultiLayerConfiguration, NeuralNetConfiguration
from ..nn.conf.input_type import InputType
from ..nn.conf.layers import (ConvolutionLayer, DenseLayer, OutputLayer,
                              SubsamplingLayer)

#: ImageNet per-channel means (RGB order) VGG16's preprocessor subtracts
VGG16_MEAN_RGB = (123.68, 116.779, 103.939)


def _conv_block(b, n_convs: int, n_out: int):
    for _ in range(n_convs):
        b = b.layer(ConvolutionLayer(n_out=n_out, kernel_size=[3, 3],
                                     stride=[1, 1], convolution_mode="same",
                                     activation="relu"))
    return b.layer(SubsamplingLayer(kernel_size=[2, 2], stride=[2, 2],
                                    pooling_type="max"))


def vgg16_conf(num_classes: int = 1000, top: bool = True,
               height: int = 224, width: int = 224, channels: int = 3,
               learning_rate: float = 0.01, updater: str = "nesterovs",
               seed: int = 123) -> MultiLayerConfiguration:
    """VGG16 as a MultiLayerConfiguration; ``top=False`` is VGG16NoTop
    (the conv feature extractor only)."""
    b = (NeuralNetConfiguration.Builder()
         .seed(seed).learning_rate(learning_rate)
         .updater(updater).momentum(0.9)
         .weight_init("xavier")
         .regularization(True).l2(5e-4)
         .list())
    for n_convs, n_out in ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)):
        b = _conv_block(b, n_convs, n_out)
    if top:
        b = (b.layer(DenseLayer(n_out=4096, activation="relu"))
             .layer(DenseLayer(n_out=4096, activation="relu"))
             .layer(OutputLayer(n_out=num_classes, loss="mcxent",
                                activation="softmax")))
    return (b.set_input_type(InputType.convolutional(height, width, channels))
            .build())


class VGG16ImagePreProcessor:
    """DataSet preprocessor subtracting the ImageNet per-channel mean from
    NHWC float features."""

    def pre_process(self, dataset) -> None:
        mean = np.asarray(VGG16_MEAN_RGB, dtype=np.float32)
        dataset.features = np.asarray(dataset.features,
                                      dtype=np.float32) - mean

    __call__ = pre_process


class ImageNetLabels:
    """ImageNet-1k class labels from a local JSON file: a list of names, or
    Keras's ``{"0": ["n01440764", "tench"], ...}`` index, passed as
    ``path`` or found at ``$DL4J_TPU_IMAGENET_LABELS``; or the ``labels``
    themselves. Nothing is downloaded."""

    def __init__(self, path: Optional[str] = None,
                 labels: Optional[Sequence[str]] = None):
        if labels is not None:
            self._labels = list(labels)
            return
        path = path or os.environ.get("DL4J_TPU_IMAGENET_LABELS")
        if not path or not os.path.exists(path):
            raise FileNotFoundError(
                "ImageNet labels file not found; pass path=, labels=, or set "
                "DL4J_TPU_IMAGENET_LABELS (nothing is downloaded)")
        with open(path) as f:
            raw = json.load(f)
        if isinstance(raw, dict):
            self._labels = [raw[str(i)][-1] if isinstance(raw[str(i)], list)
                            else raw[str(i)] for i in range(len(raw))]
        else:
            self._labels = list(raw)

    def get_label(self, idx: int) -> str:
        return self._labels[idx]

    def decode_predictions(self, predictions,
                           top: int = 5) -> List[List[dict]]:
        """The top-``top`` {label, probability} of each row."""
        p = np.asarray(predictions)
        out = []
        for row in p:
            order = np.argsort(row)[::-1][:top]
            out.append([{"label": self._labels[int(i)],
                         "probability": float(row[int(i)])} for i in order])
        return out


class TrainedModels:
    """Pretrained-model entry: ``vgg16`` builds the configuration with a
    seeded init, or imports a Keras VGG16 HDF5 file (``weights_h5``)
    through the Keras importer; ``device=None`` means the card."""

    @staticmethod
    def vgg16(num_classes: int = 1000, top: bool = True,
              weights_h5: Optional[str] = None, device=None,
              compute_dtype=None):
        from ..nn.multilayer import MultiLayerNetwork
        if weights_h5 is not None:
            from ..keras.importer import KerasModelImport
            return KerasModelImport.import_keras_sequential_model_and_weights(
                weights_h5, device=device, compute_dtype=compute_dtype)
        net = MultiLayerNetwork(vgg16_conf(num_classes=num_classes, top=top),
                                compute_dtype=compute_dtype, device=device)
        return net.init()

    @staticmethod
    def get_pre_processor() -> VGG16ImagePreProcessor:
        return VGG16ImagePreProcessor()
