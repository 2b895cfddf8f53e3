"""Keras layer → layer configuration conversion and weight mapping (the
JAX package's ``keras/layers.py``): Dense, Conv1D / 2D, Max / Average
pooling 1D / 2D, global pooling, BatchNormalization, Embedding, LSTM,
Dropout, Activation, ZeroPadding2D, TimeDistributed(Dense); Flatten and
the other shape-only layers are absorbed by the preprocessors; Add /
Subtract / Multiply / Average / Maximum / Concatenate / Merge become
graph vertices. The activation map and the gate orders (Keras 2's i, f,
c, o; Keras 1's twelve per-gate arrays) are the JAX package's."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..nn.conf.layers import (ActivationLayer, BatchNormalization,
                              Convolution1DLayer, ConvolutionLayer,
                              DenseLayer, DropoutLayer, EmbeddingLayer,
                              GlobalPoolingLayer, LSTM, Subsampling1DLayer,
                              SubsamplingLayer, ZeroPaddingLayer)
from ..nn.graph.vertices import ElementWiseVertex, MergeVertex


class KerasLayerError(ValueError):
    pass


_ACTIVATIONS = {
    "linear": "identity", "relu": "relu", "sigmoid": "sigmoid",
    "tanh": "tanh", "softmax": "softmax", "softplus": "softplus",
    "softsign": "softsign", "elu": "elu", "selu": "selu",
    "hard_sigmoid": "hardsigmoid", "swish": "swish", "gelu": "gelu",
    "leaky_relu": "leakyrelu", "exponential": "identity",
}


def _act(conf, default="identity") -> str:
    a = conf.get("activation", default)
    if isinstance(a, dict):
        a = a.get("config", {}).get("activation", default) \
            if "config" in a else default
    return _ACTIVATIONS.get(a, a or default)


def _pair(v):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v, v]


def _first(v):
    return v[0] if isinstance(v, (list, tuple)) else v


def _padding_mode(conf) -> str:
    return "same" if conf.get("padding", conf.get("border_mode",
                                                  "valid")) == "same" \
        else "truncate"


def convert_layer(cls: str, conf: dict):
    """A Keras layer's config → a layer configuration, or None for
    shape-only layers the preprocessors absorb. Raises KerasLayerError on
    an unsupported type."""
    units = conf.get("units", conf.get("output_dim", 0))
    if cls in ("Dense", "TimeDistributed"):
        if cls == "TimeDistributed":
            inner = conf.get("layer", {})
            if inner.get("class_name") != "Dense":
                raise KerasLayerError("TimeDistributed supports Dense only")
            conf = inner["config"]
            units = conf.get("units", conf.get("output_dim", 0))
        return DenseLayer(n_out=int(units), activation=_act(conf))
    if cls in ("Conv2D", "Convolution2D"):
        ks = _pair(conf.get("kernel_size") or
                   [conf.get("nb_row", 3), conf.get("nb_col", 3)])
        return ConvolutionLayer(
            n_out=int(conf.get("filters", conf.get("nb_filter", 0))),
            kernel_size=ks, stride=_pair(conf.get("strides", [1, 1])),
            convolution_mode=_padding_mode(conf),
            has_bias=bool(conf.get("use_bias", True)),
            activation=_act(conf))
    if cls in ("Conv1D", "Convolution1D"):
        k = _first(conf.get("kernel_size", conf.get("filter_length", 3)))
        s = _first(conf.get("strides", conf.get("subsample_length", 1)))
        return Convolution1DLayer(
            n_out=int(conf.get("filters", conf.get("nb_filter", 0))),
            kernel_size=[int(k)], stride=[int(s)],
            convolution_mode=_padding_mode(conf),
            has_bias=bool(conf.get("use_bias", True)),
            activation=_act(conf))
    if cls in ("MaxPooling2D", "AveragePooling2D"):
        return SubsamplingLayer(
            kernel_size=_pair(conf.get("pool_size", [2, 2])),
            stride=_pair(conf.get("strides") or conf.get("pool_size", [2, 2])),
            pooling_type="max" if cls.startswith("Max") else "avg",
            convolution_mode=_padding_mode(conf))
    if cls in ("MaxPooling1D", "AveragePooling1D"):
        p = _first(conf.get("pool_size", conf.get("pool_length", 2)))
        s = _first(conf.get("strides") or p)
        return Subsampling1DLayer(
            kernel_size=[int(p)], stride=[int(s)],
            pooling_type="max" if cls.startswith("Max") else "avg",
            convolution_mode=_padding_mode(conf))
    if cls in ("GlobalMaxPooling1D", "GlobalMaxPooling2D"):
        return GlobalPoolingLayer(pooling_type="max")
    if cls in ("GlobalAveragePooling1D", "GlobalAveragePooling2D"):
        return GlobalPoolingLayer(pooling_type="avg")
    if cls == "BatchNormalization":
        return BatchNormalization(
            eps=float(conf.get("epsilon", 1e-3)),
            decay=float(conf.get("momentum", 0.99)))
    if cls == "Activation":
        return ActivationLayer(activation=_act(conf))
    if cls == "LeakyReLU":
        return ActivationLayer(activation="leakyrelu")
    if cls == "Dropout":
        # Keras's rate is the drop probability; ours the retention one
        return DropoutLayer(drop_out=1.0 - float(conf.get("rate",
                                                          conf.get("p", 0.5))))
    if cls in ("SpatialDropout1D", "SpatialDropout2D"):
        return DropoutLayer(drop_out=1.0 - float(conf.get("rate", 0.5)))
    if cls == "Embedding":
        return EmbeddingLayer(
            n_in=int(conf.get("input_dim", 0)),
            n_out=int(conf.get("output_dim", 0)),
            activation="identity")
    if cls == "LSTM":
        inner = _ACTIVATIONS.get(conf.get("inner_activation",
                                          conf.get("recurrent_activation",
                                                   "sigmoid")), "sigmoid")
        return LSTM(n_out=int(units), activation=_act(conf, "tanh"),
                    gate_activation=inner)
    if cls == "ZeroPadding2D":
        pad = conf.get("padding", [[0, 0], [0, 0]])
        if isinstance(pad, int):
            p4 = [pad] * 4
        elif isinstance(pad[0], (list, tuple)):
            p4 = [pad[0][0], pad[0][1], pad[1][0], pad[1][1]]
        else:
            p4 = [pad[0], pad[0], pad[1], pad[1]]
        return ZeroPaddingLayer(pad=[int(p) for p in p4])
    if cls in ("Flatten", "Reshape", "InputLayer", "Permute",
               "RepeatVector", "Masking"):
        return None     # shape plumbing: preprocessors handle it
    raise KerasLayerError(f"Unsupported Keras layer type: {cls}")


def convert_vertex(cls: str, conf: dict):
    """Graph-only Keras layers → vertices (None for other layers)."""
    if cls in ("Add", "add"):
        return ElementWiseVertex(op="add")
    if cls == "Subtract":
        return ElementWiseVertex(op="subtract")
    if cls == "Multiply":
        return ElementWiseVertex(op="product")
    if cls == "Average":
        return ElementWiseVertex(op="average")
    if cls == "Maximum":
        return ElementWiseVertex(op="max")
    if cls in ("Concatenate", "Merge"):
        mode = conf.get("mode", "concat")
        if cls == "Merge" and mode in ("sum", "ave", "mul", "max"):
            return ElementWiseVertex(op={"sum": "add", "ave": "average",
                                         "mul": "product",
                                         "max": "max"}[mode])
        return MergeVertex()
    return None


def map_weights(cls: str, layer, arrays: List[np.ndarray],
                device="cpu", dtype=torch.float32
                ) -> Optional[Tuple[Dict, Dict]]:
    """Stored Keras weight arrays → (parameter update, state update) of
    tensors of ``dtype`` on ``device`` (the net's), or None when the layer
    takes none."""
    if not arrays:
        return None

    def t(a):
        # contiguous first: Theano's flipped kernels are negative-stride
        # views, which torch.from_numpy refuses
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device, dtype)

    if cls in ("Dense", "TimeDistributed"):
        p = {"W": t(arrays[0])}
        if len(arrays) > 1:
            p["b"] = t(arrays[1])
        return p, {}
    if cls in ("Conv2D", "Convolution2D", "Conv1D", "Convolution1D"):
        k = np.asarray(arrays[0])
        if cls in ("Conv2D", "Convolution2D") and k.ndim == 4 and \
                k.shape[0] == layer.n_out and k.shape[0] not in k.shape[2:]:
            # Theano OIHW → HWIO, kernels flipped
            k = np.transpose(k, (2, 3, 1, 0))[::-1, ::-1]
        p = {"W": t(k)}
        if len(arrays) > 1:
            p["b"] = t(arrays[1])
        return p, {}
    if cls == "BatchNormalization":
        p, s = {}, {}
        if len(arrays) == 4:
            p["gamma"], p["beta"] = t(arrays[0]), t(arrays[1])
            s["mean"], s["var"] = t(arrays[2]), t(arrays[3])
        return p, s
    if cls == "Embedding":
        return {"W": t(arrays[0])}, {}
    if cls == "LSTM":
        if len(arrays) == 3:      # Keras 2: kernel, recurrent, bias (i,f,c,o)
            return {"W": t(arrays[0]), "R": t(arrays[1]),
                    "b": t(arrays[2])}, {}
        if len(arrays) == 12:     # Keras 1: W / U / b a gate, i, c, f, o
            Wi, Ui, bi, Wc, Uc, bc, Wf, Uf, bf, Wo, Uo, bo = \
                [np.asarray(a) for a in arrays]
            W = np.concatenate([Wi, Wf, Wc, Wo], axis=1)
            R = np.concatenate([Ui, Uf, Uc, Uo], axis=1)
            b = np.concatenate([bi, bf, bc, bo])
            return {"W": t(W), "R": t(R), "b": t(b)}, {}
    return None


KERAS_LAYER_CONVERTERS = convert_layer  # registry alias (reference naming)
