"""Keras 2 HDF5 model files (the JAX package's ``keras/export.py``, the
inverse of the importer), written through the port's own HDF5 writer
(``hdf5.py``).

``export_resnet50_keras_h5`` writes a full-scale fixture: the ResNet-50
functional graph (stride-2 projection shortcuts, 16 Add merges, batch
norm moving statistics) with seeded random weights, bitwise the JAX
package's arrays for the same seed (both draw from numpy's generator), so
the import path can be tested and measured end to end without Keras's
own weights. ``write_keras_h5`` writes any model config with its weights
in the layout ``keras.Model.save`` used in the Keras 2 era:
``model_config`` / ``training_config`` / ``keras_version`` attributes
and a ``model_weights`` group with ``layer_names`` / ``weight_names``."""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import hdf5


def write_keras_h5(path, model_config: dict,
                   weights: Dict[str, Sequence[Tuple[str, np.ndarray]]],
                   training_config: Optional[dict] = None) -> None:
    """Write a Keras 2 model file: ``weights`` maps a layer name to its
    (weight suffix, array) pairs in Keras's order (e.g. ``("kernel:0",
    W), ("bias:0", b)``), stored as ``model_weights/<layer>/<layer>/
    <suffix>`` in float32."""
    with hdf5.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(model_config).encode()
        if training_config is not None:
            f.attrs["training_config"] = json.dumps(training_config).encode()
        f.attrs["keras_version"] = b"2.2.4"
        f.attrs["backend"] = b"tensorflow"
        mw = f.create_group("model_weights")
        for name, pairs in weights.items():
            g = mw.create_group(name)
            wnames = [f"{name}/{sfx}" for sfx, _ in pairs]
            g.attrs["weight_names"] = np.array([w.encode() for w in wnames])
            for wn, (_, arr) in zip(wnames, pairs):
                g.create_dataset(wn, data=np.asarray(arr, np.float32))
        mw.attrs["layer_names"] = np.array([n.encode() for n in weights])


def _node(inputs: List[str]):
    return [[[n, 0, 0, {}] for n in inputs]]


def _layer(cls: str, name: str, config: dict, inputs: List[str]):
    config = dict(config)
    config["name"] = name
    return {"class_name": cls, "name": name, "config": config,
            "inbound_nodes": _node(inputs) if inputs else []}


def _conv(name, inp, filters, k, s, use_bias=False):
    # kernel array is filled by the channel walk in export_resnet50_keras_h5
    # once the input channel count of this conv is known
    return _layer("Conv2D", name,
                  {"filters": int(filters), "kernel_size": [k, k],
                   "strides": [s, s], "padding": "same",
                   "data_format": "channels_last", "dilation_rate": [1, 1],
                   "activation": "linear", "use_bias": bool(use_bias)},
                  [inp])


def _bn(name, inp, channels, rng, weights):
    weights[name] = [np.abs(rng.normal(1.0, 0.1, channels)).astype(np.float32),
                     rng.normal(0, 0.1, channels).astype(np.float32),
                     rng.normal(0, 0.2, channels).astype(np.float32),
                     np.abs(rng.normal(1.0, 0.2, channels))
                     .astype(np.float32) + 0.5]
    return _layer("BatchNormalization", name,
                  {"axis": -1, "momentum": 0.99, "epsilon": 1e-3,
                   "center": True, "scale": True}, [inp])


def export_resnet50_keras_h5(path, num_classes: int = 1000,
                             height: int = 224, width: int = 224,
                             channels: int = 3, seed: int = 7,
                             blocks: Optional[List[int]] = None,
                             widths: Optional[List[Tuple[int, int]]] = None):
    """Write a ResNet-50 functional model (Keras 2 HDF5). Layer names align
    with the native ``models.resnet.resnet50_conf`` vertex names (plus the
    explicit Activation layers Keras needs where the native graph fuses
    activation into BN), so tests can load the same arrays into both nets.
    Returns the dict name -> list-of-weight-arrays that was written."""
    blocks = blocks or [3, 4, 6, 3]
    widths = widths or [(64, 256), (128, 512), (256, 1024), (512, 2048)]
    rng = np.random.default_rng(seed)
    weights: Dict[str, List[np.ndarray]] = {}
    layers = [_layer("InputLayer", "input",
                     {"batch_input_shape": [None, height, width, channels],
                      "dtype": "float32"}, [])]

    def conv_bn(name, inp, n_out, k, s, relu):
        layers.append(_conv(f"{name}_conv", inp, n_out, k, s))
        layers.append(_bn(f"{name}_bn", f"{name}_conv", n_out, rng, weights))
        if relu:
            layers.append(_layer("Activation", f"{name}_bnrelu",
                                 {"activation": "relu"}, [f"{name}_bn"]))
            return f"{name}_bnrelu"
        return f"{name}_bn"

    x = conv_bn("stem", "input", widths[0][0], 7, 2, relu=True)
    layers.append(_layer("MaxPooling2D", "stem_pool",
                         {"pool_size": [3, 3], "strides": [2, 2],
                          "padding": "same",
                          "data_format": "channels_last"}, [x]))
    x = "stem_pool"
    for stage, (n_blocks, (mid, out)) in enumerate(zip(blocks, widths)):
        for blk in range(n_blocks):
            name = f"s{stage}b{blk}"
            stride = 2 if (blk == 0 and stage > 0) else 1
            project = blk == 0
            a = conv_bn(f"{name}_a", x, mid, 1, stride, relu=True)
            b = conv_bn(f"{name}_b", a, mid, 3, 1, relu=True)
            c = conv_bn(f"{name}_c", b, out, 1, 1, relu=False)
            shortcut = x
            if project:
                shortcut = conv_bn(f"{name}_proj", x, out, 1, stride,
                                   relu=False)
            layers.append(_layer("Add", f"{name}_add", {}, [c, shortcut]))
            layers.append(_layer("Activation", f"{name}_relu",
                                 {"activation": "relu"}, [f"{name}_add"]))
            x = f"{name}_relu"
    layers.append(_layer("GlobalAveragePooling2D", "avgpool",
                         {"data_format": "channels_last"}, [x]))
    layers.append(_layer("Dense", "fc",
                         {"units": int(num_classes),
                          "activation": "softmax", "use_bias": True}, ["avgpool"]))
    # fc weights: fan-in known only after widths — final feature dim
    feat = widths[-1][1]
    weights["fc"] = [rng.normal(0, 0.05, (feat, num_classes))
                     .astype(np.float32),
                     np.zeros(num_classes, np.float32)]

    # fill conv kernels now that input channel counts are determined by walk
    ch: Dict[str, int] = {"input": channels}
    for lc in layers:
        name = lc["name"]
        ins = [e[0] for n in lc["inbound_nodes"] for e in n]
        cls = lc["class_name"]
        if cls == "Conv2D":
            cin = ch[ins[0]]
            k = lc["config"]["kernel_size"][0]
            f = lc["config"]["filters"]
            weights[name] = [rng.normal(0, np.sqrt(2.0 / (k * k * cin)),
                                        (k, k, cin, f)).astype(np.float32)]
            ch[name] = f
        elif cls in ("BatchNormalization", "Activation", "MaxPooling2D",
                     "Add"):
            ch[name] = ch[ins[0]]
        elif cls == "GlobalAveragePooling2D":
            ch[name] = ch[ins[0]]
        elif cls == "Dense":
            ch[name] = lc["config"]["units"]

    model_config = {
        "class_name": "Model",
        "config": {
            "name": "resnet50",
            "layers": layers,
            "input_layers": [["input", 0, 0]],
            "output_layers": [["fc", 0, 0]],
        },
    }
    # Nesterov SGD so the imported net runs the SAME updater program as the
    # native resnet50_conf bench (updater="nesterovs", momentum 0.9)
    training_config = {"loss": "categorical_crossentropy",
                       "metrics": ["accuracy"],
                       "optimizer_config": {
                           "class_name": "SGD",
                           "config": {"lr": 0.01, "momentum": 0.9,
                                      "nesterov": True}}}

    _WEIGHT_SUFFIX = {
        "Conv2D": ["kernel:0"],
        "Dense": ["kernel:0", "bias:0"],
        "BatchNormalization": ["gamma:0", "beta:0", "moving_mean:0",
                               "moving_variance:0"],
    }
    write_keras_h5(path, model_config, {
        lc["name"]: list(zip(_WEIGHT_SUFFIX[lc["class_name"]],
                             weights[lc["name"]]))
        for lc in layers if lc["name"] in weights}, training_config)
    return weights
