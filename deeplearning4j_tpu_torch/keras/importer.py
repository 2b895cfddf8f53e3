"""Keras HDF5 model import (the JAX package's ``keras/importer.py``), over
the port's own HDF5 reader (``hdf5.py``). Keras 1.x (``param_0``...
layout, th / tf dim ordering) and 2.x (``model_weights/<layer>`` with
``weight_names``):

- a Sequential config  → MultiLayerConfiguration → MultiLayerNetwork
- a functional Model   → ComputationGraphConfiguration → ComputationGraph

The saved ``training_config`` (loss, optimizer) is applied, so an import
is trainable. Activations are NHWC (Keras's convention), so conv kernels
(HWIO) and dense weights map without a transpose; Theano-ordered kernels
are flipped and transposed to HWIO. The net is built and its weights
land on the host (batch norm's moving statistics in the layer state);
then it moves to its device once. Entry points run on the card unless
the caller passes ``device="cpu"``."""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..nn.conf.config import MultiLayerConfiguration, NeuralNetConfiguration
from ..nn.conf.input_type import InputType
from ..nn.conf.layers import (ActivationLayer, DenseLayer, LossLayer,
                              OutputLayer)
from ..nn.conf.preprocessors import CnnToFeedForwardPreProcessor
from ..nn.graph.computation_graph import ComputationGraph
from ..nn.graph.vertices import PreprocessorVertex
from ..nn.multilayer import MultiLayerNetwork
from ..ops.platform import resolve_device, state_on
from . import hdf5
from .layers import (KERAS_LAYER_CONVERTERS, KerasLayerError, convert_layer,
                     convert_vertex, map_weights)

_STAGING = torch.device("cpu")


def _read_json_attr(obj, name: str):
    if name not in obj.attrs:
        return None
    raw = obj.attrs[name]
    if isinstance(raw, bytes):
        raw = raw.decode("utf-8")
    return json.loads(raw)


class KerasModelImport:
    """The static entry points of the reference's KerasModelImport.
    ``device=None`` means the card; ``compute_dtype`` is the net's (f32
    masters either way)."""

    @staticmethod
    def import_keras_sequential_model_and_weights(
            path, enforce_training_config: bool = False, device=None,
            compute_dtype=None):
        return _import(path, "Sequential", device, compute_dtype)

    @staticmethod
    def import_keras_model_and_weights(path,
                                       enforce_training_config: bool = False,
                                       device=None, compute_dtype=None):
        return _import(path, None, device, compute_dtype)

    @staticmethod
    def import_keras_model_configuration(path):
        with hdf5.File(path) as f:
            return _configuration(f, path, None)[0]


_KERAS_LOSS = {
    "categorical_crossentropy": "mcxent",
    "sparse_categorical_crossentropy": "mcxent",
    "binary_crossentropy": "xent",
    "mean_squared_error": "mse", "mse": "mse",
    "mean_absolute_error": "mae", "mae": "mae",
    "kullback_leibler_divergence": "kl_divergence",
    "poisson": "poisson", "hinge": "hinge", "squared_hinge": "squared_hinge",
    "cosine_proximity": "cosine_proximity",
}

_KERAS_OPTIMIZER = {"adam": "adam", "nadam": "adam", "adamax": "adamax",
                    "rmsprop": "rmsprop", "adagrad": "adagrad",
                    "adadelta": "adadelta"}


def _training_config(f):
    """(loss, opts) from the saved compile() config: ``loss`` a Keras loss
    name or a per-output-name dict (resolved by :func:`_loss_for`),
    ``opts`` the learning rate, updater and momentum."""
    tc = _read_json_attr(f, "training_config")
    if not tc:
        return None, {}
    opts = {}
    opt = tc.get("optimizer_config") or {}
    cfg = opt.get("config") or {}
    for key in ("lr", "learning_rate"):
        if isinstance(cfg.get(key), (int, float)):
            opts["lr"] = float(cfg[key])
            break
    ocls = (opt.get("class_name") or "").lower()
    if ocls == "sgd":
        momentum = float(cfg.get("momentum", 0.0) or 0.0)
        if momentum > 0:
            # plain heavy-ball and nesterov=True both map to "nesterovs",
            # the reference's only momentum-SGD rule
            opts["updater"] = "nesterovs"
            opts["momentum"] = momentum
        else:
            opts["updater"] = "sgd"
    elif ocls in _KERAS_OPTIMIZER:
        opts["updater"] = _KERAS_OPTIMIZER[ocls]
    return tc.get("loss"), opts


def _loss_for(loss, name: Optional[str]) -> Optional[str]:
    """The loss of one output (per-output dicts are keyed by name)."""
    if isinstance(loss, dict):
        loss = loss.get(name) if name is not None else \
            next(iter(loss.values()), None)
    return _KERAS_LOSS.get(loss) if isinstance(loss, str) else None


def _configuration(f, path, expect: Optional[str]):
    """(configuration, Keras layer map) of an open Keras file."""
    model_config = _read_json_attr(f, "model_config")
    if model_config is None:
        raise KerasLayerError(f"No model_config attribute in {path}")
    cls = model_config.get("class_name")
    if expect and cls != expect:
        raise KerasLayerError(f"Expected {expect} model, got {cls}")
    loss, opts = _training_config(f)
    if cls == "Sequential":
        return _sequential_conf(model_config, loss, opts)
    if cls in ("Model", "Functional"):
        return _functional_conf(model_config, loss, opts)
    raise KerasLayerError(f"Unsupported Keras model class {cls}")


def _import(path, expect: Optional[str], device, compute_dtype):
    target = resolve_device(device)
    with hdf5.File(path) as f:
        conf, keras_names = _configuration(f, path, expect)
        cls = MultiLayerNetwork if isinstance(conf, MultiLayerConfiguration) \
            else ComputationGraph
        net = cls(conf, compute_dtype=compute_dtype, device=_STAGING).init()
        net._keras_layer_map = keras_names
        _load_weights(f, net)
    _place(net, target)
    return net


def _place(net, device: torch.device) -> None:
    """Move a host-built net to ``device``: parameters, layer state and
    fresh updater state, once."""
    if device == net.device:
        return
    if isinstance(net, MultiLayerNetwork):
        net.params = [{k: v.to(device) for k, v in p.items()}
                      for p in net.params]
        net.state = [state_on(s, device) for s in net.state]
    else:
        net.params = {n: {k: v.to(device) for k, v in p.items()}
                      for n, p in net.params.items()}
        net.state = {n: state_on(s, device) for n, s in net.state.items()}
        net._fusion = None
    net.device = device
    net.init_updaters()


def _as_output_layer(converted, loss: str):
    """The network's output layer with a known training loss → a
    loss-bearing layer: Dense → OutputLayer; a trailing Activation (the
    Keras-1 Dense-then-Activation ending) → LossLayer."""
    if type(converted) is DenseLayer:
        return OutputLayer(n_in=converted.n_in, n_out=converted.n_out,
                           activation=converted.activation, loss=loss)
    if type(converted) is ActivationLayer:
        return LossLayer(activation=converted.activation, loss=loss)
    return converted


def _layer_list(model_config) -> List[dict]:
    cfg = model_config["config"]
    return cfg["layers"] if isinstance(cfg, dict) else cfg


def _input_type_from_shape(shape) -> InputType:
    """batch_input_shape (without the batch dimension) → InputType."""
    dims = [d for d in shape if d is not None]
    if len(dims) == 3:
        return InputType.convolutional(dims[0], dims[1], dims[2])
    if len(dims) == 2:
        return InputType.recurrent(dims[1], dims[0])
    return InputType.feed_forward(dims[0] if dims else 0)


def _builder(opts):
    b = NeuralNetConfiguration.Builder().activation("identity") \
        .weight_init("xavier")
    if opts.get("lr") is not None:
        b = b.learning_rate(opts["lr"])
    if opts.get("updater"):
        b = b.updater(opts["updater"])
    if opts.get("momentum") is not None:
        b = b.momentum(opts["momentum"])
    return b


def _sequential_conf(model_config, loss, opts):
    builder = _builder(opts).list()
    input_type = None
    collected: List[Tuple[object, str, str]] = []
    for lc in _layer_list(model_config):
        cls = lc["class_name"]
        conf = lc["config"]
        if input_type is None:
            shape = conf.get("batch_input_shape") or conf.get("batch_shape")
            if shape is not None:
                input_type = _input_type_from_shape(shape[1:])
        if cls == "InputLayer":
            continue
        converted = convert_layer(cls, conf)
        if converted is None:
            continue        # shape-only: the preprocessors handle it
        collected.append((converted, conf.get("name", cls), cls))
    mapped_loss = _loss_for(loss, collected[-1][1] if collected else None)
    if collected and mapped_loss is not None:
        converted, kname, kcls = collected[-1]
        collected[-1] = (_as_output_layer(converted, mapped_loss), kname,
                         kcls)
    keras_names = []
    for idx, (converted, kname, kcls) in enumerate(collected):
        builder.layer(converted)
        keras_names.append((kname, kcls, idx))
    if input_type is not None:
        builder.set_input_type(input_type)
    return builder.build(), keras_names


def _inbound_names(lc) -> List[str]:
    inbound = lc.get("inbound_nodes") or []
    names: List[str] = []
    if not inbound:
        return names
    node = inbound[0]
    if isinstance(node, dict):              # Keras 3 style
        def walk(a):
            if isinstance(a, dict) and "config" in a and \
                    "keras_history" in a.get("config", {}):
                names.append(a["config"]["keras_history"][0])
            elif isinstance(a, (list, tuple)):
                for x in a:
                    walk(x)
        walk(node.get("args", []))
    else:
        names.extend(entry[0] for entry in node)
    return names


def _output_names(cfg) -> List[str]:
    return [o[0] if isinstance(o, (list, tuple)) else o
            for o in cfg.get("output_layers", [])]


def _functional_conf(model_config, loss, opts):
    cfg = model_config["config"]
    outs = _output_names(cfg)
    g = _builder(opts).graph_builder()
    input_names, input_types, keras_names = [], [], []
    for lc in cfg["layers"]:
        cls = lc["class_name"]
        conf = lc["config"]
        name = conf.get("name") or lc.get("name")
        in_names = _inbound_names(lc)
        if cls == "InputLayer":
            input_names.append(name)
            shape = conf.get("batch_input_shape") or conf.get("batch_shape")
            input_types.append(_input_type_from_shape(shape[1:]))
            continue
        vertex = convert_vertex(cls, conf)
        if vertex is not None:
            g.add_vertex(name, vertex, *in_names)
            continue
        converted = convert_layer(cls, conf)
        if converted is None:
            # shape-only: an identity preprocessor vertex
            if cls in ("Flatten", "Reshape", "GlobalAveragePooling2D"):
                g.add_vertex(name, PreprocessorVertex(
                    preprocessor=CnnToFeedForwardPreProcessor()), *in_names)
            continue
        if name in outs:
            mapped = _loss_for(loss, name)
            if mapped is not None:
                converted = _as_output_layer(converted, mapped)
        g.add_layer(name, converted, *in_names)
        keras_names.append((name, cls, name))
    g.add_inputs(*input_names)
    g.set_outputs(*outs)
    g.set_input_types(*input_types)
    return g.build(), keras_names


def _weight_group(f):
    return f["model_weights"] if "model_weights" in f else f


def _layer_weights(group, keras_name: str) -> list:
    """One Keras layer's weight arrays in stored order (the 2.x
    ``weight_names`` attribute, or 1.x ``param_N`` order)."""
    if keras_name not in group:
        return []
    lg = group[keras_name]
    if "weight_names" in lg.attrs:
        names = [n.decode() if isinstance(n, bytes) else n
                 for n in lg.attrs["weight_names"]]
        out = []
        for n in names:
            node = lg
            for part in n.split("/"):
                if part in node:
                    node = node[part]
            out.append(np.asarray(node))
        return out
    keys = sorted(lg.keys(),
                  key=lambda k: int(k.split("_")[-1]) if "_" in k and
                  k.split("_")[-1].isdigit() else 0)
    out = []
    for k in keys:
        node = lg[k]
        if hasattr(node, "keys"):
            out.extend(np.asarray(node[kk]) for kk in node.keys())
        else:
            out.append(np.asarray(node))
    return out


def _load_weights(f, net):
    """Every Keras layer's arrays into the net's parameters and state, as
    tensors of the masters' dtype on the net's device."""
    group = _weight_group(f)
    for keras_name, cls, key in net._keras_layer_map:
        arrays = _layer_weights(group, keras_name)
        if not arrays:
            continue
        layer = net.layers[key] if isinstance(net, MultiLayerNetwork) \
            else net.conf.vertices[key].layer
        params = net.params[key]
        dtype = next(iter(params.values())).dtype if params \
            else torch.float32
        mapped = map_weights(cls, layer, arrays, device=net.device,
                             dtype=dtype)
        if mapped:
            p, state_update = mapped
            params.update(p)
            if state_update:
                net.state[key].update(state_update)
