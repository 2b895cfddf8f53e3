"""Checkpoints in the JAX package's ``utils/serializer.py`` zip layout, read
and written with numpy alone: ``configuration.json``, ``coefficients.npz``
(``r/<vertex or layer index>/<param>`` keys), ``layerState.npz``,
``updaterState.npz`` (``r/<vertex or layer index>/<param>/<slot>`` keys,
e.g. ``m`` and ``v`` for adam), ``normalizer.bin`` (a ``DataNormalizer``'s
``to_bytes``, when one is saved) and ``meta.json`` (model type, iteration,
epoch). A checkpoint either package writes, the other restores, and
training resumes where it stopped, with the layer state (batch norm's
running statistics) it had; ComputationGraph and MultiLayerNetwork
alike. ``graph_from_numpy`` / ``network_from_numpy`` carry parameters and
state across without a checkpoint. :class:`ModelSerializer` and
:class:`ModelGuesser` are the JAX package's class faces of these
functions."""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..nn.conf.config import MultiLayerConfiguration
from ..nn.graph.computation_graph import ComputationGraph
from ..nn.graph.graph_config import ComputationGraphConfiguration
from ..nn.multilayer import MultiLayerNetwork
from ..ops.dataset import DataNormalizer
from ..ops.platform import state_on

CONFIG_ENTRY = "configuration.json"
COEFF_ENTRY = "coefficients.npz"
UPDATER_ENTRY = "updaterState.npz"
STATE_ENTRY = "layerState.npz"
NORMALIZER_ENTRY = "normalizer.bin"
META_ENTRY = "meta.json"


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(conf: ComputationGraphConfiguration,
                      arrays: Dict[str, Dict[str, np.ndarray]],
                      device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{vertex: {param: ndarray}}`` (the JAX net's parameters as numpy)
    → the port's parameter dict on ``device``, bytes unchanged. Every
    vertex of ``conf`` gets an entry; unknown vertices raise."""
    unknown = set(arrays) - set(conf.vertices)
    if unknown:
        raise ValueError(f"parameters for unknown vertices: {sorted(unknown)}")
    return {name: {k: _tensor(a, device)
                   for k, a in arrays.get(name, {}).items()}
            for name in conf.topological_order}


def _state(init: Dict, given, device) -> Dict:
    """A layer's initial state on ``device`` with the given arrays (the
    JAX net's state as numpy, bytes unchanged) in place of its entries."""
    out = state_on(init, device)
    for k, a in (given or {}).items():
        out[k] = _tensor(a, device)
    return out


def graph_from_numpy(conf: ComputationGraphConfiguration,
                     arrays: Dict[str, Dict[str, np.ndarray]], device=None,
                     compute_dtype=None,
                     state: Optional[Dict[str, Dict[str, np.ndarray]]] = None
                     ) -> ComputationGraph:
    """A ready ComputationGraph with the given parameters (no random
    init), the given layer state (``{vertex: {name: ndarray}}``, e.g. batch
    norm's running mean and var; initial state where absent) and fresh
    updater state. ``device=None`` means the card."""
    net = ComputationGraph(conf, compute_dtype=compute_dtype, device=device)
    net.params = params_from_numpy(conf, arrays, net.device)
    state = state or {}
    net.state = {name: _state(conf.vertices[name].init_state(),
                              state.get(name), net.device)
                 for name in conf.topological_order}
    net.init_updaters()
    net._initialized = True
    return net


def network_from_numpy(conf: MultiLayerConfiguration,
                       arrays: List[Dict[str, np.ndarray]], device=None,
                       compute_dtype=None,
                       state: Optional[List[Dict[str, np.ndarray]]] = None
                       ) -> MultiLayerNetwork:
    """A ready MultiLayerNetwork with the given per-layer parameters (the
    JAX net's ``params`` as numpy, bytes unchanged), the given per-layer
    state (initial state where absent) and fresh updater state.
    ``device=None`` means the card."""
    if len(arrays) != len(conf.layers):
        raise ValueError(f"{len(arrays)} parameter dicts for "
                         f"{len(conf.layers)} layers")
    net = MultiLayerNetwork(conf, compute_dtype=compute_dtype, device=device)
    net.params = [{k: _tensor(a, net.device) for k, a in p.items()}
                  for p in arrays]
    state = state or [{} for _ in conf.layers]
    net.state = [_state(layer.init_state(), st, net.device)
                 for layer, st in zip(conf.layers, state)]
    net.init_updaters()
    net._initialized = True
    return net


def _npz_to_flat(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data)) as npz:
        return {k: npz[k] for k in npz.files if k != "__empty__"}


def _flat_to_npz(tree) -> bytes:
    """Nested dicts / lists of tensors → npz bytes with ``r/<a>/<b>/...``
    keys (list items by index; an empty tree writes the ``__empty__``
    placeholder, as the JAX writer does)."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}")
        elif torch.is_tensor(node):
            flat[prefix] = node.detach().cpu().numpy()
    walk(tree, "r")
    buf = io.BytesIO()
    np.savez(buf, **flat) if flat else np.savez(buf, __empty__=np.zeros(1))
    return buf.getvalue()


def _by_owner(flat: Dict[str, np.ndarray], what: str):
    """``r/<owner>/<name>`` keys → ``{owner: {name: ndarray}}``."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for key, a in flat.items():
        root, owner, name = key.split("/", 2)
        if root != "r":
            raise ValueError(f"unexpected {what} key '{key}'")
        out.setdefault(owner, {})[name] = a
    return out


def _read(path):
    """(configuration JSON, {owner: {param: ndarray}}, {owner: {state
    entry: ndarray}}, updater npz or None, meta) of a checkpoint; owners
    are vertex names or layer indices as strings."""
    with zipfile.ZipFile(Path(path), "r") as z:
        names = set(z.namelist())
        conf_json = z.read(CONFIG_ENTRY).decode()
        coeffs = _npz_to_flat(z.read(COEFF_ENTRY))
        state = _npz_to_flat(z.read(STATE_ENTRY)) \
            if STATE_ENTRY in names else {}
        upd = _npz_to_flat(z.read(UPDATER_ENTRY)) \
            if UPDATER_ENTRY in names else None
        meta = json.loads(z.read(META_ENTRY)) if META_ENTRY in names else {}
    return conf_json, _by_owner(coeffs, "coefficient"), \
        _by_owner(state, "layer state"), upd, meta


def _resume(net, owners, upd, meta):
    """Updater state, iteration and epoch from a checkpoint into ``net``;
    ``owners`` pairs each checkpoint owner key with its updater slots."""
    if upd is not None:
        for owner, slots in owners:
            for param, state in slots.items():
                for slot in (state if isinstance(state, dict) else {}):
                    key = f"r/{owner}/{param}/{slot}"
                    if key in upd:
                        state[slot] = _tensor(upd[key], net.device)
    net.iteration = int(meta.get("iteration", 0))
    net.epoch = int(meta.get("epoch", 0))
    return net


def restore_computation_graph(path, device=None, compute_dtype=None,
                              load_updater: bool = True) -> ComputationGraph:
    """Load a ComputationGraph checkpoint written by the JAX package's
    ``ModelSerializer.write_model`` (or :func:`write_model`): parameters,
    updater state (fresh with ``load_updater=False``), iteration and
    epoch, so ``fit_batch`` continues the run, and the layer state (batch
    norm's running statistics). ``device=None`` means the card."""
    conf_json, arrays, state, upd, meta = _read(path)
    conf = ComputationGraphConfiguration.from_json(conf_json)
    net = graph_from_numpy(conf, arrays, device, compute_dtype, state)
    return _resume(net, net.updater_state.items(),
                   upd if load_updater else None, meta)


def restore_multi_layer_network(path, device=None, compute_dtype=None,
                                load_updater: bool = True
                                ) -> MultiLayerNetwork:
    """Load a MultiLayerNetwork checkpoint written by the JAX package's
    ``ModelSerializer.write_model`` (or :func:`write_model`): parameters,
    updater state (fresh with ``load_updater=False``), iteration and
    epoch, and the layer state. ``device=None`` means the card."""
    conf_json, arrays, state, upd, meta = _read(path)
    conf = MultiLayerConfiguration.from_json(conf_json)
    owners = [str(i) for i in range(len(conf.layers))]
    net = network_from_numpy(conf, [arrays.get(o, {}) for o in owners],
                             device, compute_dtype,
                             [state.get(o, {}) for o in owners])
    return _resume(net, ((str(i), s) for i, s in
                         enumerate(net.updater_state)),
                   upd if load_updater else None, meta)


def write_model(net, path, save_updater: bool = True,
                normalizer: Optional[DataNormalizer] = None) -> None:
    """Write a ComputationGraph or MultiLayerNetwork, with its updater
    state unless ``save_updater`` is False and with ``normalizer`` where
    given, as a checkpoint zip the JAX package's ``ModelSerializer``
    restores."""
    with zipfile.ZipFile(Path(path), "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(CONFIG_ENTRY, net.conf.to_json())
        z.writestr(COEFF_ENTRY, _flat_to_npz(net.params))
        z.writestr(STATE_ENTRY, _flat_to_npz(net.state))
        if save_updater:
            z.writestr(UPDATER_ENTRY, _flat_to_npz(net.updater_state))
        if normalizer is not None:
            z.writestr(NORMALIZER_ENTRY, normalizer.to_bytes())
        z.writestr(META_ENTRY, json.dumps({
            "model_type": type(net).__name__,
            "iteration": net.iteration,
            "epoch": net.epoch,
            "format_version": 1,
        }))


def _meta(path) -> Dict:
    with zipfile.ZipFile(Path(path), "r") as z:
        return json.loads(z.read(META_ENTRY)) if META_ENTRY in z.namelist() \
            else {}


def restore_model(path, device=None, compute_dtype=None):
    """Restore a checkpoint as the model type its ``meta.json`` names
    (MultiLayerNetwork unless it says ComputationGraph)."""
    restore = restore_computation_graph \
        if _meta(path).get("model_type") == "ComputationGraph" \
        else restore_multi_layer_network
    return restore(path, device, compute_dtype)


def restore_normalizer(path) -> Optional[DataNormalizer]:
    """The checkpoint's ``normalizer.bin`` as a DataNormalizer (None when
    the checkpoint has none)."""
    with zipfile.ZipFile(Path(path), "r") as z:
        if NORMALIZER_ENTRY not in z.namelist():
            return None
        return DataNormalizer.from_bytes(z.read(NORMALIZER_ENTRY))


class ModelSerializer:
    """The JAX package's checkpoint API (``utils/serializer.py:71``) over
    this module's functions; ``device=None`` means the card."""

    @staticmethod
    def write_model(net, path, save_updater: bool = True,
                    normalizer: Optional[DataNormalizer] = None) -> None:
        write_model(net, path, save_updater, normalizer)

    @staticmethod
    def restore_multi_layer_network(path, load_updater: bool = True,
                                    device=None, compute_dtype=None):
        return restore_multi_layer_network(path, device, compute_dtype,
                                           load_updater)

    @staticmethod
    def restore_computation_graph(path, load_updater: bool = True,
                                  device=None, compute_dtype=None):
        return restore_computation_graph(path, device, compute_dtype,
                                         load_updater)

    @staticmethod
    def restore_normalizer(path) -> Optional[DataNormalizer]:
        return restore_normalizer(path)


class ModelGuesser:
    """Load a saved model, guessing its type (the JAX package's
    ``utils/serializer.py:149``): a file with the HDF5 signature is a
    Keras model and goes through ``keras.importer`` (Sequential →
    MultiLayerNetwork, functional → ComputationGraph); otherwise the
    zip's ``meta.json`` decides MultiLayerNetwork or ComputationGraph."""

    HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"

    @staticmethod
    def load_model_guess_type(path, device=None, compute_dtype=None):
        with open(path, "rb") as f:
            magic = f.read(8)
        if magic == ModelGuesser.HDF5_MAGIC:
            from ..keras.importer import KerasModelImport
            return KerasModelImport.import_keras_model_and_weights(
                path, device=device, compute_dtype=compute_dtype)
        return restore_model(path, device, compute_dtype)
