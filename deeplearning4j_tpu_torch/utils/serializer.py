"""Checkpoints in the JAX package's ``utils/serializer.py`` zip layout, read
and written with numpy alone: ``configuration.json``, ``coefficients.npz``
(``r/<vertex or layer index>/<param>`` keys), ``layerState.npz``,
``updaterState.npz`` (``r/<vertex or layer index>/<param>/<slot>`` keys,
e.g. ``m`` and ``v`` for adam) and ``meta.json`` (model type, iteration,
epoch). A checkpoint either package writes, the other restores, and
training resumes where it stopped; ComputationGraph and MultiLayerNetwork
alike. ``graph_from_numpy`` / ``network_from_numpy`` carry parameters
across without a checkpoint."""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ..nn.conf.config import MultiLayerConfiguration
from ..nn.graph.computation_graph import ComputationGraph
from ..nn.graph.graph_config import ComputationGraphConfiguration
from ..nn.multilayer import MultiLayerNetwork

CONFIG_ENTRY = "configuration.json"
COEFF_ENTRY = "coefficients.npz"
UPDATER_ENTRY = "updaterState.npz"
STATE_ENTRY = "layerState.npz"
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


def graph_from_numpy(conf: ComputationGraphConfiguration,
                     arrays: Dict[str, Dict[str, np.ndarray]], device=None,
                     compute_dtype=None) -> ComputationGraph:
    """A ready ComputationGraph with the given parameters (no random
    init) and fresh updater state. ``device=None`` means the card."""
    net = ComputationGraph(conf, compute_dtype=compute_dtype, device=device)
    net.params = params_from_numpy(conf, arrays, net.device)
    net.state = {name: conf.vertices[name].init_state()
                 for name in conf.topological_order}
    net.init_updaters()
    net._initialized = True
    return net


def network_from_numpy(conf: MultiLayerConfiguration,
                       arrays: List[Dict[str, np.ndarray]], device=None,
                       compute_dtype=None) -> MultiLayerNetwork:
    """A ready MultiLayerNetwork with the given per-layer parameters (the
    JAX net's ``params`` as numpy, bytes unchanged) and fresh updater
    state. ``device=None`` means the card."""
    if len(arrays) != len(conf.layers):
        raise ValueError(f"{len(arrays)} parameter dicts for "
                         f"{len(conf.layers)} layers")
    net = MultiLayerNetwork(conf, compute_dtype=compute_dtype, device=device)
    net.params = [{k: _tensor(a, net.device) for k, a in p.items()}
                  for p in arrays]
    net.state = [layer.init_state() for layer in conf.layers]
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


def _read(path):
    """(configuration JSON, {owner: {param: ndarray}}, updater npz or None,
    meta) of a checkpoint; owners are vertex names or layer indices as
    strings."""
    with zipfile.ZipFile(Path(path), "r") as z:
        names = set(z.namelist())
        conf_json = z.read(CONFIG_ENTRY).decode()
        coeffs = _npz_to_flat(z.read(COEFF_ENTRY))
        upd = _npz_to_flat(z.read(UPDATER_ENTRY)) \
            if UPDATER_ENTRY in names else None
        meta = json.loads(z.read(META_ENTRY)) if META_ENTRY in names else {}
    arrays: Dict[str, Dict[str, np.ndarray]] = {}
    for key, a in coeffs.items():
        root, owner, param = key.split("/", 2)
        if root != "r":
            raise ValueError(f"unexpected coefficient key '{key}'")
        arrays.setdefault(owner, {})[param] = a
    return conf_json, arrays, upd, meta


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


def restore_computation_graph(path, device=None,
                              compute_dtype=None) -> ComputationGraph:
    """Load a ComputationGraph checkpoint written by the JAX package's
    ``ModelSerializer.write_model`` (or :func:`write_model`): parameters,
    updater state, iteration and epoch, so ``fit_batch`` continues the
    run. ``device=None`` means the card."""
    conf_json, arrays, upd, meta = _read(path)
    conf = ComputationGraphConfiguration.from_json(conf_json)
    net = graph_from_numpy(conf, arrays, device, compute_dtype)
    return _resume(net, net.updater_state.items(), upd, meta)


def restore_multi_layer_network(path, device=None,
                                compute_dtype=None) -> MultiLayerNetwork:
    """Load a MultiLayerNetwork checkpoint written by the JAX package's
    ``ModelSerializer.write_model`` (or :func:`write_model`): parameters,
    updater state, iteration and epoch. ``device=None`` means the card."""
    conf_json, arrays, upd, meta = _read(path)
    conf = MultiLayerConfiguration.from_json(conf_json)
    net = network_from_numpy(conf, [arrays.get(str(i), {})
                                    for i in range(len(conf.layers))],
                             device, compute_dtype)
    return _resume(net, ((str(i), s) for i, s in
                         enumerate(net.updater_state)), upd, meta)


def write_model(net, path) -> None:
    """Write a ComputationGraph or MultiLayerNetwork with its updater state
    as a checkpoint zip the JAX package's ``ModelSerializer`` restores."""
    with zipfile.ZipFile(Path(path), "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(CONFIG_ENTRY, net.conf.to_json())
        z.writestr(COEFF_ENTRY, _flat_to_npz(net.params))
        z.writestr(STATE_ENTRY, _flat_to_npz(net.state))
        z.writestr(UPDATER_ENTRY, _flat_to_npz(net.updater_state))
        z.writestr(META_ENTRY, json.dumps({
            "model_type": type(net).__name__,
            "iteration": net.iteration,
            "epoch": net.epoch,
            "format_version": 1,
        }))
