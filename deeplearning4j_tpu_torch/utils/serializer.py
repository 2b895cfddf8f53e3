"""Checkpoints in the JAX package's ``utils/serializer.py`` zip layout, read
and written with numpy alone: ``configuration.json``, ``coefficients.npz``
(``r/<vertex>/<param>`` keys), ``layerState.npz``, ``updaterState.npz``
(``r/<vertex>/<param>/<slot>`` keys, e.g. ``m`` and ``v`` for adam) and
``meta.json`` (model type, iteration, epoch). A checkpoint either package
writes, the other restores, and training resumes where it stopped."""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..nn.graph.computation_graph import ComputationGraph
from ..nn.graph.graph_config import ComputationGraphConfiguration

CONFIG_ENTRY = "configuration.json"
COEFF_ENTRY = "coefficients.npz"
UPDATER_ENTRY = "updaterState.npz"
STATE_ENTRY = "layerState.npz"
META_ENTRY = "meta.json"


def params_from_numpy(conf: ComputationGraphConfiguration,
                      arrays: Dict[str, Dict[str, np.ndarray]],
                      device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{vertex: {param: ndarray}}`` (the JAX net's parameters as numpy)
    → the port's parameter dict on ``device``, bytes unchanged. Every
    vertex of ``conf`` gets an entry; unknown vertices raise."""
    unknown = set(arrays) - set(conf.vertices)
    if unknown:
        raise ValueError(f"parameters for unknown vertices: {sorted(unknown)}")
    return {name: {k: torch.from_numpy(np.array(a, copy=True)).to(device)
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


def _npz_to_flat(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data)) as npz:
        return {k: npz[k] for k in npz.files if k != "__empty__"}


def _flat_to_npz(tree) -> bytes:
    """Nested dicts of tensors → npz bytes with ``r/<a>/<b>/...`` keys (an
    empty tree writes the ``__empty__`` placeholder, as the JAX writer
    does)."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}")
        elif torch.is_tensor(node):
            flat[prefix] = node.detach().cpu().numpy()
    walk(tree, "r")
    buf = io.BytesIO()
    np.savez(buf, **flat) if flat else np.savez(buf, __empty__=np.zeros(1))
    return buf.getvalue()


def restore_computation_graph(path, device=None,
                              compute_dtype=None) -> ComputationGraph:
    """Load a ComputationGraph checkpoint written by the JAX package's
    ``ModelSerializer.write_model`` (or :func:`write_model`): parameters,
    updater state, iteration and epoch, so ``fit_batch`` continues the
    run. ``device=None`` means the card."""
    with zipfile.ZipFile(Path(path), "r") as z:
        names = set(z.namelist())
        conf = ComputationGraphConfiguration.from_json(
            z.read(CONFIG_ENTRY).decode())
        coeffs = _npz_to_flat(z.read(COEFF_ENTRY))
        upd = _npz_to_flat(z.read(UPDATER_ENTRY)) \
            if UPDATER_ENTRY in names else None
        meta = json.loads(z.read(META_ENTRY)) if META_ENTRY in names else {}
    arrays: Dict[str, Dict[str, np.ndarray]] = {}
    for key, a in coeffs.items():
        root, vertex, param = key.split("/", 2)
        if root != "r":
            raise ValueError(f"unexpected coefficient key '{key}'")
        arrays.setdefault(vertex, {})[param] = a
    net = graph_from_numpy(conf, arrays, device, compute_dtype)
    if upd is not None:
        for vertex, slots in net.updater_state.items():
            for param, state in slots.items():
                for slot in (state if isinstance(state, dict) else {}):
                    key = f"r/{vertex}/{param}/{slot}"
                    if key in upd:
                        state[slot] = torch.from_numpy(
                            np.array(upd[key], copy=True)).to(net.device)
    net.iteration = int(meta.get("iteration", 0))
    net.epoch = int(meta.get("epoch", 0))
    return net


def write_model(net: ComputationGraph, path) -> None:
    """Write ``net`` with its updater state as a checkpoint zip the JAX
    package's ``ModelSerializer.restore_computation_graph`` reads."""
    with zipfile.ZipFile(Path(path), "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(CONFIG_ENTRY, net.conf.to_json())
        z.writestr(COEFF_ENTRY, _flat_to_npz(net.params))
        z.writestr(STATE_ENTRY, _flat_to_npz(net.state))
        z.writestr(UPDATER_ENTRY, _flat_to_npz(net.updater_state))
        z.writestr(META_ENTRY, json.dumps({
            "model_type": "ComputationGraph",
            "iteration": net.iteration,
            "epoch": net.epoch,
            "format_version": 1,
        }))
