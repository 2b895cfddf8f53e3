"""Weights carried across from the JAX package (its ``utils/serializer.py``
checkpoint zip: ``configuration.json`` + ``coefficients.npz`` with
``r/<vertex>/<param>`` keys), read with numpy alone."""

from __future__ import annotations

import io
import zipfile
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..nn.graph.computation_graph import ComputationGraph
from ..nn.graph.graph_config import ComputationGraphConfiguration

CONFIG_ENTRY = "configuration.json"
COEFF_ENTRY = "coefficients.npz"


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
    init). ``device=None`` means the card."""
    net = ComputationGraph(conf, compute_dtype=compute_dtype, device=device)
    net.params = params_from_numpy(conf, arrays, net.device)
    net.state = {name: conf.vertices[name].init_state()
                 for name in conf.topological_order}
    net._initialized = True
    return net


def restore_computation_graph(path, device=None,
                              compute_dtype=None) -> ComputationGraph:
    """Load a ComputationGraph checkpoint written by the JAX package's
    ``ModelSerializer.write_model``. ``device=None`` means the card."""
    with zipfile.ZipFile(Path(path), "r") as z:
        conf = ComputationGraphConfiguration.from_json(
            z.read(CONFIG_ENTRY).decode())
        with np.load(io.BytesIO(z.read(COEFF_ENTRY))) as npz:
            flat = {k: npz[k] for k in npz.files if k != "__empty__"}
    arrays: Dict[str, Dict[str, np.ndarray]] = {}
    for key, a in flat.items():
        root, vertex, param = key.split("/", 2)
        if root != "r":
            raise ValueError(f"unexpected coefficient key '{key}'")
        arrays.setdefault(vertex, {})[param] = a
    return graph_from_numpy(conf, arrays, device, compute_dtype)
