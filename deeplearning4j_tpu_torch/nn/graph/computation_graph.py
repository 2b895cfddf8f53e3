"""ComputationGraph: the DAG model (the JAX package's
``nn/graph/computation_graph.py``), inference branch.

Parameters are f32 masters in ``params[vertex][name]`` on ``device``; a
bf16 ``compute_dtype`` runs the forward on a cast copy
(:meth:`_cast_params`). ``device=None`` means the CUDA card and raises
when there is none — tests and CPU references pass ``device="cpu"``."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ...ops import rng as rngmod
from ...ops.platform import resolve_device
from .graph_config import ComputationGraphConfiguration


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration,
                 compute_dtype=None, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype or torch.float32
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        self.state: Dict[str, Dict] = {}
        self._initialized = False

    # ------------------------------------------------------------------ init
    def init(self) -> "ComputationGraph":
        """Seeded f32 initialization on the net's device: one generator
        per vertex, folded from the configuration seed and the vertex's
        topological index."""
        base = rngmod.for_purpose(self.conf.seed, "init")
        self.params, self.state = {}, {}
        for idx, name in enumerate(self.conf.topological_order):
            v = self.conf.vertices[name]
            gen = rngmod.generator(rngmod.fold_in(base, idx), self.device)
            self.params[name] = v.init_params(gen, torch.float32)
            self.state[name] = v.init_state()
        self._initialized = True
        return self

    def _ensure_init(self):
        if not self._initialized:
            self.init()

    # --------------------------------------------------------------- forward
    def _forward(self, params, state, inputs: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Walk the topological order; returns every vertex's activation."""
        acts: Dict[str, torch.Tensor] = dict(inputs)
        for name in self.conf.topological_order:
            acts[name], _ = self.conf.vertices[name].forward(
                params[name], state[name],
                [acts[i] for i in self.conf.vertex_inputs[name]])
        return acts

    def _to_device_dtype(self, a) -> torch.Tensor:
        """compute_dtype for floats; integer inputs (token ids) keep an
        integer dtype — casting ids through bf16 would corrupt every
        id >= 257."""
        t = torch.as_tensor(np.asarray(a)) if not torch.is_tensor(a) else a
        t = t.to(self.device)
        if t.dtype.is_floating_point:
            return t.to(self.compute_dtype)
        return t.long()

    def _inputs_dict(self, features) -> Dict[str, torch.Tensor]:
        names = self.conf.network_inputs
        if isinstance(features, dict):
            return {k: self._to_device_dtype(v) for k, v in features.items()}
        if isinstance(features, (list, tuple)):
            return {n: self._to_device_dtype(f)
                    for n, f in zip(names, features)}
        return {names[0]: self._to_device_dtype(features)}

    def _inference_state(self):
        """Per-vertex state for inference (empty for the transformer
        LM)."""
        return self.state

    def _cast_params(self, params):
        """Mixed precision: a compute-dtype copy of the f32 master
        params."""
        cd = self.compute_dtype
        if cd == torch.float32:
            return params
        return {v: {k: a.to(cd) for k, a in p.items()}
                for v, p in params.items()}

    @torch.no_grad()
    def output(self, *features) -> List[np.ndarray]:
        """Forward pass → list of output activations as float32 numpy
        arrays (one per network output)."""
        self._ensure_init()
        inputs = self._inputs_dict(features[0] if len(features) == 1
                                   else list(features))
        acts = self._forward(self._cast_params(self.params),
                             self._inference_state(), inputs)
        return [acts[o].float().cpu().numpy()
                for o in self.conf.network_outputs]

    def num_params(self) -> int:
        self._ensure_init()
        return sum(int(a.numel()) for p in self.params.values()
                   for a in p.values())
