"""Layer configuration base classes (the JAX package's
``nn/conf/layers/base.py``).

Each layer is one dataclass: its fields are the JSON-serialized surface,
identical to the JAX package's (same names, same order) so the two read
and write the same configuration, and its methods are plain functions on
tensors:

    init_params(gen, dtype) -> params dict    seeded init on gen's device
    init_state() -> state dict
    forward(params, state, x, mask, train=, gen=) -> (y, new_state)

Parameters keep the JAX layout (``x @ W``, W of shape [n_in, n_out]), so
weights map across 1:1 without transposes. The training fields are
applied by ``ComputationGraph.fit_batch``: the updater and its
hyperparameters, the learning rate (with the configuration's lr policy),
the l1/l2 penalty on :meth:`LayerConf.regularizable` parameters, dropout
(:meth:`LayerConf.maybe_dropout`, from an explicit generator) and the
gradient normalization."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ....ops.activations import get_activation
from ....ops.weight_init import init_weights


@dataclasses.dataclass
class LayerConf:
    """Common per-layer hyperparameters. ``None`` means "inherit from the
    global NeuralNetConfiguration builder"."""
    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    dist: Optional[dict] = None
    bias_init: Optional[float] = None
    learning_rate: Optional[float] = None
    bias_learning_rate: Optional[float] = None
    updater: Optional[str] = None
    momentum: Optional[float] = None
    rho: Optional[float] = None
    rms_decay: Optional[float] = None
    adam_mean_decay: Optional[float] = None
    adam_var_decay: Optional[float] = None
    epsilon: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    drop_out: Optional[float] = None          # retention probability
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None

    def input_kind(self) -> str:
        return "ff"

    def init_params(self, gen: torch.Generator,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
        return {}

    def init_state(self) -> Dict:
        return {}

    def regularizable(self):
        """Param names the l1/l2 penalty applies to (weights, not
        biases)."""
        return ("W", "R")

    def reg_penalty(self, params: Dict):
        """l1·Σ|w| + ½·l2·Σw² over :meth:`regularizable` params (0.0 when
        both are off)."""
        l1, l2 = self.l1 or 0.0, self.l2 or 0.0
        pen = 0.0
        if l1 == 0.0 and l2 == 0.0:
            return pen
        for name in self.regularizable():
            if name in params:
                w = params[name]
                if l1:
                    pen = pen + l1 * w.abs().sum()
                if l2:
                    pen = pen + 0.5 * l2 * (w * w).sum()
        return pen

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        raise NotImplementedError

    def activation_fn(self):
        return get_activation(self.activation or "identity")

    def uses_dropout(self) -> bool:
        """Whether :meth:`maybe_dropout` draws anything when training."""
        p = self.drop_out
        return p is not None and 0.0 < p < 1.0

    def maybe_dropout(self, x, *, train: bool, gen):
        """Inverted dropout: ``drop_out`` is the retention probability p;
        kept elements are scaled by 1/p. Draws from ``gen`` (on x's
        device); identity when not training or without a generator."""
        if not train or gen is None or not self.uses_dropout():
            return x
        p = self.drop_out
        keep = torch.rand(x.shape, generator=gen, device=x.device) < p
        return torch.where(keep, x / p, torch.zeros_like(x))

    def _winit(self, gen, shape, fan_in, fan_out, dtype):
        return init_weights(gen, shape, fan_in, fan_out,
                            self.weight_init or "xavier", dtype)


@dataclasses.dataclass
class FeedForwardLayerConf(LayerConf):
    """Layers with a dense [nIn → nOut] core."""
    n_in: int = 0
    n_out: int = 0
