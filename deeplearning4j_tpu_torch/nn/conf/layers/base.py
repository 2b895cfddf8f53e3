"""Layer configuration base classes (the JAX package's
``nn/conf/layers/base.py``).

Each layer is one dataclass: its fields are the JSON-serialized surface,
identical to the JAX package's (same names, same order) so the two read
and write the same configuration, and its methods are plain functions on
tensors:

    init_params(gen, dtype) -> params dict    seeded init on gen's device
    init_state() -> state dict
    forward(params, state, x, mask) -> (y, new_state)

Parameters keep the JAX layout (``x @ W``, W of shape [n_in, n_out]), so
weights map across 1:1 without transposes. Inference only: the training
fields (updater, dropout, regularization, ...) are carried for the JSON
but not applied."""

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

    def init_params(self, gen: torch.Generator,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
        return {}

    def init_state(self) -> Dict:
        return {}

    def forward(self, params, state, x, mask=None):
        raise NotImplementedError

    def activation_fn(self):
        return get_activation(self.activation or "identity")

    def _winit(self, gen, shape, fan_in, fan_out, dtype):
        return init_weights(gen, shape, fan_in, fan_out,
                            self.weight_init or "xavier", dtype)


@dataclasses.dataclass
class FeedForwardLayerConf(LayerConf):
    """Layers with a dense [nIn → nOut] core."""
    n_in: int = 0
    n_out: int = 0
