"""Layer configuration base classes (the JAX package's
``nn/conf/layers/base.py``).

Each layer is one dataclass: its fields are the JSON-serialized surface,
identical to the JAX package's (same names, same order) so the two read
and write the same configuration, and its methods are plain functions on
tensors:

    set_n_in(input_type)                      nIn inference
    get_output_type(input_type) -> InputType  shape inference
    init_params(gen, dtype) -> params dict    seeded init on gen's device
    init_state() -> state dict
    forward(params, state, x, mask, train=, gen=) -> (y, new_state)

Parameters keep the JAX layout (``x @ W``, W of shape [n_in, n_out]), so
weights map across 1:1 without transposes. The training fields are
applied by ``ComputationGraph.fit_batch`` and ``MultiLayerNetwork``'s
train step: the updater and its
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
from ..input_type import InputType


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

    def set_n_in(self, it: InputType) -> None:
        pass

    def get_output_type(self, it: InputType) -> InputType:
        return it

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
        """Whether the training forward draws from the layer's generator
        (here: :meth:`maybe_dropout`'s retention probability is in (0,
        1))."""
        p = self.drop_out
        return p is not None and 0.0 < p < 1.0

    def maybe_dropout(self, x, *, train: bool, gen):
        """Inverted dropout: ``drop_out`` is the retention probability p;
        kept elements are scaled by 1/p. Draws from ``gen`` (on x's
        device); identity when not training, without a generator, or
        without a retention probability in (0, 1)."""
        p = self.drop_out
        if not train or gen is None or p is None or not 0.0 < p < 1.0:
            return x
        keep = torch.rand(x.shape, generator=gen, device=x.device) < p
        return torch.where(keep, x / p, torch.zeros_like(x))

    def _winit(self, gen, shape, fan_in, fan_out, dtype):
        return init_weights(gen, shape, fan_in, fan_out,
                            self.weight_init or "xavier", self.dist, dtype)

    def _binit(self, gen, shape, dtype):
        return torch.full(shape, float(self.bias_init or 0.0),
                          device=gen.device, dtype=dtype)


@dataclasses.dataclass
class FeedForwardLayerConf(LayerConf):
    """Layers with a dense [nIn → nOut] core."""
    n_in: int = 0
    n_out: int = 0

    def set_n_in(self, it: InputType) -> None:
        if not self.n_in:
            self.n_in = it.flat_size()

    def get_output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)


@dataclasses.dataclass
class BaseRecurrentLayerConf(FeedForwardLayerConf):
    """Recurrent layers: [N, T, nIn] → [N, T, nOut], with an (h, c) carry
    in their state."""

    def input_kind(self) -> str:
        return "rnn"

    def set_n_in(self, it: InputType) -> None:
        if not self.n_in:
            self.n_in = it.size

    def get_output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timesteps)
