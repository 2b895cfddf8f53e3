"""The vocabulary head (the JAX package's ``nn/conf/layers/feedforward.py``
``RnnOutputLayer``): a per-timestep dense projection plus activation.
Losses are training-side and not ported."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..serde import register_config
from .base import FeedForwardLayerConf


@register_config
@dataclasses.dataclass
class RnnOutputLayer(FeedForwardLayerConf):
    """Output layer applied per timestep to [N, T, F] input:
    activation(x·W + b)."""
    loss: str = "mcxent"

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        return {"W": self._winit(gen, (self.n_in, self.n_out), self.n_in,
                                 self.n_out, dtype),
                "b": torch.full((self.n_out,), float(self.bias_init or 0.0),
                                device=gen.device, dtype=dtype)}

    def preoutput(self, params, x):
        return x @ params["W"] + params["b"]

    def forward(self, params, state, x, mask=None):
        return self.activation_fn()(self.preoutput(params, x)), state
