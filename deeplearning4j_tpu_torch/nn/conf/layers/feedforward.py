"""Output heads (the JAX package's ``nn/conf/layers/feedforward.py``):
``OutputLayer``, a dense projection plus activation whose loss the graph
computes from the pre-activation, and ``RnnOutputLayer``, the same applied
per timestep to [N, T, F] input.

Only the loss the transformer LM trains with is ported: integer class ids
on a terminal softmax + mcxent head, which ``ComputationGraph`` computes as
one fused sparse cross-entropy (``kernels/fused_ce.py``). The materialized
one-hot ``compute_loss`` is not ported."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..serde import register_config
from .base import FeedForwardLayerConf


@register_config
@dataclasses.dataclass
class OutputLayer(FeedForwardLayerConf):
    """Dense + loss head: activation(x·W + b)."""
    loss: str = "mcxent"

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        return {"W": self._winit(gen, (self.n_in, self.n_out), self.n_in,
                                 self.n_out, dtype),
                "b": torch.full((self.n_out,), float(self.bias_init or 0.0),
                                device=gen.device, dtype=dtype)}

    def preoutput(self, params, x):
        return x @ params["W"] + params["b"]

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        x = self.maybe_dropout(x, train=train, gen=gen)
        return self.activation_fn()(self.preoutput(params, x)), state


@register_config
@dataclasses.dataclass
class RnnOutputLayer(OutputLayer):
    """Output layer applied per timestep to [N, T, F] input."""

    def input_kind(self) -> str:
        return "rnn"
