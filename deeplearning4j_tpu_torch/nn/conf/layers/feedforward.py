"""Dense layers and output heads (the JAX package's
``nn/conf/layers/feedforward.py``): ``DenseLayer``, ``OutputLayer`` (a
dense projection plus activation, scored from its pre-activation) and
``RnnOutputLayer`` (the same per timestep on [N, T, F]).

A head scores through :meth:`OutputLayer.compute_score`, the JAX
package's ``compute_loss`` on one-hot (or real-valued) labels and any
ported loss. Integer class ids on a softmax + mcxent head take the fused
sparse cross-entropy instead (``kernels/fused_ce.py``), chosen by the
network. The other feed-forward layers of the JAX module (embedding,
autoencoder, RBM, center loss, ...) are not ported."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ....ops.losses import compute_loss
from ..input_type import InputType
from ..serde import register_config
from .base import FeedForwardLayerConf


def _affine(x, W, b):
    """x @ W + b in the promoted dtype of x and W (a bf16 input against f32
    master weights computes in f32, as JAX promotes)."""
    dt = torch.promote_types(x.dtype, W.dtype)
    return x.to(dt) @ W.to(dt) + b.to(dt)


@register_config
@dataclasses.dataclass
class DenseLayer(FeedForwardLayerConf):
    """Fully connected layer: activation(x·W + b)."""

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        return {"W": self._winit(gen, (self.n_in, self.n_out), self.n_in,
                                 self.n_out, dtype),
                "b": self._binit(gen, (self.n_out,), dtype)}

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        x = self.maybe_dropout(x, train=train, gen=gen)
        return self.activation_fn()(_affine(x, params["W"], params["b"])), \
            state


@register_config
@dataclasses.dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head: activation(x·W + b), scored from x·W + b."""
    loss: str = "mcxent"

    def compute_score(self, params, labels, preoutput, mask=None,
                      average: bool = True):
        return compute_loss(self.loss, labels, preoutput,
                            self.activation or "identity", mask, average)

    def preoutput(self, params, x):
        return _affine(x, params["W"], params["b"])


@register_config
@dataclasses.dataclass
class RnnOutputLayer(OutputLayer):
    """Output layer applied per timestep to [N, T, F] input; the loss
    honours the label mask for variable-length sequences."""

    def input_kind(self) -> str:
        return "rnn"

    def set_n_in(self, it: InputType) -> None:
        if not self.n_in:
            self.n_in = it.size

    def get_output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.n_out, it.timesteps)
