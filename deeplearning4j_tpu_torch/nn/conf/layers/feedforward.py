"""The feed-forward layer family (the JAX package's
``nn/conf/layers/feedforward.py``): ``DenseLayer``, ``OutputLayer`` (a
dense projection plus activation, scored from its pre-activation),
``RnnOutputLayer`` (the same per timestep on [N, T, F]), ``LossLayer``,
the parameterless ``ActivationLayer`` and ``DropoutLayer``,
``EmbeddingLayer``, the pretrainable ``AutoEncoder`` and ``RBM``, and
``CenterLossOutputLayer``.

A head scores through :meth:`OutputLayer.compute_score`, the JAX
package's ``compute_loss`` on one-hot (or real-valued) labels and any
ported loss. Integer class ids on a softmax + mcxent head take the fused
sparse cross-entropy instead (``kernels/fused_ce.py``), chosen by the
network.

Noise (dropout masks, the autoencoder's input corruption, the RBM's
hidden samples) is drawn from an explicit ``torch.Generator``; its bits
differ from the JAX package's threefry draws, and a seed gives the same
draws on every run."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ....ops.losses import compute_loss, get_loss, loss_terms
from ..input_type import InputType
from ..serde import register_config
from .base import FeedForwardLayerConf, LayerConf


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

    def compute_score_terms(self, params, labels, preoutput, mask=None):
        """(summed score, its denominator unclamped): ops/losses.py's
        ``loss_terms``."""
        return loss_terms(self.loss, labels, preoutput,
                          self.activation or "identity", mask)

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


@register_config
@dataclasses.dataclass
class ActivationLayer(LayerConf):
    """Parameterless activation on input of any kind."""

    def input_kind(self) -> str:
        return "any"

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        return self.activation_fn()(x), state


@register_config
@dataclasses.dataclass
class LossLayer(LayerConf):
    """A loss head without parameters: its input is the pre-activation."""
    loss: str = "mse"

    def input_kind(self) -> str:
        return "any"

    def compute_score(self, params, labels, preoutput, mask=None,
                      average: bool = True):
        return compute_loss(self.loss, labels, preoutput,
                            self.activation or "identity", mask, average)

    def compute_score_terms(self, params, labels, preoutput, mask=None):
        return loss_terms(self.loss, labels, preoutput,
                          self.activation or "identity", mask)

    def preoutput(self, params, x):
        return x

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        return self.activation_fn()(x), state


@register_config
@dataclasses.dataclass
class DropoutLayer(LayerConf):
    """Dropout as a layer of its own; ``drop_out`` is the retention
    probability."""

    def input_kind(self) -> str:
        return "any"

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        return self.maybe_dropout(x, train=train, gen=gen), state


@register_config
@dataclasses.dataclass
class EmbeddingLayer(FeedForwardLayerConf):
    """Index → vector lookup: the input is integer ids [N] / [N, 1] or
    one-hot rows [N, n_in]; a gather, not a matmul."""

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        return {"W": self._winit(gen, (self.n_in, self.n_out), self.n_in,
                                 self.n_out, dtype),
                "b": self._binit(gen, (self.n_out,), dtype)}

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        W = params["W"]
        if x.dim() >= 2 and x.shape[-1] == self.n_in:
            ids = x.argmax(dim=-1)                  # one-hot input
        else:
            ids = x.long().reshape(x.shape[0])
        return self.activation_fn()(W[ids] + params["b"].to(W.dtype)), \
            state


@register_config
@dataclasses.dataclass
class AutoEncoder(FeedForwardLayerConf):
    """Denoising autoencoder with tied weights: encode act(x·W + b),
    decode act(h·Wᵀ + vb); :meth:`pretrain_loss` is the reconstruction
    loss of a corrupted input (each input kept with probability
    1 − ``corruption_level``)."""
    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss: str = "mse"

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        return {"W": self._winit(gen, (self.n_in, self.n_out), self.n_in,
                                 self.n_out, dtype),
                "b": self._binit(gen, (self.n_out,), dtype),
                "vb": torch.zeros((self.n_in,), dtype=dtype,
                                  device=gen.device)}

    def encode(self, params, x):
        return self.activation_fn()(_affine(x, params["W"], params["b"]))

    def decode(self, params, h):
        return self.activation_fn()(_affine(h, params["W"].t(),
                                            params["vb"]))

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        return self.encode(params, x), state

    def pretrain_loss(self, params, x, gen):
        """Mean reconstruction loss; the corruption is drawn from ``gen``
        (none without one)."""
        corrupted = x
        if self.corruption_level > 0 and gen is not None:
            keep = torch.rand(x.shape, generator=gen, device=x.device) < \
                1.0 - self.corruption_level
            corrupted = x * keep
        h = self.encode(params, corrupted)
        recon_pre = _affine(h, params["W"].t(), params["vb"])
        per = get_loss(self.loss)(x.to(recon_pre.dtype), recon_pre,
                                  self.activation or "sigmoid")
        return per.mean()


@register_config
@dataclasses.dataclass
class RBM(FeedForwardLayerConf):
    """Restricted Boltzmann machine: forward is act(v·W + b);
    :meth:`cd_gradient` is one CD-k step's gradients, and
    :meth:`pretrain_loss` the reconstruction cross-entropy (squared error
    for gaussian visible units), which ``pretrain`` differentiates, as the
    JAX package's does."""
    visible_unit: str = "binary"    # binary | gaussian
    hidden_unit: str = "binary"
    k: int = 1

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        return {"W": self._winit(gen, (self.n_in, self.n_out), self.n_in,
                                 self.n_out, dtype),
                "b": self._binit(gen, (self.n_out,), dtype),
                "vb": torch.zeros((self.n_in,), dtype=dtype,
                                  device=gen.device)}

    def propup(self, params, v):
        return torch.sigmoid(_affine(v, params["W"], params["b"]))

    def propdown(self, params, h):
        pre = _affine(h, params["W"].t(), params["vb"])
        return pre if self.visible_unit == "gaussian" else torch.sigmoid(pre)

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        return self.activation_fn()(_affine(x, params["W"], params["b"])), \
            state

    def cd_gradient(self, params, v0, gen):
        """One CD-k step → {W, b, vb} gradients for the updater; binary
        hidden units are sampled from ``gen``."""
        h0 = self.propup(params, v0)
        hs, vk = h0, v0
        for _ in range(self.k):
            if self.hidden_unit == "binary":
                hs = (torch.rand(hs.shape, generator=gen,
                                 device=hs.device) < hs).to(v0.dtype)
            vk = self.propdown(params, hs)
            hs = self.propup(params, vk)
        n = v0.shape[0]
        return {"W": -(v0.t() @ h0 - vk.t() @ hs) / n,
                "b": -(h0 - hs).mean(dim=0),
                "vb": -(v0 - vk).mean(dim=0)}

    def pretrain_loss(self, params, x, gen):
        recon = self.propdown(params, self.propup(params, x))
        x = x.to(recon.dtype)
        if self.visible_unit == "gaussian":
            return ((x - recon) ** 2).mean()
        r = recon.clamp(1e-7, 1 - 1e-7)
        return -(x * torch.log(r) + (1 - x) * torch.log(1 - r)).mean()


@register_config
@dataclasses.dataclass
class CenterLossOutputLayer(OutputLayer):
    """Output layer with center loss: the network adds
    (lambda/2)·mean‖f − c_y‖² to the head's loss, f being the head's
    input. The class centers live in layer *state* and move by ``alpha``
    towards each batch's class means; they are not trained by gradient."""
    alpha: float = 0.05
    lambda_: float = 2e-4

    def init_state(self) -> Dict:
        return {"centers": torch.zeros((self.n_out, self.n_in),
                                       dtype=torch.float32)}

    def center_loss_and_update(self, state, features, labels):
        """(center loss, {"centers": the moved centers}) for a batch of
        head inputs ``features`` [N, n_in] and one-hot ``labels``."""
        centers = state["centers"]
        dt = torch.promote_types(features.dtype, centers.dtype)
        features, labels = features.to(dt), labels.to(dt)
        c_y = centers.to(dt)[labels.argmax(dim=-1)]           # [N, n_in]
        diff = features - c_y
        loss = 0.5 * self.lambda_ * (diff * diff).sum(dim=-1).mean()
        counts = labels.sum(dim=0).clamp_min(1.0)             # [n_out]
        sums = labels.t() @ diff                              # [n_out, n_in]
        new_centers = centers + self.alpha * (sums / counts[:, None]) \
            .detach().to(centers.dtype)
        return loss, {"centers": new_centers}
