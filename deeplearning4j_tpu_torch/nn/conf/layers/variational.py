"""Variational autoencoder layer (the JAX package's
``nn/conf/layers/variational.py``).

Unsupervised pretraining minimizes the negative ELBO with the
reparameterization trick (ε drawn from an explicit generator; without one
ε is 0, so z = μ). In a supervised stack the layer's forward pass outputs
the mean of q(z|x), the encoder as a feature extractor. Reconstruction
distributions: gaussian (diagonal) and bernoulli."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

from ....ops.activations import get_activation
from ..serde import register_config
from .base import FeedForwardLayerConf
from .feedforward import _affine


@register_config
@dataclasses.dataclass
class VariationalAutoencoder(FeedForwardLayerConf):
    encoder_layer_sizes: List[int] = dataclasses.field(
        default_factory=lambda: [256])
    decoder_layer_sizes: List[int] = dataclasses.field(
        default_factory=lambda: [256])
    pzx_activation: str = "identity"
    reconstruction_distribution: str = "bernoulli"   # bernoulli | gaussian
    num_samples: int = 1

    def _out_dim(self) -> int:
        return self.n_in * (2 if self.reconstruction_distribution ==
                            "gaussian" else 1)

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        """Encoder ``eW{i}`` / ``eb{i}``, the q(z|x) heads ``muW`` / ``mub``
        and ``lvW`` / ``lvb``, decoder ``dW{i}`` / ``db{i}`` and the
        reconstruction head ``oW`` / ``ob`` (twice n_in wide for a gaussian:
        mean and log-variance)."""
        zeros = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)
        params = {}
        last = self.n_in
        for i, size in enumerate(self.encoder_layer_sizes):
            params[f"eW{i}"] = self._winit(gen, (last, size), last, size,
                                           dtype)
            params[f"eb{i}"] = zeros(size)
            last = size
        for head in ("mu", "lv"):
            params[f"{head}W"] = self._winit(gen, (last, self.n_out), last,
                                             self.n_out, dtype)
            params[f"{head}b"] = zeros(self.n_out)
        last = self.n_out
        for i, size in enumerate(self.decoder_layer_sizes):
            params[f"dW{i}"] = self._winit(gen, (last, size), last, size,
                                           dtype)
            params[f"db{i}"] = zeros(size)
            last = size
        out = self._out_dim()
        params["oW"] = self._winit(gen, (last, out), last, out, dtype)
        params["ob"] = zeros(out)
        return params

    def regularizable(self):
        return ("muW", "lvW", "oW") + \
            tuple(f"eW{i}" for i in range(len(self.encoder_layer_sizes))) + \
            tuple(f"dW{i}" for i in range(len(self.decoder_layer_sizes)))

    def _encode(self, params, x):
        """(μ, log σ²) of q(z|x)."""
        act = self.activation_fn()
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = act(_affine(h, params[f"eW{i}"], params[f"eb{i}"]))
        mu = get_activation(self.pzx_activation)(
            _affine(h, params["muW"], params["mub"]))
        return mu, _affine(h, params["lvW"], params["lvb"])

    def _decode(self, params, z):
        """The reconstruction head's pre-activation."""
        act = self.activation_fn()
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = act(_affine(h, params[f"dW{i}"], params[f"db{i}"]))
        return _affine(h, params["oW"], params["ob"])

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        mu, _ = self._encode(params, x)
        return mu, state

    def reconstruct(self, params, x):
        """The reconstruction of ``x`` through z = μ: the gaussian mean, or
        the bernoulli probabilities."""
        mu, _ = self._encode(params, x)
        out = self._decode(params, mu)
        if self.reconstruction_distribution == "gaussian":
            return out[:, :self.n_in]
        return torch.sigmoid(out)

    def _elbo(self, params, x, eps_samples):
        """Negative ELBO averaged over the batch, for the given ε draws
        (one [N, n_out] tensor per sample)."""
        mu, logvar = self._encode(params, x)
        x = x.to(mu.dtype)
        total = 0.0
        for eps in eps_samples:
            out = self._decode(params, mu + torch.exp(0.5 * logvar) * eps)
            if self.reconstruction_distribution == "gaussian":
                rmu, rlogvar = out[:, :self.n_in], out[:, self.n_in:]
                nll = 0.5 * (rlogvar + (x - rmu) ** 2 / torch.exp(rlogvar)
                             + math.log(2 * math.pi)).sum(dim=-1)
            else:                                   # logits
                nll = (out.clamp_min(0) - out * x +
                       torch.log1p(torch.exp(-out.abs()))).sum(dim=-1)
            total = total + nll.mean()
        recon = total / len(eps_samples)
        kl = -0.5 * (1 + logvar - mu ** 2 - torch.exp(logvar)) \
            .sum(dim=-1).mean()
        return recon + kl

    def pretrain_loss(self, params, x, gen):
        """Negative ELBO over ``num_samples`` ε draws from ``gen`` (ε = 0
        without one)."""
        shape = (x.shape[0], self.n_out)
        dt = torch.promote_types(x.dtype, params["muW"].dtype)
        eps = [torch.randn(shape, generator=gen, device=x.device,
                           dtype=dt) if gen is not None else
               torch.zeros(shape, device=x.device, dtype=dt)
               for _ in range(self.num_samples)]
        return self._elbo(params, x, eps)
