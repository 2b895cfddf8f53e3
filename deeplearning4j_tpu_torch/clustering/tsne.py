"""Exact t-SNE embedding: the JAX package's ``clustering/tsne.py`` in
PyTorch (reference plot/Tsne.java, the UI's word-vector view). The
perplexity calibration is the JAX package's host numpy; the O(N²)
gradient and the momentum / gain update run on ``device`` (``None``: the
CUDA card) as dense [N, N] algebra, for the N of a few thousand points a
view shows (``BarnesHutTsne`` takes larger N).

The embedding runs in numpy's dtype for its inputs, float64 (the initial
draw and P), as the JAX package's does where float64 is enabled (its
tests enable it); without it JAX would round to float32."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.platform import resolve_device
from ..ops.transfer import device_fetch


def _perplexity_search(D2: np.ndarray, perplexity: float,
                       tol: float = 1e-5, max_tries: int = 50) -> np.ndarray:
    """Per-point binary search for beta = 1/(2σ²) hitting the target
    perplexity (reference Tsne d2p / computeGaussianPerplexity)."""
    n = D2.shape[0]
    P = np.zeros((n, n))
    log_u = np.log(perplexity)
    for i in range(n):
        beta, beta_min, beta_max = 1.0, -np.inf, np.inf
        row = D2[i].copy()
        row[i] = np.inf
        for _ in range(max_tries):
            p = np.exp(-row * beta)
            sum_p = max(p.sum(), 1e-12)
            h = np.log(sum_p) + beta * np.sum(row[np.isfinite(row)] *
                                              p[np.isfinite(row)]) / sum_p
            diff = h - log_u
            if abs(diff) < tol:
                break
            if diff > 0:
                beta_min = beta
                beta = beta * 2 if beta_max == np.inf else \
                    (beta + beta_max) / 2
            else:
                beta_max = beta
                beta = beta / 2 if beta_min == -np.inf else \
                    (beta + beta_min) / 2
        P[i] = np.exp(-row * beta)
        P[i, i] = 0
        P[i] /= max(P[i].sum(), 1e-12)
    return P


def _tsne_terms(Y, P):
    """(gradient [N, d], Q) of the exact t-SNE objective: JAX's
    ``(diag(Σ_j PQ) − PQ) @ Y`` as ``Σ_j PQ · Y − PQ @ Y`` (no [N, N]
    diagonal matrix), the self terms zeroed in place."""
    sq = torch.sum(Y ** 2, 1)
    D2 = sq[:, None] - 2 * Y @ Y.T + sq[None, :]
    num = 1.0 / (1.0 + D2)
    num.fill_diagonal_(0.0)
    Q = num / torch.clamp(torch.sum(num), min=1e-12)
    PQ = (P - torch.clamp(Q, min=1e-12)) * num
    grad = 4.0 * (torch.sum(PQ, dim=1)[:, None] * Y - PQ @ Y)
    return grad, Q


def _tsne_grad(Y, P):
    """(gradient [N, d], KL divergence) of the exact t-SNE objective."""
    grad, Q = _tsne_terms(Y, P)
    kl = torch.sum(P * torch.log(torch.clamp(P, min=1e-12) /
                                 torch.clamp(Q, min=1e-12)))
    return grad, kl


class Tsne:
    """Builder-compatible t-SNE (reference BarnesHutTsne.Builder surface)."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, n_iter: int = 500,
                 early_exaggeration: float = 12.0, momentum: float = 0.8,
                 seed: int = 42, device=None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.early_exaggeration = early_exaggeration
        self.momentum = momentum
        self.seed = seed
        self.device = resolve_device(device)
        self.kl_divergence_: Optional[float] = None

    class Builder:
        def __init__(self):
            self._kw = {}

        def perplexity(self, p):
            self._kw["perplexity"] = float(p)
            return self

        def learning_rate(self, lr):
            self._kw["learning_rate"] = float(lr)
            return self

        def set_max_iter(self, n):
            self._kw["n_iter"] = int(n)
            return self

        def theta(self, t):
            return self   # BH approximation knob: exact impl ignores

        def device(self, d):
            self._kw["device"] = d
            return self

        def build(self) -> "Tsne":
            return Tsne(**self._kw)

    def calculate(self, X: np.ndarray) -> np.ndarray:
        """Embed rows of X → [N, n_components] (reference BarnesHutTsne.fit).
        Reads back the KL divergence and the embedding once each, at the
        end (``tsne.result``)."""
        X = np.asarray(X, np.float64)
        n = X.shape[0]
        D2 = np.sum(X ** 2, 1, keepdims=True) - 2 * X @ X.T + np.sum(X ** 2, 1)
        P = _perplexity_search(D2, min(self.perplexity, (n - 1) / 3.0))
        P = (P + P.T) / (2.0 * n)
        P = np.maximum(P, 1e-12)

        rng = np.random.default_rng(self.seed)
        Y = torch.from_numpy(rng.normal(0, 1e-4, (n, self.n_components))).to(
            self.device)
        Pt = torch.from_numpy(P).to(self.device)
        vel = torch.zeros_like(Y)
        gains = torch.ones_like(Y)
        exag_until = min(100, self.n_iter // 4)
        kl = None
        for it in range(self.n_iter):
            Puse = Pt * self.early_exaggeration if it < exag_until else Pt
            if it == self.n_iter - 1:        # the KL is read only at the end
                grad, kl = _tsne_grad(Y, Puse)
            else:
                grad, _ = _tsne_terms(Y, Puse)
            gains = torch.where(torch.sign(grad) != torch.sign(vel),
                                gains + 0.2, gains * 0.8)
            gains = torch.clamp(gains, min=0.01)
            mom = 0.5 if it < 20 else self.momentum
            vel = mom * vel - self.learning_rate * gains * grad
            Y = Y + vel
            Y = Y - torch.mean(Y, dim=0)[None, :]
        self.kl_divergence_ = float(device_fetch(kl, "tsne.result"))
        return device_fetch(Y, "tsne.result")

    fit_transform = calculate
