"""Scalable Barnes-Hut t-SNE: the JAX package's ``clustering/bhtsne.py``
in PyTorch (reference plot/BarnesHutTsne.java, the UI's word-vector view
for real vocabularies). The same factorization on ``device`` (``None``:
the CUDA card):

- input similarities: exact kNN by chunked [chunk, N] distance matmuls,
  then the JAX package's vectorized per-row beta search (host numpy) on
  the [N, k] neighbour distances, symmetrized into a directed edge list;
- attraction: the edge list's forces summed per source row by
  ``kernels/segment_update.py::segment_update`` (a zero table, zero
  weights and lr 1 make it a segment sum): on the card the hand-written
  ``csrc/segment_update.cu``, which sums every row in a fixed order, so a
  seeded run repeats bitwise (the library's float sums are atomics);
- repulsion up to ``exact_threshold`` points: exact, in [chunk, N]
  blocks; above it the unbiased negative-sampling estimator (S uniform
  non-self samples a point, scaled by (N − 1) / S), its draws from a
  generator on the device seeded from (seed, iteration).

No [N, N] matrix is ever materialized."""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.segment_update import segment_update
from ..ops.platform import resolve_device
from ..ops.rng import fold_in, generator
from ..ops.transfer import device_fetch


def _smallest(d2, k1: int):
    """(indices, values) of each row's ``k1`` smallest values, ascending,
    equal values in index order (the lowest indices win a tie at the
    boundary too): ``jax.lax.top_k``'s order on ``-d2``, which
    ``torch.topk`` does not promise."""
    neg = -d2
    edge = torch.topk(neg, k1, dim=1).values[:, -1:]
    above = neg > edge
    tie = neg == edge
    need = k1 - torch.sum(above, dim=1, keepdim=True)
    keep = above | (tie & (torch.cumsum(tie, dim=1) <= need))
    cols = torch.nonzero(keep)[:, 1].reshape(-1, k1)
    vals = torch.gather(neg, 1, cols)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return torch.gather(cols, 1, order), -torch.gather(vals, 1, order)


def _knn_chunked(X: np.ndarray, k: int, chunk: int = 4096, device="cpu"):
    """Exact kNN (indices [N,k], sq-distances [N,k]) via blocked matmuls
    on ``device``; read back once each (``bhtsne.knn``)."""
    X = np.asarray(X, np.float32)
    n = X.shape[0]
    sq = (X * X).sum(1)
    Xt = torch.from_numpy(X).to(device)
    sqt = torch.from_numpy(sq).to(device)
    idxs, d2s = [], []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d2 = sqt[s:e, None] + sqt[None, :] - 2.0 * (Xt[s:e] @ Xt.T)
        # top-(k+1) smallest (self included), then self is dropped below
        idx, d2 = _smallest(d2, k + 1)
        idxs.append(idx)
        d2s.append(d2)
    idx = device_fetch(torch.cat(idxs), "bhtsne.knn")
    d2 = device_fetch(torch.cat(d2s), "bhtsne.knn")
    # drop self (first occurrence of own index per row; fall back to col 0)
    rows = np.arange(n)
    self_pos = np.argmax(idx == rows[:, None], axis=1)
    keep = np.ones((n, k + 1), bool)
    keep[rows, self_pos] = False
    idx = idx[keep].reshape(n, k)
    d2 = np.maximum(d2[keep].reshape(n, k), 0.0)
    return idx, d2


def _beta_search(d2: np.ndarray, perplexity: float, iters: int = 50):
    """Vectorized per-row binary search for beta hitting the perplexity on
    the kNN distances (reference computeGaussianPerplexity)."""
    n = d2.shape[0]
    beta = np.ones(n)
    lo = np.full(n, -np.inf)
    hi = np.full(n, np.inf)
    log_u = np.log(perplexity)
    for _ in range(iters):
        p = np.exp(-d2 * beta[:, None])
        sum_p = np.maximum(p.sum(1), 1e-12)
        h = np.log(sum_p) + beta * (d2 * p).sum(1) / sum_p
        diff = h - log_u
        too_high = diff > 0
        lo = np.where(too_high, beta, lo)
        hi = np.where(too_high, hi, beta)
        beta = np.where(too_high,
                        np.where(np.isinf(hi), beta * 2, (beta + hi) / 2),
                        np.where(np.isinf(lo), beta / 2, (beta + lo) / 2))
    p = np.exp(-d2 * beta[:, None])
    p /= np.maximum(p.sum(1, keepdims=True), 1e-12)
    return p


def _apply_update(Y, vel, gains, grad, momentum, lr):
    gains = torch.where(torch.sign(grad) != torch.sign(vel),
                        gains + 0.2, gains * 0.8)
    gains = torch.clamp(gains, min=0.01)
    vel = momentum * vel - lr * gains * grad
    Y = Y + vel
    return Y - torch.mean(Y, dim=0)[None, :], vel, gains


def _attraction(Y, src, dst, w, exaggeration):
    """Σ over the edges leaving each row of w·exaggeration·q·(y_src −
    y_dst): ``jax.ops.segment_sum`` as a segment update of a zero table
    (zero weights divide by sqrt(max(0, 1)) = 1, lr 1)."""
    diff = Y[src] - Y[dst]
    q = 1.0 / (1.0 + torch.sum(diff * diff, dim=1))
    table = torch.zeros_like(Y)
    return segment_update(table, src, (w * exaggeration * q)[:, None] * diff,
                          torch.zeros_like(w), 1.0, False)


def _iteration_exact(Y, vel, gains, src, dst, w, momentum, lr, exaggeration,
                     chunk=2048):
    """One t-SNE update: sparse attractive forces + EXACT repulsion computed
    in [chunk, N] blocks (never materializes the full [N, N] matrix)."""
    n = Y.shape[0]
    attr = _attraction(Y, src, dst, w, exaggeration)

    sq = torch.sum(Y * Y, dim=1)
    pad = (-n) % chunk
    Yp = F.pad(Y, (0, 0, 0, pad))
    sqp = F.pad(sq, (0, pad))
    negs, sum_qs = [], []
    for s in range(0, n + pad, chunk):
        yb, sqb = Yp[s:s + chunk], sqp[s:s + chunk]
        d2 = torch.clamp(sqb[:, None] + sq[None, :] - 2.0 * (yb @ Y.T),
                         min=0.0)
        qb = 1.0 / (1.0 + d2)
        sum_qs.append(torch.sum(qb, dim=1) - 1.0)    # minus the self term
        q2 = qb * qb
        # Σ_j q² (y_i − y_j) = (Σ_j q²) y_i − q² @ Y
        negs.append(torch.sum(q2, dim=1)[:, None] * yb - q2 @ Y)
    neg = torch.cat(negs)[:n]
    Z = torch.clamp(torch.sum(torch.cat(sum_qs)[:n]), min=1e-12)
    grad = 4.0 * (attr - neg / Z)
    return _apply_update(Y, vel, gains, grad, momentum, lr)


def _iteration_ns_given(Y, vel, gains, src, dst, w, idx, momentum, lr,
                        exaggeration):
    """One t-SNE update at 100k+ scale on the raw draws ``idx`` [N, S]
    (uniform over 0..N−2): sparse attractive forces + the unbiased
    negative-sampling estimate of the repulsive term, each draw at or
    past its own row shifted by one (uniform over j != i)."""
    n = Y.shape[0]
    attr = _attraction(Y, src, dst, w, exaggeration)

    S = int(idx.shape[1])
    rows = torch.arange(n, device=Y.device)[:, None]
    idx = torch.where(idx >= rows, idx + 1, idx)
    d = Y[:, None, :] - Y[idx]                       # [N, S, 2]
    d2 = torch.sum(d * d, dim=2)
    qn = 1.0 / (1.0 + d2)
    scale = (n - 1) / S
    Z = torch.clamp(scale * torch.sum(qn), min=1e-12)
    neg = scale * torch.sum((qn * qn)[:, :, None] * d, dim=1)
    grad = 4.0 * (attr - neg / Z)
    return _apply_update(Y, vel, gains, grad, momentum, lr)


def _iteration_ns(Y, vel, gains, src, dst, w, gen, n_samples, momentum, lr,
                  exaggeration):
    """:func:`_iteration_ns_given` on ``n_samples`` draws a row from
    ``gen`` (a generator on Y's device)."""
    n = Y.shape[0]
    idx = torch.randint(0, n - 1, (n, int(n_samples)), generator=gen,
                        device=Y.device)
    return _iteration_ns_given(Y, vel, gains, src, dst, w, idx, momentum,
                               lr, exaggeration)


class BarnesHutTsne:
    """Reference-named entry point (plot/BarnesHutTsne.java): builder-style
    hyperparameters, ``calculate(X)`` / ``fit(X)`` → [N, 2] embedding.

    Exact blocked repulsion up to ``exact_threshold`` points; above it,
    the negative-sampling estimator with ``negative_samples`` per point,
    the draws of iteration ``it`` from a generator seeded with
    ``fold_in(seed, it)``. ``device`` (``None``: the CUDA card) holds the
    whole iteration; the embedding is read back once, at the end."""

    def __init__(self, perplexity: float = 30.0, theta: float = 0.5,
                 learning_rate: float = 200.0, n_iter: int = 1000,
                 exaggeration: float = 12.0, stop_lying_iteration: int = 250,
                 momentum: float = 0.5, final_momentum: float = 0.8,
                 switch_momentum_iteration: int = 250,
                 exact_threshold: int = 8192, negative_samples: int = 64,
                 seed: int = 42, device=None):
        self.perplexity = float(perplexity)
        self.theta = float(theta)          # API parity with the reference
        self.learning_rate = float(learning_rate)
        self.n_iter = int(n_iter)
        self.exaggeration = float(exaggeration)
        self.stop_lying_iteration = int(stop_lying_iteration)
        self.momentum = float(momentum)
        self.final_momentum = float(final_momentum)
        self.switch_momentum_iteration = int(switch_momentum_iteration)
        self.exact_threshold = int(exact_threshold)
        self.negative_samples = int(negative_samples)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.timings_: dict = {}
        self.edges_ = None

    class Builder:
        def __init__(self):
            self._kw = {}

        def perplexity(self, p):
            self._kw["perplexity"] = p
            return self

        def theta(self, t):
            self._kw["theta"] = t
            return self

        def learning_rate(self, lr):
            self._kw["learning_rate"] = lr
            return self

        def set_max_iter(self, n):
            self._kw["n_iter"] = n
            return self

        def device(self, d):
            self._kw["device"] = d
            return self

        def build(self) -> "BarnesHutTsne":
            return BarnesHutTsne(**self._kw)

    def _edges(self, X: np.ndarray):
        """The symmetrized directed edge list (src, dst, w) on the device:
        (i→j, p/2N) ∪ (j→i, p/2N) over each row's k = 3·perplexity
        nearest neighbours."""
        X = np.asarray(X, np.float32)
        n = X.shape[0]
        k = int(min(max(3 * self.perplexity, 3), n - 1))
        idx, d2 = _knn_chunked(X, k, device=self.device)
        p = _beta_search(d2, min(self.perplexity, max(k / 3.0, 2.0)))
        rows = np.repeat(np.arange(n), k)
        cols = idx.reshape(-1)
        vals = (p.reshape(-1) / (2.0 * n)).astype(np.float32)
        to = lambda a: torch.from_numpy(a).to(self.device)
        return (to(np.concatenate([rows, cols]).astype(np.int64)),
                to(np.concatenate([cols, rows]).astype(np.int64)),
                to(np.concatenate([vals, vals])))

    def calculate(self, X: np.ndarray,
                  n_iter: Optional[int] = None) -> np.ndarray:
        """Embed rows of X → [N, 2]. ``timings_`` holds the seconds of
        the input similarities (kNN and beta search, ending in their
        readback) and of the iterations (ending in the embedding's);
        ``edges_`` the directed edge list (src, dst, w) on the device."""
        X = np.asarray(X, np.float32)
        n = X.shape[0]
        n_iter = self.n_iter if n_iter is None else int(n_iter)
        t0 = time.perf_counter()
        src, dst, w = self.edges_ = self._edges(X)
        t1 = time.perf_counter()

        rng = np.random.default_rng(self.seed)
        Y = torch.from_numpy(rng.normal(0, 1e-4, (n, 2)).astype(
            np.float32)).to(self.device)
        vel = torch.zeros_like(Y)
        gains = torch.ones_like(Y)
        exact = n <= self.exact_threshold
        for it in range(n_iter):
            momentum = self.momentum if it < self.switch_momentum_iteration \
                else self.final_momentum
            ex = self.exaggeration if it < self.stop_lying_iteration else 1.0
            if exact:
                Y, vel, gains = _iteration_exact(Y, vel, gains, src, dst, w,
                                                 momentum,
                                                 self.learning_rate, ex)
            else:
                gen = generator(fold_in(self.seed, it), self.device)
                Y, vel, gains = _iteration_ns(Y, vel, gains, src, dst, w,
                                              gen, self.negative_samples,
                                              momentum,
                                              self.learning_rate, ex)
        Y = device_fetch(Y, "bhtsne.result")
        self.timings_ = {"similarities_s": t1 - t0,
                         "iterations_s": time.perf_counter() - t1}
        return Y

    fit = calculate
