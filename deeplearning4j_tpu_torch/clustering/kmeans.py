"""K-means clustering: the JAX package's ``clustering/kmeans.py`` in
PyTorch (reference clustering/kmeans/KMeansClustering.java). Lloyd's
algorithm with k-means++ seeding: the seeding is the JAX package's host
numpy (the same draws, so the same initial centres), each assignment /
update iteration runs on ``device`` (``None``: the CUDA card) as two
matmuls and an argmin, and the cost is read back once an iteration for
the stopping rule."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.platform import resolve_device
from ..ops.transfer import device_fetch


def _lloyd_step(points, centers, k: int):
    """One Lloyd iteration: (new centres [k, D], assignments [N], cost).
    ``torch.argmin`` takes the first minimum, as ``jnp.argmin`` does; a
    centre with no point keeps its place."""
    d2 = torch.sum(points ** 2, 1, keepdim=True) - \
        2 * points @ centers.T + torch.sum(centers ** 2, 1)[None, :]
    assign = torch.argmin(d2, dim=1)
    onehot = F.one_hot(assign, k).to(points.dtype)             # [N, k]
    counts = torch.sum(onehot, dim=0)
    sums = onehot.T @ points
    new_centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1.0),
                              centers)
    cost = torch.sum(torch.min(d2, dim=1).values)
    return new_centers, assign, cost


class KMeansClustering:
    def __init__(self, k: int, max_iterations: int = 100, tol: float = 1e-6,
                 seed: int = 0, device=None):
        self.k = int(k)
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.device = resolve_device(device)
        self.centers: Optional[np.ndarray] = None
        self.iterations_ = 0

    @staticmethod
    def setup(k: int, max_iterations: int = 100, distance: str = "euclidean",
              seed: int = 0, device=None) -> "KMeansClustering":
        return KMeansClustering(k, max_iterations, seed=seed, device=device)

    def _init_pp(self, points: np.ndarray, rng) -> np.ndarray:
        """k-means++ seeding."""
        n = len(points)
        centers = [points[rng.integers(0, n)]]
        for _ in range(1, self.k):
            d2 = np.min([np.sum((points - c) ** 2, axis=1)
                         for c in centers], axis=0)
            probs = d2 / max(d2.sum(), 1e-12)
            centers.append(points[rng.choice(n, p=probs)])
        return np.stack(centers)

    def apply_to(self, points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Fit; returns (assignments [N], centers [k, D]). Reads back the
        cost once an iteration (``kmeans.cost``) and the result once
        (``kmeans.result``); ``iterations_`` counts the iterations run."""
        points = np.asarray(points, np.float32)
        rng = np.random.default_rng(self.seed)
        centers = torch.from_numpy(self._init_pp(points, rng)).to(
            self.device)
        pts = torch.from_numpy(points).to(self.device)
        last_cost = np.inf
        assign = None
        self.iterations_ = 0
        for _ in range(self.max_iterations):
            centers, assign, cost = _lloyd_step(pts, centers, self.k)
            self.iterations_ += 1
            cost = float(device_fetch(cost, "kmeans.cost"))
            if abs(last_cost - cost) < self.tol * max(abs(last_cost), 1.0):
                break
            last_cost = cost
        self.centers = device_fetch(centers, "kmeans.result")
        return device_fetch(assign, "kmeans.result"), self.centers

    def predict(self, points: np.ndarray) -> np.ndarray:
        d2 = np.sum((np.asarray(points)[:, None, :] -
                     self.centers[None]) ** 2, axis=2)
        return np.argmin(d2, axis=1)
