"""Space-partitioning trees for nearest-neighbor queries: the JAX
package's ``clustering/trees.py``, the same host numpy (reference
clustering/kdtree/KDTree.java and clustering/vptree/VPTree.java, used by
t-SNE and the nearest-neighbors UI; clustering/quadtree and
clustering/sptree for Barnes-Hut). Queries are pointer-chasing, so they
stay on the host."""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class KDTree:
    """k-d tree over rows of a point matrix."""

    class _Node:
        __slots__ = ("idx", "dim", "left", "right")

        def __init__(self, idx, dim):
            self.idx = idx
            self.dim = dim
            self.left = None
            self.right = None

    def __init__(self, points: np.ndarray):
        self.points = np.asarray(points, np.float64)
        idxs = list(range(len(self.points)))
        self.root = self._build(idxs, 0)

    def _build(self, idxs: List[int], depth: int):
        if not idxs:
            return None
        dim = depth % self.points.shape[1]
        idxs.sort(key=lambda i: self.points[i, dim])
        mid = len(idxs) // 2
        node = KDTree._Node(idxs[mid], dim)
        node.left = self._build(idxs[:mid], depth + 1)
        node.right = self._build(idxs[mid + 1:], depth + 1)
        return node

    def nn(self, query: np.ndarray) -> Tuple[int, float]:
        best = [(-1, np.inf)]

        def visit(node):
            if node is None:
                return
            p = self.points[node.idx]
            d = float(np.sum((p - query) ** 2))
            if d < best[0][1]:
                best[0] = (node.idx, d)
            diff = query[node.dim] - p[node.dim]
            near, far = (node.left, node.right) if diff < 0 else \
                (node.right, node.left)
            visit(near)
            if diff * diff < best[0][1]:
                visit(far)

        visit(self.root)
        return best[0][0], float(np.sqrt(best[0][1]))

    def knn(self, query: np.ndarray, k: int) -> List[Tuple[int, float]]:
        heap: List[Tuple[float, int]] = []   # max-heap by -dist

        def visit(node):
            if node is None:
                return
            p = self.points[node.idx]
            d = float(np.sum((p - query) ** 2))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.idx))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.idx))
            diff = query[node.dim] - p[node.dim]
            near, far = (node.left, node.right) if diff < 0 else \
                (node.right, node.left)
            visit(near)
            if len(heap) < k or diff * diff < -heap[0][0]:
                visit(far)

        visit(self.root)
        out = [(i, float(np.sqrt(-d))) for d, i in heap]
        return sorted(out, key=lambda t: t[1])


class VPTree:
    """Vantage-point tree (metric tree; reference VPTree used by
    words-nearest queries)."""

    class _Node:
        __slots__ = ("idx", "radius", "inside", "outside")

        def __init__(self, idx):
            self.idx = idx
            self.radius = 0.0
            self.inside = None
            self.outside = None

    def __init__(self, points: np.ndarray, seed: int = 0):
        self.points = np.asarray(points, np.float64)
        rng = np.random.default_rng(seed)
        self.root = self._build(list(range(len(self.points))), rng)

    def _dist(self, a: int, q) -> float:
        return float(np.linalg.norm(self.points[a] - q))

    def _build(self, idxs: List[int], rng):
        if not idxs:
            return None
        vp = idxs[rng.integers(0, len(idxs))] if len(idxs) > 1 else idxs[0]
        rest = [i for i in idxs if i != vp]
        node = VPTree._Node(vp)
        if not rest:
            return node
        dists = [self._dist(i, self.points[vp]) for i in rest]
        node.radius = float(np.median(dists))
        inside = [i for i, d in zip(rest, dists) if d <= node.radius]
        outside = [i for i, d in zip(rest, dists) if d > node.radius]
        node.inside = self._build(inside, rng)
        node.outside = self._build(outside, rng)
        return node

    def knn(self, query: np.ndarray, k: int) -> List[Tuple[int, float]]:
        heap: List[Tuple[float, int]] = []

        def visit(node):
            if node is None:
                return
            d = self._dist(node.idx, query)
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.idx))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.idx))
            tau = -heap[0][0] if len(heap) == k else np.inf
            if node.inside is not None and d - tau <= node.radius:
                visit(node.inside)
            if node.outside is not None and d + tau > node.radius:
                visit(node.outside)

        visit(self.root)
        return sorted([(i, -d) for d, i in heap], key=lambda t: t[1])


class _BHCell:
    """Shared Barnes-Hut cell logic (center-of-mass + theta traversal) for
    QuadTree (2-D, reference clustering/quadtree/QuadTree.java) and SpTree
    (d-dim, reference clustering/sptree/SpTree.java). Each cell's com/size
    cover every point in its subtree; ``compute_non_edge_forces`` walks
    with the theta criterion accumulating the t-SNE repulsive numerator,
    exactly BarnesHutTsne.java's tree pass."""

    def __init__(self, center, half, d):
        self.center = np.asarray(center, np.float64)
        self.half = float(half)
        self.d = int(d)
        self.com = np.zeros(self.d)
        self.size = 0
        self.children = None
        self.point = None
        self._leaf = True

    @classmethod
    def build(cls, points: np.ndarray):
        points = np.asarray(points, np.float64)
        lo, hi = points.min(0), points.max(0)
        center = (lo + hi) / 2
        half = float(max(hi - lo) / 2 + 1e-9)
        tree = cls(center, half, points.shape[1])
        for p in points:
            tree.insert(p)
        return tree

    def _make_child(self, key):
        h = self.half / 2
        center = self.center + h * (np.asarray(key) * 2 - 1)
        return type(self)(center, h, self.d)

    def _child_for(self, p):
        key = tuple(int(p[i] >= self.center[i]) for i in range(self.d))
        if self.children is None:
            self.children = {}
        child = self.children.get(key)
        if child is None:
            child = self._make_child(key)
            self.children[key] = child
        return child

    def insert(self, p):
        p = np.asarray(p, np.float64)
        self.com = (self.com * self.size + p) / (self.size + 1)
        self.size += 1
        if self._leaf and self.point is None:
            self.point = p
            return
        if self._leaf:
            if np.allclose(self.point, p):
                # duplicate point: aggregate in this cell (com/size already
                # count it) — subdividing forever would never terminate
                return
            old = self.point
            self.point = None
            self._leaf = False
            child = self._child_for(old)
            # every prior point in this cell is a coincident duplicate of
            # `old` (a distinct point would have subdivided earlier): move
            # the FULL mass down, not one copy (self.size already counts p)
            for _ in range(self.size - 1):
                child.insert(old)
        self._child_for(p).insert(p)

    def compute_non_edge_forces(self, point, theta: float = 0.5):
        """(neg_force [d], sum_q) for one point: Barnes-Hut approximation
        of Σ_j q²(y−y_j) and Σ_j q with q = 1/(1+‖y−y_j‖²), skipping the
        query point itself."""
        point = np.asarray(point, np.float64)
        neg = np.zeros(self.d)
        sum_q = 0.0
        stack = [self]
        while stack:
            node = stack.pop()
            if node.size == 0:
                continue
            diff = point - node.com
            d2 = float(diff @ diff)
            if node._leaf or (node.half * 2) ** 2 < theta * theta * d2:
                count = node.size
                # tolerance, not equality: a leaf's running-average com can
                # drift from the coincident points by an ulp, which must
                # still be recognized as the query point's own cell
                if d2 <= 1e-18:
                    count -= 1          # the query point (or its duplicate)
                    if count > 0:
                        sum_q += count  # coincident points: q = 1
                    continue
                q = 1.0 / (1.0 + d2)
                sum_q += count * q
                neg += count * q * q * diff
            else:
                stack.extend(node.children.values())
        return neg, sum_q


class QuadTree(_BHCell):
    """2-D Barnes-Hut quadtree (reference clustering/quadtree)."""

    @classmethod
    def build(cls, points: np.ndarray):
        points = np.asarray(points, np.float64)
        assert points.shape[1] == 2, "QuadTree is 2-D; use SpTree"
        return super().build(points)


class SpTree(_BHCell):
    """d-dimensional Barnes-Hut cell tree (reference clustering/sptree)."""
