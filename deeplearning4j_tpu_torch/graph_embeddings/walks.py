"""Random walk iterators (reference graph/iterator/RandomWalkIterator.java +
WeightedRandomWalkIterator.java; SURVEY.md §2.6): fixed-length uniform or
edge-weight-proportional walks from every vertex, with no-edge modes. The
port's copy draws the same walks as the JAX package's for a seed."""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from .graph import Graph


class RandomWalkIterator:
    """Uniform random walks of ``walk_length`` steps from each vertex."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 0,
                 no_edge_handling: str = "self_loop"):
        self.graph = graph
        self.walk_length = int(walk_length)
        self.seed = seed
        self.no_edge_handling = no_edge_handling

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed)
        order = rng.permutation(self.graph.num_vertices())
        for start in order:
            yield self._walk(int(start), rng)

    def _walk(self, start: int, rng) -> List[int]:
        walk = [start]
        cur = start
        adj = self.graph._adj     # (to, weight) lists: no copy a step
        for _ in range(self.walk_length):
            nbrs = adj[cur]
            if not nbrs:
                if self.no_edge_handling == "self_loop":
                    walk.append(cur)
                    continue
                break
            cur = int(nbrs[rng.integers(0, len(nbrs))][0])
            walk.append(cur)
        return walk


class WeightedWalkIterator(RandomWalkIterator):
    """Edge-weight-proportional walks (reference WeightedRandomWalkIterator)."""

    def _walk(self, start: int, rng) -> List[int]:
        walk = [start]
        cur = start
        for _ in range(self.walk_length):
            nbrs = self.graph.neighbors_weighted(cur)
            if not nbrs:
                if self.no_edge_handling == "self_loop":
                    walk.append(cur)
                    continue
                break
            weights = np.array([w for _, w in nbrs], np.float64)
            probs = weights / weights.sum()
            cur = int(nbrs[rng.choice(len(nbrs), p=probs)][0])
            walk.append(cur)
        return walk
