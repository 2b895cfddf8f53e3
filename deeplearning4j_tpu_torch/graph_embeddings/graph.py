"""In-memory graph (reference graph/api/IGraph + graph/graph/Graph.java;
SURVEY.md §2.6): vertices with optional values, directed/undirected weighted
edges, adjacency lists."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Vertex:
    idx: int
    value: Any = None


@dataclasses.dataclass
class Edge:
    frm: int
    to: int
    weight: float = 1.0
    directed: bool = False


class Graph:
    def __init__(self, num_vertices: int, directed: bool = False):
        self.directed = directed
        self.vertices = [Vertex(i) for i in range(num_vertices)]
        self._adj: List[List[Tuple[int, float]]] = \
            [[] for _ in range(num_vertices)]

    def num_vertices(self) -> int:
        return len(self.vertices)

    def add_edge(self, frm: int, to: int, weight: float = 1.0):
        self._adj[frm].append((to, weight))
        if not self.directed:
            self._adj[to].append((frm, weight))

    def get_vertex(self, idx: int) -> Vertex:
        return self.vertices[idx]

    def neighbors(self, idx: int) -> List[int]:
        return [t for t, _ in self._adj[idx]]

    def neighbors_weighted(self, idx: int) -> List[Tuple[int, float]]:
        return list(self._adj[idx])

    def degree(self, idx: int) -> int:
        return len(self._adj[idx])
