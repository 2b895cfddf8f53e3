"""DeepWalk graph embeddings (reference graph/models/deepwalk/DeepWalk.java
(254 LoC) — skip-gram with hierarchical softmax over random walks, with the
Huffman coding built from VERTEX DEGREES (GraphHuffman.java:36-39);
SURVEY.md §2.6).

Reuses the batched skip-gram HS step of nlp/skipgram.py — same aggregate
op, different corpus. The counterpart of the JAX package's
``graph_embeddings/deepwalk.py``: the tables live on ``device`` (``None``:
the CUDA card), and each chunk's shuffled pairs cross to it once."""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch

from ..nlp.huffman import build_huffman
from ..nlp.skipgram import skipgram_hs_step, vectorized_skipgram_pairs
from ..ops.platform import resolve_device
from .graph import Graph
from .walks import RandomWalkIterator


class DeepWalk:
    class Builder:
        def __init__(self):
            self._kw = {}

        def vector_size(self, n):
            self._kw["vector_size"] = int(n)
            return self

        def window_size(self, n):
            self._kw["window"] = int(n)
            return self

        def learning_rate(self, lr):
            self._kw["learning_rate"] = float(lr)
            return self

        def seed(self, s):
            self._kw["seed"] = int(s)
            return self

        def device(self, device):
            """The tables' device (default: the CUDA card)."""
            self._kw["device"] = device
            return self

        def build(self) -> "DeepWalk":
            return DeepWalk(**self._kw)

    def __init__(self, vector_size: int = 100, window: int = 5,
                 learning_rate: float = 0.025, batch_size: int = 2048,
                 seed: int = 42, device=None):
        self.vector_size = vector_size
        self.window = window
        self.learning_rate = learning_rate
        self.batch_size = batch_size
        self.seed = seed
        self.device = resolve_device(device)
        self.vertex_vectors = None
        self._syn1 = None
        self._codes = self._points = self._lengths = None

    def initialize(self, graph: Graph):
        """Build degree-based Huffman coding (GraphHuffman parity) + tables."""
        degrees = [max(graph.degree(i), 1)
                   for i in range(graph.num_vertices())]
        codes, points = build_huffman(degrees)
        L = max(len(c) for c in codes)
        V = graph.num_vertices()
        carr = np.zeros((V, L), np.float32)
        parr = np.zeros((V, L), np.int32)
        larr = np.zeros(V, np.int32)
        for i in range(V):
            l = len(codes[i])
            carr[i, :l] = codes[i]
            parr[i, :l] = points[i]
            larr[i] = l
        dev = self.device
        self._codes = torch.from_numpy(carr).to(dev)
        self._points = torch.from_numpy(parr).to(dev).long()
        self._lengths = torch.from_numpy(larr).to(dev).long()
        rng = np.random.default_rng(self.seed)
        self.vertex_vectors = torch.tensor(
            (rng.random((V, self.vector_size)) - 0.5) / self.vector_size,
            dtype=torch.float32, device=dev)
        self._syn1 = torch.zeros((max(V - 1, 1), self.vector_size),
                                 device=dev)
        return self

    def fit(self, graph: Graph, walk_length: int = 40, walks_per_vertex: int = 1):
        if self.vertex_vectors is None:
            self.initialize(graph)
        for rep in range(walks_per_vertex):
            it = RandomWalkIterator(graph, walk_length,
                                    seed=self.seed + rep)
            self.fit_walks(it)
        return self

    # tokens per vectorized chunk — bounds host memory for the pair set
    # (walks may be a generator; streaming is preserved chunk by chunk)
    CHUNK_TOKENS = 2_000_000

    def fit_walks(self, walks: Iterable[List[int]]):
        rng = np.random.default_rng(self.seed)
        # walks as separator-delimited streams, vectorized window extraction
        # (see nlp/skipgram.py; windows never cross walks)
        parts, size = [], 0
        sep = np.array([-1], np.int32)

        def run_chunk():
            c, t = vectorized_skipgram_pairs(np.concatenate(parts),
                                             self.window, rng)
            if len(c):
                perm = rng.permutation(len(c))
                self._flush(c[perm], t[perm])

        for walk in walks:
            w = np.asarray(walk, np.int32)
            if len(w):
                parts.append(w)
                parts.append(sep)
                size += len(w)
            if size >= self.CHUNK_TOKENS:
                run_chunk()
                parts, size = [], 0
        if parts:
            run_chunk()
        return self

    def _flush(self, centers, targets):
        B = self.batch_size
        nb = (len(centers) + B - 1) // B
        pad = nb * B - len(centers)       # the last batch pads with vertex 0
        cs, ts = (torch.from_numpy(np.concatenate(
            [a, np.zeros(pad, np.int32)])).to(self.device).long()
            for a in (centers, targets))
        lr = float(np.float32(self.learning_rate))
        for i in range(nb):
            c, t = cs[i * B:(i + 1) * B], ts[i * B:(i + 1) * B]
            *_, self._loss = skipgram_hs_step(
                self.vertex_vectors, self._syn1, c, t, self._codes[t],
                self._points[t], self._lengths[t], lr)

    # --- GraphVectors query surface (reference models/embeddings) ---
    def get_vertex_vector(self, idx: int) -> np.ndarray:
        return self.vertex_vectors[idx].to("cpu", copy=True).numpy()

    def similarity(self, a: int, b: int) -> float:
        va, vb = self.get_vertex_vector(a), self.get_vertex_vector(b)
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / denom) if denom else 0.0

    def verticies_nearest(self, idx: int, n: int = 10) -> List[int]:
        v = self.get_vertex_vector(idx)
        all_v = self.vertex_vectors.cpu().numpy()
        sims = all_v @ v / np.maximum(
            np.linalg.norm(all_v, axis=1) * np.linalg.norm(v), 1e-12)
        sims[idx] = -np.inf
        return [int(i) for i in np.argsort(-sims)[:n]]


class GraphVectorSerializer:
    """reference models/loader/GraphVectorSerializer: vertex-id + vector rows."""

    @staticmethod
    def write_graph_vectors(model: DeepWalk, path):
        with open(path, "w", encoding="utf-8") as f:
            all_v = model.vertex_vectors.cpu().numpy()
            for i in range(all_v.shape[0]):
                f.write(f"{i} " + " ".join(f"{x:.6f}" for x in all_v[i])
                        + "\n")

    @staticmethod
    def load_graph_vectors(path) -> np.ndarray:
        rows = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                rows.append((int(parts[0]),
                             np.array([float(x) for x in parts[1:]],
                                      np.float32)))
        rows.sort(key=lambda r: r[0])
        return np.stack([v for _, v in rows])
