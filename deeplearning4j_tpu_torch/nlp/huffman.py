"""Huffman coding for hierarchical softmax (reference
models/word2vec/Huffman.java; also GraphHuffman built from vertex degrees,
graph/models/deepwalk/GraphHuffman.java:36-39 — same algorithm,
frequency source differs)."""

from __future__ import annotations

import heapq
from typing import List, Sequence, Tuple

import numpy as np


def build_huffman(frequencies: Sequence[float]
                  ) -> Tuple[List[List[int]], List[List[int]]]:
    """Return (codes, points) per leaf index: codes[i] = bit path (0/1),
    points[i] = inner-node indices root→leaf (the rows of syn1 used)."""
    n = len(frequencies)
    if n == 0:
        return [], []
    if n == 1:
        return [[0]], [[0]]
    heap = [(float(f), i) for i, f in enumerate(frequencies)]
    heapq.heapify(heap)
    parent = {}
    bit = {}
    next_id = n
    while len(heap) > 1:
        f1, a = heapq.heappop(heap)
        f2, b = heapq.heappop(heap)
        parent[a] = next_id
        parent[b] = next_id
        bit[a] = 0
        bit[b] = 1
        heapq.heappush(heap, (f1 + f2, next_id))
        next_id += 1
    root = heap[0][1]
    codes, points = [], []
    for leaf in range(n):
        code, path = [], []
        node = leaf
        while node != root:
            code.append(bit[node])
            path.append(parent[node] - n)   # inner nodes numbered from 0
            node = parent[node]
        codes.append(list(reversed(code)))
        points.append(list(reversed(path)))
    return codes, points


def apply_huffman(vocab) -> None:
    """Attach codes/points to a VocabCache's words (reference Huffman.build)."""
    freqs = [vocab.words[w].count for w in vocab.index2word]
    codes, points = build_huffman(freqs)
    for i, w in enumerate(vocab.index2word):
        vw = vocab.words[w]
        vw.code = codes[i]
        vw.point = points[i]


def pad_codes(vocab, max_len: int = 0):
    """Pack codes/points into fixed-shape arrays for batched device HS:
    returns (codes [V, L], points [V, L], lengths [V])."""
    lens = [len(vocab.words[w].code) for w in vocab.index2word]
    L = max_len or (max(lens) if lens else 1)
    V = len(vocab.index2word)
    codes = np.zeros((V, L), np.float32)
    points = np.zeros((V, L), np.int32)
    lengths = np.zeros(V, np.int32)
    for i, w in enumerate(vocab.index2word):
        vw = vocab.words[w]
        l = min(len(vw.code), L)
        codes[i, :l] = vw.code[:l]
        points[i, :l] = vw.point[:l]
        lengths[i] = l
    return codes, points, lengths
