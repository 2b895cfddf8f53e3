"""GloVe embeddings: the counterpart of the JAX package's ``nlp/glove.py``
(reference models/glove/: co-occurrence counting with ring buffers +
AdaGrad weighted-least-squares fit; SURVEY.md §2.5).

Host-side co-occurrence counting (the reference's count/ round-trip
files), then one AdaGrad step over batched (i, j, X_ij) triples on the
tables' device, updating them in place — the replacement for the
reference's per-pair threaded updates."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops.platform import resolve_device
from .skipgram import _index_sum
from .vocab import VocabCache, VocabConstructor


def _glove_step(w, wc, b, bc, hw, hb, rows, cols, xij, lr, x_max, alpha):
    """AdaGrad GloVe step, in place. w/wc [V,D] main+context vectors, b/bc
    [V] biases, hw/hb AdaGrad accumulators (packed: hw [2,V,D], hb [2,V]).

    Each AdaGrad denominator is read after its whole batch's accumulation,
    as the JAX step reads ``hw_i[rows]`` after ``.at[rows].add``: a row
    that repeats within the batch divides by the batch's summed history.
    Returns (w, wc, b, bc, hw, hb, loss)."""
    wi = w[rows]
    wj = wc[cols]
    weight = torch.clamp((xij / x_max) ** alpha, max=1.0)
    diff = torch.einsum("bd,bd->b", wi, wj) + b[rows] + bc[cols] - \
        torch.log(xij)
    loss = torch.mean(weight * diff * diff)
    g = weight * diff                                   # [B]
    gwi = g[:, None] * wj
    gwj = g[:, None] * wi
    # AdaGrad
    _index_sum(hw[0], rows, gwi * gwi)
    _index_sum(hw[1], cols, gwj * gwj)
    _index_sum(w, rows, -lr * gwi / torch.sqrt(hw[0][rows] + 1e-8))
    _index_sum(wc, cols, -lr * gwj / torch.sqrt(hw[1][cols] + 1e-8))
    _index_sum(hb[0], rows, g * g)
    _index_sum(hb[1], cols, g * g)
    _index_sum(b, rows, -lr * g / torch.sqrt(hb[0][rows] + 1e-8))
    _index_sum(bc, cols, -lr * g / torch.sqrt(hb[1][cols] + 1e-8))
    return w, wc, b, bc, hw, hb, loss


class Glove:
    def __init__(self, vector_length: int = 100, window: int = 5,
                 min_word_frequency: int = 1, learning_rate: float = 0.05,
                 epochs: int = 5, x_max: float = 100.0, alpha: float = 0.75,
                 batch_size: int = 4096, symmetric: bool = True,
                 seed: int = 42, device=None):
        self.vector_length = vector_length
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.x_max = x_max
        self.alpha = alpha
        self.batch_size = batch_size
        self.symmetric = symmetric
        self.seed = seed
        self.device = resolve_device(device)
        self.vocab: VocabCache = None
        self.w = None

    def fit(self, sequences: Sequence[List[str]]):
        self.vocab = VocabConstructor(self.min_word_frequency).build(sequences)
        # vectorized co-occurrence counting (the reference's threaded ring
        # buffers, models/glove/count/): one separator-delimited index
        # stream, one numpy pass per window offset, sparse aggregation by
        # flattened (row, col) key
        V = len(self.vocab)
        parts: List[np.ndarray] = []
        sep = np.array([-1], np.int32)
        for seq in sequences:
            idxs = np.fromiter(
                (self.vocab.index_of(t) for t in seq if t in self.vocab),
                np.int32)
            if len(idxs):
                parts.append(idxs)
                parts.append(sep)
        if not parts:
            return self
        corpus = np.concatenate(parts)
        seg = np.cumsum(corpus < 0)
        n = len(corpus)
        keys: List[np.ndarray] = []
        vals: List[np.ndarray] = []
        for off in range(1, self.window + 1):
            if off >= n:
                break
            a, b = corpus[:n - off], corpus[off:]
            valid = (a >= 0) & (b >= 0) & (seg[:n - off] == seg[off:])
            ai, bi = a[valid].astype(np.int64), b[valid].astype(np.int64)
            inc = np.float32(1.0 / off)              # distance weighting
            keys.append(ai * V + bi)
            vals.append(np.full(len(ai), inc, np.float32))
            if self.symmetric:
                keys.append(bi * V + ai)
                vals.append(np.full(len(ai), inc, np.float32))
        key = np.concatenate(keys) if keys else np.zeros(0, np.int64)
        if not len(key):
            return self          # no valid window pair in the corpus
        val = np.concatenate(vals)
        uniq, inv = np.unique(key, return_inverse=True)
        acc = np.bincount(inv, weights=val,
                          minlength=len(uniq)).astype(np.float32)
        rows = (uniq // V).astype(np.int32)
        cols = (uniq % V).astype(np.int32)
        xij = acc

        V, D = len(self.vocab), self.vector_length
        rng = np.random.default_rng(self.seed)
        dev = self.device
        self.w = torch.tensor((rng.random((V, D)) - 0.5) / D,
                              dtype=torch.float32, device=dev)
        self.wc = torch.tensor((rng.random((V, D)) - 0.5) / D,
                               dtype=torch.float32, device=dev)
        self.b = torch.zeros(V, device=dev)
        self.bc = torch.zeros(V, device=dev)
        hw = torch.zeros((2, V, D), device=dev)
        hb = torch.zeros((2, V), device=dev)

        n = len(rows)
        B = min(self.batch_size, n)
        order = np.arange(n)
        rows_d = torch.from_numpy(rows).to(dev).long()
        cols_d = torch.from_numpy(cols).to(dev).long()
        xij_d = torch.from_numpy(xij).to(dev)
        lr = float(np.float32(self.learning_rate))
        for epoch in range(self.epochs):
            rng.shuffle(order)
            order_d = torch.from_numpy(order).to(dev)
            for s in range(0, n - n % B or n, B):
                sel = order_d[s:s + B]
                if len(sel) < B:
                    sel = torch.cat([sel, order_d[:B - len(sel)]])
                *_, loss = _glove_step(
                    self.w, self.wc, self.b, self.bc, hw, hb, rows_d[sel],
                    cols_d[sel], xij_d[sel], lr, self.x_max, self.alpha)
            self._last_loss = float(loss)
        return self

    def get_word_vector(self, word: str):
        idx = self.vocab.index_of(word)
        if idx < 0:
            return None
        return (self.w[idx] + self.wc[idx]).cpu().numpy()   # GloVe sums both

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        if va is None or vb is None:
            return float("nan")
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / denom) if denom else 0.0
