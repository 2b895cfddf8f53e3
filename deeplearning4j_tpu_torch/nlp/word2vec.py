"""Word2Vec and ParagraphVectors user-facing builders over SequenceVectors:
the counterpart of the JAX package's ``nlp/word2vec.py`` (reference
models/word2vec/Word2Vec.java (606 LoC),
models/paragraphvectors/ParagraphVectors.java; SURVEY.md §2.5). Both take
``device=`` (``None``: the CUDA card; the Builder's ``device(...)``)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .sequence_vectors import SequenceVectors
from .skipgram import skipgram_hs_step, vectorized_skipgram_pairs
from .tokenization import TokenizerFactory, DefaultTokenizerFactory


class Word2Vec(SequenceVectors):
    """word2vec over sentences (reference Word2Vec.Builder surface)."""

    class Builder:
        def __init__(self):
            self._kw = {}
            self._tokenizer: TokenizerFactory = DefaultTokenizerFactory()
            self._iterator = None

        def layer_size(self, n):
            self._kw["vector_length"] = int(n)
            return self

        def window_size(self, n):
            self._kw["window"] = int(n)
            return self

        def min_word_frequency(self, n):
            self._kw["min_word_frequency"] = int(n)
            return self

        def learning_rate(self, lr):
            self._kw["learning_rate"] = float(lr)
            return self

        def min_learning_rate(self, lr):
            self._kw["min_learning_rate"] = float(lr)
            return self

        def epochs(self, n):
            self._kw["epochs"] = int(n)
            return self

        def iterations(self, n):
            return self

        def negative_sample(self, n):
            self._kw["negative"] = int(n)
            self._kw["use_hierarchic_softmax"] = (n == 0)
            return self

        def shared_negatives(self, flag):
            """Negative-draw granularity for the large-corpus scan path:
            True (default) shares one k-negative draw per scan step (faster,
            slightly correlated updates), False draws per pair like
            word2vec.c. See SequenceVectors.__init__."""
            self._kw["shared_negatives"] = bool(flag)
            return self

        def scan_min_tokens(self, n):
            """Corpus size at which fit() switches from shuffled per-batch
            programs to the corpus-scan device program (default 100k)."""
            self._kw["scan_min_tokens"] = int(n)
            return self

        def use_hierarchic_softmax(self, flag):
            self._kw["use_hierarchic_softmax"] = bool(flag)
            return self

        def sampling(self, s):
            self._kw["sample"] = float(s)
            return self

        def seed(self, s):
            self._kw["seed"] = int(s)
            return self

        def batch_size(self, n):
            self._kw["batch_size"] = int(n)
            return self

        def device(self, device):
            """The tables' device (default: the CUDA card)."""
            self._kw["device"] = device
            return self

        def tokenizer_factory(self, tf):
            self._tokenizer = tf
            return self

        def iterate(self, sentence_iterator):
            self._iterator = sentence_iterator
            return self

        def build(self) -> "Word2Vec":
            w2v = Word2Vec(**self._kw)
            w2v._tokenizer = self._tokenizer
            w2v._sentence_iter = self._iterator
            return w2v

    _tokenizer: TokenizerFactory = None
    _sentence_iter = None

    def _sequences(self) -> List[List[str]]:
        tok = self._tokenizer or DefaultTokenizerFactory()
        seqs = []
        for sentence in self._sentence_iter:
            seqs.append(tok.create(sentence).get_tokens())
        return seqs

    def fit(self, sequences: Optional[Sequence[List[str]]] = None):
        if sequences is None:
            sequences = self._sequences()
        return super().fit(sequences)


class ParagraphVectors(SequenceVectors):
    """Doc embeddings: DBOW / DM over labelled documents (reference
    ParagraphVectors; labels become extra rows trained like word2vec —
    DBOW: doc vector predicts each word's Huffman code; DM: doc vector joins
    the averaged context). ``infer_vector`` gradient-fits a fresh vector with
    frozen word weights (ParagraphVectors.inferVector)."""

    def __init__(self, *args, sequence_algorithm: str = "dbow", **kw):
        super().__init__(*args, **kw)
        self.sequence_algorithm = sequence_algorithm
        self.label_index = {}
        self.doc_vectors = None

    def fit_documents(self, documents: Sequence[Tuple[str, List[str]]]):
        """documents: [(label, tokens)].

        Batched like SequenceVectors.fit: (doc, word) pairs for DBOW (the
        doc vector is the skip-gram center) and word windows for DM are
        collected corpus-wide, shuffled, staged on the device once an epoch
        and trained in fixed-size batches."""
        seqs = [tokens for _, tokens in documents]
        if self.vocab is None:
            self.build_vocab(seqs)
        rng = np.random.default_rng(self.seed)
        self.label_index = {label: i for i, (label, _) in
                            enumerate(documents)}
        D = len(documents)
        self.doc_vectors = torch.tensor(
            (np.random.default_rng(self.seed + 1)
             .random((D, self.vector_length)) - 0.5) / self.vector_length,
            dtype=torch.float32, device=self.device)
        # (doc, word) pairs + word-window pairs, one pass over the corpus
        doc_c, doc_t, word_parts = [], [], []
        sep = np.array([-1], np.int32)
        for label, tokens in documents:
            didx = self.label_index[label]
            idxs = np.array([self.vocab.index_of(w) for w in tokens
                             if w in self.vocab], np.int32)
            if len(idxs) == 0:
                continue
            doc_c.append(np.full(len(idxs), didx, np.int32))
            doc_t.append(idxs)
            word_parts.append(idxs)
            word_parts.append(sep)
        if not doc_c:
            return self
        doc_c = np.concatenate(doc_c)
        doc_t = np.concatenate(doc_t)
        total = len(doc_t) * self.epochs
        B = self.batch_size
        lt = self.lookup
        for epoch in range(self.epochs):
            perm = rng.permutation(len(doc_c))
            nb, (dc, dt) = self._batches((doc_c[perm], doc_t[perm]), B)
            for i in range(nb):
                lr = self._lr32(
                    epoch * len(doc_t) + len(doc_t) * i / max(nb, 1), total)
                c, t = dc[i * B:(i + 1) * B], dt[i * B:(i + 1) * B]
                skipgram_hs_step(self.doc_vectors, lt.syn1, c, t,
                                 self._codes[t], self._points[t],
                                 self._lengths[t], lr)
            if self.sequence_algorithm == "dm":
                wc, wt = vectorized_skipgram_pairs(
                    np.concatenate(word_parts), self.window, rng)
                wperm = rng.permutation(len(wc))
                nbw, (wcs, wts) = self._batches((wc[wperm], wt[wperm]), B)
                for i in range(nbw):
                    lr = self._lr32(
                        epoch * len(doc_t) + len(doc_t) * i / max(nbw, 1),
                        total)
                    c, t = wcs[i * B:(i + 1) * B], wts[i * B:(i + 1) * B]
                    skipgram_hs_step(lt.syn0, lt.syn1, c, t, self._codes[t],
                                     self._points[t], self._lengths[t], lr)
        return self

    def get_doc_vector(self, label: str) -> Optional[np.ndarray]:
        i = self.label_index.get(label)
        return None if i is None else \
            self.doc_vectors[i].to("cpu", copy=True).numpy()

    def infer_vector(self, tokens: List[str], steps: int = 10,
                     lr: float = 0.025) -> np.ndarray:
        """Fit a new doc vector against frozen syn1 (reference inferVector).
        The steps update a private copy of syn1, so the model's stays
        frozen."""
        idxs = np.array([self.vocab.index_of(w) for w in tokens
                         if w in self.vocab], np.int32)
        rng = np.random.default_rng(0)
        vec = torch.tensor((rng.random((1, self.vector_length)) - 0.5) /
                           self.vector_length, dtype=torch.float32,
                           device=self.device)
        if len(idxs) == 0:
            return vec[0].cpu().numpy()
        syn1 = self.lookup.syn1.clone()
        tj = torch.from_numpy(idxs).to(self.device).long()
        centers = torch.zeros(len(idxs), dtype=torch.int64,
                              device=self.device)
        codes, points, lengths = (self._codes[tj], self._points[tj],
                                  self._lengths[tj])
        for s in range(steps):
            skipgram_hs_step(vec, syn1, centers, tj, codes, points, lengths,
                             float(np.float32(lr * (1 - s / steps))))
        return vec[0].cpu().numpy()

    def similarity_to_label(self, tokens: List[str], label: str) -> float:
        v = self.infer_vector(tokens)
        d = self.get_doc_vector(label)
        if d is None:
            return float("nan")
        denom = np.linalg.norm(v) * np.linalg.norm(d)
        return float(v @ d / denom) if denom else 0.0
