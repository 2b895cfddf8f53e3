"""Word-vectors-as-network-input iterators (reference
models/word2vec/iterator/Word2VecDataSetIterator.java and the moving-window
text iterators under deeplearning4j-nlp iterator/; SURVEY.md §2.5
"Word2Vec-as-input").

``Word2VecDataSetIterator`` turns labelled sentences into RNN DataSets: each
sentence becomes a [vector_length, T] sequence of word vectors (time-major
last, matching the framework's RNN layout [N, T, F]), with the one-hot label
broadcast over time and a labels mask marking only the final step — the
reference's alignment for sequence classification from embeddings.

``WindowDataSetIterator`` (reference Window/WindowConverter path) yields
fixed-size context windows around each word, concatenating the window's word
vectors into one flat feature vector per example.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.dataset import DataSet
from ..datasets.iterators import DataSetIterator


class Word2VecDataSetIterator(DataSetIterator):
    def __init__(self, vectors, labelled_sentences:
                 Sequence[Tuple[str, str]], labels: List[str],
                 batch_size: int = 32, tokenizer_factory=None,
                 max_length: Optional[int] = None):
        """``vectors``: trained SequenceVectors/Word2Vec (get_word_vector);
        ``labelled_sentences``: (sentence, label) pairs;
        ``labels``: full ordered label set (defines the one-hot layout)."""
        from .tokenization import DefaultTokenizerFactory
        self.vectors = vectors
        self.data = list(labelled_sentences)
        self.labels = list(labels)
        self._bs = int(batch_size)
        self.tf = tokenizer_factory or DefaultTokenizerFactory()
        self.max_length = max_length

    def _embed(self, sentence: str) -> np.ndarray:
        toks = self.tf.create(sentence).get_tokens()
        vecs = [self.vectors.get_word_vector(t) for t in toks]
        vecs = [v for v in vecs if v is not None]
        if not vecs:
            vecs = [np.zeros(self.vectors.vector_length, np.float32)]
        if self.max_length:
            vecs = vecs[:self.max_length]
        return np.stack(vecs).astype(np.float32)      # [T, F]

    def __iter__(self):
        for i in range(0, len(self.data), self._bs):
            chunk = self.data[i:i + self._bs]
            seqs = [self._embed(s) for s, _ in chunk]
            T = max(len(s) for s in seqs)
            F = seqs[0].shape[1]
            n = len(chunk)
            feats = np.zeros((n, T, F), np.float32)
            fmask = np.zeros((n, T), np.float32)
            labels = np.zeros((n, T, len(self.labels)), np.float32)
            lmask = np.zeros((n, T), np.float32)
            for j, (seq, (_, lab)) in enumerate(zip(seqs, chunk)):
                t = len(seq)
                feats[j, :t] = seq
                fmask[j, :t] = 1.0
                labels[j, t - 1, self.labels.index(lab)] = 1.0
                lmask[j, t - 1] = 1.0    # align label to final real step
            yield DataSet(feats, labels, fmask, lmask)

    def batch_size(self) -> int:
        return self._bs

    def total_examples(self) -> int:
        return len(self.data)


class WindowDataSetIterator(DataSetIterator):
    """Moving context windows → flat concatenated word-vector features
    (reference text/movingwindow/Window.java + WordConverter)."""

    def __init__(self, vectors, sentences: Sequence[str],
                 window_size: int = 5, batch_size: int = 32,
                 tokenizer_factory=None):
        from .tokenization import DefaultTokenizerFactory
        if window_size % 2 == 0:
            raise ValueError("window_size must be odd (center word + "
                             "symmetric context)")
        self.vectors = vectors
        self.window = window_size
        self._bs = int(batch_size)
        tf = tokenizer_factory or DefaultTokenizerFactory()
        self._tokens = [tf.create(s).get_tokens() for s in sentences]

    def _examples(self):
        half = self.window // 2
        for toks in self._tokens:
            known = [t for t in toks
                     if self.vectors.get_word_vector(t) is not None]
            if not known:
                continue
            dim = len(self.vectors.get_word_vector(known[0]))
            for c in range(len(toks)):
                parts = []
                for off in range(-half, half + 1):
                    i = c + off
                    v = self.vectors.get_word_vector(toks[i]) \
                        if 0 <= i < len(toks) else None
                    parts.append(np.zeros(dim, np.float32)
                                 if v is None else v)
                center = self.vectors.get_word_vector(toks[c])
                if center is None:
                    continue
                yield np.concatenate(parts).astype(np.float32), toks[c]

    def __iter__(self):
        batch_f, batch_w = [], []
        for feat, word in self._examples():
            batch_f.append(feat)
            batch_w.append(word)
            if len(batch_f) == self._bs:
                yield DataSet(np.stack(batch_f), None), batch_w
                batch_f, batch_w = [], []
        if batch_f:
            yield DataSet(np.stack(batch_f), None), batch_w

    def batch_size(self) -> int:
        return self._bs

    def total_examples(self) -> int:
        return sum(len(t) for t in self._tokens)
