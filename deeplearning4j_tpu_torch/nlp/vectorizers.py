"""Bag-of-words / TF-IDF vectorizers + word-vector serialization (reference
bagofwords/vectorizer/{BagOfWordsVectorizer,TfidfVectorizer} and
models/embeddings/loader/WordVectorSerializer; SURVEY.md §2.5)."""

from __future__ import annotations

import math
from collections import Counter
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

import numpy as np

from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabCache, VocabConstructor


class BagOfWordsVectorizer:
    def __init__(self, tokenizer: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1):
        self.tokenizer = tokenizer or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.vocab: Optional[VocabCache] = None

    def fit(self, documents: Iterable[str]):
        seqs = [self.tokenizer.create(d).get_tokens() for d in documents]
        self.vocab = VocabConstructor(self.min_word_frequency).build(seqs)
        return self

    def transform(self, document: str) -> np.ndarray:
        counts = Counter(self.tokenizer.create(document).get_tokens())
        vec = np.zeros(len(self.vocab), np.float32)
        for word, c in counts.items():
            idx = self.vocab.index_of(word)
            if idx >= 0:
                vec[idx] = c
        return vec

    def fit_transform(self, documents: List[str]) -> np.ndarray:
        self.fit(documents)
        return np.stack([self.transform(d) for d in documents])


class TfidfVectorizer(BagOfWordsVectorizer):
    def __init__(self, tokenizer: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1):
        super().__init__(tokenizer, min_word_frequency)
        self.idf = None

    def fit(self, documents: Iterable[str]):
        docs = list(documents)
        super().fit(docs)
        n_docs = len(docs)
        df = np.zeros(len(self.vocab), np.float64)
        for d in docs:
            seen = set(self.tokenizer.create(d).get_tokens())
            for w in seen:
                idx = self.vocab.index_of(w)
                if idx >= 0:
                    df[idx] += 1
        self.idf = np.log(n_docs / np.maximum(df, 1.0)).astype(np.float32)
        return self

    def transform(self, document: str) -> np.ndarray:
        tf = super().transform(document)
        total = max(tf.sum(), 1.0)
        return (tf / total) * self.idf


class WordVectorSerializer:
    """Text + npz word-vector formats (reference WordVectorSerializer:
    writeWordVectors/loadTxtVectors)."""

    @staticmethod
    def write_word_vectors(model, path):
        """word2vec text format: one 'word v1 v2 ...' line per word."""
        path = Path(path)
        with open(path, "w", encoding="utf-8") as f:
            for word in model.vocab.index2word:
                vec = model.get_word_vector(word)
                f.write(word + " " + " ".join(f"{x:.6f}" for x in vec) + "\n")

    @staticmethod
    def load_txt_vectors(path) -> Tuple[VocabCache, np.ndarray]:
        words, vecs = [], []
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 2:
                    continue
                if len(vecs) == 0 and len(parts) == 2 and \
                        parts[0].isdigit() and parts[1].isdigit():
                    continue   # optional "V D" header line
                words.append(parts[0])
                vecs.append(np.array([float(x) for x in parts[1:]],
                                     np.float32))
        vocab = VocabCache()
        for w in words:
            vocab.add(w)
        vocab.finish(min_word_frequency=0)
        # preserve file order
        vocab.index2word = words
        for i, w in enumerate(words):
            vocab.words[w].index = i
        return vocab, np.stack(vecs)

    @staticmethod
    def write_word_vectors_binary(model, path):
        np.savez_compressed(
            path, words=np.array(model.vocab.index2word),
            vectors=np.stack([model.get_word_vector(w)
                              for w in model.vocab.index2word]))

    @staticmethod
    def load_binary_vectors(path) -> Tuple[VocabCache, np.ndarray]:
        with np.load(path, allow_pickle=False) as z:
            words = [str(w) for w in z["words"]]
            vectors = z["vectors"]
        vocab = VocabCache()
        for w in words:
            vocab.add(w)
        vocab.finish(0)
        vocab.index2word = words
        for i, w in enumerate(words):
            vocab.words[w].index = i
        return vocab, vectors


class StaticWord2Vec:
    """Read-only lookup over serialized vectors (reference StaticWord2Vec —
    memory-mapped read-only vectors for inference)."""

    def __init__(self, vocab: VocabCache, vectors: np.ndarray):
        self.vocab = vocab
        self.vectors = vectors

    @staticmethod
    def load(path) -> "StaticWord2Vec":
        vocab, vectors = WordVectorSerializer.load_binary_vectors(path)
        return StaticWord2Vec(vocab, vectors)

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self.vectors[i]

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        if va is None or vb is None:
            return float("nan")
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / denom) if denom else 0.0
