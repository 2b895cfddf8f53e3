"""Vocabulary construction (reference models/word2vec/wordstore/:
VocabCache/AbstractCache + VocabConstructor parallel counting; SURVEY.md
§2.5): word→index/frequency store with min-frequency trimming, frequency-
descending indexing, and the subsampling + negative-sampling tables the
trainers consume."""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Iterable, List, Optional

import numpy as np


class VocabWord:
    __slots__ = ("word", "count", "index", "code", "point")

    def __init__(self, word: str, count: int = 0, index: int = -1):
        self.word = word
        self.count = count
        self.index = index
        self.code: List[int] = []      # Huffman code bits
        self.point: List[int] = []     # Huffman inner-node path

    def __repr__(self):
        return f"VocabWord({self.word!r}, count={self.count})"


class VocabCache:
    """In-memory vocab (reference AbstractCache)."""

    def __init__(self):
        self.words: Dict[str, VocabWord] = {}
        self.index2word: List[str] = []
        self.total_word_count = 0

    def add(self, word: str, count: int = 1):
        vw = self.words.get(word)
        if vw is None:
            self.words[word] = VocabWord(word, count)
        else:
            vw.count += count
        self.total_word_count += count

    def __contains__(self, word: str) -> bool:
        return word in self.words

    def __len__(self) -> int:
        return len(self.words)

    def word_for(self, index: int) -> str:
        return self.index2word[index]

    def index_of(self, word: str) -> int:
        vw = self.words.get(word)
        return vw.index if vw else -1

    def word_frequency(self, word: str) -> int:
        vw = self.words.get(word)
        return vw.count if vw else 0

    def finish(self, min_word_frequency: int = 1):
        """Trim by min frequency and index by frequency descending
        (reference VocabConstructor.buildJointVocabulary semantics)."""
        kept = {w: vw for w, vw in self.words.items()
                if vw.count >= min_word_frequency}
        ordered = sorted(kept.values(), key=lambda v: (-v.count, v.word))
        self.words = {}
        self.index2word = []
        for i, vw in enumerate(ordered):
            vw.index = i
            self.words[vw.word] = vw
            self.index2word.append(vw.word)
        self.total_word_count = sum(v.count for v in ordered)
        return self

    # --- sampling tables -------------------------------------------------
    def unigram_table(self, size: int = 1 << 20,
                      power: float = 0.75) -> np.ndarray:
        """Negative-sampling table (word2vec unigram^0.75)."""
        counts = np.array([self.words[w].count for w in self.index2word],
                          np.float64)
        probs = counts ** power
        probs /= probs.sum()
        return np.searchsorted(np.cumsum(probs),
                               np.random.default_rng(0).random(size)
                               ).astype(np.int32)

    def subsample_keep_prob(self, sample: float) -> Optional[np.ndarray]:
        """Frequent-word subsampling keep-probabilities (word2vec 'sample')."""
        if not sample or sample <= 0:
            return None
        counts = np.array([self.words[w].count for w in self.index2word],
                          np.float64)
        freq = counts / max(self.total_word_count, 1)
        keep = (np.sqrt(freq / sample) + 1) * sample / np.maximum(freq, 1e-12)
        return np.minimum(keep, 1.0)


class VocabConstructor:
    """Build a VocabCache from sequence iterables (reference VocabConstructor;
    the reference parallelizes counting across threads — here Counter is the
    hot loop and stays host-side)."""

    def __init__(self, min_word_frequency: int = 1):
        self.min_word_frequency = min_word_frequency

    def build(self, sequences: Iterable[List[str]]) -> VocabCache:
        from itertools import chain
        # one-shot count over the chained iterator: Counter's C fast path
        # runs once instead of once per sentence (the reference
        # parallelizes counting across threads; here the C loop is the
        # single-host equivalent)
        counter: Counter = Counter(chain.from_iterable(sequences))
        cache = VocabCache()
        for word, count in counter.items():
            cache.add(word, count)
        return cache.finish(self.min_word_frequency)
