"""SequenceVectors: the generic embedding trainer, the counterpart of the
JAX package's ``nlp/sequence_vectors.py`` (reference
models/sequencevectors/SequenceVectors.java — vocab build :103,
AsyncSequencer prefetch :996, VectorCalculationsThread workers :1101,
pluggable learning algorithms :161-168; SURVEY.md §2.5, §3.5).

The reference's thread pool + native AggregateSkipGram becomes a host-side
pair generator feeding fixed-size batches into one step on the tables'
device (skipgram.py), or, for a large single-objective skip-gram chunk, a
loop of scan steps over the corpus staged on the device once. Elements
learning algorithms: skipgram | cbow; both HS and negative sampling;
word2vec's linear lr decay over total expected words.

The tables live on ``device`` (``None``: the CUDA card, raising without
one; ``"cpu"`` runs the same code on the CPU). They start from the same
numpy generator as the JAX package's, so both packages begin bitwise
equal; every randomness drawn on the device comes from a generator
seeded with (seed, chunk, absolute step or batch) and differs from JAX's
threefry bits by design. Training never reads back to the host inside
the loop: the loss is read once, at the end of :meth:`SequenceVectors.fit`."""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..ops.platform import resolve_device
from ..ops.rng import fold_in
from .huffman import apply_huffman, pad_codes
from .skipgram import (skipgram_hs_step, skipgram_ns_step_rng, cbow_hs_step,
                       cbow_ns_step_rng, skipgram_hs_corpus_scan,
                       skipgram_ns_corpus_scan, vectorized_skipgram_pairs,
                       vectorized_cbow_windows)
from .vocab import VocabCache, VocabConstructor


def _stage_corpus(padded: np.ndarray, device):
    """The scan path's corpus on the device: the (int16 / int32)
    pre-padded corpus crosses once and is widened there, and the
    separator prefix sum is computed there."""
    corpus_d = torch.from_numpy(padded).to(device).long()
    return corpus_d, torch.cumsum((corpus_d < 0).long(), dim=0)


def _as_table(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.tensor(np.asarray(a, np.float32), device=device)


class InMemoryLookupTable:
    """syn0/syn1/syn1neg tables (reference
    models/embeddings/inmemory/InMemoryLookupTable)."""

    def __init__(self, vocab: VocabCache, vector_length: int, seed: int = 42,
                 use_hs: bool = True, negative: int = 0, device="cpu"):
        self.vocab = vocab
        self.vector_length = vector_length
        self.device = torch.device(device)
        V = len(vocab)
        rng = np.random.default_rng(seed)
        # word2vec init distribution (uniform(-0.5, 0.5)/dim), drawn on the
        # host in f32 exactly as the JAX package draws it
        self.syn0 = _as_table((rng.random((V, vector_length), np.float32)
                               - 0.5) / vector_length, self.device)
        self.syn1 = torch.zeros((max(V - 1, 1), vector_length),
                                device=self.device) if use_hs else None
        self.syn1neg = torch.zeros((V, vector_length), device=self.device) \
            if negative > 0 else None
        self._host = None

    @classmethod
    def from_arrays(cls, syn0, syn1=None, syn1neg=None, vocab=None,
                    device="cpu") -> "InMemoryLookupTable":
        """A table holding copies of given arrays (numpy, or a JAX model's
        tables through ``np.asarray``) on ``device``."""
        lt = cls.__new__(cls)
        lt.vocab = vocab
        lt.device = torch.device(device)
        lt.syn0 = _as_table(syn0, lt.device)
        lt.vector_length = int(lt.syn0.shape[1])
        lt.syn1 = _as_table(syn1, lt.device)
        lt.syn1neg = _as_table(syn1neg, lt.device)
        lt._host = None
        return lt

    def host_syn0(self) -> np.ndarray:
        """syn0 on the host, read back once per version of the table (an
        in-place update or a new tensor reads it again)."""
        t = self.syn0
        if self._host is None or self._host[0] is not t or \
                self._host[1] != t._version:
            self._host = (t, t._version,
                          t.detach().to("cpu", copy=True).numpy())
        return self._host[2]

    def vector(self, word: str) -> Optional[np.ndarray]:
        idx = self.vocab.index_of(word)
        if idx < 0:
            return None
        return self.host_syn0()[idx].copy()


class SequenceVectors:
    def __init__(self, vector_length: int = 100, window: int = 5,
                 min_word_frequency: int = 1, learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4, epochs: int = 1,
                 negative: int = 0, use_hierarchic_softmax: bool = True,
                 sample: float = 0.0, batch_size: int = 2048,
                 elements_algorithm: str = "skipgram", seed: int = 42,
                 shared_negatives: bool = True,
                 scan_min_tokens: Optional[int] = None, device=None):
        self.vector_length = vector_length
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.epochs = epochs
        self.negative = negative
        self.use_hs = use_hierarchic_softmax or negative == 0
        self.sample = sample
        self.batch_size = batch_size
        self.elements_algorithm = elements_algorithm
        self.seed = seed
        # Negative-sampling variance tradeoff: the corpus scan (used at
        # >= scan_min_tokens) defaults to ONE set of k negatives per scan
        # step shared across the step's pairs, while the per-batch path
        # draws per-pair negatives. shared_negatives=False forces per-pair
        # draws in the scan too; scan_min_tokens moves the switchover.
        self.shared_negatives = bool(shared_negatives)
        if scan_min_tokens is not None:
            self.SCAN_MIN_TOKENS = int(scan_min_tokens)
        self.device = resolve_device(device)
        self.vocab: Optional[VocabCache] = None
        self.lookup: Optional[InMemoryLookupTable] = None
        self._codes = self._points = self._lengths = None
        self._neg_table = None
        self._neg_table_dev = None

    # ------------------------------------------------------------------ fit
    def build_vocab(self, sequences: Iterable[List[str]]):
        self.vocab = VocabConstructor(self.min_word_frequency).build(sequences)
        if self.use_hs:
            apply_huffman(self.vocab)
            codes, points, lengths = pad_codes(self.vocab)
            self._codes = torch.from_numpy(codes).to(self.device)
            self._points = torch.from_numpy(points).to(self.device).long()
            self._lengths = torch.from_numpy(lengths).to(self.device).long()
        if self.negative > 0:
            self._neg_table = self.vocab.unigram_table()
            self._neg_table_dev = torch.from_numpy(self._neg_table).to(
                self.device).long()
        self.lookup = InMemoryLookupTable(self.vocab, self.vector_length,
                                          self.seed, self.use_hs,
                                          self.negative, self.device)
        return self

    # tokens per vectorized chunk: bounds host memory for the pair set
    # (~chunk * 2*window pairs in flight)
    CHUNK_TOKENS = 2_000_000

    def _index_chunks(self, sequences: Sequence[List[str]]):
        """Yield the corpus as int32 index streams with ``-1`` sentence
        separators (windows never cross a separator), in whole-sentence
        chunks of ~CHUNK_TOKENS so arbitrarily large corpora stream.
        Out-of-vocab words are DROPPED, never turned into separators: a
        trimmed word must not break window adjacency, matching the
        reference's vocab-filtered iteration."""
        lookup = {w: vw.index for w, vw in self.vocab.words.items()}
        # "\x00" is the interleaved separator sentinel (a pathological real
        # vocab word "\x00" would be treated as a separator)
        lookup["\x00"] = -1
        batch: List[List[str]] = []
        size = raw = 0
        for seq in sequences:
            batch.append(seq)
            size += len(seq)        # chunk threshold: tokens
            raw += len(seq) + 1
            if size >= self.CHUNK_TOKENS:
                yield self._index_batch(batch, lookup, raw)
                batch, size, raw = [], 0, 0
        if batch:
            yield self._index_batch(batch, lookup, raw)

    @staticmethod
    def _index_batch(batch, lookup, count) -> np.ndarray:
        from itertools import chain
        get = lookup.get
        it = chain.from_iterable(chain(s, ("\x00",)) for s in batch)
        arr = np.fromiter((get(w, -2) for w in it), np.int32, count=count)
        return arr[arr != -2]                     # drop out-of-vocab words

    def fit(self, sequences: Sequence[List[str]]):
        """Train over the corpus (reference SequenceVectors.fit).

        Vectorized corpus-wide window extraction (one numpy pass per window
        offset), shuffled fixed-size batches and one step per batch with
        negatives drawn on the device — or, for a single-objective
        skip-gram chunk of at least SCAN_MIN_TOKENS tokens, the corpus scan
        in corpus order. No host sync inside the loop."""
        if self.vocab is None:
            self.build_vocab(sequences)
        rng = np.random.default_rng(self.seed)
        keep = self.vocab.subsample_keep_prob(self.sample)
        total = max(self.vocab.total_word_count * self.epochs, 1)
        seen = 0
        loss = None
        chunk_id = 0
        for epoch in range(self.epochs):
            for corpus in self._index_chunks(sequences):
                if keep is not None and len(corpus):
                    m = rng.random(len(corpus)) < np.where(
                        corpus >= 0, keep[np.maximum(corpus, 0)], 1.0)
                    corpus = corpus[m]
                ntokens = int((corpus >= 0).sum())
                nskey = fold_in(self.seed, chunk_id)
                chunk_id += 1
                if self.elements_algorithm == "cbow":
                    tgt, ctx, cmask = vectorized_cbow_windows(
                        corpus, self.window, rng)
                    perm = rng.permutation(len(tgt))
                    loss = self._run_cbow(tgt[perm], ctx[perm], cmask[perm],
                                          seen, ntokens, total, nskey)
                elif (self.use_hs and self.negative > 0) or \
                        ntokens < self.SCAN_MIN_TOKENS:
                    # combined HS+NS, or a small corpus: per-batch path with
                    # globally shuffled pairs
                    c, t = vectorized_skipgram_pairs(corpus, self.window,
                                                     rng)
                    perm = rng.permutation(len(c))
                    loss = self._run_skipgram(c[perm], t[perm], seen,
                                              ntokens, total, nskey)
                else:
                    # single-objective skip-gram at scale: the whole chunk
                    # trains as scan steps in corpus order (word2vec.c's)
                    loss = self._run_skipgram_scan(corpus, seen, ntokens,
                                                   total, nskey)
                seen += ntokens
        if loss is not None:
            self._last_loss = float(loss)   # one sync, at the end
        return self

    def _lr_now(self, seen: float, total: int) -> float:
        """word2vec linear decay by tokens seen."""
        frac = min(seen / max(total, 1), 1.0)
        return max(self.learning_rate * (1.0 - frac), self.min_learning_rate)

    def _lr32(self, seen: float, total: int) -> float:
        """:meth:`_lr_now` rounded to f32, as the JAX steps receive it."""
        return float(np.float32(self._lr_now(seen, total)))

    @staticmethod
    def _pad(a: np.ndarray, size: int) -> np.ndarray:
        if len(a) == size:
            return a
        pad = np.zeros((size - len(a),) + a.shape[1:], a.dtype)
        return np.concatenate([a, pad])
        # padded entries train word 0 on itself once per epoch, as the
        # JAX package's fixed-shape batches do

    def _batches(self, arrays, B: int, index: bool = True):
        """Stage ``arrays`` (host, one row per example) on the device once,
        padded to whole batches of ``B`` rows as :meth:`_pad` pads the
        last, and return (number of batches, the staged tensors)."""
        n = len(arrays[0])
        nb = (n + B - 1) // B
        staged = []
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(
                self._pad(a, nb * B))).to(self.device)
            staged.append(t.long() if index and a.dtype.kind == "i" else t)
        return nb, staged

    # corpora below this size train via the shuffled per-batch path; the
    # corpus scan pays off where per-batch transfers dominate
    SCAN_MIN_TOKENS = 100_000

    def _run_skipgram_scan(self, corpus, seen, ntokens, total, nskey):
        """Whole-chunk skip-gram as scan steps: the corpus crosses to the
        device once (2 bytes a token below 2^15 words) instead of pairs per
        batch. Each scan step covers ~batch_size/(2·window) center
        positions, so the number of updates an epoch matches the per-batch
        path's — one giant step would under-train small corpora."""
        lt = self.lookup
        window = self.window
        p = max(32, self.batch_size // (2 * window))
        n = len(corpus)
        n_steps = max((n + p - 1) // p, 1)
        wire = np.int16 if len(self.vocab) < 2 ** 15 else np.int32
        padded = np.full((n_steps * p + 2 * window,), -1, wire)
        padded[window:window + n] = corpus
        corpus_d, sep_d = _stage_corpus(padded, self.device)
        frac0 = seen / max(total, 1)
        frac_per_step = (ntokens / max(total, 1)) / n_steps
        lr0, lr_min = self.learning_rate, self.min_learning_rate
        if self.negative > 0:
            _, _, ls, c = skipgram_ns_corpus_scan(
                lt.syn0, lt.syn1neg, corpus_d, sep_d, self._neg_table_dev,
                nskey, 0, lr0, lr_min, frac0, frac_per_step, k=self.negative,
                window=window, n_steps=n_steps, p=p,
                shared_negatives=self.shared_negatives)
        else:
            _, _, ls, c = skipgram_hs_corpus_scan(
                lt.syn0, lt.syn1, corpus_d, sep_d, self._codes, self._points,
                self._lengths, nskey, 0, lr0, lr_min, frac0, frac_per_step,
                window=window, n_steps=n_steps, p=p)
        return ls / torch.clamp(c, min=1.0)   # read at the end of fit

    def _run_skipgram(self, centers, targets, seen, ntokens, total, nskey):
        B = self.batch_size
        lt = self.lookup
        loss = None
        nb, (cs, ts) = self._batches((centers, targets), B)
        gen = torch.Generator(device=self.device) if self.negative > 0 \
            else None
        for i in range(nb):
            c, t = cs[i * B:(i + 1) * B], ts[i * B:(i + 1) * B]
            lr = self._lr32(seen + ntokens * i / nb, total)
            if self.use_hs:
                _, _, loss = skipgram_hs_step(
                    lt.syn0, lt.syn1, c, t, self._codes[t],
                    self._points[t], self._lengths[t], lr)
            if self.negative > 0:
                gen.manual_seed(fold_in(nskey, i))
                _, _, loss = skipgram_ns_step_rng(
                    lt.syn0, lt.syn1neg, c, t, self._neg_table_dev, gen, lr,
                    self.negative)
        return loss

    def _run_cbow(self, targets, contexts, cmasks, seen, ntokens, total,
                  nskey):
        B = self.batch_size
        lt = self.lookup
        loss = None
        nb, (ts, ctxs, cms) = self._batches((targets, contexts, cmasks), B)
        gen = torch.Generator(device=self.device) if self.negative > 0 \
            else None
        for i in range(nb):
            t = ts[i * B:(i + 1) * B]
            ctx = ctxs[i * B:(i + 1) * B]
            cm = cms[i * B:(i + 1) * B]
            lr = self._lr32(seen + ntokens * i / nb, total)
            if self.use_hs:
                _, _, loss = cbow_hs_step(
                    lt.syn0, lt.syn1, ctx, cm, t, self._codes[t],
                    self._points[t], self._lengths[t], lr)
            if self.negative > 0:
                gen.manual_seed(fold_in(nskey, i))
                _, _, loss = cbow_ns_step_rng(
                    lt.syn0, lt.syn1neg, ctx, cm, t, self._neg_table_dev,
                    gen, lr, self.negative)
        return loss

    # ------------------------------------------------------------ query API
    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        return self.lookup.vector(word)

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.lookup.vector(a), self.lookup.vector(b)
        if va is None or vb is None:
            return float("nan")
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / denom) if denom else 0.0

    def words_nearest(self, word: str, n: int = 10) -> List[str]:
        v = self.lookup.vector(word)
        if v is None:
            return []
        syn0 = self.lookup.host_syn0()
        norms = np.linalg.norm(syn0, axis=1) * np.linalg.norm(v)
        sims = syn0 @ v / np.maximum(norms, 1e-12)
        idx = self.vocab.index_of(word)
        sims[idx] = -np.inf
        top = np.argsort(-sims)[:n]
        return [self.vocab.word_for(int(i)) for i in top]
