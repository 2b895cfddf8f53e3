"""Trainable averaged-perceptron POS tagger (reference uima PoStagger role:
`.../annotator/PoStagger.java` drives a trained OpenNLP maxent model; the
rule tagger in nlp/annotators.py covers the zero-data case, this closes
the qualitative gap with a model that LEARNS from a tagged corpus).

Classic Collins-style greedy structured perceptron with weight averaging:
predict left to right using the two previous predicted tags as context,
add 1 to the gold tag's feature weights and subtract 1 from the wrongly
predicted tag's on every mistake, and return time-averaged weights so
late training noise is damped. Plain Python dictionaries — this is host
preprocessing, not device math; it feeds the same "pos" annotations the
tree parser consumes (treeparser.py:98).
"""

from __future__ import annotations

import json
import random
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .annotators import AnnotatedDocument, Annotation, Annotator, \
    group_tokens_by_sentence

START = ("-START-", "-START2-")


class AveragedPerceptron:
    """Multiclass perceptron with lazy weight averaging (the nltk/
    textbook formulation): ``_totals`` accumulates weight × survival-time
    via ``_tstamps``, so averaging is O(features touched)."""

    def __init__(self):
        self.weights: Dict[str, Dict[str, float]] = {}
        self.classes: set = set()
        self._totals: Dict[Tuple[str, str], float] = defaultdict(float)
        self._tstamps: Dict[Tuple[str, str], int] = defaultdict(int)
        self.i = 0

    def predict(self, features: Dict[str, int]) -> str:
        scores: Dict[str, float] = defaultdict(float)
        for feat, value in features.items():
            if feat not in self.weights or value == 0:
                continue
            for label, weight in self.weights[feat].items():
                scores[label] += value * weight
        # stable argmax: ties break lexicographically so decoding is
        # deterministic across runs
        return max(self.classes, key=lambda l: (scores[l], l))

    def update(self, truth: str, guess: str,
               features: Dict[str, int]) -> None:
        self.i += 1
        if truth == guess:
            return
        for feat in features:
            w = self.weights.setdefault(feat, {})
            for label, delta in ((truth, 1.0), (guess, -1.0)):
                key = (feat, label)
                self._totals[key] += (self.i - self._tstamps[key]) * \
                    w.get(label, 0.0)
                self._tstamps[key] = self.i
                w[label] = w.get(label, 0.0) + delta

    def average_weights(self) -> None:
        for feat, w in self.weights.items():
            for label in list(w):
                key = (feat, label)
                total = self._totals[key] + \
                    (self.i - self._tstamps[key]) * w[label]
                avg = total / self.i if self.i else 0.0
                if abs(avg) > 1e-12:
                    w[label] = round(avg, 6)
                else:
                    del w[label]
        self._totals.clear()
        self._tstamps.clear()


def _features(i: int, word: str, context: Sequence[str],
              prev: str, prev2: str) -> Dict[str, int]:
    """Feature templates: current word + affixes + shape, previous two
    predicted tags, and the neighboring words (context is padded with
    START/END sentinels, so i is offset by len(START))."""
    w = word.lower()
    f: Dict[str, int] = {}

    def add(name, *args):
        f[" ".join((name,) + args)] = 1

    add("bias")
    add("w", w)
    add("suf3", w[-3:])
    add("suf2", w[-2:])
    add("pre1", w[:1])
    add("t-1", prev)
    add("t-2", prev2)
    add("t-1t-2", prev, prev2)
    add("w-1", context[i - 1])
    add("w+1", context[i + 1])
    add("suf3-1", context[i - 1][-3:])
    add("suf3+1", context[i + 1][-3:])
    if w.isdigit():
        add("isdigit")
    if word[:1].isupper():
        add("istitle")
        if i > len(START):
            add("inner-title")
    return f


class PerceptronPosTagger(Annotator):
    """Drop-in replacement for the rule PosTagger: emits the same "pos"
    annotations, so `AnnotatorPipeline([..., PerceptronPosTagger.default()])`
    feeds TreeParser unchanged. Construct empty and ``train()``, or use
    ``default()`` for the model trained on the bundled mini-treebank."""

    _default_instance: Optional["PerceptronPosTagger"] = None

    def __init__(self):
        self.model = AveragedPerceptron()

    # ------------------------------------------------------------- training
    def train(self, sentences: Iterable[List[Tuple[str, str]]],
              iterations: int = 5, seed: int = 0) -> "PerceptronPosTagger":
        sents = [list(s) for s in sentences if s]
        for _, tag in (pair for s in sents for pair in s):
            self.model.classes.add(tag)
        rng = random.Random(seed)
        for _ in range(iterations):
            rng.shuffle(sents)
            for sent in sents:
                words = [w for w, _ in sent]
                context = list(START) + [w.lower() for w in words] + \
                    ["-END-", "-END2-"]
                prev, prev2 = START
                for i, (word, gold) in enumerate(sent):
                    feats = _features(i + len(START), word, context,
                                      prev, prev2)
                    guess = self.model.predict(feats)
                    self.model.update(gold, guess, feats)
                    prev2, prev = prev, guess
        self.model.average_weights()
        return self

    # ------------------------------------------------------------- tagging
    def tag(self, words: Sequence[str]) -> List[str]:
        context = list(START) + [w.lower() for w in words] + \
            ["-END-", "-END2-"]
        prev, prev2 = START
        tags = []
        for i, word in enumerate(words):
            feats = _features(i + len(START), word, context, prev, prev2)
            guess = self.model.predict(feats)
            tags.append(guess)
            prev2, prev = prev, guess
        return tags

    def accuracy(self, sentences: Iterable[List[Tuple[str, str]]]) -> float:
        right = total = 0
        for sent in sentences:
            words = [w for w, _ in sent]
            for guess, (_, gold) in zip(self.tag(words), sent):
                right += guess == gold
                total += 1
        return right / max(total, 1)

    def process(self, doc: AnnotatedDocument) -> None:
        for _, toks in group_tokens_by_sentence(doc):
            if not toks:
                continue
            for tok, tag in zip(toks, self.tag([t.text for t in toks])):
                doc.annotations.append(
                    Annotation("pos", tok.begin, tok.end, tok.text,
                               {"tag": tag}))

    # -------------------------------------------------------- persistence
    def to_json(self) -> str:
        return json.dumps({"classes": sorted(self.model.classes),
                           "weights": self.model.weights})

    @classmethod
    def from_json(cls, blob: str) -> "PerceptronPosTagger":
        data = json.loads(blob)
        tagger = cls()
        tagger.model.classes = set(data["classes"])
        tagger.model.weights = data["weights"]
        return tagger

    @classmethod
    def default(cls) -> "PerceptronPosTagger":
        """Tagger trained on the bundled mini-treebank (cached; training
        takes ~100 ms)."""
        if cls._default_instance is None:
            from .mini_treebank import TRAIN
            cls._default_instance = cls().train(TRAIN, iterations=8)
        return cls._default_instance
