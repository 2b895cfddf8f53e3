"""Text pipeline: tokenizers, sentence iterators, preprocessors (reference
text/tokenization/ + text/sentenceiterator/: DefaultTokenizer,
NGramTokenizer, CommonPreprocessor, Basic/LineSentenceIterator,
CollectionSentenceIterator, LabelAware variants; SURVEY.md §2.5)."""

from __future__ import annotations

import re
from pathlib import Path
from typing import Iterable, Iterator, List, Optional


class TokenPreProcess:
    def pre_process(self, token: str) -> str:
        return token


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation (reference CommonPreprocessor)."""
    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


class Tokenizer:
    def __init__(self, tokens: List[str],
                 preprocessor: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._pre = preprocessor

    def get_tokens(self) -> List[str]:
        if self._pre is None:
            return [t for t in self._tokens if t]
        out = [self._pre.pre_process(t) for t in self._tokens]
        return [t for t in out if t]

    def count_tokens(self) -> int:
        return len(self.get_tokens())


class TokenizerFactory:
    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self._pre = pre
        return self


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenizer (reference DefaultTokenizerFactory)."""

    def __init__(self, preprocessor: Optional[TokenPreProcess] = None):
        self._pre = preprocessor

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(text.split(), self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    """Word n-grams (reference NGramTokenizerFactory)."""

    def __init__(self, n_min: int = 1, n_max: int = 2,
                 preprocessor: Optional[TokenPreProcess] = None):
        self.n_min = n_min
        self.n_max = n_max
        self._pre = preprocessor

    def create(self, text: str) -> Tokenizer:
        words = text.split()
        tokens = []
        for n in range(self.n_min, self.n_max + 1):
            for i in range(len(words) - n + 1):
                tokens.append(" ".join(words[i:i + n]))
        return Tokenizer(tokens, self._pre)


# --- sentence iterators -------------------------------------------------------

class SentenceIterator:
    def __iter__(self) -> Iterator[str]:
        raise NotImplementedError

    def reset(self):
        pass


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Iterable[str]):
        self._sentences = list(sentences)

    def __iter__(self):
        return iter(self._sentences)


class LineSentenceIterator(SentenceIterator):
    """One sentence per line from a file (reference LineSentenceIterator)."""

    def __init__(self, path):
        self.path = Path(path)

    def __iter__(self):
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line


class BasicLineIterator(LineSentenceIterator):
    pass


class LabelAwareSentenceIterator(SentenceIterator):
    """(label, sentence) pairs (reference LabelAwareSentenceIterator)."""

    def __init__(self, labelled: Iterable):
        self._items = list(labelled)

    def __iter__(self):
        return iter(s for _, s in self._items)

    def labelled(self):
        return iter(self._items)


STOP_WORDS = set("""a an and are as at be but by for if in into is it no not
of on or such that the their then there these they this to was will with"""
                 .split())


class StopWords:
    @staticmethod
    def get_stop_words() -> List[str]:
        return sorted(STOP_WORDS)
