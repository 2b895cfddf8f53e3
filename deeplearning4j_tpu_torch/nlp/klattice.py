"""Dictionary/lattice Korean tokenizer — the morphological-analyzer role
of the reference's deeplearning4j-nlp-korean (KoreanTokenizer.java:1
wraps the twitter-korean-text analyzer), built the nlp/lattice.py way:
a Viterbi lattice over a paradigm-generated morpheme dictionary
(nlp/kconj.py) with an unknown-word model, replacing the eojeol +
trailing-josa heuristic of cjk.KoreanTokenizerFactory (which remains as
the dictionary-free fallback).

Differences from the Japanese lattice that matter for Korean:

- eojeols are whitespace-delimited, so the lattice runs per eojeol and
  the connection matrix models WITHIN-eojeol morphotactics (noun→josa is
  nearly free, bos→josa is forbidden-expensive, noun→copula cheap);
- unknown runs share the hangul character class with any trailing josa,
  so the unknown model emits EVERY prefix length
  (ViterbiLattice(unknown_all_lengths=True)) and the Viterbi picks
  unknown(스마트폰)+josa(을) over one merged unknown token;
- conjugated verb/adjective surfaces are whole tokens (generated by the
  paradigms), nouns split from their josa, noun+copula splits — the same
  convention the heuristic factory and the gold corpus
  (tests/ko_gold_corpus.py) use."""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Tuple

from .cjk import KO_STRIP_PUNCT
from .kconj import generated_entries
from .lattice import ViterbiLattice, _Trie
from .tokenization import Tokenizer, TokenizerFactory, TokenPreProcess

_BOS = "bos"
_DEFAULT = 1000
_CONN: Dict[Tuple[str, str], int] = {
    (_BOS, "noun"): 200, (_BOS, "pron"): 150, (_BOS, "adv"): 200,
    (_BOS, "verb"): 350, (_BOS, "adj"): 350, (_BOS, "det"): 250,
    (_BOS, "num"): 300, (_BOS, "unknown"): 600,
    (_BOS, "josa"): 4000, (_BOS, "cop"): 4000, (_BOS, "suffix"): 3000,
    ("noun", "josa"): 50, ("noun", "cop"): 120, ("noun", "suffix"): 200,
    ("noun", "noun"): 1400, ("noun", "verb"): 1300, ("noun", "adj"): 1300,
    # a dictionary noun directly followed by an unknown run is almost
    # always a mis-split of one long loanword (아이+스크림): price it above
    # the unknown length penalty so the whole-run unknown wins
    ("noun", "unknown"): 2200,
    ("pron", "josa"): 50, ("pron", "cop"): 200, ("pron", "noun"): 900,
    ("det", "noun"): 300, ("det", "suffix"): 500,
    ("num", "suffix"): 100, ("num", "noun"): 700,
    ("suffix", "josa"): 150, ("suffix", "cop"): 300,
    ("suffix", "suffix"): 800,
    ("verb", "josa"): 900, ("adj", "josa"): 900,
    ("unknown", "josa"): 250, ("unknown", "cop"): 400,
    ("unknown", "suffix"): 500, ("unknown", "unknown"): 1800,
    ("josa", "josa"): 1500, ("josa", "noun"): 1600,
    ("josa", "verb"): 1600, ("josa", "unknown"): 1500,
    ("cop", "josa"): 800,
}


def _conn(left: str, right: str) -> int:
    return _CONN.get((left, right), _DEFAULT)


class LatticeKoreanTokenizerFactory(TokenizerFactory):
    """Lattice Korean tokenizer behind the TokenizerFactory seam.
    ``user_entries`` extends the generated dictionary with
    (surface, pos, cost) tuples."""

    def __init__(self, preprocessor: Optional[TokenPreProcess] = None,
                 user_entries: Optional[List[Tuple[str, str, int]]] = None,
                 drop_punct: bool = True):
        self.preprocessor = preprocessor
        self.drop_punct = drop_punct
        self.trie = _Trie()
        for surface, pos, cost in generated_entries():
            self.trie.insert(surface, pos, cost)
        for surface, pos, cost in (user_entries or []):
            self.trie.insert(surface, pos, cost)
        self._lattice = ViterbiLattice(self.trie, conn=_conn,
                                       unknown_all_lengths=True)

    def tokenize_with_pos(self, text: str) -> List[Tuple[str, str]]:
        text = unicodedata.normalize("NFKC", text)
        out = []
        for eojeol in text.split():
            if self.drop_punct:
                eojeol = eojeol.strip(KO_STRIP_PUNCT)
            if eojeol:
                out.extend(self._lattice.tokenize(eojeol))
        return out

    def create(self, text: str) -> Tokenizer:
        tokens = [s for s, _pos in self.tokenize_with_pos(text) if s.strip()]
        if self.preprocessor is not None:
            tokens = [self.preprocessor.pre_process(t) for t in tokens]
        return Tokenizer(tokens)

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self.preprocessor = pre
        return self
