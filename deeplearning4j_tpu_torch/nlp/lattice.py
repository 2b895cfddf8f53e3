"""Dictionary/lattice Japanese tokenizer — the Kuromoji-class analyzer the
reference vendors (deeplearning4j-nlp-japanese, com/atilika/kuromoji,
6,786 LoC: ViterbiBuilder/ViterbiSearcher over a dictionary lattice with
an unknown-word model). Same architecture, Python-native:

1. build a lattice over the sentence: at every position, every dictionary
   entry matching as a prefix (trie lookup) opens an edge, and the
   unknown-word model opens edges over runs of a single character class
   (kanji / hiragana / katakana / latin / digit), exactly Kuromoji's
   CharacterDefinition grouping;
2. Viterbi minimizes total cost = word costs + POS-pair connection costs
   (a small hand-tuned matrix standing in for IPADIC's matrix.def);
3. the best path's surfaces are the tokens.

Exposed behind the same TokenizerFactory seam the rest of the NLP stack
consumes (SequenceVectors, vectorizers, iterators), like
JapaneseTokenizerFactory's char-class approximation which remains as the
dictionary-free fallback."""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Tuple

from .cjk import _char_class
from .jdict import default_entries
from .tokenization import Tokenizer, TokenizerFactory, TokenPreProcess

_BOS = "bos"
_UNK_BASE_COST = 6000
_UNK_LEN_COST = 1500

# Connection costs (matrix.def role): row = left POS, col = right POS.
# Encodes the few constraints that matter for everyday segmentation:
# particles chain badly, nouns take particles cheaply, aux follows verbs.
_DEFAULT_CONN = 800
_CONN: Dict[Tuple[str, str], int] = {
    (_BOS, "particle"): 3000, (_BOS, "aux"): 3000,
    (_BOS, "noun"): 200, (_BOS, "pron"): 100, (_BOS, "verb"): 400,
    (_BOS, "adv"): 300, (_BOS, "adj"): 300,
    ("particle", "particle"): 3500, ("particle", "aux"): 2500,
    ("particle", "noun"): 200, ("particle", "verb"): 200,
    ("particle", "pron"): 300, ("particle", "adj"): 300,
    ("particle", "adv"): 300,
    ("noun", "particle"): 100, ("noun", "aux"): 600,
    ("noun", "noun"): 1200, ("noun", "suffix"): 150,
    ("pron", "particle"): 100,
    ("verb", "particle"): 400, ("verb", "aux"): 100,
    ("verb", "noun"): 900,
    ("aux", "aux"): 300, ("aux", "particle"): 500,
    ("adj", "noun"): 300, ("adj", "particle"): 500, ("adj", "aux"): 300,
    ("adv", "verb"): 200, ("adv", "adj"): 300,
    ("suffix", "particle"): 200,
    ("unknown", "particle"): 300, ("unknown", "aux"): 600,
    ("particle", "unknown"): 300, (_BOS, "unknown"): 500,
    ("unknown", "unknown"): 1500,
}


class _Trie:
    __slots__ = ("children", "entries")

    def __init__(self):
        self.children: Dict[str, "_Trie"] = {}
        self.entries: List[Tuple[str, str, int]] = []

    def insert(self, surface: str, pos: str, cost: int):
        node = self
        for ch in surface:
            node = node.children.setdefault(ch, _Trie())
        node.entries.append((surface, pos, cost))

    def prefixes(self, text: str, start: int):
        """Yield dictionary entries matching text[start:] as prefixes."""
        node = self
        i = start
        while i < len(text):
            node = node.children.get(text[i])
            if node is None:
                return
            i += 1
            for e in node.entries:
                yield e


def _conn(left: str, right: str) -> int:
    return _CONN.get((left, right), _DEFAULT_CONN)


class ViterbiLattice:
    """Minimal-cost segmentation of one sentence over a morpheme trie.

    ``conn``: POS-pair connection-cost function (defaults to the Japanese
    matrix; the Korean lattice passes its own). ``unknown_all_lengths``:
    emit every prefix of the unknown run, not just {1, full} — needed for
    agglutinative scripts where a trailing particle shares the unknown
    run's character class (스마트폰을 → unknown(스마트폰) + josa(을))."""

    def __init__(self, trie: _Trie, max_unk_len: int = 8, conn=None,
                 unknown_all_lengths: bool = False):
        self.trie = trie
        self.max_unk_len = max_unk_len
        self.conn = conn or _conn
        self.unknown_all_lengths = unknown_all_lengths

    def _unknown_edges(self, text: str, i: int):
        """Unknown-word candidates: prefixes of the same-char-class run
        starting at i (Kuromoji's unknown-word grouping)."""
        cls = _char_class(text[i])
        end = i + 1
        while end < len(text) and end - i < self.max_unk_len and \
                _char_class(text[end]) == cls:
            end += 1
        if self.unknown_all_lengths:
            lens = range(1, end - i + 1)
        else:
            # the full run and single char (the two useful granularities)
            lens = sorted({1, end - i})
        for ln in lens:
            yield (text[i:i + ln], "unknown",
                   _UNK_BASE_COST + _UNK_LEN_COST * (ln - 1))

    def tokenize(self, text: str) -> List[Tuple[str, str]]:
        """→ [(surface, pos)] of the minimal-cost path. States are keyed
        by (position, POS) — keeping only one state per position would
        prune paths whose cheaper connection cost pays off later, exactly
        why Kuromoji's lattice nodes carry their POS."""
        n = len(text)
        if n == 0:
            return []
        # states[j]: pos -> (cost, (prev_index, prev_pos, surface))
        states: List[Dict[str, Tuple]] = [dict() for _ in range(n + 1)]
        states[0][_BOS] = (0.0, None)
        for i in range(n):
            if not states[i]:
                continue
            cands = list(self.trie.prefixes(text, i))
            cands.extend(self._unknown_edges(text, i))
            for surface, pos, wcost in cands:
                j = i + len(surface)
                for lpos, (lcost, _bp) in states[i].items():
                    c = lcost + wcost + self.conn(lpos, pos)
                    cur = states[j].get(pos)
                    if cur is None or c < cur[0]:
                        states[j][pos] = (c, (i, lpos, surface))
        end = states[n]        # always reachable: length-1 unknown edges
        pos = min(end, key=lambda p: end[p][0])
        out = []
        j = n
        while j > 0:
            _c, (i, lpos, surface) = states[j][pos]
            out.append((surface, pos))
            j, pos = i, lpos
        return list(reversed(out))


class LatticeJapaneseTokenizerFactory(TokenizerFactory):
    """Dictionary/lattice Japanese tokenizer behind the TokenizerFactory
    seam (the Kuromoji JapaneseTokenizer role). ``user_entries`` extends
    the vendored dictionary with (surface, pos, cost) tuples."""

    def __init__(self, preprocessor: Optional[TokenPreProcess] = None,
                 user_entries: Optional[List[Tuple[str, str, int]]] = None,
                 drop_whitespace: bool = True):
        self.preprocessor = preprocessor
        self.drop_whitespace = drop_whitespace
        self.trie = _Trie()
        for surface, pos, cost in default_entries():
            self.trie.insert(surface, pos, cost)
        for surface, pos, cost in (user_entries or []):
            self.trie.insert(surface, pos, cost)
        self._lattice = ViterbiLattice(self.trie)

    def tokenize_with_pos(self, text: str) -> List[Tuple[str, str]]:
        # NFKC first, like the char-class factory: half-width katakana and
        # full-width latin/digits must hit the same dictionary entries
        text = unicodedata.normalize("NFKC", text)
        out = []
        for chunk in text.split():
            out.extend(self._lattice.tokenize(chunk))
        return out

    def create(self, text: str) -> Tokenizer:
        tokens = [s for s, _pos in self.tokenize_with_pos(text)
                  if s.strip() or not self.drop_whitespace]
        if self.preprocessor is not None:
            tokens = [self.preprocessor.pre_process(t) for t in tokens]
        return Tokenizer(tokens)

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self.preprocessor = pre
        return self
