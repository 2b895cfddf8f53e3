"""Japanese/Korean tokenization (reference deeplearning4j-nlp-japanese —
vendored Kuromoji, com/atilika/kuromoji, 6,786 LoC — and
deeplearning4j-nlp-korean's tokenizer wrapper; SURVEY.md §2.5).

The reference vendors a dictionary-based morphological analyzer. Shipping a
full IPADIC is out of scope here, so these factories implement
dictionary-free segmentation behind the SAME TokenizerFactory seam, which is
the capability boundary the rest of the stack (SequenceVectors, vectorizers,
iterators) consumes:

- Japanese: runs of the same character class (kanji / hiragana / katakana /
  latin / digits) become tokens, with hiragana runs further split so common
  particles (は が を に で と の も へ や) separate — a standard
  lightweight approximation of morpheme boundaries.
- Korean: whitespace eojeol segmentation with optional trailing-particle
  (josa) stripping.

These are the dictionary-FREE fallbacks; the dictionary/lattice analyzers
live in nlp/lattice.py (Japanese) and nlp/klattice.py (Korean, over the
paradigm-generated morpheme dictionary of nlp/kconj.py). A user with an
external analyzer can plug it in via the TokenizerFactory interface
unchanged.
"""

from __future__ import annotations

import unicodedata
from typing import List, Optional

from .tokenization import Tokenizer, TokenizerFactory, TokenPreProcess


def _char_class(ch: str) -> str:
    code = ord(ch)
    if 0x3040 <= code <= 0x309F:
        return "hiragana"
    if 0x30A0 <= code <= 0x30FF or code == 0x30FC:
        return "katakana"
    if 0x4E00 <= code <= 0x9FFF or 0x3400 <= code <= 0x4DBF:
        return "kanji"
    if 0xAC00 <= code <= 0xD7A3 or 0x1100 <= code <= 0x11FF or \
            0x3130 <= code <= 0x318F:
        return "hangul"
    if ch.isdigit():
        return "digit"
    if ch.isalpha():
        return "latin"
    if ch.isspace():
        return "space"
    return "punct"


_JA_PARTICLES = set("はがをにでとのもへやね")


class JapaneseTokenizerFactory(TokenizerFactory):
    """Character-class run segmentation (Kuromoji-role stand-in)."""

    def __init__(self, preprocessor: Optional[TokenPreProcess] = None,
                 split_particles: bool = True):
        self.pre = preprocessor
        self.split_particles = split_particles

    def create(self, text: str) -> Tokenizer:
        text = unicodedata.normalize("NFKC", text)
        tokens: List[str] = []
        run, run_cls = "", None
        for ch in text + "\0":
            cls = _char_class(ch) if ch != "\0" else None
            if cls != run_cls or (
                    self.split_particles and cls == "hiragana"
                    and ch in _JA_PARTICLES):
                if run and run_cls not in ("space", "punct"):
                    tokens.append(run)
                run, run_cls = "", cls
                if self.split_particles and cls == "hiragana" \
                        and ch in _JA_PARTICLES:
                    tokens.append(ch)
                    run_cls = None
                    continue
            run += ch
        return Tokenizer(tokens, self.pre)

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self.pre = pre


_KO_JOSA = ("은", "는", "이", "가", "을", "를", "의", "에", "와", "과",
            "도", "로", "으로", "에서", "부터", "까지", "마저", "조차")

# shared by the heuristic factory here and the lattice factory
# (nlp/klattice.py) so the two Korean tokenizers strip identically
KO_STRIP_PUNCT = ".,!?·…\"'()[]~"


class KoreanTokenizerFactory(TokenizerFactory):
    """Eojeol (whitespace) segmentation with optional josa stripping."""

    def __init__(self, preprocessor: Optional[TokenPreProcess] = None,
                 strip_josa: bool = True):
        self.pre = preprocessor
        self.strip_josa = strip_josa

    def create(self, text: str) -> Tokenizer:
        tokens = []
        for eojeol in unicodedata.normalize("NFKC", text).split():
            word = eojeol.strip(KO_STRIP_PUNCT)
            if not word:
                continue
            if self.strip_josa and len(word) > 1:
                for josa in sorted(_KO_JOSA, key=len, reverse=True):
                    if word.endswith(josa) and len(word) > len(josa):
                        stem = word[:-len(josa)]
                        tokens.extend([stem, josa])
                        break
                else:
                    tokens.append(word)
            else:
                tokens.append(word)
        return Tokenizer(tokens, self.pre)

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self.pre = pre
