"""Annotator pipeline (reference deeplearning4j-nlp-uima, 3,085 LoC:
SentenceAnnotator, TokenizerAnnotator, PoStagger, StemmerAnnotator driven by
UIMA's AnalysisEngine; SURVEY.md §2.5).

The UIMA framework's role — typed annotations over character spans produced
by a chain of analysis engines — is reproduced with plain dataclasses and a
composable pipeline; the annotator set matches what the reference's
UimaTokenizerFactory / PoStagger pipeline produced for downstream consumers.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional


# shared English punctuation strip set (sentence punctuation riding on
# whitespace tokens), used by treeparser._vector and sentiment scoring
EN_STRIP_PUNCT = ".,!?;:\"'()[]"


@dataclass
class Annotation:
    """A typed span over the document text (UIMA Annotation analog)."""
    type: str                 # "sentence" | "token" | "pos" | "stem" | ...
    begin: int
    end: int
    text: str
    features: Dict[str, str] = field(default_factory=dict)


@dataclass
class AnnotatedDocument:
    """CAS analog: source text + accumulated annotations."""
    text: str
    annotations: List[Annotation] = field(default_factory=list)

    def select(self, type_: str) -> List[Annotation]:
        return [a for a in self.annotations if a.type == type_]


def group_tokens_by_sentence(doc: "AnnotatedDocument"):
    """[(sentence, [tokens covered])] via one two-pointer sweep over the
    span-sorted annotation lists — the per-sentence select() scan was
    quadratic over large documents (shared by treeparser and sentiment)."""
    sentences = sorted(doc.select("sentence"), key=lambda a: a.begin)
    tokens = sorted(doc.select("token"), key=lambda a: a.begin)
    out = []
    i = 0
    for sent in sentences:
        while i < len(tokens) and tokens[i].begin < sent.begin:
            i += 1
        j = i
        while j < len(tokens) and tokens[j].end <= sent.end:
            j += 1
        out.append((sent, tokens[i:j]))
        i = j
    return out


class Annotator:
    def process(self, doc: AnnotatedDocument) -> None:
        raise NotImplementedError


class SentenceAnnotator(Annotator):
    """Sentence spans by terminator punctuation (reference
    uima/sentence SentenceAnnotator)."""

    _BOUNDARY = re.compile(r"[.!?。！？]+[\s$]*")

    def process(self, doc: AnnotatedDocument) -> None:
        start = 0
        for m in self._BOUNDARY.finditer(doc.text):
            end = m.end()
            chunk = doc.text[start:end].strip()
            if chunk:
                b = doc.text.index(chunk, start)
                doc.annotations.append(
                    Annotation("sentence", b, b + len(chunk), chunk))
            start = end
        tail = doc.text[start:].strip()
        if tail:
            b = doc.text.index(tail, start)
            doc.annotations.append(
                Annotation("sentence", b, b + len(tail), tail))


class TokenizerAnnotator(Annotator):
    """Token spans inside each sentence (UimaTokenizer analog); uses any
    TokenizerFactory from the tokenization module."""

    def __init__(self, tokenizer_factory=None):
        from .tokenization import DefaultTokenizerFactory
        self.tf = tokenizer_factory or DefaultTokenizerFactory()

    def process(self, doc: AnnotatedDocument) -> None:
        sentences = doc.select("sentence") or [
            Annotation("sentence", 0, len(doc.text), doc.text)]
        for sent in sentences:
            cursor = sent.begin
            for tok in self.tf.create(sent.text).get_tokens():
                found = doc.text.find(tok, cursor, sent.end)
                b = found if found >= 0 else cursor
                doc.annotations.append(
                    Annotation("token", b, b + len(tok), tok))
                if found >= 0:
                    cursor = found + len(tok)


class PosTagger(Annotator):
    """Heuristic POS tags on token annotations (reference uima PoStagger;
    suffix/lexicon rules instead of the OpenNLP model binary)."""

    _DET = {"the", "a", "an", "this", "that", "these", "those"}
    _PRON = {"i", "you", "he", "she", "it", "we", "they"}
    _BE_VERB = {"is", "are", "was", "were", "be", "been", "being", "am",
                "has", "have", "had", "do", "does", "did", "go", "goes",
                "went", "gone", "get", "gets", "got", "make", "makes",
                "made", "say", "says", "said", "see", "sees", "saw",
                "take", "takes", "took", "run", "runs", "ran", "sat",
                "sit", "sits", "came", "come", "comes"}
    _MODAL = {"can", "could", "will", "would", "shall", "should", "may",
              "might", "must"}
    _PREP = {"in", "on", "at", "by", "for", "with", "over", "under", "past",
             "to", "of", "from"}
    _CONJ = {"and", "or", "but", "nor", "so", "yet"}

    def _tag(self, word: str) -> str:
        w = word.lower()
        if w in self._BE_VERB:
            return "VB"
        if w in self._MODAL:
            return "MD"
        if w in self._DET:
            return "DT"
        if w in self._PRON:
            return "PRP"
        if w in self._PREP:
            return "IN"
        if w in self._CONJ:
            return "CC"
        if re.fullmatch(r"[0-9]+([.,][0-9]+)?", w):
            return "CD"
        if w.endswith("ly"):
            return "RB"
        if w.endswith(("ing", "ed", "es")) or w.endswith("s") and \
                len(w) > 3 and w[:-1].endswith(("e", "t", "n", "k")):
            return "VB"
        if w.endswith(("ous", "ful", "ive", "able", "al", "ic")):
            return "JJ"
        return "NN"

    def process(self, doc: AnnotatedDocument) -> None:
        for tok in doc.select("token"):
            doc.annotations.append(
                Annotation("pos", tok.begin, tok.end, tok.text,
                           {"tag": self._tag(tok.text)}))


class StemmerAnnotator(Annotator):
    """Suffix-stripping stemmer (reference StemmerAnnotator / snowball)."""

    _SUFFIXES = ("ational", "iveness", "fulness", "ization", "ations",
                 "ingly", "ation", "ness", "ment", "ing", "ed", "ly",
                 "es", "s")

    def process(self, doc: AnnotatedDocument) -> None:
        for tok in doc.select("token"):
            w = tok.text.lower()
            stem = w
            for suf in self._SUFFIXES:
                if w.endswith(suf) and len(w) - len(suf) >= 3:
                    stem = w[:-len(suf)]
                    break
            doc.annotations.append(
                Annotation("stem", tok.begin, tok.end, tok.text,
                           {"stem": stem}))


class AnnotatorPipeline:
    """AnalysisEngine chain (UIMA aggregate analog)."""

    def __init__(self, annotators: Optional[List[Annotator]] = None):
        self.annotators = annotators or [SentenceAnnotator(),
                                         TokenizerAnnotator(), PosTagger()]

    def process(self, text: str) -> AnnotatedDocument:
        doc = AnnotatedDocument(text)
        for a in self.annotators:
            a.process(doc)
        return doc
