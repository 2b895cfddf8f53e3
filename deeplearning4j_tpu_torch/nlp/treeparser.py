"""Constituency tree parsing + vectorization over the annotator pipeline
(reference deeplearning4j-nlp-uima corpora/treeparser: TreeParser.java:1
drives an OpenNLP chunker into Tree objects; BinarizeTreeTransformer.java:1
left-factors n-ary nodes; CollapseUnaries.java:1; HeadWordFinder.java:1
applies Collins-style head rules; TreeVectorizer.java:1 = parse →
binarize → collapse-unaries → word vectors at the leaves, feeding the
recursive-autoencoder/RNTN layers).

This implementation replaces OpenNLP with a rule-based shallow parser
over the repo's own annotator pipeline (nlp/annotators.py): tokens + POS
tags chunk into NP/VP/PP/ADJP phrases, PP absorbs its object NP, VP
absorbs following argument phrases, and the sentence closes over the
top-level constituents. The downstream surface is the reference's:
``TreeVectorizer.get_trees(text)`` returns binarized, unary-collapsed
trees with per-leaf word vectors, and ``get_trees_with_labels`` stamps a
gold label on every node the way the RNTN trainers expect."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .annotators import EN_STRIP_PUNCT, AnnotatorPipeline


@dataclass
class Tree:
    """Constituency node (reference recursive/Tree.java essentials):
    phrase/POS ``label``, children (empty = leaf), covered ``value``
    text, character span, optional head word, per-node vector and gold
    label for the vectorizer."""
    label: str
    children: List["Tree"] = field(default_factory=list)
    value: str = ""
    begin: int = 0
    end: int = 0
    head_word: str = ""
    vector: Optional[np.ndarray] = None
    gold_label: Optional[str] = None

    def is_leaf(self) -> bool:
        return not self.children

    def is_pre_terminal(self) -> bool:
        return len(self.children) == 1 and self.children[0].is_leaf()

    def yield_leaves(self) -> List["Tree"]:
        if self.is_leaf():
            return [self]
        out: List[Tree] = []
        for c in self.children:
            out.extend(c.yield_leaves())
        return out

    def tokens(self) -> List[str]:
        return [leaf.value for leaf in self.yield_leaves()]

    def depth(self) -> int:
        if self.is_leaf():
            return 0
        return 1 + max(c.depth() for c in self.children)

    def all_nodes(self) -> List["Tree"]:
        out = [self]
        for c in self.children:
            out.extend(c.all_nodes())
        return out

    def to_bracket(self) -> str:
        """(S (NP (DT the) (NN dog)) ...) — Penn-style rendering."""
        if self.is_leaf():
            return self.value
        inner = " ".join(c.to_bracket() for c in self.children)
        return f"({self.label} {inner})"


# ---------------------------------------------------------------- parser

_NOUNISH = {"NN", "NNS", "NNP", "NNPS", "PRP", "CD"}
_ADJISH = {"JJ", "JJR", "JJS"}
_VERBISH = {"VB", "VBD", "VBZ", "VBP", "VBG", "VBN", "MD"}


class TreeParser:
    """Shallow constituency parser (reference TreeParser.java role):
    chunk tokens into NP/VP/PP/ADJP by POS pattern, then attach PP
    objects and VP arguments. Any TokenizerFactory-compatible pipeline
    can be passed; the default is the annotator pipeline with the
    heuristic POS tagger."""

    def __init__(self, pipeline: Optional[AnnotatorPipeline] = None):
        self.pipeline = pipeline or AnnotatorPipeline()

    def get_trees(self, text: str) -> List[Tree]:
        doc = self.pipeline.process(text)
        pos_by_span = {(a.begin, a.end): a.features.get("tag", "NN")
                       for a in doc.select("pos")}
        from .annotators import group_tokens_by_sentence
        trees = []
        for sent, toks in group_tokens_by_sentence(doc):
            if not toks:
                continue
            leaves = []
            for t in toks:
                tag = pos_by_span.get((t.begin, t.end), "NN")
                leaf = Tree(tag, [Tree(t.text, value=t.text,
                                       begin=t.begin, end=t.end)],
                            value=t.text, begin=t.begin, end=t.end)
                leaves.append(leaf)
            trees.append(self._parse_sentence(leaves, sent.begin, sent.end))
        return trees

    def get_trees_with_labels(self, text: str, label: str,
                              labels: Sequence[str]) -> List[Tree]:
        """Trees with ``gold_label`` stamped on every node (the RNTN
        training contract of TreeParser.getTreesWithLabels); ``label``
        must be one of ``labels`` (NONE is always allowed)."""
        allowed = list(labels)
        if "NONE" not in allowed:
            allowed.append("NONE")
        if label not in allowed:
            raise ValueError(f"label {label!r} not in {allowed}")
        trees = self.get_trees(text)
        for t in trees:
            for node in t.all_nodes():
                node.gold_label = label
        return trees

    @staticmethod
    def _phrase(label, kids):
        return Tree(label, kids, value=" ".join(k.value for k in kids),
                    begin=kids[0].begin, end=kids[-1].end)

    def _parse_sentence(self, pre: List[Tree], begin: int,
                        end: int) -> Tree:
        # pass 1: chunk maximal POS runs into base phrases
        chunks: List[Tree] = []
        i = 0
        n = len(pre)
        while i < n:
            tag = pre[i].label
            if tag == "DT" or tag in _ADJISH or tag in _NOUNISH:
                j = i
                kids = []
                while j < n and (pre[j].label == "DT" or
                                 pre[j].label in _ADJISH or
                                 pre[j].label in _NOUNISH):
                    kids.append(pre[j])
                    j += 1
                # pure adjective run with no noun head -> ADJP
                if all(k.label in _ADJISH for k in kids):
                    chunks.append(self._phrase("ADJP", kids))
                else:
                    chunks.append(self._phrase("NP", kids))
                i = j
            elif tag in _VERBISH or tag == "RB":
                j = i
                kids = []
                while j < n and (pre[j].label in _VERBISH or
                                 pre[j].label == "RB"):
                    kids.append(pre[j])
                    j += 1
                if all(k.label == "RB" for k in kids):
                    chunks.append(self._phrase("ADVP", kids))
                else:
                    chunks.append(self._phrase("VP", kids))
                i = j
            elif tag == "IN" or tag == "TO":
                chunks.append(self._phrase("PP", [pre[i]]))
                i += 1
            else:
                chunks.append(pre[i])
                i += 1
        # pass 2: PP absorbs its object NP
        merged: List[Tree] = []
        for c in chunks:
            if merged and merged[-1].label == "PP" and \
                    len(merged[-1].children) == 1 and c.label == "NP":
                pp = merged[-1]
                pp.children.append(c)
                pp.value = f"{pp.value} {c.value}"
                pp.end = c.end
            else:
                merged.append(c)
        # pass 3: VP absorbs following argument phrases (NP/PP/ADJP/ADVP)
        args_done: List[Tree] = []
        for c in merged:
            if args_done and args_done[-1].label == "VP" and \
                    c.label in ("NP", "PP", "ADJP", "ADVP"):
                vp = args_done[-1]
                vp.children.append(c)
                vp.value = f"{vp.value} {c.value}"
                vp.end = c.end
            else:
                args_done.append(c)
        return Tree("S", args_done,
                    value=" ".join(c.value for c in args_done),
                    begin=begin, end=end)


# ------------------------------------------------------------ transforms

class BinarizeTreeTransformer:
    """Left-factored binarization (reference
    BinarizeTreeTransformer.java:1, after Stanford CoreNLP): nodes with
    >2 children nest their right siblings under @LABEL intermediate
    nodes, so every internal node has at most two children — the shape
    recursive nets consume."""

    def transform(self, t: Optional[Tree]) -> Optional[Tree]:
        if t is None:
            return None
        kids = [self.transform(c) for c in t.children]
        while len(kids) > 2:
            right = kids[-2:]
            inter = Tree("@" + t.label, right,
                         value=f"{right[0].value} {right[1].value}",
                         begin=right[0].begin, end=right[1].end)
            kids = kids[:-2] + [inter]
        t.children = kids
        return t


class CollapseUnaries:
    """Collapse unary chains X -> Y -> ... (reference
    CollapseUnaries.java:1): a node with exactly one non-leaf child takes
    that child's children; pre-terminals (POS over a word) survive."""

    def transform(self, t: Optional[Tree]) -> Optional[Tree]:
        if t is None or t.is_leaf():
            return t
        while len(t.children) == 1 and not t.is_pre_terminal() and \
            not t.children[0].is_pre_terminal():
            t.children = t.children[0].children
        t.children = [self.transform(c) for c in t.children]
        return t


class HeadWordFinder:
    """Collins-style head finding (reference HeadWordFinder.java:1):
    per-parent priority over child categories, walked to the bottom-most
    terminal head."""

    # parent -> (direction, [head-tag priority])
    _RULES = {
        "S": ("right", ["VP", "S", "SBAR", "ADJP", "NP"]),
        "VP": ("left", ["VBD", "VBZ", "VBP", "VBG", "VBN", "VB", "MD",
                        "VP", "ADJP", "NP"]),
        "NP": ("right", ["NN", "NNS", "NNP", "NNPS", "PRP", "NP", "CD",
                         "JJ"]),
        "PP": ("left", ["IN", "TO", "PP", "NP"]),
        "ADJP": ("right", ["JJ", "JJR", "JJS", "ADJP", "VBN", "RB"]),
        "ADVP": ("right", ["RB", "RBR", "RBS", "ADVP"]),
    }

    def find_head(self, t: Tree) -> Tree:
        cursor = t
        while not cursor.is_leaf():
            if cursor.is_pre_terminal():
                cursor = cursor.children[0]
                break
            cursor = self._head_child(cursor)
        return cursor

    def _head_child(self, t: Tree) -> Tree:
        base = t.label.lstrip("@")
        direction, prio = self._RULES.get(base, ("left", []))
        kids = t.children if direction == "left" else list(t.children)[::-1]
        for want in prio:
            for k in kids:
                if k.label.lstrip("@") == want:
                    return k
        return kids[0]

    def annotate(self, t: Tree) -> Tree:
        """Set ``head_word`` on every internal node."""
        for node in t.all_nodes():
            if not node.is_leaf():
                node.head_word = self.find_head(node).value
        return t


# ------------------------------------------------------------ vectorizer

class TreeVectorizer:
    """parse → binarize → collapse unaries → head words → word vectors at
    the leaves (reference TreeVectorizer.java:1). ``lookup`` is anything
    with ``vector(word) -> ndarray | None`` (Word2Vec, StaticWord2Vec,
    InMemoryLookupTable) or a plain dict; unknown words get zeros of the
    model's dimensionality."""

    def __init__(self, parser: Optional[TreeParser] = None, lookup=None,
                 dim: int = 0):
        self.parser = parser or TreeParser()
        self.binarizer = BinarizeTreeTransformer()
        self.collapser = CollapseUnaries()
        self.heads = HeadWordFinder()
        self.lookup = lookup
        self.dim = dim

    def _vector(self, word: str) -> Optional[np.ndarray]:
        if self.lookup is None:
            return None
        key = word
        if isinstance(self.lookup, dict):
            get = self.lookup.get
        else:
            # SequenceVectors/Word2Vec/StaticWord2Vec surface
            get = getattr(self.lookup, "get_word_vector", None) or \
                getattr(self.lookup, "vector")
        v = get(key)
        if v is None:
            # tokens keep their sentence punctuation ("cat."); the
            # embedding model was usually trained on clean words
            stripped = key.strip(EN_STRIP_PUNCT).lower()
            if stripped != key:
                v = get(stripped)
        if v is not None:
            v = np.asarray(v, np.float32)
            if not self.dim:
                self.dim = v.shape[-1]
        return v

    def _finish(self, trees: List[Tree]) -> List[Tree]:
        out = []
        for t in trees:
            t = self.collapser.transform(self.binarizer.transform(t))
            self.heads.annotate(t)
            for leaf in t.yield_leaves():
                leaf.vector = self._vector(leaf.value)
            out.append(t)
        # zero-fill AFTER resolving across all trees: the model dim may
        # only be learned from a later sentence, and every unknown leaf -
        # wherever it sits - must get zeros of that dim
        if self.dim:
            for t in out:
                for leaf in t.yield_leaves():
                    if leaf.vector is None:
                        leaf.vector = np.zeros((self.dim,), np.float32)
        return out

    def get_trees(self, text: str) -> List[Tree]:
        return self._finish(self.parser.get_trees(text))

    def get_trees_with_labels(self, text: str, label: str,
                              labels: Sequence[str]) -> List[Tree]:
        return self._finish(
            self.parser.get_trees_with_labels(text, label, labels))

    def node_features(self, tree: Tree) -> Dict[str, np.ndarray]:
        """Per-node feature arrays for recursive nets: leaf vector matrix
        [n_leaves, dim] in textual order plus the span/label table."""
        leaves = tree.yield_leaves()
        dim = self.dim or max((len(l.vector) for l in leaves
                               if l.vector is not None), default=0)
        mat = np.zeros((len(leaves), dim), np.float32)
        for i, leaf in enumerate(leaves):
            if leaf.vector is not None:
                mat[i, :len(leaf.vector)] = leaf.vector
        return {"leaf_vectors": mat,
                "spans": np.asarray([[n.begin, n.end]
                                     for n in tree.all_nodes()], np.int32)}
