"""PyTorch port, the NLP text tier on the CPU against the JAX package: the
port owns copies of the host modules (tokenizers and sentence iterators,
the CJK char-class and lattice tokenizers with their dictionaries, the
annotators, the rule and perceptron POS taggers, the tree parser with its
transforms and vectorizer, sentiment, vocabulary and Huffman coding,
BoW / TF-IDF), and each is held output-for-output equal to the JAX
package's on the same text: token for token on the Japanese and Korean
gold and held-out corpora, tag for tag on the mini-treebank, tree for tree
(bracket strings, head words, vectors) and score for score, plus the
oracles' own bars run through the port (``tests/test_lattice_tokenizer.py``,
``test_postagger.py``, ``test_treeparser_sentiment.py``). The lattice
tokenizer also feeds the port's Word2Vec on the CPU."""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp as jnlp
import deeplearning4j_tpu_torch.nlp as pnlp
from deeplearning4j_tpu.nlp import annotators as j_ann
from deeplearning4j_tpu.nlp import postagger as j_pos
from deeplearning4j_tpu.nlp import sentiment as j_sent
from deeplearning4j_tpu.nlp import treeparser as j_tree
from deeplearning4j_tpu.nlp.mini_treebank import HELDOUT as TB_HELDOUT
from deeplearning4j_tpu.nlp.mini_treebank import TRAIN as TB_TRAIN
from deeplearning4j_tpu_torch.nlp import annotators as p_ann
from deeplearning4j_tpu_torch.nlp import postagger as p_pos
from deeplearning4j_tpu_torch.nlp import sentiment as p_sent
from deeplearning4j_tpu_torch.nlp import treeparser as p_tree
from deeplearning4j_tpu_torch.nlp.mini_treebank import HELDOUT, TRAIN
from tests.ja_gold_corpus import GOLD as JA_GOLD
from tests.ja_heldout_corpus import HELDOUT as JA_HELDOUT
from tests.ko_gold_corpus import GOLD as KO_GOLD
from tests.ko_heldout_corpus import HELDOUT as KO_HELDOUT
from tests.sentiment_heldout import HELDOUT as SENT_HELDOUT


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the test workers of a parallel run would spin
    on each other's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ENGLISH = ["The quick dog chased a small cat.",
           "The dog sat on the mat. She opened the old door.",
           "I like it. You hate it.",
           "The small cat sleeps on the warm floor.",
           "Hello, World! 123 foo -- it's 3:45 (or so)."]

CORPORA = {"ja_gold": JA_GOLD, "ja_heldout": JA_HELDOUT,
           "ko_gold": KO_GOLD, "ko_heldout": KO_HELDOUT}
TOKENIZERS = {"ja": ("LatticeJapaneseTokenizerFactory",
                     "JapaneseTokenizerFactory"),
              "ko": ("LatticeKoreanTokenizerFactory",
                     "KoreanTokenizerFactory")}


def test_text_tier_exports_every_name():
    assert set(jnlp.__all__) <= set(dir(pnlp))
    assert pnlp.__all__ == jnlp.__all__


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_cjk_tokenizers_equal_jax_on_corpus(corpus):
    """Token for token (and POS for POS on the lattices) on every sentence
    of the corpus, spaced and unspaced, for both the lattice and the
    char-class factory of the language."""
    lattice, charclass = TOKENIZERS[corpus[:2]]
    pairs = [(getattr(jnlp, n)(), getattr(pnlp, n)())
             for n in (lattice, charclass)]
    for text, _ in CORPORA[corpus]:
        for t in (text, "".join(text.split())):
            for jf, pf in pairs:
                assert pf.create(t).get_tokens() == \
                    jf.create(t).get_tokens(), t
            assert pairs[0][1].tokenize_with_pos(t) == \
                pairs[0][0].tokenize_with_pos(t), t


@pytest.mark.parametrize("lang", ["ja", "ko"])
def test_lattice_user_entries_equal_jax(lang):
    entries = {"ja": [("深層学習", "noun", 400)],
               "ko": [("딥러닝", "noun", 300)]}[lang]
    texts = {"ja": ["深層学習の本を読んだ", "ブロックチェーンは技術です",
                    "すもももももももものうち"],
             "ko": ["딥러닝을 공부해요", "스마트폰을 샀어요"]}[lang]
    name = TOKENIZERS[lang][0]
    jf = getattr(jnlp, name)(user_entries=entries)
    pf = getattr(pnlp, name)(user_entries=entries)
    for t in texts:
        assert pf.create(t).get_tokens() == jf.create(t).get_tokens()


def test_lattice_heldout_bars_hold_through_the_port():
    """The oracle's held-out floors, measured on the port's tokenizers."""
    from tests.test_lattice_tokenizer import TestOpenDomainHeldout
    oracle = TestOpenDomainHeldout()
    ja = pnlp.LatticeJapaneseTokenizerFactory()
    ko = pnlp.LatticeKoreanTokenizerFactory()
    jf1 = oracle._f1(lambda t: ja.create(t).get_tokens(), JA_HELDOUT)
    kf1 = oracle._f1(lambda t: ko.create(t).get_tokens(), KO_HELDOUT)
    want = (oracle._f1(lambda t: jnlp.LatticeJapaneseTokenizerFactory()
                       .create(t).get_tokens(), JA_HELDOUT),
            oracle._f1(lambda t: jnlp.LatticeKoreanTokenizerFactory()
                       .create(t).get_tokens(), KO_HELDOUT))
    assert (jf1, kf1) == want
    assert pnlp.LatticeJapaneseTokenizerFactory().create(
        "すもももももももものうち").get_tokens() == \
        ["すもも", "も", "もも", "も", "もも", "の", "うち"]


@pytest.mark.parametrize("factory", ["default", "common", "ngram"])
def test_english_tokenizers_equal_jax(factory):
    def make(m):
        if factory == "default":
            return m.DefaultTokenizerFactory()
        if factory == "common":
            return m.DefaultTokenizerFactory(m.CommonPreprocessor())
        return m.NGramTokenizerFactory(1, 3)
    for text in ENGLISH:
        assert make(pnlp).create(text).get_tokens() == \
            make(jnlp).create(text).get_tokens()
    assert list(pnlp.CollectionSentenceIterator(ENGLISH)) == \
        list(jnlp.CollectionSentenceIterator(ENGLISH))


def test_sentence_iterators_and_stop_words_equal_jax(tmp_path):
    path = tmp_path / "lines.txt"
    path.write_text("\n".join(ENGLISH) + "\n", encoding="utf-8")
    assert list(pnlp.LineSentenceIterator(path)) == \
        list(jnlp.LineSentenceIterator(path))
    labelled = [(s, "l%d" % (i % 2)) for i, s in enumerate(ENGLISH)]
    got = pnlp.LabelAwareSentenceIterator(labelled)
    want = jnlp.LabelAwareSentenceIterator(labelled)
    assert list(got) == list(want)
    assert sorted(pnlp.StopWords.get_stop_words()) == \
        sorted(jnlp.StopWords.get_stop_words())


def test_vocab_and_huffman_equal_jax():
    rng = np.random.default_rng(3)
    words = [f"w{int(z)}" for z in rng.zipf(1.3, 4000) if z < 400]
    seqs = [words[i:i + 9] for i in range(0, len(words), 9)]
    for minf in (1, 3):
        jv = jnlp.VocabConstructor(minf).build(seqs)
        pv = pnlp.VocabConstructor(minf).build(seqs)
        assert pv.index2word == jv.index2word
        assert pv.total_word_count == jv.total_word_count
        np.testing.assert_array_equal(pv.unigram_table(),
                                      jv.unigram_table())
        np.testing.assert_array_equal(pv.subsample_keep_prob(1e-3),
                                      jv.subsample_keep_prob(1e-3))
        jnlp.apply_huffman(jv)
        pnlp.apply_huffman(pv)
        for a, b in zip(pnlp.pad_codes(pv), jnlp.pad_codes(jv)):
            np.testing.assert_array_equal(a, b)
    assert pnlp.build_huffman([50, 30, 10, 5, 3, 2]) == \
        jnlp.build_huffman([50, 30, 10, 5, 3, 2])


def test_bow_and_tfidf_equal_jax():
    docs = ["cat dog cat", "dog bird", "cat fish bird bird", "the cat"]
    for name in ("BagOfWordsVectorizer", "TfidfVectorizer"):
        got = getattr(pnlp, name)().fit_transform(docs)
        want = getattr(jnlp, name)().fit_transform(docs)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tagger", ["rule", "perceptron"])
def test_pos_tags_equal_jax_on_treebank(tagger):
    """Tag for tag on every mini-treebank sentence (train and held out),
    and the same annotations through the annotator pipeline."""
    assert HELDOUT == TB_HELDOUT and TRAIN == TB_TRAIN
    if tagger == "rule":
        jt, pt = j_ann.PosTagger(), p_ann.PosTagger()
        for sent in TB_TRAIN + TB_HELDOUT:
            assert [pt._tag(w) for w, _ in sent] == \
                [jt._tag(w) for w, _ in sent]
    else:
        jt = j_pos.PerceptronPosTagger.default()
        pt = p_pos.PerceptronPosTagger.default()
        for sent in TB_TRAIN + TB_HELDOUT:
            words = [w for w, _ in sent]
            assert pt.tag(words) == jt.tag(words)
        assert pt.accuracy(HELDOUT) == jt.accuracy(TB_HELDOUT) >= 0.80
        assert p_pos.PerceptronPosTagger.from_json(pt.to_json()).tag(
            [w for w, _ in HELDOUT[0]]) == pt.tag([w for w, _ in HELDOUT[0]])

    def spans(m, tag):
        doc = m.AnnotatorPipeline([m.SentenceAnnotator(),
                                   m.TokenizerAnnotator(), tag]).process(
            " ".join(ENGLISH))
        return [(a.type, a.begin, a.end, a.text, dict(a.features))
                for a in doc.annotations]
    assert spans(p_ann, pt) == spans(j_ann, jt)


def test_perceptron_training_equal_jax():
    jt = j_pos.PerceptronPosTagger().train(TB_TRAIN, iterations=3)
    pt = p_pos.PerceptronPosTagger().train(TRAIN, iterations=3)
    assert pt.to_json() == jt.to_json()


@pytest.mark.parametrize("trained", [False, True], ids=["rule", "trained"])
def test_trees_equal_jax(trained):
    """Tree for tree: brackets, head words, binarized and collapsed forms,
    and labels stamped on every node, on the English sentences and every
    mini-treebank sentence."""
    def parser(m, pm, am):
        if not trained:
            return m.TreeParser()
        return m.TreeParser(am.AnnotatorPipeline([
            am.SentenceAnnotator(), am.TokenizerAnnotator(),
            pm.PerceptronPosTagger.default()]))
    jp, pp = parser(j_tree, j_pos, j_ann), parser(p_tree, p_pos, p_ann)
    texts = ENGLISH + [" ".join(w for w, _ in s) + "." for s in TB_HELDOUT]

    def forms(m, t):
        b = m.BinarizeTreeTransformer().transform(t)
        c = m.CollapseUnaries().transform(b)
        h = m.HeadWordFinder().annotate(c)
        return (t.to_bracket(), b.to_bracket(), c.to_bracket(),
                [(n.label, n.value, getattr(n, "head_word", None))
                 for n in h.all_nodes()])
    for text in texts:
        got, want = pp.get_trees(text), jp.get_trees(text)
        assert [forms(p_tree, t) for t in got] == \
            [forms(j_tree, t) for t in want], text
    got = pp.get_trees_with_labels("The dog runs.", "positive",
                                   ["positive", "negative"])
    want = jp.get_trees_with_labels("The dog runs.", "positive",
                                    ["positive", "negative"])
    assert [[n.gold_label for n in t.all_nodes()] for t in got] == \
        [[n.gold_label for n in t.all_nodes()] for t in want]
    with pytest.raises(ValueError):
        pp.get_trees_with_labels("Hi there.", "bogus", ["positive"])


def test_tree_vectorizer_equal_jax():
    lookup = {"dog": np.ones(4), "cat": np.full(4, 2.0),
              "mat": np.arange(4.0)}
    for text in ENGLISH:
        got = p_tree.TreeVectorizer(lookup=lookup).get_trees(text)
        want = j_tree.TreeVectorizer(lookup=lookup).get_trees(text)
        assert [t.to_bracket() for t in got] == \
            [t.to_bracket() for t in want]
        for g, w in zip(got, want):
            for a, b in zip(g.yield_leaves(), w.yield_leaves()):
                np.testing.assert_array_equal(a.vector, b.vector)
            fg = p_tree.TreeVectorizer(lookup=lookup).node_features(g)
            fw = j_tree.TreeVectorizer(lookup=lookup).node_features(w)
            assert sorted(fg) == sorted(fw)
            for k in fg:
                np.testing.assert_array_equal(fg[k], fw[k])


def test_sentiment_equal_jax():
    js, ps = j_sent.SentimentScorer(), p_sent.SentimentScorer()
    assert p_sent.default_lexicon() == j_sent.default_lexicon()
    texts = [t for t, _ in SENT_HELDOUT] + ENGLISH + [
        "The film was not good.", "This movie is excellent and wonderful."]
    for t in texts:
        assert ps.score(t) == js.score(t), t
        assert ps.classify(t) == js.classify(t), t
    right = sum((("positive" if s > 0 else "negative" if s < 0 else
                  "neutral") == label)
                for s, label in ((ps.score(t), lab)
                                 for t, lab in SENT_HELDOUT))
    assert right / len(SENT_HELDOUT) >= 0.85
    lines = ["# comment", "a\t00001\t0.75\t0\tgood#1 goodish#2",
             "a\t00002\t0\t0.625\tbad#1", "a\t3\tN/A\t0\tfoo#1"]
    assert p_sent.SentimentScorer.load_swn(lines).lexicon == \
        j_sent.SentimentScorer.load_swn(lines).lexicon


def test_lattice_tokens_feed_the_ports_word2vec():
    """The factory slots into the port's SequenceVectors pipeline: the
    same vocabulary as the JAX Word2Vec over the same tokenizer, and
    vectors for the words."""
    corpus = ["私は東京に住んでいます", "私は学校で学ぶ",
              "学生が東京で学ぶ", "先生は学校にいます"] * 8
    builds = []
    for m, extra in ((jnlp, {}), (pnlp, {"device": "cpu"})):
        b = (m.Word2Vec.Builder().layer_size(8).window_size(2).epochs(1)
             .seed(0).batch_size(64).min_word_frequency(1)
             .tokenizer_factory(m.LatticeJapaneseTokenizerFactory())
             .iterate(m.CollectionSentenceIterator(corpus)))
        for k, v in extra.items():
            getattr(b, k)(v)
        builds.append(b.build().fit())
    jw, pw = builds
    assert pw.vocab.index2word == jw.vocab.index2word
    assert "東京" in pw.vocab and pw.get_word_vector("東京").shape == (8,)
    np.testing.assert_allclose(pw.get_word_vector("東京"),
                               jw.get_word_vector("東京"), rtol=1e-5,
                               atol=1e-7)
