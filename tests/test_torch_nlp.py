"""PyTorch port, word embeddings and graph embeddings on the CPU against
the JAX package: each step function of ``nlp/skipgram.py`` (both numerics
of the segment update, hierarchical softmax, negative sampling with the
negatives passed in, the masked and shared-negative pair-block updates,
CBOW) and GloVe's AdaGrad step on the same numpy inputs as the JAX
function; whole fits whose only randomness is numpy's (HS per-batch and
CBOW-HS Word2Vec, ParagraphVectors DBOW / DM and ``infer_vector``, GloVe,
DeepWalk) against JAX's tables; the corpus scan against its own
step-by-step masked updates with the same draws, and the same tables
whatever its segmentation; the oracles' quality bars
(``tests/test_nlp_graph.py``, ``test_fetchers_w2v_input.py``'s
``TestWord2VecInput``, ``test_determinism.py``'s seeded Word2Vec,
``test_pipeline_listeners_distw2v.py``'s ``TestDistributedWord2Vec``) run
through the port; and the word- and graph-vector files crossing the two
packages both ways, with ``InMemoryLookupTable.from_arrays`` carrying a
JAX model's tables into the port.

Tolerances: 1e-5 relative L2 on the tables' change (per step) or on the
tables (whole fits). Both packages sum the same f32 products in other
orders; on the segment update's one-hot route they round the same f32
updates to bf16, where an order difference could flip one rounding."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.graph_embeddings as jge
import deeplearning4j_tpu.nlp as jnlp
import deeplearning4j_tpu_torch.graph_embeddings as pge
import deeplearning4j_tpu_torch.nlp as pnlp
from deeplearning4j_tpu.nlp import glove as jglove
from deeplearning4j_tpu.nlp import skipgram as jsg
from deeplearning4j_tpu_torch.nlp import glove as pglove
from deeplearning4j_tpu_torch.nlp import skipgram as psg
from deeplearning4j_tpu_torch.nlp.sequence_vectors import \
    InMemoryLookupTable

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the test workers of a parallel run would spin
    on each other's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def _topic_corpus(rng, n_sentences=300, sentence_len=8):
    """Two topics with disjoint vocabularies (tests/test_nlp_graph.py)."""
    topic_a = [f"alpha{i}" for i in range(8)]
    topic_b = [f"beta{i}" for i in range(8)]
    seqs = []
    for s in range(n_sentences):
        words = topic_a if s % 2 == 0 else topic_b
        seqs.append([words[rng.integers(0, len(words))]
                     for _ in range(sentence_len)])
    return seqs, topic_a, topic_b


def _corpus(n=300, seed=12345):
    return _topic_corpus(np.random.default_rng(seed), n_sentences=n)


# ----------------------------------------------------------------- surface
def test_exports_and_no_jax_imports():
    assert set(jnlp.__all__) <= set(dir(pnlp))
    assert set(jge.__all__) <= set(dir(pge))
    assert pge.__all__ == jge.__all__
    files = sorted((ROOT / "deeplearning4j_tpu_torch/nlp").glob("*.py")) + \
        sorted((ROOT / "deeplearning4j_tpu_torch/graph_embeddings")
               .glob("*.py"))
    jax_files = {p.name for p in (ROOT / "deeplearning4j_tpu/nlp")
                 .glob("*.py")} | {p.name for p in (
                     ROOT / "deeplearning4j_tpu/graph_embeddings")
                     .glob("*.py")}
    assert {p.name for p in files} == jax_files
    for p in files:
        for node in ast.walk(ast.parse(p.read_text(encoding="utf-8"))):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                and node.level == 0 else []
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib",
                                               "deeplearning4j_tpu"), p


def test_chip_smoke_defines_each_name_once():
    """chip_smoke.py grows a phase a slice: a helper of a new phase that
    reuses an earlier phase's name replaces it for the whole script."""
    import collections
    tree = ast.parse((ROOT / "chip_smoke.py").read_text(encoding="utf-8"))
    names = collections.Counter(
        node.name for node in tree.body
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)))
    names.update(t.id for node in tree.body if isinstance(node, ast.Assign)
                 for t in node.targets if isinstance(t, ast.Name))
    assert [n for n, c in names.items() if c > 1] == []


def test_entry_points_default_to_the_card():
    """device=None is the CUDA card: without one every trainer raises."""
    makers = [lambda d: pnlp.Word2Vec(device=d),
              lambda d: pnlp.ParagraphVectors(device=d),
              lambda d: pnlp.Glove(device=d),
              lambda d: pge.DeepWalk(device=d)]
    for make in makers:
        assert make("cpu").device.type == "cpu"
        if torch.cuda.is_available():
            assert make(None).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make(None)


# -------------------------------------------------------- per-step parity
@pytest.mark.parametrize("route,v", [("onehot", 50), ("scatter", 33000)])
def test_segment_update_matches_jax(route, v):
    rng = np.random.default_rng(v)
    d, b = 6, 96
    table = rng.normal(0, 0.1, (v, d)).astype(np.float32)
    idx = rng.integers(0, min(v, 40), b).astype(np.int32)   # repeats
    upd = rng.normal(0, 1.0, (b, d)).astype(np.float32)
    w = (rng.random(b) > 0.2).astype(np.float32)
    assert psg.segment_route(v, b) == route
    got = psg._segment_update(_t(table), _t(idx).long(), _t(upd), _t(w),
                              0.025).numpy()
    want = np.asarray(jsg._segment_update(jnp.asarray(table),
                                          jnp.asarray(idx), jnp.asarray(upd),
                                          jnp.asarray(w), jnp.float32(0.025)))
    assert _rel(got - table, want - table) <= TOL


def test_segment_routes_follow_jax_bounds():
    cases = [(32768, 8192), (32769, 1), (1000, (1 << 28) // 1000),
             (1000, (1 << 28) // 1000 + 1)]
    for rows, n in cases:
        onehot = rows <= jsg.ONEHOT_SEGMENT_MAX_V and \
            n * rows <= jsg.ONEHOT_SEGMENT_MAX_ELEMS
        assert psg.segment_route(rows, n) == \
            ("onehot" if onehot else "scatter")


def _hs_case(v, b, d=8, seed=0):
    rng = np.random.default_rng(seed)
    freqs = rng.integers(1, 1000, v)
    codes, points = jnlp.build_huffman(freqs)
    L = max(len(c) for c in codes)
    carr = np.zeros((v, L), np.float32)
    parr = np.zeros((v, L), np.int32)
    larr = np.array([len(c) for c in codes], np.int32)
    for i in range(v):
        carr[i, :larr[i]] = codes[i]
        parr[i, :larr[i]] = points[i]
    syn0 = rng.normal(0, 0.1, (v, d)).astype(np.float32)
    syn1 = rng.normal(0, 0.1, (v - 1, d)).astype(np.float32)
    c = rng.integers(0, v, b).astype(np.int32)
    t = rng.integers(0, v, b).astype(np.int32)
    return syn0, syn1, c, t, carr, parr, larr


@pytest.mark.parametrize("v", [60, 33000])
def test_skipgram_hs_step_matches_jax(v):
    syn0, syn1, c, t, codes, points, lengths = _hs_case(v, 128)
    got = psg.skipgram_hs_step(_t(syn0), _t(syn1), _t(c).long(),
                               _t(t).long(), _t(codes[t]),
                               _t(points[t]).long(), _t(lengths[t]).long(),
                               0.05)
    want = jsg.skipgram_hs_step(jnp.asarray(syn0), jnp.asarray(syn1),
                                jnp.asarray(c), jnp.asarray(t),
                                jnp.asarray(codes[t]),
                                jnp.asarray(points[t]),
                                jnp.asarray(lengths[t]), jnp.float32(0.05))
    for g, w, init in zip(got[:2], want[:2], (syn0, syn1)):
        assert _rel(g.numpy() - init, np.asarray(w) - init) <= TOL
    assert abs(float(got[2]) - float(want[2])) <= TOL * abs(float(want[2]))


def test_cbow_hs_step_matches_jax():
    syn0, syn1, _, t, codes, points, lengths = _hs_case(70, 96, seed=1)
    rng = np.random.default_rng(2)
    ctx = rng.integers(0, 70, (96, 6)).astype(np.int32)
    cm = (rng.random((96, 6)) > 0.3).astype(np.float32)
    got = psg.cbow_hs_step(_t(syn0), _t(syn1), _t(ctx).long(), _t(cm),
                           _t(t).long(), _t(codes[t]), _t(points[t]).long(),
                           _t(lengths[t]).long(), 0.05)
    want = jsg.cbow_hs_step(jnp.asarray(syn0), jnp.asarray(syn1),
                            jnp.asarray(ctx), jnp.asarray(cm),
                            jnp.asarray(t), jnp.asarray(codes[t]),
                            jnp.asarray(points[t]), jnp.asarray(lengths[t]),
                            jnp.float32(0.05))
    for g, w, init in zip(got[:2], want[:2], (syn0, syn1)):
        assert _rel(g.numpy() - init, np.asarray(w) - init) <= TOL
    assert abs(float(got[2]) - float(want[2])) <= TOL * abs(float(want[2]))


def _ns_case(v=80, b=128, k=5, d=8, seed=3):
    rng = np.random.default_rng(seed)
    syn0 = rng.normal(0, 0.1, (v, d)).astype(np.float32)
    syn1neg = rng.normal(0, 0.1, (v, d)).astype(np.float32)
    c = rng.integers(0, v, b).astype(np.int32)
    pos = rng.integers(0, v, b).astype(np.int32)
    negs = rng.integers(0, v, (b, k)).astype(np.int32)
    return rng, syn0, syn1neg, c, pos, negs


@pytest.mark.parametrize("kind", ["skipgram", "cbow"])
def test_ns_steps_match_jax(kind):
    rng, syn0, syn1neg, c, pos, negs = _ns_case()
    if kind == "skipgram":
        got = psg.skipgram_ns_step(_t(syn0), _t(syn1neg), _t(c).long(),
                                   _t(pos).long(), _t(negs).long(), 0.05)
        want = jsg.skipgram_ns_step(jnp.asarray(syn0), jnp.asarray(syn1neg),
                                    jnp.asarray(c), jnp.asarray(pos),
                                    jnp.asarray(negs), jnp.float32(0.05))
    else:
        ctx = rng.integers(0, 80, (128, 4)).astype(np.int32)
        cm = (rng.random((128, 4)) > 0.25).astype(np.float32)
        got = psg.cbow_ns_step(_t(syn0), _t(syn1neg), _t(ctx).long(),
                               _t(cm), _t(pos).long(), _t(negs).long(), 0.05)
        want = jsg.cbow_ns_step(jnp.asarray(syn0), jnp.asarray(syn1neg),
                                jnp.asarray(ctx), jnp.asarray(cm),
                                jnp.asarray(pos), jnp.asarray(negs),
                                jnp.float32(0.05))
    for g, w, init in zip(got[:2], want[:2], (syn0, syn1neg)):
        assert _rel(g.numpy() - init, np.asarray(w) - init) <= TOL
    assert abs(float(got[2]) - float(want[2])) <= TOL * abs(float(want[2]))


@pytest.mark.parametrize("shared", [False, True], ids=["per_pair", "shared"])
def test_masked_ns_updates_match_jax(shared):
    rng, syn0, syn1neg, c, pos, negs = _ns_case(seed=4)
    valid = rng.random(128) > 0.3
    negs = negs[0] if shared else negs
    fn = ("_masked_ns_update_shared" if shared else "_masked_ns_update")
    got = getattr(psg, fn)(_t(syn0), _t(syn1neg), _t(c).long(),
                           _t(pos).long(), _t(valid), _t(negs).long(),
                           0.03, torch.float32)
    want = getattr(jsg, fn)(jnp.asarray(syn0), jnp.asarray(syn1neg),
                            jnp.asarray(c), jnp.asarray(pos),
                            jnp.asarray(valid), jnp.asarray(negs),
                            jnp.float32(0.03), jnp.float32)
    for g, w, init in zip(got[:2], want[:2], (syn0, syn1neg)):
        assert _rel(g.numpy() - init, np.asarray(w) - init) <= TOL
    assert abs(float(got[2]) - float(want[2])) <= TOL * abs(float(want[2]))
    assert float(got[3]) == float(want[3]) == valid.sum()


def test_glove_step_matches_jax_with_repeated_rows():
    """A row that repeats in a batch divides by the batch's summed AdaGrad
    history, as JAX reads ``hw_i[rows]`` after ``.at[rows].add``."""
    rng = np.random.default_rng(5)
    v, d, b = 30, 6, 64
    arrs = [rng.normal(0, 0.1, (v, d)), rng.normal(0, 0.1, (v, d)),
            rng.normal(0, 0.1, v), rng.normal(0, 0.1, v),
            rng.random((2, v, d)), rng.random((2, v))]
    arrs = [a.astype(np.float32) for a in arrs]
    rows = rng.integers(0, 8, b).astype(np.int32)
    cols = rng.integers(0, 8, b).astype(np.int32)
    xij = (rng.random(b) * 50 + 0.5).astype(np.float32)
    got = pglove._glove_step(*[_t(a) for a in arrs], _t(rows).long(),
                             _t(cols).long(), _t(xij), 0.05, 100.0, 0.75)
    want = jglove._glove_step(*[jnp.asarray(a) for a in arrs],
                              jnp.asarray(rows), jnp.asarray(cols),
                              jnp.asarray(xij), jnp.float32(0.05), 100.0,
                              0.75)
    for g, w, init in zip(got[:6], want[:6], arrs):
        assert _rel(g.numpy() - init, np.asarray(w) - init) <= TOL
    assert abs(float(got[6]) - float(want[6])) <= TOL * abs(float(want[6]))


# ---------------------------------------------------------- corpus scans
def _staged_corpus(v=40, n=700, window=3, p=32, steps=None, seed=6):
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import _stage_corpus
    rng = np.random.default_rng(seed)
    corpus = rng.integers(0, v, n).astype(np.int32)
    corpus[rng.random(n) < 0.1] = -1                 # sentence separators
    n_steps = steps or (n + p - 1) // p
    padded = np.full((n_steps * p + 2 * window,), -1, np.int16)
    padded[window:window + n] = corpus
    return _stage_corpus(padded, "cpu"), n_steps


@pytest.mark.parametrize("kind", ["ns_shared", "ns_per_pair", "hs"])
def test_scan_equals_its_masked_steps(kind):
    """The scan is its per-step masked updates, drawn from one generator a
    step seeded with scan_step_seed(key, step): window shrinks first,
    then negatives."""
    v, d, window, p, k, key = 40, 8, 3, 32, 4, 1234
    (corpus, sep), n_steps = _staged_corpus(v, window=window, p=p)
    rng = np.random.default_rng(7)
    syn0 = _t(rng.normal(0, 0.1, (v, d)).astype(np.float32))
    out = _t(rng.normal(0, 0.1, (v, d)).astype(np.float32))
    neg_table = torch.arange(v).repeat(3)
    _, _, codes_t, points_t, lengths_t = \
        (None, None, *[_t(a) for a in _hs_case(v, 1)[4:]])
    points_t, lengths_t = points_t.long(), lengths_t.long()
    args = (0.05, 1e-4, 0.1, 0.02)
    a0, a1 = syn0.clone(), (out[:v - 1] if kind == "hs" else out).clone()
    if kind == "hs":
        got = psg.skipgram_hs_corpus_scan(
            a0, a1, corpus, sep, codes_t, points_t, lengths_t, key, 0, *args,
            window=window, n_steps=n_steps, p=p)
    else:
        got = psg.skipgram_ns_corpus_scan(
            a0, a1, corpus, sep, neg_table, key, 0, *args, k=k,
            window=window, n_steps=n_steps, p=p,
            shared_negatives=kind == "ns_shared")
    b0, b1 = syn0.clone(), (out[:v - 1] if kind == "hs" else out).clone()
    geometry = psg.scan_geometry(p, window, "cpu")
    loss = torch.zeros(())
    for step in range(n_steps):
        g = torch.Generator().manual_seed(psg.scan_step_seed(key, step))
        b = torch.randint(1, window + 1, (p,), generator=g)
        cflat, ctx, valid = psg.scan_step_pairs(corpus, sep, step, p, window,
                                                geometry, b)
        lr = psg.scan_lr(*args, step)
        if kind == "hs":
            ls, _ = psg._masked_hs_update(b0, b1, cflat, ctx, valid, codes_t,
                                          points_t, lengths_t, lr,
                                          torch.float32)
        elif kind == "ns_shared":
            negs = neg_table[torch.randint(0, 3 * v, (k,), generator=g)]
            ls = psg._masked_ns_update_shared(b0, b1, cflat, ctx, valid, negs,
                                              lr, torch.float32)[2]
        else:
            negs = neg_table[torch.randint(0, 3 * v, (len(cflat), k),
                                           generator=g)]
            ls = psg._masked_ns_update(b0, b1, cflat, ctx, valid, negs, lr,
                                       torch.float32)[2]
        loss += ls
    assert torch.equal(got[0], b0) and torch.equal(got[1], b1)
    assert torch.equal(got[2], loss)
    assert not torch.equal(b0, syn0)


def test_scan_pairs_match_the_host_pair_builder():
    """With no window shrink the scan's valid pairs are exactly the
    vectorized host builder's multiset (windows never cross a separator)."""
    window, p = 3, 32
    (corpus, sep), n_steps = _staged_corpus(window=window, p=p, seed=8)
    geometry = psg.scan_geometry(p, window, "cpu")
    pairs = []
    for step in range(n_steps):
        cflat, ctx, valid = psg.scan_step_pairs(
            corpus, sep, step, p, window, geometry,
            torch.full((p,), window))
        pairs += list(zip(cflat[valid].tolist(), ctx[valid].tolist()))
    raw = corpus[window:].numpy()
    c, t = psg.vectorized_skipgram_pairs(raw, window,
                                         np.random.default_rng(0),
                                         dynamic_window=False)
    assert sorted(pairs) == sorted(zip(c.tolist(), t.tolist()))


@pytest.mark.parametrize("negative", [0, 5], ids=["hs", "ns"])
def test_scan_does_not_depend_on_segmentation(negative):
    """The scan called once over every step, in runs of a few steps or
    one step a call (each call given its absolute start step) leaves the
    same tables, loss and pair count: every step seeds its own generator."""
    v, d, window, p, key = 40, 8, 3, 32, 99
    (corpus, sep), n_steps = _staged_corpus(v, window=window, p=p)
    rng = np.random.default_rng(3)
    syn0 = _t(rng.normal(0, 0.1, (v, d)).astype(np.float32))
    out = _t(rng.normal(0, 0.1, (v, d)).astype(np.float32))
    neg_table = torch.arange(v).repeat(3)
    codes_t, points_t, lengths_t = [_t(a) for a in _hs_case(v, 1)[4:]]
    points_t, lengths_t = points_t.long(), lengths_t.long()
    args = (0.05, 1e-4, 0.1, 0.02)
    results = []
    for runs in ((n_steps,), (4, 7, 1, n_steps - 12), (1,) * n_steps):
        a0, a1 = syn0.clone(), (out if negative else out[:v - 1]).clone()
        loss, cnt, start = torch.zeros(()), torch.zeros(()), 0
        for use in runs:
            if negative:
                _, _, ls, c = psg.skipgram_ns_corpus_scan(
                    a0, a1, corpus, sep, neg_table, key, start, *args,
                    k=negative, window=window, n_steps=use, p=p)
            else:
                _, _, ls, c = psg.skipgram_hs_corpus_scan(
                    a0, a1, corpus, sep, codes_t, points_t, lengths_t, key,
                    start, *args, window=window, n_steps=use, p=p)
            loss, cnt, start = loss + ls, cnt + c, start + use
        assert start == n_steps
        results.append((a0, a1, loss, cnt))
    assert not torch.equal(results[0][0], syn0)
    for got in results[1:]:
        assert all(torch.equal(x, y) for x, y in zip(results[0][:2], got[:2]))
        assert torch.equal(results[0][3], got[3])
        assert torch.allclose(results[0][2], got[2], rtol=1e-6, atol=0)


# ------------------------------------------------------ whole-fit parity
def _w2v_pair(negative=0, algo="skipgram", **kw):
    builds = []
    for m in (jnlp, pnlp):
        b = (m.Word2Vec.Builder().layer_size(24).window_size(3)
             .learning_rate(0.05).epochs(3).seed(1).batch_size(512)
             .negative_sample(negative).use_hierarchic_softmax(True))
        if m is pnlp:
            b = b.device("cpu")
        w = b.build()
        w.elements_algorithm = algo
        for k, v in kw.items():
            setattr(w, k, v)
        builds.append(w)
    return builds


@pytest.mark.parametrize("algo", ["skipgram", "cbow"])
def test_hs_per_batch_fit_matches_jax(algo):
    """HS per-batch skip-gram and CBOW draw only from numpy (windows,
    shuffles), so the fit is JAX's up to float order; the loss too."""
    seqs, ta, tb = _corpus(300)
    jw, pw = _w2v_pair(algo=algo)
    jw.fit(seqs)
    pw.fit(seqs)
    assert pw.vocab.index2word == jw.vocab.index2word
    assert _rel(pw.lookup.syn0.numpy(), np.asarray(jw.lookup.syn0)) <= TOL
    assert _rel(pw.lookup.syn1.numpy(), np.asarray(jw.lookup.syn1)) <= TOL
    assert abs(pw._last_loss - jw._last_loss) <= TOL * jw._last_loss
    assert pw.words_nearest(ta[0], 5) == jw.words_nearest(ta[0], 5)


def test_init_tables_equal_jax_bitwise():
    seqs, _, _ = _corpus(50)
    jw, pw = _w2v_pair(negative=3)
    jw.build_vocab(seqs)
    pw.build_vocab(seqs)
    np.testing.assert_array_equal(pw.lookup.syn0.numpy(),
                                  np.asarray(jw.lookup.syn0))
    np.testing.assert_array_equal(pw._neg_table, jw._neg_table)
    np.testing.assert_array_equal(pw._codes.numpy(), np.asarray(jw._codes))


@pytest.mark.parametrize("algo", ["dbow", "dm"])
def test_paragraph_vectors_match_jax(algo):
    seqs, _, _ = _corpus(100)
    docs = [(f"doc{i}", s) for i, s in enumerate(seqs[:40])]
    kw = dict(vector_length=16, epochs=5, seed=4, learning_rate=0.05,
              sequence_algorithm=algo)
    jp = jnlp.ParagraphVectors(**kw).fit_documents(docs)
    pp = pnlp.ParagraphVectors(device="cpu", **kw).fit_documents(docs)
    assert _rel(pp.doc_vectors.numpy(), np.asarray(jp.doc_vectors)) <= TOL
    assert _rel(pp.lookup.syn1.numpy(), np.asarray(jp.lookup.syn1)) <= TOL
    assert _rel(pp.lookup.syn0.numpy(), np.asarray(jp.lookup.syn0)) <= TOL
    got, want = pp.infer_vector(seqs[0]), jp.infer_vector(seqs[0])
    assert _rel(got, want) <= TOL
    assert abs(pp.similarity_to_label(seqs[0], "doc0") -
               jp.similarity_to_label(seqs[0], "doc0")) <= TOL
    if algo == "dbow":
        # the oracle's bar: doc0 (topic a) nearer doc2 (a) than doc1 (b)
        cos = lambda a, b: a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        d0, d1, d2 = (pp.get_doc_vector(f"doc{i}") for i in range(3))
        assert cos(d0, d2) > cos(d0, d1)


def test_glove_fit_matches_jax():
    seqs, ta, tb = _corpus(200)
    kw = dict(vector_length=16, window=3, epochs=20, learning_rate=0.05,
              seed=5)
    jg = jnlp.Glove(**kw).fit(seqs)
    pg = pnlp.Glove(device="cpu", **kw).fit(seqs)
    for a in ("w", "wc", "b", "bc"):
        assert _rel(getattr(pg, a).numpy(), np.asarray(getattr(jg, a))) \
            <= TOL, a
    assert abs(pg._last_loss - jg._last_loss) <= TOL * jg._last_loss
    assert pg.similarity(ta[0], ta[1]) > pg.similarity(ta[0], tb[0])


def _two_cluster_graph(m):
    g = m.Graph(10)
    for i in range(5):
        for j in range(i + 1, 5):
            g.add_edge(i, j)
            g.add_edge(i + 5, j + 5)
    g.add_edge(0, 5)   # single bridge
    return g


def test_deepwalk_matches_jax_and_clusters():
    jd = (jge.DeepWalk.Builder().vector_size(16).window_size(3)
          .learning_rate(0.05).seed(6).build())
    pd = (pge.DeepWalk.Builder().vector_size(16).window_size(3)
          .learning_rate(0.05).seed(6).device("cpu").build())
    jd.fit(_two_cluster_graph(jge), walk_length=20, walks_per_vertex=8)
    pd.fit(_two_cluster_graph(pge), walk_length=20, walks_per_vertex=8)
    assert _rel(pd.vertex_vectors.numpy(), np.asarray(jd.vertex_vectors)) \
        <= TOL
    assert _rel(pd._syn1.numpy(), np.asarray(jd._syn1)) <= TOL
    assert pd.similarity(1, 2) > pd.similarity(1, 7)
    assert pd.verticies_nearest(1, 3) == jd.verticies_nearest(1, 3)


def test_walk_iterators_equal_jax():
    for it in ("RandomWalkIterator", "WeightedWalkIterator"):
        got = list(getattr(pge, it)(_two_cluster_graph(pge), 7, seed=3))
        want = list(getattr(jge, it)(_two_cluster_graph(jge), 7, seed=3))
        assert got == want


# --------------------------------------------------- the oracles' bars
def _fit(negative, n=200, scan=False, shared=True, **kw):
    seqs, ta, tb = _corpus(n)
    b = (pnlp.Word2Vec.Builder().layer_size(16).window_size(3)
         .negative_sample(negative).epochs(10).seed(2).batch_size(256)
         .shared_negatives(shared).device("cpu"))
    if scan:
        b = b.scan_min_tokens(0)
    w = b.build().fit(seqs)
    return w, ta, tb


@pytest.mark.parametrize("negative,scan,shared", [
    (5, False, True), (5, True, True), (0, True, True), (5, True, False)],
    ids=["ns_batch", "ns_scan", "hs_scan", "ns_scan_per_pair"])
def test_topic_similarity_bars(negative, scan, shared):
    w, ta, tb = _fit(negative, scan=scan, shared=shared)
    assert w.similarity(ta[0], ta[1]) > w.similarity(ta[0], tb[0])
    assert np.isfinite(w._last_loss)


def test_hs_topic_similarity_and_nearest():
    seqs, ta, tb = _corpus(300)
    w = (pnlp.Word2Vec.Builder().layer_size(24).window_size(3)
         .min_word_frequency(1).learning_rate(0.05).epochs(3).seed(1)
         .batch_size(512).device("cpu").build().fit(seqs))
    assert w.similarity(ta[0], ta[1]) > w.similarity(ta[0], tb[0])
    assert sum(x.startswith("alpha") for x in w.words_nearest(ta[0], 5)) >= 3


def test_scan_respects_sentence_boundaries():
    rng = np.random.default_rng(7)
    seqs = []
    for _ in range(300):
        seqs.append([f"a{rng.integers(0, 4)}" for _ in range(6)])
        seqs.append([f"b{rng.integers(0, 4)}" for _ in range(6)])
    w = (pnlp.Word2Vec.Builder().layer_size(12).window_size(5)
         .negative_sample(3).epochs(6).seed(3).batch_size(512)
         .scan_min_tokens(0).device("cpu").build().fit(seqs))
    within = np.mean([w.similarity("a0", "a1"), w.similarity("b0", "b1")])
    across = np.mean([w.similarity("a0", "b0"), w.similarity("a1", "b2")])
    assert within > across


@pytest.mark.parametrize("negative,scan", [(0, False), (5, False), (5, True),
                                           (0, True)],
                         ids=["hs", "ns", "ns_scan", "hs_scan"])
def test_seeded_fit_is_reproducible(negative, scan):
    """tests/test_determinism.py's bar, on every route of the port."""
    corpus = [f"tok{i % 50} tok{(i * 7) % 50} tok{(i * 3) % 50}".split()
              for i in range(300)]
    runs = []
    for _ in range(2):
        b = (pnlp.Word2Vec.Builder().layer_size(16).window_size(2)
             .min_word_frequency(1).epochs(1).seed(5)
             .negative_sample(negative).device("cpu"))
        if scan:
            b = b.scan_min_tokens(0)
        runs.append(b.build().fit(corpus).lookup.syn0.clone())
    assert torch.equal(runs[0], runs[1])


W2V_CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "the lazy dog sleeps in the warm sun",
    "a quick red fox runs past the brown dog",
    "cats chase the quick mice in the barn",
    "the warm sun shines over the green field",
] * 4


def _input_vectors():
    """tests/test_fetchers_w2v_input.py's vectors, JAX's and the port's
    (HS per-batch: the same tables up to float order)."""
    out = []
    for m in (jnlp, pnlp):
        b = (m.Word2Vec.Builder().layer_size(16).window_size(3)
             .min_word_frequency(1).epochs(12).learning_rate(0.1).seed(11)
             .iterate(W2V_CORPUS))
        if m is pnlp:
            b = b.device("cpu")
        w = b.build()
        w.fit()
        out.append(w)
    return out


def test_word2vec_dataset_iterators_match_jax():
    jw, pw = _input_vectors()
    assert _rel(pw.lookup.syn0.numpy(), np.asarray(jw.lookup.syn0)) <= TOL
    # the same tables on both sides: the port's iterators build JAX's
    # batches bit for bit
    pw.lookup = InMemoryLookupTable.from_arrays(
        np.asarray(jw.lookup.syn0), vocab=pw.vocab, device="cpu")
    labelled = [("the quick fox runs", "animal"),
                ("the warm sun shines", "nature"),
                ("cats chase mice", "animal"),
                ("the green field", "nature"), ("zzz unknown", "nature")]
    got = list(pnlp.Word2VecDataSetIterator(pw, labelled,
                                            ["animal", "nature"], 2,
                                            max_length=3))
    want = list(jnlp.Word2VecDataSetIterator(jw, labelled,
                                             ["animal", "nature"], 2,
                                             max_length=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a in ("features", "labels", "features_mask", "labels_mask"):
            np.testing.assert_array_equal(getattr(g, a), getattr(w, a))
        assert g.labels_mask.sum(axis=1).tolist() == [1.0] * len(g.labels)
    sents = ["the quick brown fox", "the lazy dog"]
    got = list(pnlp.WindowDataSetIterator(pw, sents, 3, 4))
    want = list(jnlp.WindowDataSetIterator(jw, sents, 3, 4))
    for (g, gw), (w, ww) in zip(got, want):
        np.testing.assert_array_equal(g.features, w.features)
        assert gw == ww
    assert sum(len(w) for _, w in got) == \
        pnlp.WindowDataSetIterator(pw, sents, 3, 4).total_examples()


def test_rnn_trains_on_port_embeddings():
    """TestWord2VecInput's bar through the port: word vectors → masked
    [N, T, F] sequences → GravesLSTM → RnnOutputLayer on the CPU."""
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (GravesLSTM,
                                                         RnnOutputLayer)
    _, w2v = _input_vectors()
    labelled = [("the quick fox runs past the dog", "animal"),
                ("the warm sun shines over the field", "nature")] * 4
    it = pnlp.Word2VecDataSetIterator(w2v, labelled, ["animal", "nature"],
                                      batch_size=8)
    conf = (NeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
            .updater("adam").weight_init("xavier").list()
            .layer(GravesLSTM(n_out=12, activation="tanh"))
            .layer(RnnOutputLayer(n_out=2, loss="mcxent",
                                  activation="softmax"))
            .set_input_type(InputType.recurrent(16)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.fit(it, num_epochs=30)
    ds = next(iter(it))
    out = np.asarray(net.output(ds.features))
    correct = 0
    for j in range(len(labelled)):
        t_last = int(ds.features_mask[j].sum()) - 1
        correct += int(ds.labels[j, t_last].argmax() ==
                       out[j, t_last].argmax())
    assert correct >= 6


def test_distributed_word2vec_trains_and_matches_api():
    corpus = [s.split() for s in W2V_CORPUS[:4]] * 6
    dw2v = pnlp.DistributedWord2Vec(num_workers=2, push_frequency=2,
                                    vector_length=12, window=3,
                                    min_word_frequency=1, epochs=2, seed=5,
                                    device="cpu")
    model = dw2v.fit(corpus)
    assert dw2v.trained_sequences == len(corpus)
    assert dw2v.server.pushes >= 2
    v = model.get_word_vector("fox")
    assert v is not None and v.shape == (12,)
    assert -1.0 <= model.similarity("fox", "dog") <= 1.0
    assert model.lookup.syn0.device.type == "cpu"


# ------------------------------------------- files across the packages
def _trained_pair():
    seqs, ta, _ = _corpus(50)
    jw = (jnlp.Word2Vec.Builder().layer_size(8).epochs(1).seed(3).build()
          .fit(seqs))
    pw = (pnlp.Word2Vec.Builder().layer_size(8).epochs(1).seed(3)
          .device("cpu").build())
    pw.build_vocab(seqs)
    pw.lookup = InMemoryLookupTable.from_arrays(
        np.asarray(jw.lookup.syn0), np.asarray(jw.lookup.syn1),
        vocab=pw.vocab, device="cpu")
    return seqs, ta, jw, pw


def test_word_vector_files_cross_both_ways(tmp_path):
    _, ta, jw, pw = _trained_pair()
    S = (jnlp.WordVectorSerializer, pnlp.WordVectorSerializer)
    for writer, model in ((S[0], jw), (S[1], pw)):
        tag = "jax" if model is jw else "port"
        txt, npz = tmp_path / f"{tag}.txt", tmp_path / f"{tag}.npz"
        writer.write_word_vectors(model, txt)
        writer.write_word_vectors_binary(model, npz)
        for reader in S:
            vocab, vecs = reader.load_txt_vectors(txt)
            assert vocab.index2word == jw.vocab.index2word
            np.testing.assert_allclose(vecs[vocab.index_of(ta[0])],
                                       jw.get_word_vector(ta[0]), atol=1e-6)
            vocab, vecs = reader.load_binary_vectors(npz)
            np.testing.assert_array_equal(vecs, np.asarray(jw.lookup.syn0))
        static = pnlp.StaticWord2Vec.load(npz)
        np.testing.assert_array_equal(static.get_word_vector(ta[0]),
                                      jw.get_word_vector(ta[0]))
    assert (tmp_path / "jax.txt").read_bytes() == \
        (tmp_path / "port.txt").read_bytes()


def test_graph_vector_files_cross_both_ways(tmp_path):
    jd = jge.DeepWalk(vector_size=8, seed=7)
    jd.fit(_two_cluster_graph(jge), walk_length=10)
    pd = pge.DeepWalk(vector_size=8, seed=7, device="cpu")
    pd.fit(_two_cluster_graph(pge), walk_length=10)
    jge.GraphVectorSerializer.write_graph_vectors(jd, tmp_path / "j.txt")
    pge.GraphVectorSerializer.write_graph_vectors(pd, tmp_path / "p.txt")
    for path, model in ((tmp_path / "j.txt", jd), (tmp_path / "p.txt", pd)):
        want = pge.GraphVectorSerializer.load_graph_vectors(path)
        np.testing.assert_array_equal(
            jge.GraphVectorSerializer.load_graph_vectors(path), want)
        np.testing.assert_allclose(want, np.asarray(model.vertex_vectors),
                                   atol=1e-6)


def test_from_arrays_continues_jax_training():
    """A JAX model's tables carried into the port train on as JAX's do."""
    seqs, _, jw, pw = _trained_pair()
    jw.fit(seqs)
    pw.fit(seqs)
    assert _rel(pw.lookup.syn0.numpy(), np.asarray(jw.lookup.syn0)) <= TOL
    assert _rel(pw.lookup.syn1.numpy(), np.asarray(jw.lookup.syn1)) <= TOL


def test_host_vectors_follow_in_place_updates():
    """get_word_vector reads the table back once per version: an in-place
    training step is seen, and a returned vector is a copy."""
    seqs, ta, _, pw = _trained_pair()
    before = pw.get_word_vector(ta[0])
    before[:] = 0.0
    again = pw.get_word_vector(ta[0])
    assert np.abs(again).sum() > 0
    pw.fit(seqs)
    assert not np.array_equal(pw.get_word_vector(ta[0]), again)
    np.testing.assert_array_equal(
        pw.get_word_vector(ta[0]),
        pw.lookup.syn0[pw.vocab.index_of(ta[0])].numpy())
