"""PyTorch port: speculative decoding against the JAX package. The
prompt-lookup drafter's drafts, ``verify_block`` / ``paged_verify_block``
outputs and written cells, and the speculative engines (slab and paged,
spec_k in {1, 2, 4}) token-identical to JAX's with equal ``spec_*``
accounting; plus the port's own contracts: a verify window emits what
decode_block would (sampled included), eos inside an accepted window,
and zero acceptance with the page audit balanced after every rewind.

The net is the JAX suite's: trained briefly on cycles of 12 tokens, so
cyclic prompts are accepted and random ones rejected."""

import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.models import (SlotGenerationEngine as JaxEngine,
                                       TransformerDecoder as JaxDecoder,
                                       lm_batch,
                                       transformer_lm_conf as jax_lm_conf)
from deeplearning4j_tpu.models.speculative import NGramDrafter as JaxDrafter
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.ops.dataset import DataSet
from deeplearning4j_tpu_torch.models import (SlotGenerationEngine,
                                             TransformerDecoder,
                                             transformer_lm_conf)
from deeplearning4j_tpu_torch.models.speculative import NGramDrafter
from deeplearning4j_tpu_torch.utils import graph_from_numpy

KW = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2,
          max_length=32, learning_rate=1e-2, seed=5)
CYCLE = 12
TOL = dict(rtol=1e-5, atol=1e-5)
SPEC_KEYS = ("spec_blocks", "spec_drafted", "spec_accepted_tokens",
             "spec_fallbacks", "decode_blocks", "completed",
             "prefix_cache_hits", "prefix_cache_hit_tokens")


@pytest.fixture(scope="module")
def nets():
    """(JAX net trained on 12-token cycles, port net with its weights)."""
    rng = np.random.default_rng(4242)
    jnet = JaxGraph(jax_lm_conf(**KW)).init()
    seq = (rng.integers(0, CYCLE, (16, 1)) + np.arange(17)[None]) % CYCLE
    ds = DataSet(*lm_batch(seq, KW["vocab_size"]))
    for _ in range(120):
        jnet.fit_batch(ds)
    net = graph_from_numpy(transformer_lm_conf(**KW),
                           {v: {k: np.asarray(a) for k, a in p.items()}
                            for v, p in jnet.params.items()}, device="cpu")
    return jnet, net


def _cyclic(start, n=13):
    return ((start + np.arange(n)) % CYCLE).astype(np.int64)


def _prompts(rng, n=8):
    """Half cyclic (draftable: 13 tokens cover a period), half random."""
    return [_cyclic(int(rng.integers(0, CYCLE))) if i % 2 == 0
            else rng.integers(0, CYCLE, int(rng.integers(3, 7)))
            for i in range(n)]


def _run(engine, prompts, gens, **submit_kw):
    reqs = [engine.submit(p, g, **submit_kw) for p, g in zip(prompts, gens)]
    engine.run_until_drained()
    return [r.result(5) for r in reqs]


def _bad_draft(self, k):
    """Out of vocabulary: never a selection, so every draft is rejected."""
    return np.full(k, -1, np.int32)


# ------------------------------------------------------------- drafter
DRAFTER_CASES = {
    "empty": ([], [], 3, [0, 0, 0]),
    "repeat_last": ([1, 2, 3], [], 2, [3, 3]),
    "suffix_match": ([5, 6, 7, 9, 5, 6, 7], [], 3, [9, 5, 6]),
    "lag_wrap": ([(3 + i) % CYCLE for i in range(16)], [], 20,
                 [(3 + 16 + j) % CYCLE for j in range(20)]),
    "with_generated": ([4, 8, 1], [4, 8, 1, 4], 4, [8, 1, 4, 8]),
}


@pytest.mark.parametrize("case", sorted(DRAFTER_CASES))
def test_drafts_equal_jax(case):
    prompt, generated, k, want = DRAFTER_CASES[case]
    ours, theirs = NGramDrafter(3), JaxDrafter(3)
    if prompt or generated:
        ours.sync(case, prompt, generated)
        theirs.sync(case, prompt, generated)
    assert list(ours.draft(k)) == list(theirs.draft(k)) == want


def test_drafter_rebuilds_on_owner_change_and_truncation():
    d = NGramDrafter(3)
    d.sync("a", [1, 2, 3], [4, 5])
    assert len(d) == 5
    d.sync("a", [1, 2, 3], [4])                   # truncated: rebuild
    assert len(d) == 4
    d.sync(object(), [9, 9], [])                  # new owner: rebuild
    assert len(d) == 2


def test_incremental_sync_matches_rebuild_and_jax():
    rng = np.random.default_rng(7)
    toks = list(rng.integers(0, CYCLE, 40))
    inc, scratch, theirs = NGramDrafter(3), NGramDrafter(3), JaxDrafter(3)
    for i in range(10, 41):
        inc.sync("o", toks[:5], toks[5:i])
        theirs.sync("o", toks[:5], toks[5:i])
        assert list(inc.draft(6)) == list(theirs.draft(6))
    scratch.sync("o", toks[:5], toks[5:])
    assert list(inc.draft(6)) == list(scratch.draft(6))


# ---------------------------------------------------- verify programs
def _verify_case():
    """Four lanes: a cyclic prompt whose third drafted token is its eos,
    a random prompt with a random draft, a cyclic prompt at position 29
    (3 cells to the context edge) and a frozen lane."""
    rng = np.random.default_rng(8)
    prompts = [_cyclic(3), rng.integers(0, CYCLE, 6), _cyclic(5, 29),
               rng.integers(0, CYCLE, 5)]
    tokens = np.zeros((4, 32), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    lengths = np.array([len(p) for p in prompts], np.int32)
    # the window starts at the prefill's selection (the cycle's next
    # token), so the drafts continue from the one after it
    draft = np.stack([_cyclic(5, 4), rng.integers(0, CYCLE, 4),
                      _cyclic(11, 4), np.zeros(4)]).astype(np.int32)
    eos = np.array([draft[0, 2], -1, -1, -1], np.int32)
    stopped = np.array([False, False, False, True])
    return tokens, lengths, draft, eos, stopped


@pytest.mark.parametrize("paged", [False, True])
def test_verify_block_matches_jax(nets, paged):
    jnet, net = nets
    jd, td = JaxDecoder(jnet), TransformerDecoder(net)
    tokens, lengths, draft, eos, stopped = _verify_case()
    ptab = (np.arange(16, dtype=np.int32) + 1).reshape(4, 4)
    if paged:
        jc, tc = jd.init_paged_pool(17, 8), td.init_paged_pool(17, 8)
        z = np.zeros(4, np.int32)
        jids, jc = jd.paged_prefill(jc, tokens, z, lengths, ptab)
        ids, _, tc = td.paged_prefill(tc, tokens, z, lengths, ptab)
        want = jd.paged_verify_block(jc, ptab, np.asarray(jids), lengths,
                                     draft, eos_ids=eos, stopped=stopped)
        got = td.paged_verify_block(tc, ptab, ids, lengths, draft,
                                    eos_ids=eos, stopped=stopped)
    else:
        jids, _, jc = jd.prefill(jd.init_cache(4), tokens, lengths)
        ids, _, tc = td.prefill(td.init_cache(4), tokens, lengths)
        want = jd.verify_block(jc, np.asarray(jids), lengths, draft,
                               eos_ids=eos, stopped=stopped)
        got = td.verify_block(tc, ids, lengths, draft, eos_ids=eos,
                              stopped=stopped)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for name in td.attn_names:
        for kk in ("k", "v"):
            g, w = got[4][name][kk].numpy(), np.asarray(want[4][name][kk])
            if paged:
                g, w = g[1:], w[1:]
            np.testing.assert_allclose(g, w, **TOL)
    out = got[0].numpy()
    emit = out[:, -1]
    assert emit[0] == 3 and out[0, 2] == eos[0]    # cut after its eos
    assert 1 <= emit[2] <= 3 and emit[3] == 0
    assert got[3].numpy().tolist() == [True, False, emit[2] == 3, True]


def test_sampled_verify_emits_what_decode_block_would(nets):
    """From identical caches, a verify window at step0 emits decode_block's
    tokens (K = spec_k + 1, same step0, temperature 1): all of them where
    the draft is its own tokens, up to and including the first
    mismatch's position otherwise."""
    _, net = nets
    td = TransformerDecoder(net)
    tokens, lengths, _, _, _ = _verify_case()
    tokens, lengths = tokens[:2], lengths[:2]
    ids, _, cache = td.prefill(td.init_cache(2), tokens, lengths)
    twin = {n: {kk: t.clone() for kk, t in kv.items()}
            for n, kv in cache.items()}
    temps = np.ones(2, np.float32)
    kw = dict(seed=7, step0=10, key_salt=1 << 20)
    toks = td.decode_block(cache, ids, lengths, temps, block_size=5,
                           **kw)[0].numpy()
    draft = toks[:, :4].copy()
    draft[1, 2] = (draft[1, 2] + 1) % 64
    out = td.verify_block(twin, ids, lengths, draft, temps, **kw)[0].numpy()
    assert out[0, -1] == 5 and out[1, -1] == 3
    np.testing.assert_array_equal(out[0, :5], toks[0])
    np.testing.assert_array_equal(out[1, :3], toks[1, :3])


# ------------------------------------------------------------- engines
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_engine_matches_jax_engine(nets, k, paged):
    jnet, net = nets
    rng = np.random.default_rng(9)
    prompts = _prompts(rng)
    gens = [int(g) for g in rng.integers(3, 9, len(prompts))]
    kw = dict(num_slots=2, block_size=min(k, 4), speculative=True,
              spec_k=k)
    if paged:
        kw.update(paged=True, page_size=8)
    jeng = JaxEngine(jnet, **kw)
    want = _run(jeng, prompts, gens)
    eng = SlotGenerationEngine(net, device="cpu", **kw)
    got = _run(eng, prompts, gens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    st, jst = eng.stats(), jeng.stats()
    assert {key: st[key] for key in SPEC_KEYS} == \
        {key: jst[key] for key in SPEC_KEYS}
    assert st["spec_blocks"] > 0 and st["spec_accepted_tokens"] > 0
    # one readback per admission and per verify or plain block
    assert st["host_readbacks"] <= st["prefill_batches"] + \
        st["decode_blocks"]
    plain = _run(SlotGenerationEngine(net, num_slots=2, block_size=4,
                                      device="cpu"), prompts, gens)
    for g, w in zip(got, plain):
        np.testing.assert_array_equal(g, w)
    if paged:
        assert eng._pager.audit(eng._slot_pages) == []


def test_fixed_seed_sampled_spec_equals_spec_off(monkeypatch):
    """Sampled rows of an untrained net (flat logits, so the draws vary
    with the seed) through a drafter that proposes the spec-off run's own
    continuation: every verify block spends spec_k + 1 steps of the seed
    schedule, as a plain block of K = spec_k + 1 does, so the sampled
    streams are identical."""
    jnet = JaxGraph(jax_lm_conf(**KW)).init()
    net = graph_from_numpy(transformer_lm_conf(**KW),
                           {v: {k: np.asarray(a) for k, a in p.items()}
                            for v, p in jnet.params.items()}, device="cpu")
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, 64, int(n)) for n in (6, 3, 9, 4)]
    gens = [11, 9, 14, 12]
    temps = [0.9, 0.0, 1.3, 0.7]

    def run(seed, **kw):
        eng = SlotGenerationEngine(net, num_slots=4, seed=seed,
                                   block_size=4, device="cpu", **kw)
        reqs = [eng.submit(p, g, temperature=t)
                for p, g, t in zip(prompts, gens, temps)]
        eng.run_until_drained()
        return eng, [r.result(5) for r in reqs]

    _, want = run(3)
    _, reseeded = run(4)
    assert any((a != b).any() for a, b in zip(reseeded, want))

    def oracle(self, k):
        full = next(w for w in want
                    if list(w[:len(self._tokens)]) == self._tokens)
        out = np.zeros(k, np.int32)
        tail = full[len(self._tokens):len(self._tokens) + k]
        out[:len(tail)] = tail
        return out

    monkeypatch.setattr(NGramDrafter, "draft", oracle)
    eng, got = run(3, speculative=True, spec_k=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    st = eng.stats()
    assert st["spec_fallbacks"] == 0 and st["spec_accepted_tokens"] > 0


def test_eos_inside_an_accepted_window(nets):
    """The cyclic continuation reaches each stream's eos a few tokens in,
    inside the K = 8 window: emission stops at the eos, as without
    speculation and as in the JAX engine."""
    jnet, net = nets
    rng = np.random.default_rng(17)
    prompts = [_cyclic(int(rng.integers(0, CYCLE))) for _ in range(4)]
    eos = [int((p[-1] + 4) % CYCLE) for p in prompts]
    kw = dict(num_slots=2, block_size=4, speculative=True, spec_k=8,
              paged=True, page_size=8)
    eng = SlotGenerationEngine(net, device="cpu", **kw)
    jeng = JaxEngine(jnet, **kw)
    reqs = [eng.submit(p, 10, eos_id=e) for p, e in zip(prompts, eos)]
    jreqs = [jeng.submit(p, 10, eos_id=e) for p, e in zip(prompts, eos)]
    eng.run_until_drained()
    jeng.run_until_drained()
    for p, e, r, j in zip(prompts, eos, reqs, jreqs):
        want = _run(SlotGenerationEngine(net, num_slots=2, block_size=4,
                                         device="cpu"), [p], [10],
                    eos_id=e)[0]
        got = r.result(5)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, j.result(5))
        assert got[-1] == e and len(got) - len(p) < 10
    assert eng.stats()["spec_accepted_tokens"] > 0
    assert eng._pager.audit(eng._slot_pages) == []


@pytest.mark.parametrize("paged", [False, True])
def test_zero_acceptance_falls_back_and_rewinds(nets, monkeypatch, paged):
    """A drafter that is always wrong: every verify block emits only its
    bonus token and rewinds the rest, the cooldown routes through plain
    blocks with a probe every 2, output stays the spec-off output, the
    accounting equals JAX's under the same drafter, and every rewind
    leaves the page refcounts balanced."""
    jnet, net = nets
    rng = np.random.default_rng(23)
    prompts = _prompts(rng)
    gens = [int(g) for g in rng.integers(3, 9, len(prompts))]
    want = _run(SlotGenerationEngine(net, num_slots=2, block_size=4,
                                     device="cpu"), prompts, gens)
    monkeypatch.setattr(NGramDrafter, "draft", _bad_draft)
    monkeypatch.setattr(JaxDrafter, "draft", _bad_draft)
    kw = dict(num_slots=2, block_size=4, speculative=True, spec_k=4,
              spec_probe_every=2)
    if paged:
        kw.update(paged=True, page_size=8)
    eng = SlotGenerationEngine(net, device="cpu", **kw)
    retire = eng._retire_spec
    tight = []

    def check_rewind(*args):
        # after a rewind a lane maps exactly the pages its context covers
        retire(*args)
        tight.extend(len(eng._slot_pages[s]) ==
                     max(1, -(-int(eng._positions[s]) // 8))
                     for s in range(2) if eng._slots[s] is not None)

    monkeypatch.setattr(eng, "_retire_spec", check_rewind)
    got = _run(eng, prompts, gens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if paged:
        assert tight and all(tight)
    jeng = JaxEngine(jnet, **kw)
    _run(jeng, prompts, gens)
    st, jst = eng.stats(), jeng.stats()
    assert {key: st[key] for key in SPEC_KEYS} == \
        {key: jst[key] for key in SPEC_KEYS}
    assert st["spec_blocks"] > 0 and st["spec_fallbacks"] > 0
    assert st["spec_accepted_tokens"] == 0
    if paged:
        assert eng._pager.audit(eng._slot_pages) == []
        assert eng.kv_page_stats()["mapped"] == 0


def test_spec_engine_defaults(nets):
    _, net = nets
    eng = SlotGenerationEngine(net, block_size=2, speculative=True,
                               device="cpu")
    assert eng.spec_k == 4 and eng.spec_ngram == 3
    assert eng.spec_threshold == 0.35 and eng.spec_probe_every == 16
    assert SlotGenerationEngine(net, block_size=8, speculative=True,
                                device="cpu").spec_k == 8
