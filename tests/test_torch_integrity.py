"""PyTorch port: the silent-data-corruption defence against the JAX
package, in f32 on the CPU. The injector's corruption plans,
``PageVerifier``, ``page_content_checksum`` and ``corrupt_host_frames``,
the allocator's chain eviction; the numerics sentinel in the engine (clean
runs token-identical with at most one readback a decode block, slab and
paged, K 1 and 4, speculative too; a NaN injection failing exactly the
poisoned request with NumericalFault and streaming none of its block; the
chunked prefill's accumulated verdict; a decoder / engine mismatch
rejected; ``generate`` raising); and KV-page verification (a flipped
shared-prefix page caught on the next hit, the chain evicted, the
allocator balanced); the golden canary (the same golden sequence as
JAX's, a flipped page under a replica's canary prefix quarantining it
CORRUPT as JAX's router does)."""

import numpy as np
import pytest

from deeplearning4j_tpu.models import (SlotGenerationEngine as JaxEngine,
                                       TransformerDecoder as JaxDecoder,
                                       transformer_lm_conf as jax_lm_conf)
from deeplearning4j_tpu.models import paging as jpaging
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.observability import integrity as jintegrity
from deeplearning4j_tpu.parallel.faults import \
    FaultInjector as JaxFaultInjector
from deeplearning4j_tpu_torch.models import (SlotGenerationEngine,
                                             TransformerDecoder,
                                             transformer_lm_conf)
from deeplearning4j_tpu_torch.models.paging import (PageAllocator,
                                                    PageFrameSet,
                                                    chain_digests)
from deeplearning4j_tpu_torch.observability import (IntegrityConfig,
                                                    NumericalFault,
                                                    PageVerifier,
                                                    as_integrity,
                                                    corrupt_host_frames,
                                                    page_content_checksum)
from deeplearning4j_tpu_torch.ops.transfer import fetch_counts
from deeplearning4j_tpu_torch.parallel import FaultInjector
from deeplearning4j_tpu_torch.utils import graph_from_numpy

VOCAB = 12
KW = dict(vocab_size=VOCAB, d_model=32, num_heads=2, num_layers=2,
          max_length=32, seed=5)
CFG = IntegrityConfig(kv_verify_rate=1.0)
JCFG = jintegrity.IntegrityConfig(kv_verify_rate=1.0)
COUNTERS = ("completed", "emitted_tokens", "prefills", "numerical_faults",
            "kv_page_corruptions", "prefix_cache_hits", "page_preempted")


def _sharpened(jnet):
    """The JAX net with every weight matrix scaled by 4 (both packages
    take these weights). At init a random net emits nearly one token
    whatever its context, so a clobbered cache cell could leave greedy
    tokens unchanged; sharper weights make them depend on the context."""
    jnet.params = {v: {k: a * 4 if a.ndim == 2 else a for k, a in p.items()}
                   for v, p in jnet.params.items()}
    return jnet


@pytest.fixture(scope="module")
def nets():
    """{"jnet", "net", and (plain, sentinel) decoders of each package} on
    the same parameters; every engine of the module shares them."""
    jnet = _sharpened(JaxGraph(jax_lm_conf(**KW)).init())
    net = graph_from_numpy(transformer_lm_conf(**KW),
                           {v: {k: np.asarray(a) for k, a in p.items()}
                            for v, p in jnet.params.items()}, device="cpu")
    return {"jnet": jnet, "net": net,
            "jdec": JaxDecoder(jnet),
            "jdec_s": JaxDecoder(jnet, sentinel=True,
                                 logit_bound=JCFG.logit_bound),
            "dec": TransformerDecoder(net),
            "dec_s": TransformerDecoder(net, sentinel=True,
                                        logit_bound=CFG.logit_bound)}


def _prompts(seed, n, lo=2, hi=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, int(rng.integers(lo, hi)))
            for _ in range(n)]


def _run(engine, prompts, gens, temps=None):
    temps = temps or [0.0] * len(prompts)
    reqs = [engine.submit(p, g, temperature=t)
            for p, g, t in zip(prompts, gens, temps)]
    engine.run_until_drained()
    return reqs


def _same_outcome(got, want):
    for g, w in zip(got, want):
        if w._error is None:
            assert g._error is None, g
            np.testing.assert_array_equal(g.result(0), w.result(0))
        else:
            assert type(g._error).__name__ == type(w._error).__name__


def _same_counters(eng, jeng, keys=COUNTERS):
    st, jst = eng.stats(), jeng.stats()
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}


# ------------------------------------------------------ injector plans
def test_corruption_fires_by_site_scoped_hits():
    inj = FaultInjector()
    inj.corrupt("device.corrupt_page", mode="flip", at=2,
                where="registered")
    assert inj.corruption("device.corrupt_page", where="handoff") is None
    assert inj.corruption("device.corrupt_page",
                          where="registered") is None        # hit 1
    assert inj.corruption("device.corrupt_page",
                          where="registered") == {"mode": "flip"}
    assert inj.corruption("device.corrupt_page",
                          where="registered") is None        # exhausted
    assert inj.hits("device.corrupt_page@registered") == 3


def test_fire_skips_corrupt_plans_and_modes_validate():
    inj = FaultInjector()
    inj.corrupt("engine.step", mode="nan")
    assert inj.fire("engine.step") is False
    assert inj.corruption("engine.step") == {"mode": "nan"}
    with pytest.raises(ValueError):
        inj.corrupt("engine.step", mode="zero")


def test_clear_point_disarms_site_scoped_plans():
    inj = FaultInjector()
    inj.corrupt("device.corrupt_page", where="registered")
    inj.corrupt("device.corrupt_page", where="handoff")
    inj.clear("device.corrupt_page")
    assert inj.corruption("device.corrupt_page", where="registered") is None
    assert inj.corruption("device.corrupt_page", where="handoff") is None


# ------------------------------------------------ verifier, checksums
def test_page_verifier_record_check_staleness_forget():
    pv = PageVerifier(capacity=4)
    a, b = b"digestA", b"digestB"
    assert pv.check(a, 3, b"sum1") is None        # first sight records
    assert pv.check(a, 3, b"sum1") is True
    assert pv.check(a, 3, b"sum2") is False       # corrupt
    assert pv.mismatches == 1
    assert pv.check(a, 9, b"sum3") is None        # a new page refreshes
    assert pv.check(a, 9, b"sum3") is True
    pv.forget([a])
    assert pv.expected(a, 9) is None
    assert pv.check(b, 1, b"x") is None and len(pv) <= 4
    for i in range(6):
        pv.record(bytes([i]), i, b"s")
    assert len(pv) == 4                           # bounded


def test_checksum_matches_jax_and_is_order_sensitive():
    x = np.arange(8, dtype=np.float32)
    y = x + 1
    assert page_content_checksum([x, y]) == \
        jintegrity.page_content_checksum([x, y])
    assert page_content_checksum([x, y]) != page_content_checksum([y, x])
    assert as_integrity(True) == IntegrityConfig()
    assert as_integrity(None) is None
    assert IntegrityConfig(kv_verify_rate=0.25).verify_every == 4
    assert IntegrityConfig(kv_verify_rate=0.0).verify_every == 0
    with pytest.raises(TypeError):
        as_integrity("yes")


def _frames(dtype="float32", seed=0, n_pages=2):
    rng = np.random.default_rng(seed)
    layers = {f"attn{i}": {kk: rng.normal(size=(n_pages, 2, 4, 3))
                           .astype(np.float32) for kk in ("k", "v")}
              for i in range(2)}
    if dtype == "bfloat16":     # raw words, as PageFrameSet holds them
        layers = {n: {kk: (a.view(np.uint32) >> 16).astype(np.uint16)
                      for kk, a in kv.items()} for n, kv in layers.items()}
    return PageFrameSet(4, rng.integers(0, 50, 7), layers, dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["nan", "flip"])
def test_corrupt_host_frames_caught_by_content_checksums(dtype, mode):
    """A corruption after the checksums were stamped: every page CRC
    computed later passes, the content checksum does not. f32 frames
    corrupt byte for byte as the JAX package's do."""
    st = _frames(dtype)
    corrupt_host_frames(st, mode=mode, page=1)
    assert st.verify() == [1]
    if dtype == "bfloat16":
        a = st.layers["attn0"]["k"][1]
        assert (a == 0x7FC0).all() if mode == "nan" else \
            ((a ^ _frames(dtype).layers["attn0"]["k"][1]) == 0x8000).all()
        return
    ref = _frames(dtype)
    jst = jpaging.PageFrameSet(4, ref.tokens, ref.layers)
    jintegrity.corrupt_host_frames(jst, mode=mode, page=1)
    for n in st.layers:
        for kk in ("k", "v"):
            assert st.layers[n][kk].tobytes() == jst.layers[n][kk].tobytes()


def test_allocator_chain_eviction_balanced():
    pa = PageAllocator(8, 4)
    toks = np.arange(8)
    pages = pa.alloc(2)
    pa.register_chain(toks, pages)
    dgs = chain_digests(toks, 4)
    assert pa.cached_page(dgs[0]) == pages[0]
    assert pa.evict_digests(dgs) == 2 and pa.cached_page(dgs[0]) is None
    assert pa.audit([pages]) == []           # mapping refs intact
    assert pa.free_subset(pages) == []
    for pid in pages:
        pa.unref(pid)
    assert pa.free_subset(pages) == sorted(pages)
    assert pa.audit([]) == []
    pages = pa.alloc(2)
    pa.register_chain(toks, pages)
    assert sorted(pa.evict_pages(pages)) == sorted(dgs)


# ------------------------------------------------------ the sentinel
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
@pytest.mark.parametrize("k", [1, 4])
def test_sentinel_clean_parity_one_readback_a_block(nets, paged, k):
    """Sentinel on changes no token: greedy ones equal the JAX sentinel
    engine's, sampled ones the sentinel-off port engine's; the verdict
    rides the block's one readback."""
    rng = np.random.default_rng(7)
    prompts = _prompts(7, 8)
    gens = [int(rng.integers(3, 8)) for _ in range(8)]
    pg = dict(paged=True, page_size=8) if paged else {}
    jeng = JaxEngine(nets["jnet"], num_slots=2, decoder=nets["jdec_s"],
                     block_size=k, integrity=JCFG, **pg)
    eng = SlotGenerationEngine(nets["net"], num_slots=2,
                               decoder=nets["dec_s"], block_size=k,
                               integrity=CFG, **pg)
    before = fetch_counts("engine.decode")["engine.decode"]
    reqs = _run(eng, prompts, gens)
    fetched = fetch_counts("engine.decode")["engine.decode"] - before
    _same_outcome(reqs, _run(jeng, prompts, gens))
    _same_counters(eng, jeng)
    st = eng.stats()
    assert st["numerical_faults"] == 0
    assert fetched <= st["decode_blocks"]
    temps = [0.0, 0.9] * 4
    plain = SlotGenerationEngine(nets["net"], num_slots=2,
                                 decoder=nets["dec"], block_size=k,
                                 seed=3, **pg)
    on = SlotGenerationEngine(nets["net"], num_slots=2,
                              decoder=nets["dec_s"], block_size=k, seed=3,
                              integrity=CFG, **pg)
    _same_outcome(_run(on, prompts, gens, temps),
                  _run(plain, prompts, gens, temps))


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_sentinel_speculative_parity(nets, paged):
    """Verify blocks carry the verdict column too."""
    rng = np.random.default_rng(8)
    motif = rng.integers(0, VOCAB, 4)
    prompts = [np.tile(motif, 3)[:int(n)] for n in rng.integers(6, 12, 4)]
    gens = [8] * 4
    pg = dict(paged=True, page_size=8) if paged else {}
    kw = dict(num_slots=2, speculative=True, spec_k=3, spec_threshold=0.0)
    jeng = JaxEngine(nets["jnet"], decoder=nets["jdec_s"], integrity=JCFG,
                     **kw, **pg)
    eng = SlotGenerationEngine(nets["net"], decoder=nets["dec_s"],
                               integrity=CFG, **kw, **pg)
    reqs = _run(eng, prompts, gens)
    _same_outcome(reqs, _run(jeng, prompts, gens))
    assert eng.stats()["spec_blocks"] > 0
    assert eng.stats()["numerical_faults"] == 0


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_nan_injection_fails_typed_never_streams(nets, paged):
    """``device.corrupt_logits`` at the first block: exactly the request
    of the poisoned lane fails with NumericalFault and keeps only its
    clean tokens; every other request is token-identical; the same
    request fails on the JAX engine; the allocator balances."""
    prompts = _prompts(0, 6)
    gens = [5] * 6
    pg = dict(paged=True, page_size=8) if paged else {}
    outs = []
    for pkg in ("jax", "port"):
        inj = (JaxFaultInjector if pkg == "jax" else FaultInjector)()
        inj.corrupt("device.corrupt_logits", mode="nan", at=1)
        if pkg == "jax":
            eng = JaxEngine(nets["jnet"], num_slots=2,
                            decoder=nets["jdec_s"], block_size=4,
                            integrity=JCFG, fault_injector=inj, **pg)
        else:
            eng = SlotGenerationEngine(nets["net"], num_slots=2,
                                       decoder=nets["dec_s"], block_size=4,
                                       integrity=CFG, fault_injector=inj,
                                       **pg)
        outs.append((eng, _run(eng, prompts, gens)))
    (jeng, jreqs), (eng, reqs) = outs
    _same_outcome(reqs, jreqs)
    faulted = [r for r in reqs if isinstance(r._error, NumericalFault)]
    assert len(faulted) == 1 and len(faulted[0].generated) == 1
    assert all(r.state == r.DONE for r in reqs if r not in faulted)
    _same_counters(eng, jeng)
    if paged:
        assert eng._pager.audit(eng._slot_pages) == []


def test_chunked_prefill_carries_the_verdict(nets):
    """Windows OR the verdict on the device, read back only with the
    final window: a clean chunked run stays token-identical with one
    prefill readback per final window or admission; with a bound every
    logit exceeds, every request fails typed at its first token, as on
    the JAX engine."""
    prompts = _prompts(5, 3, lo=20, hi=21)
    gens = [4] * 3
    plain = SlotGenerationEngine(nets["net"], num_slots=2,
                                 decoder=nets["dec"])
    want = _run(plain, prompts, gens)
    eng = SlotGenerationEngine(nets["net"], num_slots=2,
                               decoder=nets["dec_s"], prefill_chunk=8,
                               integrity=CFG)
    before = fetch_counts("engine.prefill")["engine.prefill"]
    _same_outcome(_run(eng, prompts, gens), want)
    fetched = fetch_counts("engine.prefill")["engine.prefill"] - before
    st = eng.stats()
    assert st["prefill_chunks"] >= 6
    assert fetched <= st["prefills"] + st["prefill_batches"]
    tiny = IntegrityConfig(logit_bound=1e-9)
    dec_t = TransformerDecoder(nets["net"], sentinel=True, logit_bound=1e-9)
    jdec_t = JaxDecoder(nets["jnet"], sentinel=True, logit_bound=1e-9)
    eng = SlotGenerationEngine(nets["net"], num_slots=2, decoder=dec_t,
                               prefill_chunk=8, integrity=tiny)
    jeng = JaxEngine(nets["jnet"], num_slots=2, decoder=jdec_t,
                     prefill_chunk=8, integrity=jintegrity.IntegrityConfig(
                         logit_bound=1e-9))
    prompts = prompts + _prompts(6, 2)          # short ones: whole prefill
    reqs = _run(eng, prompts, [4] * 5)
    _same_outcome(reqs, _run(jeng, prompts, [4] * 5))
    assert all(isinstance(r._error, NumericalFault) and not r.generated
               for r in reqs)
    _same_counters(eng, jeng)
    assert not eng._any_active()


def test_mismatched_decoder_and_engine_rejected(nets):
    with pytest.raises(ValueError, match="sentinel"):
        SlotGenerationEngine(nets["net"], decoder=nets["dec_s"])
    with pytest.raises(ValueError, match="sentinel"):
        SlotGenerationEngine(nets["net"], decoder=nets["dec"],
                             integrity=CFG)
    eng = SlotGenerationEngine(nets["net"], integrity=True, device="cpu")
    assert eng.decoder.sentinel and eng.decoder.logit_bound == 1e4


def test_generate_raises_on_a_sentinel_trip(nets):
    dec = TransformerDecoder(nets["net"], sentinel=True, logit_bound=1e-9)
    with pytest.raises(NumericalFault):
        dec.generate([[1, 2, 3]], 6, block_size=4)
    np.testing.assert_array_equal(
        TransformerDecoder(nets["net"], sentinel=True).generate(
            [[1, 2, 3]], 6, block_size=4)[0],
        nets["dec"].generate([[1, 2, 3]], 6, block_size=4)[0])


# ------------------------------------------------ KV page verification
def test_shared_prefix_flip_detected_chain_evicted(nets):
    """The next registration flips the first page of the published chain
    (at rest); the next hit verifies at rate 1.0, catches it, evicts the
    chain and re-prefills as a miss, token-identically; the allocator
    balances; the re-registered chain verifies clean. Token for token
    and counter for counter as the JAX engine."""
    sys_prompt = np.random.default_rng(11).integers(0, VOCAB, 17)
    outs = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            inj = JaxFaultInjector()
            eng = JaxEngine(nets["jnet"], num_slots=2,
                            decoder=nets["jdec_s"], block_size=4,
                            paged=True, page_size=8, num_pages=64,
                            integrity=JCFG, fault_injector=inj)
        else:
            inj = FaultInjector()
            eng = SlotGenerationEngine(nets["net"], num_slots=2,
                                       decoder=nets["dec_s"], block_size=4,
                                       paged=True, page_size=8,
                                       num_pages=64, integrity=CFG,
                                       fault_injector=inj)
        first = _run(eng, [sys_prompt], [4])[0]
        inj.corrupt("device.corrupt_page", mode="flip", at=1,
                    where="registered")
        _run(eng, [np.concatenate([sys_prompt, [2]])], [3])
        before = eng.stats()["kv_page_corruptions"]
        again = _run(eng, [sys_prompt], [4])[0]
        assert eng.stats()["kv_page_corruptions"] == before + 1
        np.testing.assert_array_equal(again.result(0), first.result(0))
        assert eng._pager.audit(eng._slot_pages) == []
        hits = eng.stats()["prefix_cache_hits"]
        third = _run(eng, [sys_prompt], [4])[0]
        np.testing.assert_array_equal(third.result(0), first.result(0))
        assert eng.stats()["prefix_cache_hits"] > hits
        assert eng.stats()["kv_page_corruptions"] == before + 1
        outs.append((eng, [first, again, third]))
    (jeng, jreqs), (eng, reqs) = outs
    _same_outcome(reqs, jreqs)
    _same_counters(eng, jeng)
    assert len(eng._kv_verifier) > 0


# --------------------------------------------------------- golden canary
def test_golden_canary_records_and_compares_as_jax():
    from deeplearning4j_tpu_torch.observability import GoldenCanary
    for vocab in (2, 12, 32000):
        assert GoldenCanary.default_prompt(vocab) == \
            jintegrity.GoldenCanary.default_prompt(vocab)
    got, want = GoldenCanary((3, 4)), jintegrity.GoldenCanary((3, 4))
    for c in (got, want):
        assert c.observe(2, [3, 4, 5, 6]) is None
        assert c.observe(2, [3, 4, 5, 6]) is True
        assert c.observe(2, [3, 4, 5, 7]) is False
        assert c.observe(1, [3, 4, 9]) is None
    assert got.golden(2) == want.golden(2) and got.golden(1) == want.golden(1)
    with pytest.raises(ValueError):
        GoldenCanary(())
    assert IntegrityConfig().canary_period is None
    for field in ("canary_period", "canary_tokens", "canary_prompt",
                  "canary_deadline", "fault_threshold", "fault_window",
                  "replace_corrupt"):
        assert getattr(IntegrityConfig(), field) == \
            getattr(jintegrity.IntegrityConfig(), field), field


def _canary_flip(router_cls, inj_cls, net, cfg, sentinel_dec):
    injs = [inj_cls(), inj_cls()]
    router = router_cls(net, num_replicas=2, decoder=sentinel_dec,
                        num_slots=2, block_size=4, paged=True, page_size=4,
                        integrity=cfg, replica_injectors=injs)
    router.start()
    try:
        round1 = router.canary_round()
        golden = router._canary.golden(cfg.canary_tokens)
        injs[0].corrupt("device.corrupt_page", mode="flip", at=1,
                        where="registered")
        prompt = list(router._canary.prompt) + [1, 1]
        router.submit(prompt, 2, replica_id="r0").result(30)
        round2 = router.canary_round()
        states = {rid: router.replica_state(rid)
                  for rid in router.replica_ids()}
        return (round1, round2, states, int(router.corrupt_quarantines),
                golden)
    finally:
        router.shutdown()


def test_canary_round_quarantines_a_flipped_replica_as_jax(nets):
    """The fleet's canary records the same golden sequence as JAX's on
    the first round; a page flipped at rest under r0's canary prefix
    gives the same verdict in both packages: r0 mismatches and is
    quarantined CORRUPT, a replacement grows."""
    from deeplearning4j_tpu.streaming.fleet import \
        EngineFleetRouter as JaxRouter
    from deeplearning4j_tpu_torch.streaming import EngineFleetRouter
    cfg = IntegrityConfig(kv_verify=False, fault_threshold=1,
                          canary_tokens=4)
    jcfg = jintegrity.IntegrityConfig(kv_verify=False, fault_threshold=1,
                                      canary_tokens=4)
    want = _canary_flip(JaxRouter, JaxFaultInjector, nets["jnet"], jcfg,
                        nets["jdec_s"])
    got = _canary_flip(EngineFleetRouter, FaultInjector, nets["net"], cfg,
                       nets["dec_s"])
    assert got == want
    assert got[0] == {"r0": "ok", "r1": "ok"}
    assert got[1]["r0"] == "mismatch" and got[2]["r0"] == "CORRUPT"
    assert got[3] == 1 and len(got[4]) == 6 + 4    # prompt + 4 tokens
