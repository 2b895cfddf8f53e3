"""PyTorch port: the serving engine's scheduling tier against the JAX
package on the same seeded weights, in f32 on the CPU. Chunked prefill
(slab and paged, K 1 and 4, the final window's slide at the cache edge,
cancel / deadline mid-chunk, quarantine of a chunking request), EDF order
and its FIFO tie-break, headroom shedding (one shed, every chunk window
charged, the re-shed at pop time), adaptive K (the policy, and parity
while K switches), the supervisor keeping the policy across a restart,
and ``recompute_logits`` within 1e-5 of JAX. Greedy tokens identical,
counters and exception types equal."""

import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import (SlotGenerationEngine as JaxEngine,
                                       TransformerDecoder as JaxDecoder,
                                       transformer_lm_conf as jax_lm_conf)
from deeplearning4j_tpu.models.generation import \
    GenerationRequest as JaxRequest
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu_torch.models import (SlotGenerationEngine,
                                             TransformerDecoder,
                                             transformer_lm_conf)
from deeplearning4j_tpu_torch.models.generation import GenerationRequest
from deeplearning4j_tpu_torch.observability import interval_now
from deeplearning4j_tpu_torch.parallel import (Cancelled, DeadlineExceeded,
                                               EngineSupervisor,
                                               RejectedError)
from deeplearning4j_tpu_torch.utils import graph_from_numpy

KW = dict(vocab_size=12, d_model=32, num_heads=2, num_layers=2,
          max_length=64, seed=5)
#: counters both engines keep the same way on every path
COUNTERS = ("prefills", "prefill_chunks", "completed", "emitted_tokens",
            "rejected", "headroom_shed", "deadline_exceeded", "cancelled",
            "failed")


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
    """(JAX net, JAX decoder, port net, port decoder) on the same
    parameters; every engine of the module shares the decoders."""
    jnet = _sharpened(JaxGraph(jax_lm_conf(**KW)).init())
    net = graph_from_numpy(transformer_lm_conf(**KW),
                           {v: {k: np.asarray(a) for k, a in p.items()}
                            for v, p in jnet.params.items()}, device="cpu")
    return jnet, JaxDecoder(jnet), net, TransformerDecoder(net)


def _prompts(seed, n, lo=2, hi=30):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 12, int(rng.integers(lo, hi)))
            for _ in range(n)]


def _run(engine, prompts, gens, **kw):
    reqs = [engine.submit(p, g, **kw) for p, g in zip(prompts, gens)]
    engine.run_until_drained()
    return reqs


def _pair(nets, **kw):
    """(JAX engine, port engine) of one configuration."""
    jnet, jdec, net, dec = nets
    return (JaxEngine(jnet, decoder=jdec, **kw),
            SlotGenerationEngine(net, decoder=dec, **kw))


def _same_outcome(got, want):
    """Per request: identical tokens, or the same exception type."""
    for g, w in zip(got, want):
        if w._error is None:
            assert g._error is None, g
            np.testing.assert_array_equal(g.result(0), w.result(0))
        else:
            assert type(g._error).__name__ == type(w._error).__name__


def _same_counters(eng, jeng, keys=COUNTERS):
    st, jst = eng.stats(), jeng.stats()
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}


# ------------------------------------------------------ chunked prefill
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
@pytest.mark.parametrize("k", [1, 4])
def test_chunked_prefill_matches_jax(nets, paged, k):
    """8 prompts of 2-29 tokens through 2 slots, prefill_chunk 8: the
    windowed prefill (interleaved with K-step decode blocks, whose frozen
    chunking lane must not touch the windows' cells) gives the JAX
    chunked engine's tokens, which are the whole-prompt engine's."""
    prompts = _prompts(1, 8)
    gens = [3 + i % 5 for i in range(8)]
    pg = dict(paged=True, page_size=8) if paged else {}
    whole, _ = _pair(nets, num_slots=2, block_size=k, **pg)
    want = _run(whole, prompts, gens)
    jeng, eng = _pair(nets, num_slots=2, block_size=k, prefill_chunk=8,
                      **pg)
    jreqs = _run(jeng, prompts, gens)
    reqs = _run(eng, prompts, gens)
    _same_outcome(reqs, jreqs)
    _same_outcome(reqs, want)
    assert eng.stats()["prefill_chunks"] > 0
    keys = COUNTERS + (("prefix_cache_hits", "prefix_cache_misses")
                       if paged else ())
    if k > 1 or paged:      # JAX's slab K = 1 loop refills a step earlier
        keys += ("prefill_batches", "decode_blocks")
    _same_counters(eng, jeng, keys)
    if paged:
        assert eng._pager.audit(eng._slot_pages) == []


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_final_window_slides_at_cache_edge(nets, paged):
    """58 tokens at t_max 64, windows of 16: the last window slides left
    over filled cells instead of overhanging the cache."""
    jnet, jdec, net, dec = nets
    p = np.random.default_rng(2).integers(0, 12, 58)
    want = jdec.generate([p], 4)[0]
    pg = dict(paged=True, page_size=8) if paged else {}
    eng = SlotGenerationEngine(net, num_slots=2, decoder=dec,
                               prefill_chunk=16, **pg)
    req = eng.submit(p, 4)
    eng.run_until_drained()
    np.testing.assert_array_equal(req.result(0), want)
    assert eng.stats()["prefill_chunks"] == 4


@pytest.mark.parametrize("how", ["cancel", "deadline"])
def test_cancel_and_deadline_mid_chunk(nets, how):
    """One window filled by hand, then a cancel or an expired deadline:
    the next cycle frees the chunking slot without another window, and
    the follow-up request gets the slot. Same on both engines."""
    prompt = np.random.default_rng(3).integers(0, 12, 28)
    outcome = []
    for eng in _pair(nets, num_slots=1, prefill_chunk=8):
        req = eng.submit(prompt, 4, deadline=None if how == "cancel"
                         else 30.0)
        eng._sweep_pending()
        eng._admit()
        eng._advance_chunks()
        assert eng._chunking and not req.done()
        if how == "cancel":
            assert req.cancel()
        else:
            req._deadline_t -= 60.0
        ok = eng.submit([1, 2, 3], 3)
        eng.run_until_drained()
        with pytest.raises(Exception):
            req.result(0)
        assert len(ok.result(0)) == 6
        st = eng.stats()
        outcome.append((type(req._error).__name__, st["prefill_chunks"],
                        st["cancelled"], st["deadline_exceeded"]))
    assert outcome[0] == outcome[1]
    assert isinstance(req._error,       # the port's, last in the pair
                      Cancelled if how == "cancel" else DeadlineExceeded)
    assert outcome[1][1] == 1          # no window after the cancel


def test_quarantine_harvests_chunking_request(nets):
    _, eng = _pair(nets, num_slots=1, prefill_chunk=8, paged=True,
                   page_size=8)
    req = eng.submit(np.random.default_rng(4).integers(0, 12, 28), 4)
    eng._sweep_pending()
    eng._admit()
    eng._advance_chunks()
    assert eng._chunking and eng.stats()["active_slots"] == 1
    harvested, cause = eng.quarantine()
    assert harvested == [req] and cause is None and not req.done()
    assert eng._pager.audit(eng._slot_pages) == []
    late = eng.submit([1, 2], 2)
    with pytest.raises(RuntimeError, match="shut down"):
        late.result(0)


# ------------------------------------------------------------------ EDF
def _completion_order(engine, deadlines):
    reqs = [engine.submit([1, 2], 2, deadline=d) for d in deadlines]
    order = []
    for r in reqs:
        r.add_done_callback(order.append)
    engine.run_until_drained()
    return [reqs.index(r) for r in order]


@pytest.mark.parametrize("scheduling", ["edf", "fifo"])
def test_edf_pop_order_matches_jax(nets, scheduling):
    """EDF: the earliest deadline first, no deadline last; the FIFO
    engine keeps submission order."""
    deadlines = [60.0, None, 5.0, 30.0]
    orders = [_completion_order(eng, deadlines)
              for eng in _pair(nets, num_slots=1, scheduling=scheduling)]
    assert orders[0] == orders[1]
    assert orders[1] == ([2, 3, 0, 1] if scheduling == "edf"
                         else [0, 1, 2, 3])


def test_equal_deadlines_pop_fifo(nets):
    _, eng = _pair(nets, num_slots=1, scheduling="edf")
    reqs = [eng.submit([1, 2], 2, deadline=60.0) for _ in range(6)]
    t = interval_now() + 60.0
    for r in reqs:                      # one ABSOLUTE deadline
        r._deadline_t = t
    order = []
    for r in reqs:
        r.add_done_callback(order.append)
    eng.run_until_drained()
    assert order == reqs
    with pytest.raises(ValueError, match="scheduling"):
        SlotGenerationEngine(nets[2], decoder=nets[3], scheduling="lifo")


# ------------------------------------------------------------- headroom
def test_headroom_sheds_exactly_one(nets):
    """Cold estimates admit everything; warm ones shed an infeasible
    request at submit with its projected miss, once; a feasible deadline
    still admits."""
    outcome = []
    for eng in _pair(nets, num_slots=2, shed_headroom=True):
        cold = eng.submit([1, 2, 3], 10_000, deadline=50.0)
        assert not cold.done()
        cold.cancel()
        warm = eng.submit([1, 2, 3], 3)
        eng.run_until_drained()
        assert warm.done() and eng.stats()["headroom_shed"] == 0
        req = eng.submit([1, 2, 3], 10_000, deadline=eng._est_step)
        assert req.done()
        with pytest.raises(Exception) as exc:
            req.result(0)
        assert exc.value.projected_miss_s > 0
        ok = eng.submit([1, 2, 3], 3, deadline=300.0)
        eng.run_until_drained()
        assert len(ok.result(0)) == 6
        st = eng.stats()
        outcome.append((type(exc.value).__name__, st["headroom_shed"],
                        st["rejected"], st["cancelled"]))
    assert outcome[0] == outcome[1] == ("RejectedError", 1, 1, 1)


def test_headroom_charges_every_chunk_window(nets):
    """4 tokens are one prefill dispatch (0.05 s fits 0.15 s); 32 are
    four windows (0.2 s does not). Both packages' policy agrees."""
    verdicts = []
    for eng, req_cls in zip(_pair(nets, num_slots=2, shed_headroom=True,
                                  prefill_chunk=8),
                            (JaxRequest, GenerationRequest)):
        eng._est_step, eng._est_prefill = 1e-4, 0.05
        short = req_cls(np.arange(4) % 12, 4, 0.0, None, deadline=0.15)
        long_ = req_cls(np.arange(32) % 12, 4, 0.0, None, deadline=0.15)
        exc = eng._headroom_check(long_)
        verdicts.append((eng._headroom_check(short) is None,
                         exc is not None and exc.projected_miss_s > 0))
    assert verdicts == [(True, True), (True, True)]


def test_pop_time_reshed_after_queue_wait(nets):
    outcome = []
    for eng in _pair(nets, num_slots=2, shed_headroom=True):
        eng.submit([1, 2], 2)
        eng.run_until_drained()
        eng._est_step = 0.5
        req = eng.submit([1, 2], 8, deadline=30.0)
        req._deadline_t = time.perf_counter() + 0.01   # headroom gone
        eng.run_until_drained()
        outcome.append((type(req._error).__name__,
                        eng.stats()["headroom_shed"]))
    assert outcome[0] == outcome[1] == ("RejectedError", 1)


# ---------------------------------------------------------- adaptive K
def test_adaptive_block_policy_matches_jax(nets):
    """Deep queue → the largest rung within the depth; idle → the
    smallest; the measured step latency caps K under the target."""
    picks = []
    for eng in _pair(nets, num_slots=2, adaptive_block=True,
                     block_ladder=(8, 1, 4, 2), block_latency_target=0.2):
        assert eng.block_size == 8 and eng.block_ladder == (1, 2, 4, 8)
        seq = [eng._choose_block_size()]
        eng._pending.extend([object()] * 3)
        seq.append(eng._choose_block_size())
        eng._pending.extend([object()] * 20)
        seq.append(eng._choose_block_size())
        eng._est_step = 0.06
        seq.append(eng._choose_block_size())
        eng._est_step = 1.0
        seq.append(eng._choose_block_size())
        eng._pending.clear()
        picks.append(seq)
    assert picks[0] == picks[1] == [1, 2, 8, 2, 1]
    with pytest.raises(ValueError, match="rungs"):
        SlotGenerationEngine(nets[2], decoder=nets[3], adaptive_block=True,
                             block_ladder=(0, 2))


def test_adaptive_block_parity_while_k_switches(nets):
    """10 requests through 2 slots with K chosen per block from (1, 2,
    4) as the queue drains: the tokens of a fixed-K run."""
    prompts = _prompts(5, 10, hi=12)
    gens = [3 + i % 4 for i in range(10)]
    jeng, eng = _pair(nets, num_slots=2, adaptive_block=True,
                      block_ladder=(1, 2, 4))
    seen = set()
    choose = eng._choose_block_size

    def recording():
        k = choose()
        seen.add(k)
        return k
    eng._choose_block_size = recording
    reqs = _run(eng, prompts, gens)
    _same_outcome(reqs, _run(jeng, prompts, gens))
    assert len(seen) > 1                 # K really switched
    fixed = SlotGenerationEngine(nets[2], decoder=nets[3], num_slots=2)
    _same_outcome(reqs, _run(fixed, prompts, gens))


def test_supervisor_restart_keeps_the_policy(nets):
    _, _, net, dec = nets
    eng = SlotGenerationEngine(net, num_slots=2, decoder=dec,
                               prefill_chunk=8, scheduling="edf",
                               shed_headroom=True, headroom_margin=1.5,
                               adaptive_block=True, block_ladder=(1, 2))
    sup = EngineSupervisor(eng, timeout=30.0, max_restarts=2).start()
    try:
        with sup._sup_lock:
            sup._restart(cause=RuntimeError("test"))
        new = sup.engine
        assert new is not eng and new.decoder is dec
        assert (new.prefill_chunk, new.scheduling, new.shed_headroom,
                new.headroom_margin, new.adaptive_block,
                new.block_ladder) == (8, "edf", True, 1.5, True, (1, 2))
        req = sup.submit(_prompts(6, 1, lo=20)[0], 3)
        assert len(req.result(30)) == len(req.prompt) + 3
    finally:
        sup.stop()


def test_prefill_chunk_validated(nets):
    with pytest.raises(ValueError, match="prefill_chunk"):
        SlotGenerationEngine(nets[2], decoder=nets[3], prefill_chunk=65)


# ------------------------------------------------------------ recompute
def test_recompute_logits_matches_jax(nets):
    """The no-cache forward over padded contexts: logits within 1e-5
    (relative) of JAX's, the same greedy ids, and equal to the cached
    prefill's logits."""
    _, jdec, _, dec = nets
    rng = np.random.default_rng(7)
    lengths = np.array([5, 16, 1, 11])
    tokens = np.zeros((4, 16), np.int64)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(0, 12, n)
    jids, jlog = jdec.recompute_logits(tokens.astype(np.int32),
                                       lengths.astype(np.int32))
    ids, logits = dec.recompute_logits(tokens, lengths)
    want = np.asarray(jlog)
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _, cached, _ = dec.prefill(dec.init_cache(4), tokens, lengths)
    torch.testing.assert_close(logits, cached, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 4])
def test_chunking_lane_parks_clear_of_its_windows(nets, k):
    """Slot 0 frees after a 3-token request and takes a 30-token prompt
    in windows of 8 while slot 1 keeps decoding: the chunking lane's
    frozen decode write must land clear of the cells its windows fill
    (a lane left at its last occupant's position rewrites cell 4)."""
    jnet, jdec, net, dec = nets
    rng = np.random.default_rng(12)
    a, c, b = (rng.integers(0, 12, n) for n in (3, 5, 30))
    want = jdec.generate([b], 8)[0]
    eng = SlotGenerationEngine(net, num_slots=2, decoder=dec, block_size=k,
                               prefill_chunk=8)
    eng.submit(a, 3)
    eng.submit(c, 40)
    rb = eng.submit(b, 8)
    eng.run_until_drained()
    np.testing.assert_array_equal(rb.result(0), want)
    assert eng.stats()["prefill_chunks"] == 4
