"""PyTorch port: the KV-cache decoder and the slot engine against the JAX
package (greedy decoding token-identical at K = 1 and 4), plus the
port's own contracts: fixed-seed sampling identical across K, one
readback per decode block, queue shedding, background serving."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import (SlotGenerationEngine as JaxEngine,
                                       TransformerDecoder as JaxDecoder,
                                       transformer_lm_conf as jax_lm_conf)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu_torch.models import (SlotGenerationEngine,
                                             TransformerDecoder, generate,
                                             transformer_lm_conf)
from deeplearning4j_tpu_torch.ops.transfer import fetch_counts
from deeplearning4j_tpu_torch.parallel import RejectedError
from deeplearning4j_tpu_torch.utils import graph_from_numpy

KW = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2,
          max_length=32, seed=5)


@pytest.fixture(scope="module")
def nets():
    """(JAX net, port net on the CPU with the same parameters)."""
    jnet = JaxGraph(jax_lm_conf(**KW)).init()
    net = graph_from_numpy(transformer_lm_conf(**KW),
                           {v: {k: np.asarray(a) for k, a in p.items()}
                            for v, p in jnet.params.items()}, device="cpu")
    return jnet, net


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, n) for n in lengths]


@pytest.mark.parametrize("k", [1, 4])
def test_generate_greedy_matches_jax(nets, k):
    jnet, net = nets
    prompts = _prompts(0, (3, 9, 5, 14))
    want = JaxDecoder(jnet).generate(prompts, 11, block_size=k)
    got = TransformerDecoder(net).generate(prompts, 11, block_size=k)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_generate_stops_at_eos_and_context_like_jax(nets):
    """Per-row eos and the full-context stop (t_max) land where JAX puts
    them, mid-block included."""
    jnet, net = nets
    prompts = _prompts(1, (4, 27))
    free = TransformerDecoder(net).generate(prompts, 8, block_size=4)
    eos = int(free[0][4 + 2])                 # row 0's third new token
    want = JaxDecoder(jnet).generate(prompts, 8, eos_id=eos, block_size=4)
    got = TransformerDecoder(net).generate(prompts, 8, eos_id=eos,
                                           block_size=4)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert len(got[1]) == KW["max_length"]    # 27 + 5: the context filled


def test_decoder_prefill_and_decode_step_logits_match_jax(nets):
    """prefill, then one decode_step at ragged positions: f32 logits
    within 1e-5 of the JAX decoder's."""
    jnet, net = nets
    prompts = _prompts(2, (5, 9, 3))
    tokens = np.zeros((3, 16), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    lengths = np.array([len(p) for p in prompts], np.int32)
    jd, td = JaxDecoder(jnet), TransformerDecoder(net)
    jids, want, jcache = jd.prefill(jd.init_cache(3), tokens, lengths)
    ids, got, tcache = td.prefill(td.init_cache(3), tokens.astype(np.int64),
                                  lengths.astype(np.int64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _, want, _ = jd.decode_step(jcache, np.asarray(jids), lengths)
    _, got, _ = td.decode_step(tcache, ids, lengths.astype(np.int64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cached_decode_matches_no_cache_reference(nets):
    """The KV-cache decoder agrees with the port's own recompute
    reference (models.transformer.generate)."""
    _, net = nets
    p = _prompts(3, (6,))[0]
    got = TransformerDecoder(net).generate([p], 7, block_size=4)[0]
    np.testing.assert_array_equal(got, generate(net, p, 7, temperature=0))


@pytest.mark.parametrize("k", [2, 4, 8])
def test_fixed_seed_sampling_identical_across_k(nets, k):
    _, net = nets
    dec = TransformerDecoder(net)
    prompts = _prompts(4, (3, 8, 5))
    temps = [1.0, 0.0, 0.7]                  # mixed greedy / sampled rows
    base = dec.generate(prompts, 12, temperature=temps, seed=9, block_size=1)
    got = dec.generate(prompts, 12, temperature=temps, seed=9, block_size=k)
    for a, b in zip(base, got):
        np.testing.assert_array_equal(a, b)
    other = dec.generate(prompts, 12, temperature=temps, seed=10,
                         block_size=k)
    assert any((a != b).any() for a, b in zip(base, other))


def test_generate_one_readback_per_block(nets):
    _, net = nets
    before = fetch_counts("generate.decode")["generate.decode"]
    TransformerDecoder(net).generate(_prompts(5, (4, 6)), 13, block_size=4)
    # 12 decode steps after the prefill token → 3 blocks, 3 readbacks
    assert fetch_counts("generate.decode")["generate.decode"] - before == 3


MIXED = ((3, 6, 2, 5, 4), (4, 7, 3, 6, 5))


@pytest.mark.parametrize("k", [1, 4])
def test_engine_matches_jax_engine(nets, k):
    """5 mixed-length greedy requests through 2 slots with refill:
    token-identical to the JAX engine."""
    jnet, net = nets
    prompts = _prompts(6, MIXED[0])
    jeng = JaxEngine(jnet, num_slots=2, block_size=k)
    jreqs = [jeng.submit(p, g) for p, g in zip(prompts, MIXED[1])]
    jeng.run_until_drained()
    eng = SlotGenerationEngine(net, num_slots=2, block_size=k,
                               device="cpu")
    reqs = [eng.submit(p, g) for p, g in zip(prompts, MIXED[1])]
    eng.run_until_drained()
    for r, j in zip(reqs, jreqs):
        np.testing.assert_array_equal(r.result(5), j.result(5))
        assert r.state == r.DONE
    st = eng.stats()
    assert st["completed"] == 5 and st["prefills"] == 5
    # one readback per admission and at most one per decode block (a
    # block whose lanes all finished in the previous one is never read)
    assert st["prefill_batches"] < st["host_readbacks"] <= \
        st["prefill_batches"] + st["decode_blocks"]


def test_engine_refill_off_matches_refill_on(nets):
    _, net = nets
    prompts = _prompts(7, (3, 3, 3, 3))
    gens = [2, 12, 12, 2]

    def run(refill):
        eng = SlotGenerationEngine(net, num_slots=2, refill=refill,
                                   block_size=4, device="cpu")
        reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
        eng.run_until_drained()
        return eng.stats()["decode_steps"], [r.result(5) for r in reqs]

    steps_on, on = run(True)
    steps_off, off = run(False)
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)
    assert steps_on < steps_off


def test_engine_sheds_past_max_pending_and_rejects_bad_requests(nets):
    _, net = nets
    eng = SlotGenerationEngine(net, num_slots=2, max_pending=2,
                               device="cpu")
    ok = [eng.submit([1, 2], 3) for _ in range(2)]
    shed = eng.submit([1, 2], 3)
    with pytest.raises(RejectedError) as exc:
        shed.result(0)
    assert exc.value.queue_depth == 2
    empty = eng.submit([], 3)
    too_long = eng.submit(np.zeros(40, np.int64), 3)
    eng.run_until_drained()
    assert all(len(r.result(5)) == 5 for r in ok)
    for bad in (empty, too_long):
        with pytest.raises(ValueError):
            bad.result(0)
    assert eng.stats()["rejected"] == 1


def test_engine_background_serving_and_shutdown(nets):
    _, net = nets
    eng = SlotGenerationEngine(net, num_slots=2, block_size=4,
                               device="cpu").start()
    try:
        reqs = [eng.submit(p, 6) for p in _prompts(8, (3, 5, 4))]
        want = TransformerDecoder(net).generate(_prompts(8, (3, 5, 4)), 6)
        for r, w in zip(reqs, want):
            np.testing.assert_array_equal(r.result(30), w)
    finally:
        eng.shutdown()
    late = eng.submit([1, 2, 3], 4)
    with pytest.raises(RuntimeError, match="shut down"):
        late.result(0)


def test_engine_device_must_match_net(nets):
    _, net = nets
    with pytest.raises(ValueError, match="device"):
        SlotGenerationEngine(net, device="cuda")
    dec = TransformerDecoder(net, t_max=16)
    with pytest.raises(ValueError, match="t_max"):
        SlotGenerationEngine(net, decoder=dec, t_max=32)


def test_engine_decodes_on_default_cuda_device_only_with_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ComputationGraph(transformer_lm_conf(**KW))
