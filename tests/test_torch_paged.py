"""PyTorch port: the paged KV cache's device half and the paged engine
against the JAX package. ``chunk_forward`` (both write paths) and the
three paged seams within 1e-5 of JAX, outputs and written cells; the
decoder's paged prefill and decode; the paged engine token-identical to
the JAX paged engine at K = 1 and 4 with equal prefix-cache accounting;
concurrency at fixed pool bytes, pool-pressure preemption, shedding; and
page frames exported by one package continuing to decode in the other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import (SlotGenerationEngine as JaxEngine,
                                       TransformerDecoder as JaxDecoder,
                                       transformer_lm_conf as jax_lm_conf)
from deeplearning4j_tpu.models import paging as jpaging
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu_torch.models import (SlotGenerationEngine,
                                             TransformerDecoder,
                                             transformer_lm_conf)
from deeplearning4j_tpu_torch.models.paging import PageFrameSet
from deeplearning4j_tpu_torch.parallel import RejectedError
from deeplearning4j_tpu_torch.utils import graph_from_numpy

KW = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2,
          max_length=32, seed=5)
TOL = dict(rtol=1e-5, atol=1e-5)
PREFIX_KEYS = ("prefix_cache_hits", "prefix_cache_misses",
               "prefix_cache_hit_tokens", "page_preempted", "prefills",
               "prefill_batches", "decode_blocks", "completed")


@pytest.fixture(scope="module")
def nets():
    """(JAX net, port net on the CPU with the same parameters)."""
    jnet = JaxGraph(jax_lm_conf(**KW)).init()
    net = graph_from_numpy(transformer_lm_conf(**KW),
                           {v: {k: np.asarray(a) for k, a in p.items()}
                            for v, p in jnet.params.items()}, device="cpu")
    return jnet, net


def _layers(nets):
    """(JAX layer, its params, port layer, its params) of the first
    attention vertex."""
    jnet, net = nets
    name = TransformerDecoder(net).attn_names[0]
    return (jnet.conf.vertices[name].layer, jnet.params[name],
            net.conf.vertices[name].layer, net.params[name])


def _j(a, dtype=None):
    return jnp.asarray(a, dtype)


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_cache(got, want, skip_null=False):
    for kk in ("k", "v"):
        g, w = got[kk].numpy(), np.asarray(want[kk])
        if skip_null:           # trash writes meet in page 0 in any order
            g, w = g[1:], w[1:]
        np.testing.assert_allclose(g, w, **TOL)


def _shared_prefix_prompts(rng, n, prefix_len=17):
    sys_p = rng.integers(0, 64, prefix_len)
    return [np.concatenate([sys_p, rng.integers(0, 64,
                                                int(rng.integers(1, 4)))])
            for _ in range(n)]


def _run(engine, prompts, gens):
    reqs = [engine.submit(p, g) for p, g in zip(prompts, gens)]
    engine.run_until_drained()
    return [r.result(5) for r in reqs]


# ----------------------------------------------------------- the seams
@pytest.mark.parametrize("case", ["clamped", "per-cell"])
def test_chunk_forward_matches_jax(nets, case):
    """valid=None slides the window left at the edge; valid given writes
    only [pos0, pos0 + valid) below t_max: a frozen lane (valid 0), lanes
    at the context edge and a partial window at position 0 included."""
    jl, jp, tl, tp = _layers(nets)
    rng = np.random.default_rng(1)
    b, c, t, h, d = 5, 5, 32, 2, 16
    x = rng.standard_normal((b, c, 32)).astype(np.float32)
    cache = {kk: rng.standard_normal((b, h, t, d)).astype(np.float32)
             for kk in ("k", "v")}
    pos0 = np.array([0, 7, 29, 30, 12], np.int32)
    valid = None if case == "clamped" else np.array([2, 0, 5, 2, 4],
                                                    np.int32)
    want, wcache = jl.chunk_forward(
        jp, _j(x), {kk: _j(a) for kk, a in cache.items()}, _j(pos0),
        None if valid is None else _j(valid))
    with torch.no_grad():
        got, tcache = tl.chunk_forward(
            tp, _t(x), {kk: _t(a) for kk, a in cache.items()},
            _t(pos0).long(), None if valid is None else _t(valid).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _check_cache(tcache, wcache)
    if valid is not None:                  # dropped cells untouched
        np.testing.assert_array_equal(tcache["k"][1].numpy(),
                                      cache["k"][1])
        np.testing.assert_array_equal(tcache["k"][2, :, :29].numpy(),
                                      cache["k"][2, :, :29])


def _pool_case(seed, b, n_pages=9, ps=8, h=2, d=16):
    rng = np.random.default_rng(seed)
    pool = {kk: rng.standard_normal((n_pages, h, ps, d)).astype(np.float32)
            for kk in ("k", "v")}
    return rng, pool


def test_paged_decode_forward_matches_jax(nets):
    jl, jp, tl, tp = _layers(nets)
    rng, pool = _pool_case(2, 3)
    x = rng.standard_normal((3, 1, 32)).astype(np.float32)
    ptab = np.array([[1, 2, 0, 0], [3, 4, 5, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([9, 20, 5], np.int32)          # row 2: a freed lane
    want, wpool = jl.paged_decode_forward(
        jp, _j(x), {kk: _j(a) for kk, a in pool.items()}, _j(ptab),
        _j(pos))
    with torch.no_grad():
        got, tpool = tl.paged_decode_forward(
            tp, _t(x), {kk: _t(a) for kk, a in pool.items()},
            _t(ptab).long(), _t(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _check_cache(tpool, wpool)


@pytest.mark.parametrize("seam", ["chunk", "prefill"])
def test_paged_window_seams_match_jax(nets, seam):
    """Row 0 prefills a fresh prompt into page 1, row 1 maps page 1
    read-only and writes only its tail (two cells past valid go to the
    null page), row 2 runs off its mapped pages into the null page."""
    jl, jp, tl, tp = _layers(nets)
    rng, pool = _pool_case(3, 3)
    x = rng.standard_normal((3, 6, 32)).astype(np.float32)
    ptab = np.array([[1, 2, 3, 0], [1, 4, 5, 0], [6, 7, 8, 0]], np.int32)
    pos0 = np.array([0, 8, 21], np.int32)
    valid = np.array([6, 4, 6], np.int32)
    jpool = {kk: _j(a) for kk, a in pool.items()}
    tpool = {kk: _t(a) for kk, a in pool.items()}
    with torch.no_grad():
        if seam == "chunk":
            want, wpool = jl.paged_chunk_forward(jp, _j(x), jpool, _j(ptab),
                                                 _j(pos0), _j(valid))
            got, tpool = tl.paged_chunk_forward(tp, _t(x), tpool,
                                                _t(ptab).long(),
                                                _t(pos0).long(),
                                                _t(valid).long())
        else:        # a fresh prompt: pos0 defaults to 0, whole window
            want, wpool = jl.paged_prefill_forward(jp, _j(x), jpool,
                                                   _j(ptab))
            got, tpool = tl.paged_prefill_forward(tp, _t(x), tpool,
                                                  _t(ptab).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _check_cache(tpool, wpool, skip_null=True)
    if seam == "chunk":                 # the shared page stays read-only
        np.testing.assert_array_equal(tpool["k"][1, :, 6:].numpy(),
                                      pool["k"][1, :, 6:])


def test_embed_chunk_matches_jax(nets):
    jnet, net = nets
    name = next(n for n in net.conf.topological_order
                if type(net.conf.vertices[n].layer).__name__ ==
                "TokenAndPositionEmbedding")
    ids = np.random.default_rng(4).integers(0, 64, (3, 5))
    pos0 = np.array([0, 20, 30], np.int32)          # 30 + 4 clamps to 31
    want = jnet.conf.vertices[name].layer.embed_chunk(
        jnet.params[name], _j(ids, jnp.int32), _j(pos0))
    got = net.conf.vertices[name].layer.embed_chunk(
        net.params[name], _t(ids), _t(pos0).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------ decoder
def _paged_state(jd, td, n_pages=9, ps=8):
    return jd.init_paged_pool(n_pages, ps), td.init_paged_pool(n_pages, ps)


def test_paged_prefill_and_decode_block_match_jax(nets):
    """Tail prefill after a shared prefix and a fresh prompt, then one
    decode step's logits (walk level) and a K = 4 paged block's tokens."""
    jnet, net = nets
    jd, td = JaxDecoder(jnet), TransformerDecoder(net)
    jpool, tpool = _paged_state(jd, td)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 64, 19)
    # fill pages 1-2 with the prompt's first 16 tokens, then prefill two
    # rows at once: the same prompt's tail on the shared pages, and a
    # fresh 11-token prompt
    head = np.zeros((1, 16), np.int32)
    head[0] = prompt[:16]
    ptab0 = np.array([[1, 2, 0, 0]], np.int32)
    _, jpool = jd.paged_prefill(jpool, head, [0], [16], ptab0)
    _, _, tpool = td.paged_prefill(tpool, head, [0], [16], ptab0)
    fresh = rng.integers(0, 64, 11)
    tokens = np.zeros((2, 16), np.int32)
    tokens[0, :3] = prompt[16:]
    tokens[1, :11] = fresh
    pos0, valid = np.array([16, 0]), np.array([3, 11])
    ptab = np.array([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    want, _ = jd._walk_paged_chunk(
        jd._device_params(), jnet._inference_state(), jpool, _j(ptab),
        _j(tokens), _j(pos0, jnp.int32), _j(valid, jnp.int32))
    jids, jpool = jd.paged_prefill(jpool, tokens, pos0, valid, ptab)
    ids, got, tpool = td.paged_prefill(tpool, tokens, pos0, valid, ptab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    for name in td.attn_names:
        _check_cache(tpool[name], jpool[name], skip_null=True)

    positions = np.array([19, 11])
    want, _ = jd._walk_paged_decode(
        jd._device_params(), jnet._inference_state(), jpool, _j(ptab),
        _j(np.asarray(jids)), _j(positions, jnp.int32))
    scratch = {n: {kk: t.clone() for kk, t in kv.items()}
               for n, kv in tpool.items()}
    with torch.no_grad():
        got = td._walk_decode(td._device_params(), net._inference_state(),
                              scratch, ids, _t(positions).long(),
                              _t(ptab).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jtoks = jd.paged_decode_block(jpool, ptab, np.asarray(jids), positions,
                                  block_size=4)[0]
    toks = td.paged_decode_block(tpool, ptab, ids, positions,
                                 block_size=4)[0]
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))


# ------------------------------------------------------------- engine
@pytest.mark.parametrize("k", [1, 4])
def test_paged_engine_matches_jax_engine(nets, k, monkeypatch):
    """Shared 17-token prefix, 8-token pages: the port's paged engine is
    token-identical to the JAX paged engine with equal accounting, and a
    prefix hit prefills only its tail."""
    jnet, net = nets
    rng = np.random.default_rng(10)
    prompts = _shared_prefix_prompts(rng, 6)
    gens = [6, 3, 8, 5, 4, 7]
    jeng = JaxEngine(jnet, num_slots=2, block_size=k, paged=True,
                     page_size=8)
    want = _run(jeng, prompts, gens)
    eng = SlotGenerationEngine(net, num_slots=2, block_size=k, paged=True,
                               page_size=8, device="cpu")
    windows = []
    prefill = eng.decoder.paged_prefill

    def spy(caches, tokens, pos0, valid, *a, **kw):
        windows.append((np.array(pos0), np.array(valid)))
        return prefill(caches, tokens, pos0, valid, *a, **kw)

    monkeypatch.setattr(eng.decoder, "paged_prefill", spy)
    got = _run(eng, prompts, gens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    st, jst = eng.stats(), jeng.stats()
    assert {key: st[key] for key in PREFIX_KEYS} == \
        {key: jst[key] for key in PREFIX_KEYS}
    assert st["prefix_cache_hits"] >= 4
    assert st["prefix_cache_hit_tokens"] == 16 * st["prefix_cache_hits"]
    # 2 slots: no padded admission rows, so the windows prefilled exactly
    # the prompts minus the shared pages
    assert sum(int(v.sum()) for _, v in windows) == \
        sum(map(len, prompts)) - st["prefix_cache_hit_tokens"]
    assert sum(int((p > 0).sum()) for p, _ in windows) == \
        st["prefix_cache_hits"]
    assert eng._pager.audit(eng._slot_pages) == []
    assert eng.kv_page_stats()["mapped"] == 0
    assert eng._pager.stats() == jeng._pager.stats()


def test_paged_engine_equals_port_slab_engine(nets):
    _, net = nets
    rng = np.random.default_rng(11)
    prompts = _shared_prefix_prompts(rng, 5) + \
        [rng.integers(0, 64, 5) for _ in range(3)]
    gens = [int(g) for g in rng.integers(3, 10, len(prompts))]
    slab = _run(SlotGenerationEngine(net, num_slots=3, block_size=4,
                                     device="cpu"), prompts, gens)
    pag = SlotGenerationEngine(net, num_slots=3, block_size=4, paged=True,
                               page_size=8, device="cpu")
    for a, b in zip(slab, _run(pag, prompts, gens)):
        np.testing.assert_array_equal(a, b)
    assert pag._pager.audit(pag._slot_pages) == []


def test_engine_rejects_unaligned_page_size(nets):
    _, net = nets
    with pytest.raises(ValueError, match="must divide t_max"):
        SlotGenerationEngine(net, num_slots=2, paged=True, page_size=5,
                             device="cpu")
    eng = SlotGenerationEngine(net, num_slots=3, paged=True, page_size=8,
                               device="cpu")
    assert eng.num_pages == 3 * 4 + 1           # slab capacity + null page
    assert SlotGenerationEngine(net, device="cpu").kv_page_stats() is None


def test_eight_live_sequences_at_two_slab_slots_bytes(nets):
    """At the slab's KV bytes (plus the null page) the paged engine holds
    4× the concurrent sequences on a short mix."""
    _, net = nets
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 64, 3) for _ in range(8)]
    slab = SlotGenerationEngine(net, num_slots=2, device="cpu")
    pag = SlotGenerationEngine(net, num_slots=8, paged=True, page_size=8,
                               num_pages=9, device="cpu")
    slab_bytes = sum(t.numel() * t.element_size()
                     for kv in slab._caches.values() for t in kv.values())
    assert pag._pool_bytes() == slab_bytes + slab_bytes // (2 * 4)
    assert pag.kv_page_stats()["num_pages"] * 8 == 2 * 32
    for eng in (slab, pag):
        for p in prompts:
            eng.submit(p, 3)
        eng._admit()                            # one admission wave
    assert sum(r is not None for r in slab._slots) == 2
    assert sum(r is not None for r in pag._slots) == 8
    st = pag.kv_page_stats()
    assert st["mapped"] == 8 and st["fragmentation"] == round(1 - 24 / 64, 4)
    slab.run_until_drained()
    pag.run_until_drained()
    assert pag.stats()["completed"] == slab.stats()["completed"] == 8
    assert pag._pager.audit(pag._slot_pages) == []


def test_pool_pressure_preempts_and_requeues_exactly_once(nets):
    """A pool too small for every lane's full length preempts lanes
    (requeued at the head, re-prefilled with their tokens so far): every
    request still returns exactly its prompt + 14 tokens, equal to the
    slab's and to the JAX paged engine's, with the same preemptions."""
    jnet, net = nets
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 64, 3) for _ in range(6)]
    gens = [14] * 6
    slab = _run(SlotGenerationEngine(net, num_slots=4, block_size=2,
                                     device="cpu"), prompts, gens)
    kw = dict(num_slots=4, paged=True, page_size=8, num_pages=7,
              block_size=2)
    jeng = JaxEngine(jnet, **kw)
    want = _run(jeng, prompts, gens)
    eng = SlotGenerationEngine(net, device="cpu", **kw)
    got = _run(eng, prompts, gens)
    for g, w, s, p in zip(got, want, slab, prompts):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)
        assert len(g) == len(p) + 14
    assert eng.stats()["page_preempted"] > 0
    assert eng.stats()["page_preempted"] == jeng.stats()["page_preempted"]
    assert eng._pager.audit(eng._slot_pages) == []


def test_oversized_request_is_shed_not_deadlocked(nets):
    _, net = nets
    eng = SlotGenerationEngine(net, num_slots=2, paged=True, page_size=8,
                               num_pages=3, device="cpu")
    req = eng.submit(np.arange(20) % 64, 8)       # needs 3 pages, has 2
    eng.run_until_drained()
    with pytest.raises(RejectedError, match="pool exhausted"):
        req.result(1)
    assert eng.stats()["rejected"] == 1
    assert eng._pager.audit(eng._slot_pages) == []


def test_shutdown_releases_every_mapping(nets):
    _, net = nets
    eng = SlotGenerationEngine(net, num_slots=2, paged=True, page_size=8,
                               device="cpu")
    reqs = [eng.submit(np.arange(10) % 64, 6) for _ in range(3)]
    eng._admit()
    assert eng.kv_page_stats()["mapped"] > 0
    eng.shutdown()
    assert all(r.state == r.FAILED for r in reqs)
    assert eng.kv_page_stats()["mapped"] == 0
    assert eng._pager.audit(eng._slot_pages) == []


# ------------------------------------------------------ page handoff
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_exported_pages_continue_decoding_in_the_other_package(
        nets, direction):
    """Prefill a 13-token prompt into pages 1-2 of one package's pool,
    export them as a PageFrameSet on the wire, import them at other page
    ids of the other package's pool: both continue with the same 8
    tokens."""
    jnet, net = nets
    jd, td = JaxDecoder(jnet), TransformerDecoder(net)
    jpool, tpool = _paged_state(jd, td)
    prompt = np.random.default_rng(14).integers(0, 64, 13)
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :13] = prompt
    src_tab = np.array([[1, 2, 3, 0]], np.int32)
    dst_tab = np.array([[5, 7, 8, 0]], np.int32)
    if direction == "jax_to_port":
        ids, jpool = jd.paged_prefill(jpool, tokens, [0], [13], src_tab)
        frames = jd.kv_export(jpool, [1, 2])
        wire = jpaging.PageFrameSet(8, prompt, {
            n: {kk: np.asarray(a) for kk, a in kv.items()}
            for n, kv in frames.items()}).to_bytes()
        fs = PageFrameSet.from_bytes(wire)
        tpool = td.kv_import(tpool, [5, 7], fs.tensors("cpu"))
        want = jd.paged_decode_block(jpool, src_tab, np.asarray(ids), [13],
                                     block_size=8)[0]
        got = td.paged_decode_block(tpool, dst_tab, np.asarray(ids), [13],
                                    block_size=8)[0]
    else:
        ids, _, tpool = td.paged_prefill(tpool, tokens, [0], [13], src_tab)
        wire = PageFrameSet.from_tensors(
            8, prompt, td.kv_export(tpool, [1, 2])).to_bytes()
        fs = jpaging.PageFrameSet.from_bytes(wire)
        jpool = jd.kv_import(jpool, [5, 7], {
            n: {kk: _j(a) for kk, a in kv.items()}
            for n, kv in fs.layers.items()})
        want = td.paged_decode_block(tpool, src_tab, ids, [13],
                                     block_size=8)[0]
        got = jd.paged_decode_block(jpool, dst_tab, ids.numpy(), [13],
                                    block_size=8)[0]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
