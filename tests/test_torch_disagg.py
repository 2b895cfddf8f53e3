"""PyTorch port: the engine's KV handoff (``phase=``, ``handoff=``,
``adopt``) and the disaggregated tier (``streaming/disagg.py``) against
the JAX package, in f32 on the CPU. A prefill engine's exported pages
adopted by a decode engine give the both-phase engine's tokens, across
the packages in both directions; the same pages encode to identical
bytes; ``PhaseRouter`` serves JAX's tokens with JAX's transfer bytes; a
late ship is fenced as in JAX; a failed ship and a killed decode worker
re-prefill exactly once; the per-role autoscalers decide as JAX's do;
and the disagg and corruption soak rounds at tiny size."""

import time

import numpy as np
import pytest

import deeplearning4j_tpu.models.paging as jpaging
from deeplearning4j_tpu.models import (SlotGenerationEngine as JaxEngine,
                                       TransformerDecoder as JaxDecoder,
                                       transformer_lm_conf as jax_lm_conf)
from deeplearning4j_tpu.models.generation import \
    GenerationRequest as JaxRequest
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.parallel.faults import \
    FaultInjector as JaxInjector
from deeplearning4j_tpu.streaming import disagg as jax_disagg
from deeplearning4j_tpu_torch.models import (SlotGenerationEngine,
                                             TransformerDecoder,
                                             transformer_lm_conf)
from deeplearning4j_tpu_torch.models.generation import GenerationRequest
from deeplearning4j_tpu_torch.models.paging import PageFrameSet
from deeplearning4j_tpu_torch.ops.transfer import fetch_counts
from deeplearning4j_tpu_torch.parallel import FaultInjector, RejectedError
from deeplearning4j_tpu_torch.streaming import (BurnRateAutoscaler,
                                                InProcessKVTransport,
                                                PhaseAutoscaler, PhaseRouter,
                                                SerializedKVTransport)
from deeplearning4j_tpu_torch.tools import chaos_soak
from deeplearning4j_tpu_torch.utils import graph_from_numpy

VOCAB = 12
PAGE = 8
LAYERS = 2
KW = dict(vocab_size=VOCAB, d_model=32, num_heads=2, num_layers=LAYERS,
          max_length=32, seed=5)


@pytest.fixture(scope="module")
def nets():
    """(JAX net, JAX decoder, port net, port decoder) on the same weights,
    weight matrices scaled by 4 so greedy tokens depend on the context."""
    jnet = JaxGraph(jax_lm_conf(**KW)).init()
    jnet.params = {v: {k: a * 4 if a.ndim == 2 else a for k, a in p.items()}
                   for v, p in jnet.params.items()}
    net = graph_from_numpy(transformer_lm_conf(**KW),
                           {v: {k: np.asarray(a) for k, a in p.items()}
                            for v, p in jnet.params.items()}, device="cpu")
    return jnet, JaxDecoder(jnet), net, TransformerDecoder(net)


def _workload(seed=0, n=8, lo=2, hi=7, plen=(2, 5)):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, VOCAB, int(rng.integers(*plen)))
               for _ in range(n)]
    gens = [int(rng.integers(lo, hi)) for _ in range(n)]
    return prompts, gens


def _both(engine_cls, net, dec, prompts, gens):
    eng = engine_cls(net, num_slots=2, decoder=dec, paged=True,
                     page_size=PAGE)
    reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    eng.run_until_drained()
    return [r.result(5) for r in reqs]


def _prefill(engine_cls, net, dec, prompts, gens):
    """A prefill-only engine's handoffs: [(request, PageFrameSet)]."""
    states = []
    pre = engine_cls(net, num_slots=2, decoder=dec, paged=True,
                     page_size=PAGE, phase="prefill",
                     handoff=lambda req, st: states.append((req, st)))
    for p, g in zip(prompts, gens):
        pre.submit(p, g)
    pre.run_until_drained()
    assert pre._pager.audit(pre._slot_pages) == []
    return pre, states


def _decode_from(engine_cls, req_cls, net, dec, states, wire):
    """Adopt ``states`` (requests of either package, frames through
    ``wire``) into a decode-only engine of ``engine_cls``; returns the
    outputs and the engine."""
    de = engine_cls(net, num_slots=2, decoder=dec, paged=True,
                    page_size=PAGE, phase="decode")
    reqs = []
    for req, st in states:
        mine = req_cls(req.prompt, req.max_new_tokens, 0.0, None)
        mine.generated = list(req.generated)
        de.adopt(mine, wire(st))
        reqs.append(mine)
    de.run_until_drained()
    return [r.result(5) for r in reqs], de


# ------------------------------------------------------------ the engine
def test_phase_needs_paged_and_a_known_name(nets):
    _, _, net, dec = nets
    with pytest.raises(ValueError, match="paged=True"):
        SlotGenerationEngine(net, decoder=dec, phase="prefill")
    with pytest.raises(ValueError, match="phase must be"):
        SlotGenerationEngine(net, decoder=dec, paged=True, page_size=PAGE,
                             phase="verify")
    de = SlotGenerationEngine(net, decoder=dec, paged=True, page_size=PAGE,
                              phase="decode")
    with pytest.raises(RuntimeError, match="decode-only"):
        de.submit([1, 2], 4).result(1)
    pre = SlotGenerationEngine(net, decoder=dec, paged=True,
                               page_size=PAGE, phase="prefill")
    r = pre.submit([1, 2, 3], 4)
    pre.run_until_drained()
    with pytest.raises(RuntimeError, match="no handoff sink"):
        r.result(1)
    assert pre._pager.audit(pre._slot_pages) == []


def test_prefill_handoff_to_decode_adopt_matches_both_phase(nets):
    """Exported pages adopted by a decode engine resume token-identically
    to the both-phase engine; each export reads back 2 x layers frames
    under ``kv_handoff``; both pools audit clean."""
    _, _, net, dec = nets
    prompts, gens = _workload(seed=3, n=8)
    want = _both(SlotGenerationEngine, net, dec, prompts, gens)
    before = fetch_counts("kv_handoff")["kv_handoff"]
    pre, states = _prefill(SlotGenerationEngine, net, dec, prompts, gens)
    readbacks = fetch_counts("kv_handoff")["kv_handoff"] - before
    finished = len(prompts) - len(states)
    assert pre.stats()["handoffs"] == len(states) > 0
    assert readbacks == 2 * LAYERS * len(states)
    for req, st in states:
        assert len(st.tokens) == len(req.prompt) + len(req.generated) - 1
        assert st.dtype == "float32" and st.page_checksums is None
    outs, de = _decode_from(SlotGenerationEngine, GenerationRequest, net,
                            dec, states, lambda st: st)
    by_prompt = {tuple(req.prompt): o for (req, _), o in zip(states, outs)}
    for p, w in zip(prompts, want):
        if tuple(p) in by_prompt:
            np.testing.assert_array_equal(by_prompt[tuple(p)], w)
    assert len(by_prompt) + finished == len(prompts)
    assert de.stats()["adopted"] == len(states)
    assert de._pager.audit(de._slot_pages) == []


def test_chunked_prefill_hands_off_long_prompts(nets):
    _, _, net, dec = nets
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, VOCAB, 19) for _ in range(2)]
    gens = [3, 4]
    want = _both(SlotGenerationEngine, net, dec, prompts, gens)
    states = []
    pre = SlotGenerationEngine(net, num_slots=2, decoder=dec, paged=True,
                               page_size=PAGE, phase="prefill",
                               prefill_chunk=8,
                               handoff=lambda r, st: states.append((r, st)))
    for p, g in zip(prompts, gens):
        pre.submit(p, g)
    pre.run_until_drained()
    assert pre.stats()["prefill_chunks"] > 0 and len(states) == 2
    outs, _ = _decode_from(SlotGenerationEngine, GenerationRequest, net,
                           dec, states, lambda st: st)
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o, w)


def test_adopt_refuses_mismatched_frames(nets):
    _, _, net, dec = nets
    _, states = _prefill(SlotGenerationEngine, net, dec, [[1, 2, 3, 4]], [5])
    req, st = states[0]
    de = SlotGenerationEngine(net, num_slots=2, decoder=dec, paged=True,
                              page_size=PAGE, phase="decode")
    slab = SlotGenerationEngine(net, num_slots=2, decoder=dec)
    with pytest.raises(ValueError, match="paged engine"):
        slab.adopt(req, st)
    other = PageFrameSet(4, st.tokens, {n: {kk: a[:, :, :4] for kk, a in
                                           lf.items()}
                                        for n, lf in st.layers.items()})
    with pytest.raises(ValueError, match="page_size mismatch"):
        de.adopt(req, other)
    f64 = PageFrameSet(PAGE, st.tokens,
                       {n: {kk: a.astype(np.float64) for kk, a in lf.items()}
                        for n, lf in st.layers.items()})
    with pytest.raises(ValueError, match="dtype"):
        de.adopt(req, f64)
    short = PageFrameSet(PAGE, st.tokens[:-1], st.layers)
    with pytest.raises(ValueError, match="resumes at"):
        de.adopt(req, short)
    assert de.stats()["adopted"] == 0


def test_pool_exhausted_receiver_sheds_and_balances(nets):
    _, _, net, dec = nets
    _, states = _prefill(SlotGenerationEngine, net, dec,
                         [np.arange(10) % VOCAB], [6])
    req, st = states[0]
    de = SlotGenerationEngine(net, num_slots=2, decoder=dec, paged=True,
                              page_size=PAGE, num_pages=2, phase="decode",
                              prefix_cache=False)
    de.adopt(req, st)
    de.run_until_drained()
    with pytest.raises(RejectedError, match="pool exhausted"):
        req.result(0)
    assert de.stats()["rejected"] == 1
    assert de._pager.audit(de._slot_pages) == []


# ------------------------------------------------------ across packages
def test_jax_handoff_adopted_by_the_port(nets):
    """JAX prefill → ``to_bytes`` → the port's ``from_bytes`` → a port
    decode engine: the tokens of JAX's both-phase engine."""
    jnet, jdec, net, dec = nets
    prompts, gens = _workload(seed=5, n=6, lo=3, hi=8)
    want = _both(JaxEngine, jnet, jdec, prompts, gens)
    _, states = _prefill(JaxEngine, jnet, jdec, prompts, gens)
    outs, de = _decode_from(SlotGenerationEngine, GenerationRequest, net,
                            dec, states,
                            lambda st: PageFrameSet.from_bytes(st.to_bytes()))
    got = {tuple(r.prompt): o for (r, _), o in zip(states, outs)}
    assert got
    for p, w in zip(prompts, want):
        if tuple(p) in got:
            np.testing.assert_array_equal(got[tuple(p)], w)
    assert de._pager.audit(de._slot_pages) == []


def test_port_handoff_adopted_by_jax(nets):
    """The reverse: the port's exported frames, per-page wire frames,
    adopted by a JAX decode engine."""
    jnet, jdec, net, dec = nets
    prompts, gens = _workload(seed=7, n=6, lo=3, hi=8)
    want = _both(JaxEngine, jnet, jdec, prompts, gens)
    _, states = _prefill(SlotGenerationEngine, net, dec, prompts, gens)
    outs, _ = _decode_from(
        JaxEngine, JaxRequest, jnet, jdec, states,
        lambda st: jpaging.PageFrameSet.from_frames(st.to_frames()))
    got = {tuple(r.prompt): o for (r, _), o in zip(states, outs)}
    assert got
    for p, w in zip(prompts, want):
        if tuple(p) in got:
            np.testing.assert_array_equal(got[tuple(p)], w)


def test_exported_pages_agree_and_encode_identically(nets):
    """The two packages' exported pages of the same prompt agree within
    1e-5 relative, and the same pages encode to identical bytes (bulk
    and per page) in both packages."""
    jnet, jdec, net, dec = nets
    prompt = np.random.default_rng(13).integers(0, VOCAB, 19)
    _, js = _prefill(JaxEngine, jnet, jdec, [prompt], [4])
    _, ps = _prefill(SlotGenerationEngine, net, dec, [prompt], [4])
    (jreq, jst), (preq, pst) = js[0], ps[0]
    assert list(jreq.generated) == list(preq.generated)
    np.testing.assert_array_equal(jst.tokens, pst.tokens)
    assert sorted(jst.layers) == sorted(pst.layers)
    for n in jst.layers:
        for kk in ("k", "v"):
            a, b = np.asarray(jst.layers[n][kk]), pst.layers[n][kk]
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(a).max())
    same = PageFrameSet(PAGE, jst.tokens,
                        {n: {kk: np.asarray(a) for kk, a in lf.items()}
                         for n, lf in jst.layers.items()}, checksums=False)
    assert same.to_bytes() == jst.to_bytes()
    assert same.to_frames() == jst.to_frames()
    assert same.nbytes == jst.nbytes


# ------------------------------------------------------------ the router
def _router_run(cls, transport, net, dec, prompts, gens, **kw):
    router = cls(net, prefill_replicas=1, decode_replicas=2, decoder=dec,
                 num_slots=2, page_size=PAGE, transport=transport,
                 suspect_after=0.5, dead_after=2.0, **kw)
    frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
    router.start()
    try:
        outs = [fr.result(60) for fr in frs]
        st = router.disagg_stats()
        ledger = router.ledger.to_dict()
    finally:
        router.shutdown()
    return outs, st, ledger


@pytest.mark.parametrize("per_page", [False, True], ids=["bytes", "frames"])
def test_phase_router_matches_jax(nets, per_page):
    """Identical tokens and transfer bytes against JAX's PhaseRouter,
    the both-phase engine's tokens, exactly once."""
    jnet, jdec, net, dec = nets
    prompts, gens = _workload(seed=21, n=8, lo=3, hi=8)
    want = _both(SlotGenerationEngine, net, dec, prompts, gens)
    jt = jax_disagg.SerializedKVTransport(per_page=per_page)
    pt = SerializedKVTransport(per_page=per_page, record_ships=True)
    jo, js, jl = _router_run(jax_disagg.PhaseRouter, jt, jnet, jdec,
                             prompts, gens)
    po, ps, pl = _router_run(PhaseRouter, pt, net, dec, prompts, gens)
    for a, b, w in zip(jo, po, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, w)
    for key in ("completed", "fenced", "failed", "bytes", "pages"):
        assert ps["handoffs"][key] == js["handoffs"][key], key
    assert pt.wire_bytes == jt.wire_bytes and pt.shipped == jt.shipped
    assert pl == jl and pl["duplicates"] == 0
    # the exact account: pages x per-page pool bytes + the token payload
    page_bytes = 2 * LAYERS * 2 * PAGE * 16 * 4
    assert ps["handoffs"]["bytes"] == sum(
        n * page_bytes + t for n, _, t in pt.ships)


def test_stale_handoff_is_fenced_as_in_jax(nets):
    """A zombie's late ship for a request the router no longer tracks is
    dropped and counted ``fenced``, in both packages."""
    jnet, jdec, net, dec = nets
    counts = []
    for cls, n, d in ((jax_disagg.PhaseRouter, jnet, jdec),
                      (PhaseRouter, net, dec)):
        router = cls(n, prefill_replicas=1, decode_replicas=1, decoder=d,
                     num_slots=2, page_size=PAGE, suspect_after=0.5,
                     dead_after=2.0).start()
        try:
            fr = router.submit([1, 2, 3], 4)
            fr.result(60)
            inner = fr._inner
            st = PageFrameSet(PAGE, np.arange(3),
                              {"a": {"k": np.zeros((1, 2, PAGE, 16),
                                                   np.float32),
                                     "v": np.zeros((1, 2, PAGE, 16),
                                                   np.float32)}})
            router._do_handoff("p0", inner, st)
            counts.append(dict(router.disagg_stats()["handoffs"]))
        finally:
            router.shutdown()
    assert counts[1] == counts[0] and counts[1]["fenced"] == 1


def test_ship_failure_reprefills_exactly_once(nets):
    _, _, net, dec = nets
    prompts, gens = _workload(seed=37, n=6, lo=3, hi=8)
    want = _both(SlotGenerationEngine, net, dec, prompts, gens)
    inj = FaultInjector()
    inj.raise_once("disagg.ship", RuntimeError("injected wire failure"),
                   at=2)
    router = PhaseRouter(net, prefill_replicas=2, decode_replicas=1,
                         decoder=dec, num_slots=2, page_size=PAGE,
                         fault_injector=inj, suspect_after=0.5,
                         dead_after=2.0).start()
    try:
        frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
        for fr, w in zip(frs, want):
            np.testing.assert_array_equal(fr.result(60), w)
        st = router.disagg_stats()["handoffs"]
        assert st["failed"] == 1 and st["completed"] >= len(frs) - 1
        assert router.ledger.to_dict()["duplicates"] == 0
    finally:
        router.shutdown()


def test_decode_worker_kill_reprefills_on_the_prefill_pool(nets):
    _, _, net, dec = nets
    prompts, gens = _workload(seed=43, n=8, lo=6, hi=12)
    want = _both(SlotGenerationEngine, net, dec, prompts, gens)
    router = PhaseRouter(net, prefill_replicas=1, decode_replicas=2,
                         decoder=dec, num_slots=2, page_size=PAGE,
                         transport=InProcessKVTransport(),
                         suspect_after=0.5, dead_after=2.0)
    frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
    router.start()
    try:
        deadline = time.monotonic() + 30
        while router.disagg_stats()["handoffs"]["completed"] < 2 and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        router.kill_replica("d0")
        for fr, w in zip(frs, want):
            np.testing.assert_array_equal(fr.result(60), w)
        led = router.ledger.to_dict()
        assert led["duplicates"] == 0 and led["completed"] == len(prompts)
        assert router.replica_state("d0") == "DEAD"
        for rid in router.replica_ids():
            eng = router._replicas[rid].engine
            assert eng._pager.audit(eng._slot_pages) == []
    finally:
        router.shutdown()


# -------------------------------------------------------- the autoscalers
class _RoleRouter:
    """The role-aware router surface the per-role autoscaler reads."""

    def __init__(self, tracker):
        self._slo_tracker = tracker
        self.roles = {"p0": "prefill", "d0": "decode"}
        self.seq = {"prefill": 1, "decode": 1}
        self.calls = []
        self.util = {"prefill": 0.0, "decode": 0.0}
        self.burn = {"prefill": 0.0, "decode": 0.0}

    def replica_role(self, rid):
        return self.roles.get(rid)

    def role_ids(self, role):
        return sorted(r for r, ro in self.roles.items() if ro == role)

    def replica_loads(self):
        return {rid: (0, 4, "ALIVE") for rid in self.roles}

    def utilization(self, role=None):
        return self.util[role]

    def role_burn_rate(self, role, window=None):
        return self.burn[role]

    def add_replica(self, role):
        rid = f"{role[0]}{self.seq[role]}"
        self.seq[role] += 1
        self.roles[rid] = role
        self.calls.append(("add", rid))
        return rid

    def retire_replica(self, rid, budget, reason):
        del self.roles[rid]
        self.calls.append(("retire", rid))
        return {"replica": rid}


#: per tick: (prefill util, prefill burn, decode util, decode burn)
ROLE_SIGNALS = [(2.0, 0.0, 0.1, 0.0), (2.0, 0.0, 0.1, 0.0),
                (0.1, 0.0, 3.0, 5.0), (0.1, 0.0, 3.0, 5.0),
                (0.1, 0.0, 3.0, 5.0)] + [(0.0, 0.0, 0.0, 0.0)] * 8


def _role_run(autoscaler_cls, tracker):
    router = _RoleRouter(tracker)
    pa = autoscaler_cls(router, prefill_max=2, decode_max=3,
                        up_consecutive=2, down_consecutive=3,
                        cooldown_s=0.0, interval=0.05)
    out = []
    for pu, pb, du, db in ROLE_SIGNALS:
        router.util.update(prefill=pu, decode=du)
        router.burn.update(prefill=pb, decode=db)
        out.append(pa.evaluate_once())
    return out, router.calls, pa.stats()


def test_phase_autoscaler_decisions_match_jax():
    from deeplearning4j_tpu.observability.slo import SLOTracker as JaxSLO
    from deeplearning4j_tpu_torch.observability import SLOTracker
    want = _role_run(jax_disagg.PhaseAutoscaler, JaxSLO())
    got = _role_run(PhaseAutoscaler, SLOTracker())
    assert got == want
    assert ("add", "p1") in got[1] and ("add", "d1") in got[1]
    assert any(c[0] == "retire" for c in got[1])


def test_role_autoscaler_needs_a_role_aware_router(nets):
    _, _, net, dec = nets
    from deeplearning4j_tpu_torch.streaming import EngineFleetRouter
    plain = EngineFleetRouter(net, num_replicas=1, decoder=dec,
                              num_slots=2)
    with pytest.raises(ValueError, match="role-aware"):
        BurnRateAutoscaler(plain, role="decode")
    plain.shutdown()


# ----------------------------------------------------------------- soaks
def test_disagg_soak_round_on_cpu():
    s = chaos_soak.run_disagg_soak(seed=0, n_requests=12, device="cpu")
    assert s["ok"], {k: s.get(k) for k in (
        "stranded", "mismatches", "failed", "failure_causes",
        "clock_breaks", "page_audit", "handoffs", "transfer", "ledger",
        "steady_new_builds")}
    assert s["transfer"]["exact"] and s["handoffs"]["failed"] >= 1


def test_corruption_soak_round_on_cpu():
    s = chaos_soak.run_corruption_soak(seed=0, n_requests=8, device="cpu")
    assert s["ok"], s["phase_ok"]
    assert s["phase_b"]["detected"] >= 1
    assert s["phase_c"]["states"]["r0"] == "CORRUPT"
