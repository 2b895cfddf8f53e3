"""PyTorch port: the engine fleet (``streaming/fleet.py``), the burn-rate
autoscaler (``streaming/autoscale.py``) and the fleet soak rounds against
the JAX package, in f32 on the CPU. The ring hash and ring walk; the
membership tables' ALIVE / SUSPECT / DEAD inputs and epoch fences on the
same scripted beats under a fake clock; the router's health transitions
on scripted ages; greedy tokens identical to JAX's router and to each
package's direct engine; a crash injected into r0 at the same step hit
migrating the same requests with the same ledger counts in both
packages; the serving route's submission order across a migration;
retire / add, CORRUPT quarantine with a replacement; the autoscaler's
decisions on the same scripted signals; the shared decoder's dispatch
lock taken by every replica's decoder calls; and the fleet, autoscale
and speculative soak rounds at tiny size. Every wait has a deadline."""

import json
import threading
import time

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.streaming.fleet as jax_fleet
import deeplearning4j_tpu_torch.streaming.fleet as port_fleet
from deeplearning4j_tpu.models import (SlotGenerationEngine as JaxEngine,
                                       TransformerDecoder as JaxDecoder,
                                       transformer_lm_conf as jax_lm_conf)
from deeplearning4j_tpu.models.paging import \
    prefix_route_key as jax_route_key
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.parallel.faults import \
    FaultInjector as JaxInjector
from deeplearning4j_tpu.streaming.autoscale import \
    BurnRateAutoscaler as JaxScaler
from deeplearning4j_tpu_torch.models import (SlotGenerationEngine,
                                             TransformerDecoder,
                                             transformer_lm_conf)
from deeplearning4j_tpu_torch.models.paging import prefix_route_key
from deeplearning4j_tpu_torch.parallel import FaultInjector
from deeplearning4j_tpu_torch.streaming import (BurnRateAutoscaler,
                                                EngineFleetRouter,
                                                GenerationServingRoute,
                                                MessageBroker,
                                                NDArrayPublisher,
                                                NDArraySubscriber,
                                                REPLICA_ALIVE,
                                                REPLICA_CORRUPT,
                                                REPLICA_DEAD,
                                                REPLICA_SUSPECT)
from deeplearning4j_tpu_torch.tools import chaos_soak
from deeplearning4j_tpu_torch.utils import graph_from_numpy

VOCAB = 12
KW = dict(vocab_size=VOCAB, d_model=32, num_heads=2, num_layers=2,
          max_length=32, seed=5)


def _wait(pred, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


@pytest.fixture(scope="module")
def nets():
    """(JAX net, JAX decoder, port net, port decoder) on the same weights,
    every weight matrix scaled by 4 so greedy tokens depend on the
    context."""
    jnet = JaxGraph(jax_lm_conf(**KW)).init()
    jnet.params = {v: {k: a * 4 if a.ndim == 2 else a for k, a in p.items()}
                   for v, p in jnet.params.items()}
    net = graph_from_numpy(transformer_lm_conf(**KW),
                           {v: {k: np.asarray(a) for k, a in p.items()}
                            for v, p in jnet.params.items()}, device="cpu")
    jdec, dec = JaxDecoder(jnet), TransformerDecoder(net)
    warm = JaxEngine(jnet, num_slots=2, decoder=jdec)
    warm.submit([1, 2], 3)
    warm.submit([2, 1, 3], 3)
    warm.run_until_drained()
    return jnet, jdec, net, dec


def _workload(seed, n, lo=3, hi=8):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, VOCAB, int(rng.integers(2, 5)))
               for _ in range(n)]
    gens = [int(rng.integers(lo, hi)) for _ in range(n)]
    return prompts, gens


def _direct(engine_cls, net, dec, prompts, gens, **kw):
    eng = engine_cls(net, num_slots=2, decoder=dec, **kw)
    reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    eng.run_until_drained()
    return [r.result(5) for r in reqs]


# ------------------------------------------------------------ ring hash
def test_ring_hash_and_ring_walk_match_jax(nets):
    jnet, jdec, net, dec = nets
    for s in ("", "r0#0", "a sticky key", "x" * 100):
        assert port_fleet._ring_hash(s) == jax_fleet._ring_hash(s)
    jr = jax_fleet.EngineFleetRouter(jnet, num_replicas=3, decoder=jdec,
                                     num_slots=2)
    pr = EngineFleetRouter(net, num_replicas=3, decoder=dec, num_slots=2)
    try:
        rng = np.random.default_rng(3)
        for _ in range(8):
            toks = rng.integers(0, VOCAB, 20)
            key = prefix_route_key(toks, 16)
            assert key == jax_route_key(toks, 16)
            assert pr._ring_walk(key) == jr._ring_walk(key)
    finally:
        jr.shutdown()
        pr.shutdown()


# ------------------------------------------------------------ membership
class _FakeKVClient:
    """A write-once key-value store with the coordinator client's
    surface (key_value_set / key_value_dir_get / key_value_delete)."""

    def __init__(self):
        self._kv = {}
        self.lock = threading.Lock()

    def key_value_set(self, key, value):
        with self.lock:
            if key in self._kv:
                raise RuntimeError(f"ALREADY_EXISTS: {key}")
            self._kv[key] = value

    def key_value_dir_get(self, prefix):
        with self.lock:
            return [(k, v) for k, v in sorted(self._kv.items())
                    if k.startswith(prefix)]

    def key_value_delete(self, key):
        with self.lock:
            self._kv.pop(key, None)


class _FakeTime:
    """The fleet module's clock: monotonic and wall time advance only
    when the script says so; sleep advances them."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


#: scripted membership runs: (op, *args). "m" ops act on a named
#: KVFleetMembership (built on first use with the given epoch).
SCRIPTS = {
    "seq_advancement": [
        ("new", "a", 50), ("register", "a", "r0"), ("ages", "a"),
        ("advance", 0.3), ("ages", "a"), ("beat", "a", "r0", 3),
        ("ages", "a")],
    "leave_tombstone_and_dup_beat": [
        ("new", "a", 60), ("beat", "a", "r0", 1), ("setseq", "a", "r0", 0),
        ("beat", "a", "r0", 9), ("ages", "a"), ("leave", "a", "r0"),
        ("leave", "a", "r0"), ("ages", "a")],
    "rejoin_after_restart": [
        ("new", "boot1", 1000)] + [("beat", "boot1", "r0", i)
                                   for i in range(5)] + [
        ("new", "obs", 7), ("ages", "obs"), ("advance", 0.5),
        ("ages", "obs"), ("new", "boot2", 2000), ("beat", "boot2", "r0", 9),
        ("ages", "obs"), ("epoch", "boot2")],
    "backward_clock_bumps_epoch": [
        ("new", "boot1", 5000), ("beat", "boot1", "r0", 1),
        ("new", "obs", 7), ("advance", 0.2), ("new", "boot2", 100),
        ("beat", "boot2", "r0", 8), ("epoch", "boot2"), ("ages", "obs")],
    "plain_seq_keys_are_epoch0": [
        ("raw", "dl4j/fleet/t/r0/00000042", json.dumps({"load": 5})),
        ("new", "obs", 3), ("ages", "obs"), ("new", "boot", 9000),
        ("beat", "boot", "r0", 2), ("ages", "obs")],
    "pruning_keeps_newest_beats": [
        ("new", "a", 70)] + [("beat", "a", rid, i) for i in range(6)
                             for rid in ("r0", "r1")] + [
        ("leave", "a", "r1")] + [("ages", "a")] * 5 + [("keys",),
                                                       ("pruned", "a")],
}


def _run_script(module, script, monkeypatch):
    clock = _FakeTime()
    monkeypatch.setattr(module, "time", clock)
    kv = _FakeKVClient()
    ms, out = {}, []
    for op, *args in script:
        if op == "new":
            ms[args[0]] = module.KVFleetMembership(
                kv, fleet_id="t", epoch=args[1], prune_every=5,
                prune_keep=2)
        elif op == "register":
            ms[args[0]].register(args[1])
        elif op == "beat":
            ms[args[0]].beat(args[1], args[2])
        elif op == "setseq":
            ms[args[0]]._seq[args[1]] = args[2]
        elif op == "leave":
            ms[args[0]].leave(args[1])
        elif op == "advance":
            clock.t += args[0]
        elif op == "raw":
            kv.key_value_set(args[0], args[1])
        elif op == "ages":
            out.append(("ages", {rid: (round(a, 6), ld) for rid, (a, ld)
                                 in ms[args[0]].ages().items()}))
        elif op == "epoch":
            out.append(("epoch", ms[args[0]].epoch))
        elif op == "keys":
            out.append(("keys", [k for k, _ in
                                 kv.key_value_dir_get("dl4j/")]))
        elif op == "pruned":
            out.append(("pruned", ms[args[0]].pruned_keys))
    return out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_kv_membership_matches_jax_on_scripted_beats(name, monkeypatch):
    """The same beats, leaves and clock steps through both packages'
    KVFleetMembership give the same ages, loads, epochs (the fence a
    restarted replica bumps past the store) and pruned keys."""
    want = _run_script(jax_fleet, SCRIPTS[name], monkeypatch)
    got = _run_script(port_fleet, SCRIPTS[name], monkeypatch)
    assert got == want
    assert got


class _ScriptedMembership:
    """A membership whose ages() replays a script (the router's view)."""

    def __init__(self):
        self.now = {}

    def register(self, rid):
        pass

    def beat(self, rid, load):
        pass

    def leave(self, rid):
        self.now.pop(rid, None)

    def ages(self):
        return dict(self.now)


#: per scan: rid -> (age, load), or missing (no beat ever)
HEALTH_SCRIPT = [
    {"r0": (0.0, 0), "r1": (0.0, 0), "r2": (0.0, 0)},
    {"r0": (0.3, 1), "r1": (0.0, 2), "r2": (0.0, 0)},     # r0 SUSPECT
    {"r0": (0.1, 1), "r1": (0.0, 2), "r2": (0.5, 0)},     # r2 SUSPECT
    {"r0": (0.1, 1), "r1": (0.0, 2), "r2": (0.1, 0)},
    {"r0": (0.1, 1), "r1": (0.0, 2), "r2": (0.1, 0)},     # r0 back
    {"r0": (0.3, 1), "r1": (1.5, 2), "r2": (0.1, 0)},     # r1 DEAD
    {"r0": (0.0, 1), "r2": (0.1, 0)},
]


def _health_run(router_cls, net, dec):
    m = _ScriptedMembership()
    router = router_cls(net, num_replicas=3, decoder=dec, num_slots=2,
                        membership=m, suspect_after=0.25, dead_after=1.0,
                        recover_beats=3)
    states = []
    try:
        for ages in HEALTH_SCRIPT:
            m.now = dict(ages)
            router._scan_once()
            states.append({rid: router.replica_state(rid)
                           for rid in router.replica_ids()})
    finally:
        router.shutdown()
    return states


def test_router_health_transitions_match_jax(nets):
    """ALIVE → SUSPECT past suspect_after, back only after recover_beats
    fresh scans, DEAD past dead_after (a partition: migration by
    clones): the same states in both packages on the same scripted
    ages."""
    jnet, jdec, net, dec = nets
    want = _health_run(jax_fleet.EngineFleetRouter, jnet, jdec)
    got = _health_run(EngineFleetRouter, net, dec)
    assert got == want
    assert got[1]["r0"] == REPLICA_SUSPECT
    assert got[3]["r0"] == REPLICA_SUSPECT and got[4]["r0"] == REPLICA_ALIVE
    assert got[-1]["r1"] == REPLICA_DEAD


# ------------------------------------------------------------- serving
def test_fleet_tokens_match_jax_router_and_direct_engines(nets):
    jnet, jdec, net, dec = nets
    prompts, gens = _workload(5, 12)
    want = _direct(JaxEngine, jnet, jdec, prompts, gens)
    mine = _direct(SlotGenerationEngine, net, dec, prompts, gens)
    outs = []
    for cls, n, d in ((jax_fleet.EngineFleetRouter, jnet, jdec),
                      (EngineFleetRouter, net, dec)):
        router = cls(n, num_replicas=3, decoder=d, num_slots=2).start()
        try:
            frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
            outs.append([fr.result(60) for fr in frs])
            assert router.ledger.to_dict()["completed"] == len(prompts)
        finally:
            router.shutdown()
    for j, p, w, m in zip(outs[0], outs[1], want, mine):
        np.testing.assert_array_equal(j, w)
        np.testing.assert_array_equal(p, m)
        np.testing.assert_array_equal(p, j)


def _crash_run(cls, inj_cls, net, dec, prompts, gens, hit):
    injs = [inj_cls() for _ in range(3)]
    injs[0].raise_once("engine.step", RuntimeError("fleet test: r0 crash"),
                       at=hit)
    router = cls(net, num_replicas=3, decoder=dec, num_slots=2,
                 replica_injectors=injs)
    # queued before start: least-load dispatch with id tie-breaks places
    # every request the same way in both packages
    frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
    placed = [fr.replica_id for fr in frs]
    router.start()
    try:
        outs = [fr.result(60) for fr in frs]
        migrated = [i for i, fr in enumerate(frs) if fr.migrations]
        ledger = router.ledger.to_dict()
        dead = [rid for rid in router.replica_ids()
                if router.replica_state(rid) == "DEAD"]
    finally:
        router.shutdown()
    return placed, outs, migrated, ledger, dead


def test_crash_migration_matches_jax(nets):
    """An engine.step crash injected into r0 at the same hit: both
    packages place the requests the same way, migrate the same requests
    off r0, hold the same ledger counts, and serve tokens identical to
    the clean run."""
    jnet, jdec, net, dec = nets
    prompts, gens = _workload(11, 12, lo=4, hi=9)
    clean = _direct(SlotGenerationEngine, net, dec, prompts, gens)
    j = _crash_run(jax_fleet.EngineFleetRouter, JaxInjector, jnet, jdec,
                   prompts, gens, hit=3)
    p = _crash_run(EngineFleetRouter, FaultInjector, net, dec, prompts,
                   gens, hit=3)
    assert p[0] == j[0]
    for got, want in zip(p[1], clean):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(j[1], p[1]):
        np.testing.assert_array_equal(got, want)
    assert p[2] == j[2] and p[2], (p[2], j[2])
    assert p[3] == j[3]
    assert p[3]["duplicates"] == 0 and p[3]["completed"] == len(prompts)
    assert p[4] == j[4] == ["r0"]


def test_route_keeps_submission_order_across_migration(nets):
    """GenerationServingRoute(engine=router): a replica killed mid-stream
    migrates its requests and the route still publishes every result
    once, in submission order."""
    jnet, jdec, net, dec = nets
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, VOCAB, 3) for _ in range(10)]
    gens = [5] * 10
    want = _direct(SlotGenerationEngine, net, dec, prompts, gens)
    router = EngineFleetRouter(net, num_replicas=2, decoder=dec,
                               num_slots=2).start()
    broker = MessageBroker()
    out_sub = NDArraySubscriber(broker, "fleet-out")
    route = GenerationServingRoute(
        None, broker, engine=router, max_new_tokens=5,
        input_topic="fleet-in", output_topic="fleet-out").start()
    try:
        pub = NDArrayPublisher(broker, "fleet-in")
        for i, p in enumerate(prompts):
            pub.publish(np.asarray(p, np.int32))
            if i == 4:
                router.kill_replica("r0", mode="crash")
        got = []
        deadline = time.monotonic() + 60
        while len(got) < len(prompts) and time.monotonic() < deadline:
            m = out_sub.poll(timeout=0.2)
            if m is not None:
                got.append(m)
        assert len(got) == len(prompts)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g, np.int64), w)
        assert route.served == len(prompts)
        assert router.replica_state("r0") == REPLICA_DEAD
    finally:
        route.stop()
        router.shutdown()
        out_sub.close()


def test_zombie_late_completion_is_fenced(nets):
    """A partitioned replica keeps running: the monitor declares it DEAD
    and migrates clones; its late completions are fenced by the ledger,
    and every request completes once with the clean tokens."""
    jnet, jdec, net, dec = nets
    prompts, gens = _workload(23, 6, lo=4, hi=8)
    want = _direct(SlotGenerationEngine, net, dec, prompts, gens)
    inj = FaultInjector()
    inj.hang_for("engine.step", seconds=0.1, at=1, times=40)
    router = EngineFleetRouter(net, num_replicas=2, decoder=dec, num_slots=2,
                               replica_injectors=[inj, FaultInjector()],
                               heartbeat_interval=0.02,
                               monitor_interval=0.02, suspect_after=0.1,
                               dead_after=0.3)
    frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
    router.start()
    try:
        router.kill_replica("r0", mode="zombie")
        for fr, w in zip(frs, want):
            np.testing.assert_array_equal(fr.result(60), w)
        assert _wait(lambda: router.ledger.to_dict()["fenced"] >= 1, 20)
        led = router.ledger.to_dict()
        assert led["duplicates"] == 0 and led["completed"] == len(prompts)
        assert router.replica_state("r0") == REPLICA_DEAD
    finally:
        router.shutdown()


def test_retire_and_add_replica_exactly_once(nets):
    jnet, jdec, net, dec = nets
    prompts, gens = _workload(29, 10, lo=5, hi=9)
    want = _direct(SlotGenerationEngine, net, dec, prompts, gens)
    router = EngineFleetRouter(net, num_replicas=2, decoder=dec,
                               num_slots=2).start()
    try:
        rid = router.add_replica()
        assert rid == "r2" and router.replica_ids() == ["r0", "r1", "r2"]
        frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
        out = router.retire_replica("r0", budget=5.0)
        assert out["replica"] == "r0" and "r0" not in router.replica_ids()
        for fr, w in zip(frs, want):
            np.testing.assert_array_equal(fr.result(60), w)
        led = router.ledger.to_dict()
        assert led["completed"] == len(prompts) and led["duplicates"] == 0
        st = router.stats()
        assert st["scale_ups"] == 1 and st["scale_downs"] == 1
        with pytest.raises(ValueError):
            router.add_replica(replica_id="r1")
    finally:
        router.shutdown()


def test_numerical_fault_quarantines_corrupt_and_replaces(nets):
    """A NaN injected into r0's logits trips the sentinel: r0 is
    quarantined as CORRUPT, its streams finish on healthy replicas with
    the clean tokens, a replacement grows, and no page stays mapped."""
    jnet, jdec, net, dec = nets
    from deeplearning4j_tpu_torch.observability import IntegrityConfig
    cfg = IntegrityConfig(kv_verify_rate=1.0, fault_threshold=1)
    sdec = TransformerDecoder(net, sentinel=True,
                              logit_bound=cfg.logit_bound)
    prompts, gens = _workload(31, 9, lo=4, hi=8)
    want = _direct(SlotGenerationEngine, net, sdec, prompts, gens,
                   paged=True, page_size=8, integrity=cfg, block_size=4)
    injs = [FaultInjector() for _ in range(3)]
    injs[0].corrupt("device.corrupt_logits", mode="nan", at=1)
    router = EngineFleetRouter(net, num_replicas=3, decoder=sdec,
                               num_slots=2, block_size=4, paged=True,
                               page_size=8, integrity=cfg,
                               replica_injectors=injs)
    frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
    router.start()
    try:
        for fr, w in zip(frs, want):
            np.testing.assert_array_equal(fr.result(60), w)
        assert router.replica_state("r0") == REPLICA_CORRUPT
        assert int(router.corrupt_quarantines) == 1
        alive = [r for r in router.replica_ids()
                 if router.replica_state(r) == REPLICA_ALIVE]
        assert len(alive) == 3                   # r1, r2 and the new r3
        for rid in router.replica_ids():
            eng = router._replicas[rid].engine
            assert eng._pager.audit(eng._slot_pages) == []
        assert router.ledger.to_dict()["duplicates"] == 0
    finally:
        router.shutdown()


def test_stats_and_fleet_stats_keys_match_jax(nets):
    jnet, jdec, net, dec = nets
    docs = []
    for cls, n, d in ((jax_fleet.EngineFleetRouter, jnet, jdec),
                      (EngineFleetRouter, net, dec)):
        router = cls(n, num_replicas=2, decoder=d, num_slots=2).start()
        try:
            router.submit([1, 2, 3], 3).result(30)
            docs.append((router.stats(), router.fleet_stats()))
        finally:
            router.shutdown()
    (js, jf), (ps, pf) = docs
    fleet_keys = {"replicas", "replicas_alive", "replicas_suspect",
                  "replicas_dead", "replicas_corrupt"} | \
        set(port_fleet._FLEET_COUNTERS)
    assert fleet_keys <= set(ps) and fleet_keys <= set(js)
    assert set(pf) == set(jf)
    assert set(pf["replicas"]["r0"]) == set(jf["replicas"]["r0"])
    assert pf["ledger"] == jf["ledger"]
    assert pf["counters"] == jf["counters"]


# ------------------------------------------------------------ autoscaler
class _FakeRouter:
    """Router surface the autoscaler reads and acts on, with scripted
    loads; add / retire record the calls."""

    def __init__(self, tracker):
        self._slo_tracker = tracker
        self.rids = ["r0"]
        self.next = 1
        self.calls = []

    def replica_loads(self):
        return {rid: (i, 10, "ALIVE") for i, rid in enumerate(self.rids)}

    def utilization(self):
        return 0.0

    def add_replica(self):
        rid = f"r{self.next}"
        self.next += 1
        self.rids.append(rid)
        self.calls.append(("add", rid))
        return rid

    def retire_replica(self, rid, budget, reason):
        self.rids.remove(rid)
        self.calls.append(("retire", rid))
        return {"replica": rid}


#: (burn_short, burn_long, utilization) a tick; the clock advances 0.5 s
SIGNALS = [(0.1, 0.1, 2.0), (3.0, 1.0, 2.0), (3.0, 1.0, 2.0),
           (3.0, 1.0, 0.2), (0.1, 0.1, 2.0), (0.1, 0.1, 2.0),
           (0.1, 0.1, 2.0), (0.0, 0.0, 0.1), (0.0, 0.0, 0.1),
           (0.0, 0.0, 0.1), (0.0, 0.0, 0.1), (0.0, 0.0, 0.1),
           (0.0, 0.0, 0.1), (0.0, 0.0, 0.1), (0.0, 0.0, 0.1),
           (0.0, 0.0, 0.1), (0.0, 0.0, 0.1)]


def _scale_run(scaler_cls, tracker):
    router = _FakeRouter(tracker)
    scaler = scaler_cls(router, min_replicas=1, max_replicas=3,
                        up_consecutive=2, down_consecutive=3,
                        cooldown_s=1.0, registry=None)
    acts = []
    for i, (bs, bl, u) in enumerate(SIGNALS):
        sig = {"burn_short": bs, "burn_long": bl, "utilization": u,
               "live_replicas": len(router.rids)}
        acts.append(scaler.evaluate_once(signals=sig, now=100.0 + 0.5 * i))
    return acts, router.calls, scaler.stats()


def test_burn_rate_autoscaler_decisions_match_jax():
    from deeplearning4j_tpu.observability.slo import SLOTracker as JaxSLO
    from deeplearning4j_tpu_torch.observability import SLOTracker
    want = _scale_run(JaxScaler, JaxSLO())
    got = _scale_run(BurnRateAutoscaler, SLOTracker())
    assert got == want
    assert "up" in got[0] and "down" in got[0]


# ----------------------------------------------------------------- soaks
def test_fleet_soak_round_on_cpu():
    s = chaos_soak.run_fleet_soak(seed=0, replicas=3, n_requests=12,
                                  fleet_scale=False, device="cpu")
    assert s["ok"], {k: s.get(k) for k in (
        "stranded", "mismatches", "failed", "ledger", "page_audit",
        "steady_new_builds", "migrated_requests")}
    assert s["migrated_requests"] >= 1 and s["ledger"]["duplicates"] == 0


def test_autoscale_soak_round_on_cpu():
    s = chaos_soak.run_autoscale_soak(seed=0, waves=2, wave_size=6,
                                      device="cpu")
    assert s["ok"], {k: s.get(k) for k in (
        "stranded", "mismatches", "failed", "grown_to", "final_live",
        "scale_ups", "scale_downs", "ledger", "timeline")}


def test_autoscale_soak_ignores_earlier_slo_misses():
    """Misses that other code recorded into the process-default SLO
    tracker within its long window (as earlier test files on the same
    pytest worker do) must not hold the round's burn rate above the
    scale-down threshold: the round reads its own tracker."""
    from deeplearning4j_tpu_torch.observability.slo import \
        default_slo_tracker
    tracker = default_slo_tracker()
    with tracker._lock:
        saved = list(tracker._records)
    try:
        for _ in range(4):
            tracker.record("error")
        s = chaos_soak.run_autoscale_soak(seed=1, waves=2, wave_size=6,
                                          device="cpu")
    finally:
        with tracker._lock:
            tracker._records.clear()
            tracker._records.extend(saved)
    assert s["ok"], {k: s.get(k) for k in (
        "stranded", "mismatches", "failed", "grown_to", "final_live",
        "scale_ups", "scale_downs", "trickle", "timeline")}


def test_spec_soak_phases_on_cpu():
    """The speculative round's three phases: a supervised crash, a fleet
    replica crash and a NaN quarantine, each mid-verify."""
    s = chaos_soak.run_spec_soak(seed=0, device="cpu")
    assert s["ok"], s["phase_ok"]
    assert s["phase_b"]["migrations"] >= 1
    assert "CORRUPT" in s["phase_c"]["states"].values()


def test_replicas_enqueue_decoder_calls_one_at_a_time(nets):
    """Every decoder call of a fleet's replicas takes the shared decoder's
    dispatch lock: with 3 replicas serving at once, every admission and
    decode block went through it, from more than one serve thread."""
    jnet, jdec, net, dec = nets
    real = dec._dispatch_lock
    calls, threads_seen = [0], set()

    class Counting:
        def __enter__(self):
            real.__enter__()
            calls[0] += 1
            threads_seen.add(threading.get_ident())
            return self

        def __exit__(self, *exc):
            return real.__exit__(*exc)

    dec._dispatch_lock = Counting()
    prompts, gens = _workload(41, 9)
    router = EngineFleetRouter(net, num_replicas=3, decoder=dec,
                               num_slots=2)
    try:
        frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
        router.start()
        for fr in frs:
            fr.result(60)
        st = router.stats()
    finally:
        router.shutdown()
        dec._dispatch_lock = real
    assert calls[0] >= st["prefill_batches"] + st["decode_blocks"]
    assert len(threads_seen) >= 2
