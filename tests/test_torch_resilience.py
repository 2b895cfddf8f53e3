"""PyTorch port: the serving engine's resilience tier against the JAX
package, in f32 on the CPU. The fault injector; the request lifecycle
(states, cancel and deadline while queued and mid-decode, queue-full
shedding with its depth, done callbacks, the death cause through
``result()`` and later ``submit()``s, an unsupervised crash failing the
queued requests too); ``EngineSupervisor`` (a crash restarted with every
in-flight request recovered token for token, a wedge detected, the first
step's grace, an exhausted restart budget); quarantine / requeue and the
preemption drain. Threaded tests drive wall-clock faults with margins of a
second or more."""

import time

import numpy as np
import pytest

from deeplearning4j_tpu.models import (SlotGenerationEngine as JaxEngine,
                                       TransformerDecoder as JaxDecoder,
                                       transformer_lm_conf as jax_lm_conf)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu_torch.models import (SlotGenerationEngine,
                                             TransformerDecoder,
                                             transformer_lm_conf)
from deeplearning4j_tpu_torch.models.generation import GenerationRequest
from deeplearning4j_tpu_torch.parallel import (NULL_INJECTOR, Cancelled,
                                               DeadlineExceeded,
                                               EngineSupervisor,
                                               FaultInjector,
                                               HeartbeatMonitor,
                                               RejectedError)
from deeplearning4j_tpu_torch.utils import graph_from_numpy

VOCAB = 12
KW = dict(vocab_size=VOCAB, d_model=32, num_heads=2, num_layers=2,
          max_length=32, seed=5)


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
    parameters; every engine and every supervisor rebuild shares the port
    decoder."""
    jnet = _sharpened(JaxGraph(jax_lm_conf(**KW)).init())
    net = graph_from_numpy(transformer_lm_conf(**KW),
                           {v: {k: np.asarray(a) for k, a in p.items()}
                            for v, p in jnet.params.items()}, device="cpu")
    return jnet, JaxDecoder(jnet), net, TransformerDecoder(net)


def _engine(nets, **kw):
    kw.setdefault("num_slots", 2)
    return SlotGenerationEngine(nets[2], decoder=nets[3], **kw)


def _jax_outputs(nets, prompts, gens):
    eng = JaxEngine(nets[0], num_slots=2, decoder=nets[1])
    reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    eng.run_until_drained()
    return [r.result(5) for r in reqs]


def _wait(pred, timeout=30.0):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


# ------------------------------------------------------- fault injector
def test_raise_once_at_hit():
    inj = FaultInjector()
    inj.raise_once("engine.step", RuntimeError("boom"), at=3)
    inj.fire("engine.step")
    inj.fire("engine.step")
    with pytest.raises(RuntimeError, match="boom"):
        inj.fire("engine.step")
    inj.fire("engine.step")                 # armed once: hit 4 is clean
    assert inj.hits("engine.step") == 4 and inj.fired("engine.step") == 1
    assert inj.counters() == {"engine.step": {"hits": 4, "fired": 1}}


def test_raise_n_with_an_exception_class():
    inj = FaultInjector()
    inj.raise_n("engine.prefill", ConnectionError, n=2)
    for _ in range(2):
        with pytest.raises(ConnectionError, match="engine.prefill"):
            inj.fire("engine.prefill")
    assert inj.fire("engine.prefill") is False


def test_drop_hang_and_clear():
    inj = FaultInjector()
    inj.drop("engine.step", n=2, at=2)
    assert [inj.fire("engine.step") for _ in range(4)] == \
        [False, True, True, False]
    inj.hang_for("engine.prefill", seconds=0.05)
    t0 = time.monotonic()
    assert inj.fire("engine.prefill") is False
    assert time.monotonic() - t0 >= 0.05
    inj.drop("engine.step", n=5)
    inj.clear()
    assert inj.fire("engine.step") is False
    assert NULL_INJECTOR.fire("engine.step") is False
    assert NULL_INJECTOR.corruption("device.corrupt_page") is None


# ------------------------------------------------------------ lifecycle
def test_states_repr_and_callbacks(nets):
    eng = _engine(nets)
    req = eng.submit([1, 2, 3], 4)
    assert req.state == GenerationRequest.PENDING
    assert "PENDING" in repr(req) and "prompt_len=3" in repr(req)
    fired = []
    req.add_done_callback(fired.append)
    req.add_done_callback(lambda r: 1 / 0)      # swallowed
    eng.run_until_drained()
    assert req.state == GenerationRequest.DONE and "DONE" in repr(req)
    assert fired == [req]
    req.add_done_callback(fired.append)         # already done: at once
    assert fired == [req, req]
    bad = eng.submit([], 4)
    assert bad.state == GenerationRequest.FAILED
    assert "error=ValueError" in repr(bad)


@pytest.mark.parametrize("how", ["cancel", "deadline"])
def test_cancel_and_deadline_while_queued_match_jax(nets, how):
    """Neither request takes a slot; the same exception and counters as
    the JAX engine."""
    outcome = []
    engines = (JaxEngine(nets[0], num_slots=2, decoder=nets[1]),
               _engine(nets))
    for eng in engines:
        if how == "cancel":
            req = eng.submit([1, 2], 8)
            assert req.cancel() is True
        else:
            req = eng.submit([1, 2], 8, deadline=0.0)
            time.sleep(0.01)
        eng.run_until_drained()
        st = eng.stats()
        outcome.append((type(req._error).__name__, req.state,
                        st["cancelled"], st["deadline_exceeded"],
                        st["prefills"]))
        assert req.cancel() is False            # already finished
    assert outcome[0] == outcome[1]
    assert outcome[1][:2] == (("Cancelled", "CANCELLED")
                              if how == "cancel"
                              else ("DeadlineExceeded", "FAILED"))


def test_queue_full_sheds_with_depth(nets):
    outcome = []
    for eng in (JaxEngine(nets[0], num_slots=1, decoder=nets[1],
                          max_pending=2),
                _engine(nets, num_slots=1, max_pending=2)):
        held = [eng.submit([1, 2], 3) for _ in range(2)]
        shed = eng.submit([3, 4], 3)
        with pytest.raises(Exception) as exc:
            shed.result(0)
        eng.run_until_drained()
        assert all(len(r.result(0)) == 5 for r in held)
        again = eng.submit([5, 6], 2)
        eng.run_until_drained()
        assert len(again.result(0)) == 4
        outcome.append((type(exc.value).__name__, exc.value.queue_depth,
                        eng.stats()["rejected"]))
    assert outcome[0] == outcome[1] == ("RejectedError", 2, 1)


def test_deadline_enforced_mid_decode(nets):
    """Every decode step hangs 0.3 s: the 1.5 s deadline passes after
    some tokens, the slot is freed and the next request reuses it."""
    inj = FaultInjector()
    inj.hang_for("engine.step", seconds=0.3, times=1000)
    eng = _engine(nets, num_slots=1, fault_injector=inj).start()
    try:
        doomed = eng.submit([1, 2, 3], 25, deadline=1.5)
        with pytest.raises(DeadlineExceeded):
            doomed.result(30)
        assert doomed.state == GenerationRequest.FAILED
        assert 1 <= len(doomed.generated) < 25   # it WAS decoding
        inj.clear()
        ok = eng.submit([4, 5], 3)
        assert len(ok.result(30)) == 5
        assert eng.stats()["deadline_exceeded"] == 1
    finally:
        eng.shutdown()


def test_cancel_mid_decode(nets):
    inj = FaultInjector()
    inj.hang_for("engine.step", seconds=0.1, times=1000)
    eng = _engine(nets, num_slots=1, fault_injector=inj).start()
    try:
        req = eng.submit([1, 2, 3], 25)
        assert _wait(lambda: len(req.generated) >= 2)
        assert req.cancel() is True
        with pytest.raises(Cancelled):
            req.result(30)
        assert req.state == GenerationRequest.CANCELLED
        inj.clear()
        ok = eng.submit([4], 3)
        assert len(ok.result(30)) == 4
        assert eng.stats()["cancelled"] == 1
    finally:
        eng.shutdown()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_death_cause_reaches_result_and_later_submits(nets):
    inj = FaultInjector()
    inj.raise_once("engine.step", RuntimeError("device melted"))
    eng = _engine(nets, fault_injector=inj).start()
    req = eng.submit([1, 2, 3], 8)
    assert _wait(req.done)
    with pytest.raises(RuntimeError, match="device melted"):
        req.result()
    late = eng.submit([4, 5], 3)
    with pytest.raises(RuntimeError, match="device melted"):
        late.result()
    assert eng.stats()["failed"] >= 1
    eng.shutdown()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_unsupervised_crash_fails_queued_requests_too(nets):
    inj = FaultInjector()
    inj.raise_once("engine.prefill", RuntimeError("prefill died"))
    eng = _engine(nets, num_slots=1, fault_injector=inj).start()
    reqs = [eng.submit([1, 2], 4) for _ in range(3)]
    for r in reqs:
        assert _wait(r.done)
        with pytest.raises(RuntimeError, match="prefill died"):
            r.result()
    assert eng.stats()["failed"] == 3
    eng.shutdown()


def test_run_until_drained_propagates_an_injected_fault(nets):
    inj = FaultInjector()
    inj.raise_once("engine.step", RuntimeError("boom"), at=2)
    eng = _engine(nets, fault_injector=inj)
    eng.submit([1, 2, 3], 6)
    with pytest.raises(RuntimeError, match="boom"):
        eng.run_until_drained()


# ----------------------------------------------------------- supervisor
def test_supervised_crash_recovers_token_for_token(nets):
    """A crash at the 4th decode block: the supervisor quarantines,
    rebuilds around the same decoder (no weight recast) and requeues;
    every request completes once with the JAX engine's tokens."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, VOCAB, n) for n in (3, 4, 2, 3, 4)]
    gens = [6, 8, 5, 7, 6]
    want = _jax_outputs(nets, prompts, gens)
    dec = nets[3]
    dec._device_params()                # cast once, whatever ran before
    casts = dec.param_casts
    inj = FaultInjector()
    inj.raise_once("engine.step", RuntimeError("injected crash"), at=4)
    eng = _engine(nets, fault_injector=inj)
    sup = EngineSupervisor(eng, timeout=30.0, interval=0.1,
                           max_restarts=2).start()
    try:
        reqs = [sup.submit(p, g) for p, g in zip(prompts, gens)]
        for r, w in zip(reqs, want):
            np.testing.assert_array_equal(r.result(60), w)
        assert sup.restarts == 1 and sup.recovered_requests >= 1
        assert sup.engine is not eng and sup.engine.decoder is dec
        s = sup.stats()
        assert s["completed"] == len(reqs) and s["failed"] == 0
        assert s["requeued"] >= 1 and s["restarts"] == 1
        assert dec.param_casts == casts
    finally:
        sup.stop()


def test_wedge_detected_and_restarted(nets):
    """The 3rd decode block hangs 4 s (the pipeline retires block 1 only
    after dispatching block 2, so a hang at block 3 follows a completed
    step and is past the first-step grace); the heartbeat times out after
    1 s and a fresh engine finishes the requests."""
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, VOCAB, 3) for _ in range(3)]
    want = _jax_outputs(nets, prompts, [6, 6, 6])
    inj = FaultInjector()
    inj.hang_for("engine.step", seconds=4.0, at=3)
    eng = _engine(nets, fault_injector=inj)
    sup = EngineSupervisor(eng, timeout=1.0, interval=0.1,
                           max_restarts=2).start()
    try:
        reqs = [sup.submit(p, 6) for p in prompts]
        for r, w in zip(reqs, want):
            np.testing.assert_array_equal(r.result(60), w)
        assert sup.restarts == 1
    finally:
        sup.stop()


def test_first_step_silence_is_grace_not_a_wedge(nets):
    """A 2 s hang before the first decode block completes reads as a cold
    start (warmup_grace), not as a wedge of the 0.5 s timeout."""
    inj = FaultInjector()
    inj.hang_for("engine.step", seconds=2.0, at=1)
    eng = _engine(nets, fault_injector=inj)
    sup = EngineSupervisor(eng, timeout=0.5, interval=0.1,
                           max_restarts=2).start()
    try:
        req = sup.submit([1, 2, 3], 4)
        assert len(req.result(30)) == 7
        assert sup.restarts == 0
    finally:
        sup.stop()


def test_restart_budget_exhausted_fails_with_cause(nets):
    inj = FaultInjector()
    inj.raise_n("engine.step", RuntimeError, n=10_000)
    eng = _engine(nets, fault_injector=inj)
    sup = EngineSupervisor(eng, timeout=30.0, interval=0.1,
                           max_restarts=2).start()
    try:
        req = sup.submit([1, 2, 3], 8)
        assert _wait(req.done, timeout=60)
        with pytest.raises(RuntimeError, match="restart budget"):
            req.result()
        assert sup.given_up is not None and sup.restarts == 2
        late = sup.submit([1, 2], 2)
        assert _wait(late.done, timeout=5)
        with pytest.raises(RuntimeError):
            late.result()
    finally:
        sup.stop()


def test_heartbeat_monitor_fires_once_per_silent_worker():
    lost = []
    mon = HeartbeatMonitor(timeout=5.0, on_failure=lost.append)
    mon.register("a")
    mon.register("b")
    mon._beats["a"] -= 10.0                 # silent for 10 s
    mon.beat("b")
    assert mon.check_once() == ["a"] and mon.check_once() == []
    assert lost == ["a"] and mon.failed_workers() == ["a"]
    mon.register("a")                       # re-registered: alive again
    assert mon.failed_workers() == []


# --------------------------------------------- quarantine and requeue
def test_quarantine_harvests_each_request_once_and_requeue_resumes(nets):
    """Mid-decode quarantine harvests the in-slot and queued requests
    once; requeued on a fresh engine they resume from their tokens so
    far and finish with the JAX engine's tokens."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, VOCAB, n) for n in (4, 3, 5)]
    gens = [9, 7, 8]
    want = _jax_outputs(nets, prompts, gens)
    eng = _engine(nets, num_slots=2, block_size=2)
    reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    eng._admit()
    eng._step()
    eng._step()
    harvested, cause = eng.quarantine()
    assert cause is None and sorted(map(id, harvested)) == \
        sorted(map(id, reqs))
    assert any(r.generated for r in harvested)
    assert eng.quarantine()[0] == []            # nothing twice
    new = _engine(nets, num_slots=2, block_size=2)
    for r in harvested:
        new.requeue(r)
    new.run_until_drained()
    for r, w in zip(reqs, want):
        np.testing.assert_array_equal(r.result(0), w)
    assert new.stats()["requeued"] == 3


def test_drain_closes_admission_and_harvests(nets):
    eng = _engine(nets, num_slots=1).start()
    try:
        eng.begin_drain()
        shed = eng.submit([1, 2], 3)
        with pytest.raises(RejectedError, match="draining"):
            shed.result(0)
    finally:
        eng.shutdown()
    inj = FaultInjector()
    inj.hang_for("engine.step", seconds=0.2, times=1000)
    eng = _engine(nets, num_slots=1, fault_injector=inj).start()
    try:
        reqs = [eng.submit([1, 2, 3], 20), eng.submit([4, 5], 20)]
        assert _wait(lambda: len(reqs[0].generated) >= 1)
        harvested, cause = eng.preempt_drain(budget=10.0)
        assert cause is None and not any(r.done() for r in harvested)
        assert sorted(map(id, harvested)) == sorted(map(id, reqs))
        assert not eng._worker.is_alive()
    finally:
        eng.shutdown()
