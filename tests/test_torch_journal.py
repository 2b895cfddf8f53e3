"""PyTorch port: the durable request journal and the preemption drain
against the JAX package, on the CPU. The CRC-framed WAL round trip (a
journal either package writes replays identically in the other), the
torn-tail and corruption sweeps, a journal written by the JAX engine
recovered by the port's ``recover_from_journal`` into the port's engine
(same weights) giving the JAX engine's tokens, idempotent recovery, the
drain's handoff manifest and a double SIGTERM, and one small subprocess
SIGKILL → restart that completes every request exactly once."""

import json
import os
import signal
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import (SlotGenerationEngine as JaxEngine,
                                       transformer_lm_conf as jax_lm_conf)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.streaming import journal as jjournal
from deeplearning4j_tpu_torch.models import (SlotGenerationEngine,
                                             TransformerDecoder,
                                             transformer_lm_conf)
from deeplearning4j_tpu_torch.observability import (FlightRecorder,
                                                    MetricsRegistry)
from deeplearning4j_tpu_torch.parallel import (FaultInjector, RejectedError,
                                               ServingPreemptionHandler)
from deeplearning4j_tpu_torch.streaming import (FleetLedger, RequestJournal,
                                                recover_from_journal,
                                                replay_journal)
from deeplearning4j_tpu_torch.streaming import journal as tjournal
from deeplearning4j_tpu_torch.tools import chaos_soak
from deeplearning4j_tpu_torch.utils import graph_from_numpy

VOCAB = 12
KW = dict(vocab_size=VOCAB, d_model=32, num_heads=2, num_layers=2,
          max_length=32, seed=5)


@pytest.fixture(scope="module")
def nets():
    """(JAX net, port net, port decoder) on the same parameters, every
    weight matrix scaled by 4 so greedy tokens depend on the context."""
    jnet = JaxGraph(jax_lm_conf(**KW)).init()
    jnet.params = {v: {k: a * 4 if a.ndim == 2 else a for k, a in p.items()}
                   for v, p in jnet.params.items()}
    net = graph_from_numpy(transformer_lm_conf(**KW),
                           {v: {k: np.asarray(a) for k, a in p.items()}
                            for v, p in jnet.params.items()}, device="cpu")
    return jnet, net, TransformerDecoder(net)


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return ([rng.integers(0, VOCAB, int(rng.integers(2, 5)))
             for _ in range(n)],
            [int(rng.integers(2, 7)) for _ in range(n)])


def _expected(nets, prompts, gens):
    _, net, dec = nets
    clean = SlotGenerationEngine(net, num_slots=2, decoder=dec,
                                 tracing=False)
    reqs = [clean.submit(p, g) for p, g in zip(prompts, gens)]
    clean.run_until_drained()
    return [r.result(1) for r in reqs]


def _fake_request(rid):
    req = type("R", (), {})()
    req.journal_id = rid
    req.prompt = np.asarray([1, 2, 3], np.int32)
    req.max_new_tokens = 7
    req.temperature = 0.5
    req.eos_id = 4
    req.deadline = 9.0
    req.generated = [5]
    req._created_t = time.perf_counter() - 1.5
    return req


def _write(mod, directory):
    jr = mod.RequestJournal(str(directory), fsync="always")
    jr.submitted(_fake_request('we"ird\\id'), route="gen0:topic")
    jr.retired([('we"ird\\id', 0, (5, 6)), ('we"ird\\id', 2, (7,))])
    jr.requeued(_fake_request('we"ird\\id'))
    jr.retired([("x", 2, (9,)), ("x", 0, (5, 6))])
    jr.finished('we"ird\\id', "done")
    jr.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_round_trip_replays_in_both_packages(tmp_path, writer):
    _write(tjournal if writer == "port" else jjournal, tmp_path)
    entries, rep = replay_journal(str(tmp_path))
    jentries, jrep = jjournal.replay_journal(str(tmp_path))
    assert rep["truncated_frames"] == jrep["truncated_frames"] == 0
    assert sorted(entries) == sorted(jentries)
    for rid in entries:
        e, j = entries[rid], jentries[rid]
        assert (e.prompt, e.max_new_tokens, e.temperature, e.eos_id,
                e.deadline, e.route, e.requeues, e.status, e.tokens()) == \
            (j.prompt, j.max_new_tokens, j.temperature, j.eos_id,
             j.deadline, j.route, j.requeues, j.status, j.tokens())
    e = entries['we"ird\\id']
    assert e.tokens() == [5, 6, 7] and e.status == "done"
    assert abs(time.time() - e.created_wall - 1.5) < 0.5
    assert entries["x"].tokens() == [5, 6, 9]
    docs = [tjournal._frame({"k": "sub", "id": "a", "p": [1]}),
            jjournal._frame({"k": "sub", "id": "a", "p": [1]})]
    assert docs[0] == docs[1]
    assert tjournal._parse_frame(docs[1].rstrip(b"\n")) == \
        jjournal._parse_frame(docs[0].rstrip(b"\n"))


def test_torn_tail_truncation_sweep(tmp_path):
    """For every truncation point of a segment, replay never raises and
    yields a prefix of the full state, as the JAX replay does."""
    jr = RequestJournal(str(tmp_path), fsync="always")
    for i in range(8):
        jr.retired([(f"r{i}", 0, (i, i + 1))])
        jr.finished(f"r{i}", "done")
    jr.close()
    (seg,) = [p for p in os.listdir(tmp_path) if p.endswith(".log")]
    path = os.path.join(tmp_path, seg)
    data = open(path, "rb").read()
    full, _ = replay_journal(str(tmp_path))
    for cut in range(len(data)):
        with open(path, "wb") as f:
            f.write(data[:cut])
        entries, rep = replay_journal(str(tmp_path))
        jentries, jrep = jjournal.replay_journal(str(tmp_path))
        assert rep["truncated_frames"] == jrep["truncated_frames"]
        assert {r: (e.status, e.tokens()) for r, e in entries.items()} == \
            {r: (e.status, e.tokens()) for r, e in jentries.items()}
        for rid, e in entries.items():
            assert e.tokens() in (full[rid].tokens(), [])
        if 0 < cut and not data[:cut].endswith(b"\n"):
            assert rep["truncated_frames"] == 1


def test_corruption_sweep_never_crashes(tmp_path):
    jr = RequestJournal(str(tmp_path), fsync="always")
    for i in range(6):
        jr.retired([(f"r{i}", 0, (i,))])
    jr.close()
    (seg,) = [p for p in os.listdir(tmp_path) if p.endswith(".log")]
    path = os.path.join(tmp_path, seg)
    data = bytearray(open(path, "rb").read())
    fr = FlightRecorder(registry=MetricsRegistry())
    for pos in range(0, len(data), 5):
        mut = bytearray(data)
        mut[pos] ^= 0xFF
        with open(path, "wb") as f:
            f.write(mut)
        entries, rep = replay_journal(str(tmp_path), fr)
        jentries, _ = jjournal.replay_journal(str(tmp_path))
        assert rep["truncated_frames"] <= 1
        assert sorted(entries) == sorted(jentries)
    assert len(fr.events(kind="journal")) > 0


def test_jax_written_journal_recovers_in_the_port(nets, tmp_path):
    """The JAX engine journals six requests and is abandoned mid-stream;
    the port's recovery replays that journal into the port's engine on
    the same weights and finishes every request with the JAX engine's
    uninterrupted tokens."""
    jnet, net, dec = nets
    prompts, _ = _prompts(6, seed=3)
    gens = [6] * 6
    jclean = JaxEngine(jnet, num_slots=2)
    want = [jclean.submit(p, g) for p, g in zip(prompts, gens)]
    jclean.run_until_drained()
    jr = jjournal.RequestJournal(str(tmp_path), fsync="always")
    jeng = JaxEngine(jnet, num_slots=2, journal=jr)
    for i, (p, g) in enumerate(zip(prompts, gens)):
        jeng.submit(p, g, journal_id=f"m{i}")
    jeng._admit()
    for _ in range(3):                    # a few blocks, then "killed"
        jeng._step()
    jr.close()
    entries, _ = jjournal.replay_journal(str(tmp_path))
    assert any(e.status == "open" and e.tokens() for e in entries.values())
    tjr = RequestJournal(str(tmp_path))
    eng = SlotGenerationEngine(net, num_slots=2, decoder=dec, journal=tjr)
    rep = recover_from_journal(tjr, eng)
    assert not rep.unrecoverable and not rep.fenced
    eng.run_until_drained()
    got = {r.journal_id: r for r in rep.requests}
    for rid, e in entries.items():
        i = int(rid[1:])
        out = got[rid].result(0) if rid in got else \
            np.asarray(list(e.prompt) + e.tokens())
        np.testing.assert_array_equal(out, want[i].result(0))
    tjr.close()


def test_recovery_is_idempotent(nets, tmp_path):
    _, net, dec = nets
    prompts, gens = _prompts(6, seed=5)
    expected = _expected(nets, prompts, gens)
    jr = RequestJournal(str(tmp_path))
    inj = FaultInjector(registry=MetricsRegistry(),
                        flight_recorder=FlightRecorder())
    inj.hang_for("engine.step", seconds=0.08, at=1, times=500)
    eng = SlotGenerationEngine(net, num_slots=2, decoder=dec, journal=jr,
                               fault_injector=inj).start()
    for i, (p, g) in enumerate(zip(prompts, gens)):
        eng.submit(p, g, journal_id=f"m{i}")
    time.sleep(0.4)                       # mid-stream
    eng.quarantine()
    jr.close()
    jr2 = RequestJournal(str(tmp_path))
    eng2 = SlotGenerationEngine(net, num_slots=2, decoder=dec,
                                journal=jr2).start()
    rep = recover_from_journal(jr2, eng2)
    assert set(rep.recovered) | set(rep.completed) | \
        set(rep.already_done) == {f"m{i}" for i in range(6)}
    for rq in rep.requests:
        np.testing.assert_array_equal(rq.result(30),
                                      expected[int(rq.journal_id[1:])])
        assert "recovered" in rq.trace.span_names()
    rep2 = recover_from_journal(jr2, eng2)        # a second pass: no-op
    assert not rep2.recovered and len(rep2.already_done) == 6
    eng2.shutdown()
    jr2.close()


def test_ledger_fences_recovery(nets, tmp_path):
    _, net, dec = nets
    jr = RequestJournal(str(tmp_path), fsync="always")
    eng = SlotGenerationEngine(net, num_slots=2, decoder=dec, journal=jr)
    eng.submit([1, 2, 3], 5, journal_id="a")
    eng.submit([3, 2], 5, journal_id="b")
    jr.sync()
    ledger = FleetLedger()
    ledger.assign("a", "other-replica")
    ledger.assign("b", "me")
    eng2 = SlotGenerationEngine(net, num_slots=2, decoder=dec)
    rep = recover_from_journal(jr, eng2, ledger=ledger, replica_id="me")
    assert rep.fenced == ["a"] and rep.recovered == ["b"]
    jr.close()


def test_drain_writes_the_manifest_and_recovers(nets, tmp_path):
    _, net, dec = nets
    prompts, gens = _prompts(6, seed=7)
    expected = _expected(nets, prompts, gens)
    jdir = str(tmp_path / "j")
    jr = RequestJournal(jdir)
    fr = FlightRecorder(registry=MetricsRegistry())
    inj = FaultInjector(registry=MetricsRegistry(), flight_recorder=fr)
    inj.hang_for("engine.step", seconds=0.08, at=1, times=500)
    eng = SlotGenerationEngine(net, num_slots=2, decoder=dec, journal=jr,
                               fault_injector=inj).start()
    for i, (p, g) in enumerate(zip(prompts, gens)):
        eng.submit(p, g, journal_id=f"d{i}")
    time.sleep(0.3)
    h = ServingPreemptionHandler(eng, jr, deadline=10.0, manifest_dir=jdir,
                                 flight_recorder=fr,
                                 registry=MetricsRegistry())
    assert h.preempt("test") is True
    assert h.preempt("again") is False
    assert h.wait(20)
    rep = h.report
    assert rep.within_budget and rep.journal_synced
    doc = json.load(open(rep.manifest_path))
    assert set(doc["extra"]["handoff"]["unfinished_ids"]) <= \
        {f"d{i}" for i in range(6)}
    assert doc["extra"]["journal"]["journal_id"] == jr.journal_id
    late = eng.submit(prompts[0], 2)
    with pytest.raises((RejectedError, RuntimeError)):
        late.result(0)
    jr.close()
    jr2 = RequestJournal(jdir)
    eng2 = SlotGenerationEngine(net, num_slots=2, decoder=dec,
                                journal=jr2).start()
    for rq in recover_from_journal(jr2, eng2).requests:
        np.testing.assert_array_equal(rq.result(30),
                                      expected[int(rq.journal_id[1:])])
    eng2.shutdown()
    jr2.close()


def test_double_sigterm_drains_once(nets, tmp_path):
    _, net, dec = nets
    jr = RequestJournal(str(tmp_path))
    eng = SlotGenerationEngine(net, num_slots=2, decoder=dec,
                               journal=jr).start()
    h = ServingPreemptionHandler(eng, jr, deadline=5.0,
                                 registry=MetricsRegistry()).install()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.wait(15)
        os.kill(os.getpid(), signal.SIGTERM)      # idempotent
        time.sleep(0.1)
        assert int(h._m_drains.value) == 1
    finally:
        h.uninstall()
    jr.close()


@pytest.mark.parametrize("argv", [[], ["--process-kill"], ["--spec"],
                                  ["--replicas", "3"], ["--autoscale"],
                                  ["--disagg"], ["--corruption"],
                                  ["--remote"], ["--remote-scale"]],
                         ids=["soak", "process-kill", "spec", "replicas",
                              "autoscale", "disagg", "corruption", "remote",
                              "remote-scale"])
def test_soak_entry_points_default_to_the_card(monkeypatch, argv):
    """Each soak round builds its tiny LM on the CUDA card unless asked
    for the CPU: with no card visible, the entry point raises naming
    device='cpu' instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chaos_soak.main(argv)


def test_process_kill_restart_completes_exactly_once(tmp_path):
    """A child process serving 4 journaled requests is SIGKILLed
    mid-stream and restarted: nothing lost, nothing duplicated (ledger
    over the result stream), tokens equal the uninterrupted run."""
    s = chaos_soak.run_process_kill_soak(
        n_requests=4, sigterm_round=False, journal_ab=False,
        workdir=str(tmp_path), round_wait_s=60.0, device="cpu")
    assert s["lost"] == 0 and s["duplicates"] == 0, s
    assert s["mismatches"] == 0 and s["failures"] == 0, s
    assert s["final_exit_code"] == 0 and s["ok"], s
