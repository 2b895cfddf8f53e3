"""Chaos soak of the port's serving host tier: the in-process rounds of
the JAX package's ``scripts/chaos_soak.py``.

- :func:`run_soak` — the supervised crash / wedge round: a seeded fault
  schedule (crashes and wedges at ``engine.step``) under an
  ``EngineSupervisor``, with the bars: zero stranded requests, no kernel
  build and no weight cast after a takeover (``cuda_lib.nvcc_runs()`` and
  ``TransformerDecoder.param_casts`` — the port's counterpart of the JAX
  soak's steady-state compile audit), at most one ``engine.decode``
  readback per decode block with telemetry on, one finished trace per
  request (``takeover`` spans on recovered ones), completed requests
  token-identical to a clean run, and with ``postmortem_dir`` one
  flight-recorder post-mortem per takeover whose trace ids are the
  recovered requests'.
- :func:`run_process_kill_soak` — the engine serves in a CHILD process
  (``--process-kill-child``) with a durable ``RequestJournal``; the
  parent SIGKILLs it mid-stream, restarts it (recovery replays the WAL),
  SIGTERMs it for a ``PreemptionHandler`` drain, and restarts it to
  completion. Bars: zero lost, zero duplicated (``FleetLedger`` over the
  result stream), token-identical to the parent's uninterrupted run, SLO
  queue-wait clocks continuous across both outages.
- :func:`run_spec_soak` — the ``--spec`` round: a cyclic-trained LM (so
  nearly every dispatch is a verify block); a supervised crash
  mid-verify, a fleet replica crash mid-verify, a NaN in a verify
  forward quarantining its replica.
- :func:`run_fleet_soak` (``--replicas N``) — N replicas behind an
  ``EngineFleetRouter``, one crash-killed and one zombied mid-stream:
  migration exactly once (``FleetLedger``), tokens identical.
- :func:`run_autoscale_soak` (``--autoscale``) — the
  ``BurnRateAutoscaler`` grows a 1-replica fleet under a burst and
  drain-shrinks it back.
- :func:`run_disagg_soak` (``--disagg``) — a ``PhaseRouter`` over the
  per-page wire, a mid-handoff transport failure and one worker of each
  role killed; the transfer byte account exact.
- :func:`run_corruption_soak` (``--corruption``) — logits NaN, an at-rest
  page flip, a canary-caught flip, a mid-handoff flip and a degraded
  journal: every corruption caught before a client sees it.

The process-per-replica rounds (``--remote``, ``--remote-scale``) drive
``streaming/remote.py``: :func:`run_remote_soak` and
:func:`run_remote_scale_ab`.

By default every round builds a tiny LM on the CUDA card (``device=``,
or ``--device cpu``, runs it on the CPU); ``net=`` (a ComputationGraph on
any device) and ``prompts=`` / ``gens=`` run it on a caller's net
instead, as ``chip_smoke.py`` does with the flagship. Run from the
repository root::

    python -m deeplearning4j_tpu_torch.tools.chaos_soak --seed 7 --json
    python -m deeplearning4j_tpu_torch.tools.chaos_soak --device cpu
    python -m deeplearning4j_tpu_torch.tools.chaos_soak --process-kill
    python -m deeplearning4j_tpu_torch.tools.chaos_soak --spec
    python -m deeplearning4j_tpu_torch.tools.chaos_soak --replicas 3
    python -m deeplearning4j_tpu_torch.tools.chaos_soak --autoscale
    python -m deeplearning4j_tpu_torch.tools.chaos_soak --disagg
    python -m deeplearning4j_tpu_torch.tools.chaos_soak --corruption
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional, Sequence

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _tiny_lm(vocab: int = 12, max_length: int = 32, device=None):
    """The soak's tiny LM; ``device`` None is the CUDA card."""
    from ..models import transformer_lm_conf
    from ..nn.graph import ComputationGraph
    return ComputationGraph(transformer_lm_conf(
        vocab, d_model=32, num_heads=2, num_layers=2, max_length=max_length,
        learning_rate=1e-2, seed=5), device=device).init()


def _builds(dec) -> tuple:
    """(kernel builds, weight casts) so far: a takeover must add neither."""
    from ..kernels import cuda_lib
    return cuda_lib.nvcc_runs(), dec.param_casts


def run_soak(seed: int = 0, n_requests: int = 16, num_slots: int = 2,
             max_new: int = 6, crashes: int = 2, hangs: int = 1,
             vocab: int = 12, supervisor_timeout: float = 2.0,
             hang_seconds: Optional[float] = None, wait_s: float = 180.0,
             steady_wave: int = 4, overhead_ab: bool = True,
             postmortem_dir: Optional[str] = None, paged: bool = False,
             profile: bool = False, net=None,
             prompts: Optional[Sequence] = None,
             gens: Optional[Sequence[int]] = None,
             block_size: int = 1,
             crash_hits: Optional[Sequence[int]] = None,
             device=None, exact_after_crash: bool = True) -> dict:
    """One supervised crash / wedge round; returns a summary dict (its
    ``ok`` is the conjunction of the bars in the module docstring).
    ``crash_hits`` pins the ``engine.step`` hits that crash (``crashes``
    seeded ones otherwise); ``device`` places the tiny LM built when no
    ``net`` is given (None: the CUDA card). ``exact_after_crash`` False
    (with ``postmortem_dir``) holds a recovered request to the clean run
    only up to its first crash point (the post-mortems'
    ``generated_so_far``) and to its length: in bf16 the re-prefill of
    prompt + tokens so far rounds otherwise than decode did, and greedy
    tokens may part after it (the JAX engine's do too); the partings are
    counted in ``diverged_after_crash``."""
    from ..models.generation import SlotGenerationEngine, TransformerDecoder
    from ..observability.flightrec import FlightRecorder
    from ..observability.metrics import Histogram, default_registry
    from ..ops.transfer import fetch_counts
    from ..parallel.failures import EngineSupervisor
    from ..parallel.faults import FaultInjector

    if hang_seconds is None:
        hang_seconds = 2.0 * supervisor_timeout
    rng = np.random.default_rng(seed)
    if net is None:
        net = _tiny_lm(vocab, device=device)
    if prompts is None:
        prompts = [rng.integers(0, vocab, int(rng.integers(2, 5)))
                   for _ in range(n_requests)]
        gens = [int(rng.integers(2, max_new + 1)) for _ in range(n_requests)]
    prompts, gens = list(prompts), list(gens)
    n_requests = len(prompts)
    dec = TransformerDecoder(net)
    eng_kw = {"block_size": block_size}
    if paged:
        eng_kw.update(paged=True, page_size=8)
    summary = {"seed": seed, "requests": n_requests, "crashes": crashes,
               "hangs": hangs, "paged": bool(paged)}
    prof = tl0 = tl_mid = None
    if profile:
        from ..observability.profiler import default_profiler
        prof = default_profiler()
        tl0 = prof.timeline.total_added
    fetch0 = fetch_counts("engine.decode")["engine.decode"]

    # clean reference: the uninterrupted ground truth (and the warmup)
    clean = SlotGenerationEngine(net, num_slots=num_slots, decoder=dec,
                                 **eng_kw)
    clean_reqs = [clean.submit(p, g) for p, g in zip(prompts, gens)]
    clean.run_until_drained()
    expected = [r.result(1) for r in clean_reqs]
    clean_blocks = clean.stats()["decode_blocks"]

    # seeded fault schedule against the decode-step hit counter: crashes
    # in the first half so they fire, the wedge right after
    est_steps = max(4, sum(gens) // max(1, num_slots * block_size))
    flightrec = FlightRecorder() if postmortem_dir else None
    inj = FaultInjector(flight_recorder=flightrec)
    crash_hits = sorted(
        {int(h) for h in (crash_hits if crash_hits is not None else
                          rng.integers(2, max(3, est_steps), crashes))})
    for h in crash_hits:
        inj.raise_once("engine.step", RuntimeError(
            f"soak: injected crash at step hit {h}"), at=h)
    hang_hits = sorted(
        {int(h) for h in rng.integers(2, max(3, est_steps), hangs)} -
        set(crash_hits))
    for h in hang_hits:
        inj.hang_for("engine.step", seconds=hang_seconds, at=h)
    summary["crash_hits"] = crash_hits
    summary["hang_hits"] = hang_hits

    eng = SlotGenerationEngine(net, num_slots=num_slots, decoder=dec,
                               fault_injector=inj,
                               flight_recorder=flightrec, **eng_kw)
    sup = EngineSupervisor(eng, timeout=supervisor_timeout, interval=0.1,
                           max_restarts=crashes + hangs + 2,
                           postmortem_dir=postmortem_dir)
    # every request queued before the loop starts: the first admissions
    # are the clean run's, so tokens before the first crash match it
    reqs = [sup.submit(p, g) for p, g in zip(prompts, gens)]
    sup.start()
    deadline = time.monotonic() + wait_s
    for r in reqs:
        r._done.wait(max(0.0, deadline - time.monotonic()))
    stranded = [r for r in reqs if not r.done()]
    if prof is not None:
        tl_mid = prof.timeline.total_added

    # post-restart steady state: faults cleared, a fresh wave must build
    # no kernel and cast no weight
    inj.clear()
    builds0 = _builds(dec)
    wave = [sup.submit(p, g)
            for p, g in zip(prompts[:steady_wave], gens[:steady_wave])]
    wave_deadline = time.monotonic() + 60.0
    for r in wave:
        r._done.wait(max(0.0, wave_deadline - time.monotonic()))
    builds1 = _builds(dec)
    stranded += [r for r in wave if not r.done()]
    stats = sup.stats()
    if paged:
        fin = sup.engine
        summary["page_audit"] = fin._pager.audit(fin._slot_pages)
    sup.stop()
    if prof is not None:
        doc, ok = _profile_round_check(prof, tl0, tl_mid,
                                       "recorded_after_takeover")
        chan = prof.channels().get(eng.slo_label)
        doc["channel"] = None if chan is None else chan.summary()
        summary["profile"] = doc
        summary["profile_ok"] = bool(ok and doc["channel"] is not None and
                                     doc["channel"]["blocks"] > 0)

    pm_ok = True
    if postmortem_dir:
        known = {r.trace.request_id
                 for r in list(reqs) + list(wave) + list(clean_reqs)
                 if r.trace is not None}
        summary["postmortems"], pm_ok = _verify_postmortems(
            flightrec.dumps, known, expected=stats["restarts"],
            id_key="recovered_request_ids")
        summary["postmortem_ok"] = pm_ok
    # tokens each recovered request had at its first takeover
    crash_at = {}
    for row in summary.get("postmortems", ()):
        for rid, n in (row.get("generated_so_far") or {}).items():
            crash_at.setdefault(rid, n)
    mismatches = diverged = completed = failed = 0
    for r, p, want in zip(reqs, prompts, expected):
        if r.state != r.DONE:
            failed += 1
            continue
        completed += 1
        got = r.result(0)
        if np.array_equal(got, want):
            continue
        n = crash_at.get(r.trace.request_id) if r.trace is not None \
            else None
        if exact_after_crash or n is None or len(got) != len(want) or \
                not np.array_equal(got[:len(p) + n], want[:len(p) + n]):
            mismatches += 1
        else:
            diverged += 1
    blocks = clean_blocks + stats["decode_blocks"]
    decode_readbacks = fetch_counts("engine.decode")["engine.decode"] - \
        fetch0
    lat_h = Histogram("soak_request_latency_seconds", sample_limit=None)
    trace_problems = takeover_spans = 0
    seen = set()
    for r in list(reqs) + list(wave) + list(clean_reqs):
        tr = r.trace
        if tr is None or tr.trace_id in seen:
            trace_problems += 1
            continue
        seen.add(tr.trace_id)
        if not tr.finished:
            trace_problems += 1
            continue
        names = tr.span_names()
        takeover_spans += names.count("takeover")
        if r.state == r.DONE:
            if not {"submit", "prefill"} <= set(names):
                trace_problems += 1
            lat_h.observe(tr.duration)
    summary.update({
        "stranded": len(stranded), "mismatches": mismatches,
        "diverged_after_crash": diverged,
        "completed": completed, "failed": failed,
        "restarts": stats["restarts"],
        "recovered_requests": stats["recovered_requests"],
        "steady_new_builds": builds1[0] - builds0[0],
        "steady_new_casts": builds1[1] - builds0[1],
        "injector": inj.counters(),
        "decode_blocks": blocks, "decode_readbacks": decode_readbacks,
        "readbacks_per_block": round(decode_readbacks / blocks, 4)
        if blocks else None,
        "trace_problems": trace_problems, "takeover_spans": takeover_spans,
        "request_latency_ms": {
            "p50": round((lat_h.percentile(50) or 0.0) * 1e3, 3),
            "p99": round((lat_h.percentile(99) or 0.0) * 1e3, 3),
            "n": lat_h.count},
        "metrics": default_registry().snapshot(),
    })
    if overhead_ab:
        summary.update(_overhead_ab(net, dec, prompts, gens, num_slots,
                                    block_size=block_size))
    summary["ok"] = bool(
        not stranded and not mismatches and not failed and
        not trace_problems and
        stats["restarts"] >= min(1, crashes + hangs) and
        summary["steady_new_builds"] == 0 and
        summary["steady_new_casts"] == 0 and
        (summary["readbacks_per_block"] or 0) <= 1.0 and pm_ok and
        summary.get("profile_ok", True) and
        not summary.get("page_audit"))
    return summary


def _profile_round_check(prof, tl0, tl_mid, after_key):
    """Every timeline entry the round recorded has non-negative phases and
    bubble, and the ring kept recording on both sides of the takeover.
    Returns (summary dict, ok)."""
    tl_end = prof.timeline.total_added
    recent = prof.timeline.recent(min(len(prof.timeline), tl_end - tl0))
    neg = sum(1 for e in recent
              if e.get("bubble_ms", 0) < 0 or
              any(v < 0 for v in (e.get("phases_ms") or {}).values()))
    doc = {"timeline_recorded": tl_end - tl0, after_key: tl_end - tl_mid,
           "negative_phases": neg}
    return doc, bool(neg == 0 and tl_end > tl_mid > tl0)


def _verify_postmortems(paths, known_trace_ids, expected: int,
                        id_key: str, known_harvest_ids=None,
                        exact: bool = True) -> tuple:
    """Load each post-mortem artifact and check it against the round: the
    embedded traces' request ids equal the ids the recovery harvested
    (``extra[id_key]``; ``exact=False`` for the fleet's artifacts, whose
    harvest lists carry fleet ids, ``known_harvest_ids``) and belong to
    this round's requests, the event timeline shows the injected fault,
    the registry snapshot is there. Returns (archive rows, ok)."""
    archive = []
    ok = len(paths) >= expected
    if known_harvest_ids is None:
        known_harvest_ids = known_trace_ids
    for path in paths:
        row = {"path": path}
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            kinds = {e.get("kind") for e in doc.get("events", ())}
            trace_ids = set(doc.get("request_ids", ()))
            extra = doc.get("extra") or {}
            harvested = set(extra.get(id_key, ()))
            row.update({
                "reason": doc.get("reason"),
                "events": len(doc.get("events", ())),
                "request_ids": sorted(trace_ids),
                "harvested": sorted(harvested),
                "generated_so_far": extra.get("generated_so_far"),
                "fault_on_timeline": "fault" in kinds,
                "trace_match": (trace_ids == harvested or not exact) and
                trace_ids <= known_trace_ids and
                harvested <= set(known_harvest_ids),
            })
            row["ok"] = bool(row["trace_match"] and
                             row["fault_on_timeline"] and
                             doc.get("metrics") is not None)
        except (OSError, ValueError) as e:
            row.update({"ok": False, "error": f"{type(e).__name__}: {e}"})
        ok = ok and row["ok"]
        archive.append(row)
    return archive, ok


def _drain_tok_s(net, dec, prompts, gens, num_slots, block_size,
                 **eng_kw) -> float:
    from ..models.generation import SlotGenerationEngine
    eng = SlotGenerationEngine(net, num_slots=num_slots, decoder=dec,
                               block_size=block_size,
                               max_pending=len(prompts) + 1, **eng_kw)
    for p, g in zip(prompts, gens):
        eng.submit(p, g)
    t0 = time.perf_counter()
    eng.run_until_drained()
    return eng.emitted_tokens / (time.perf_counter() - t0)


def _overhead_ab(net, dec, prompts, gens, num_slots, reps: int = 3,
                 block_size: int = 1) -> dict:
    """Telemetry on vs off (tracing, block histograms, flight events and
    the profiler; the registry counters are the stats machinery either
    way): interleaved drains over the shared decoder, medians and bests
    of emitted tok/s. No bar: host-bound runs move tens of percent."""
    run = lambda tracing: _drain_tok_s(net, dec, prompts, gens, num_slots,
                                       block_size, tracing=tracing)
    run(True)
    on, off = [], []
    for r in range(reps):
        pair = (True, False) if r % 2 == 0 else (False, True)
        for tracing in pair:
            (on if tracing else off).append(run(tracing))
    return {"telemetry_on_tok_s": on, "telemetry_off_tok_s": off,
            "telemetry_on_tok_s_median": float(np.median(on)),
            "telemetry_off_tok_s_median": float(np.median(off))}


def _journal_ab(net, dec, prompts, gens, num_slots, reps: int = 3,
                fsync: str = "every_n", block_size: int = 1) -> dict:
    """Journal on vs off, interleaved drains with tracing off (the
    journal's own cost): medians and samples of emitted tok/s. Each
    journal-on drain writes a fresh temporary directory."""
    from ..streaming.journal import RequestJournal

    def run(journaled: bool) -> float:
        jdir = tempfile.mkdtemp(prefix="jab-") if journaled else None
        jr = RequestJournal(jdir, fsync=fsync) if journaled else None
        try:
            return _drain_tok_s(net, dec, prompts, gens, num_slots,
                                block_size, tracing=False, journal=jr)
        finally:
            if jr is not None:
                jr.close()
                shutil.rmtree(jdir, ignore_errors=True)

    run(True)
    run(False)
    on, off = [], []
    for r in range(reps):
        pair = (True, False) if r % 2 == 0 else (False, True)
        for journaled in pair:
            (on if journaled else off).append(run(journaled))
    return {"journal_on_tok_s": on, "journal_off_tok_s": off,
            "journal_on_tok_s_median": float(np.median(on)),
            "journal_off_tok_s_median": float(np.median(off))}


def _valid_result_lines(path) -> dict:
    """The child's results.jsonl: torn or invalid lines skipped; id →
    first line (later lines for an id come back as ``extra``)."""
    out, dup = {}, []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                try:
                    doc = json.loads(line)
                except ValueError:
                    continue
                rid = doc.get("id")
                if rid is None:
                    continue
                (dup.append(doc) if rid in out else
                 out.__setitem__(rid, doc))
    except OSError:
        pass
    return {"by_id": out, "extra": dup}


def run_process_kill_soak(seed: int = 0, n_requests: int = 10,
                          num_slots: int = 2, max_new: int = 6,
                          vocab: int = 12, block_size: int = 4,
                          sigterm_round: bool = True,
                          drain_deadline: float = 8.0,
                          round_wait_s: float = 90.0,
                          journal_ab: bool = True,
                          workdir: Optional[str] = None, net=None,
                          prompts: Optional[Sequence] = None,
                          gens: Optional[Sequence[int]] = None,
                          slow: float = 0.05, device=None) -> dict:
    """Whole-process kill / recover round (module docstring). The parent
    writes ``net`` (a tiny LM on ``device`` by default, None being the
    CUDA card) with ``utils.write_model``
    into ``workdir`` beside a manifest of the requests; each child
    incarnation restores it on the net's device type and serves through
    a journal. ``slow`` paces the children's decode loop (seconds per
    step, an injected ``engine.step`` hang) so the kills land
    mid-stream."""
    from ..models.generation import SlotGenerationEngine, TransformerDecoder
    from ..streaming.fleet import FleetLedger
    from ..utils import write_model

    if net is None:
        net = _tiny_lm(vocab, device=device)
    own_workdir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="pkill-soak-")
    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    if prompts is None:
        prompts = [rng.integers(0, vocab, int(rng.integers(2, 5)))
                   for _ in range(n_requests)]
        gens = [int(rng.integers(2, max_new + 1)) for _ in range(n_requests)]
    reqs = [{"id": f"req-{i:03d}", "prompt": [int(t) for t in p],
             "gen": int(g)} for i, (p, g) in enumerate(zip(prompts, gens))]
    n_requests = len(reqs)
    write_model(net, os.path.join(workdir, "model.zip"))
    with open(os.path.join(workdir, "manifest.json"), "w",
              encoding="utf-8") as f:
        json.dump({"requests": reqs, "num_slots": num_slots,
                   "block_size": block_size,
                   "device": net.device.type,
                   "compute_dtype": str(net.compute_dtype).replace(
                       "torch.", "")}, f)

    # in-parent uninterrupted reference
    dec = TransformerDecoder(net)
    clean = SlotGenerationEngine(net, num_slots=num_slots, decoder=dec,
                                 block_size=block_size)
    clean_reqs = [clean.submit(r["prompt"], r["gen"]) for r in reqs]
    clean.run_until_drained()
    expected = {r["id"]: cr.result(1) for r, cr in zip(reqs, clean_reqs)}

    results_path = os.path.join(workdir, "results.jsonl")
    ledger = FleetLedger()
    for r in reqs:
        ledger.assign(r["id"], "proc")

    def spawn(incarnation: int, paced: bool):
        env = dict(os.environ)
        env["DL4J_SOAK_SLOW"] = str(slow) if paced else "0"
        return subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.tools."
             "chaos_soak", "--process-kill-child", workdir,
             "--incarnation", str(incarnation),
             "--drain-deadline", str(drain_deadline)],
            env=env, cwd=REPO_ROOT, stdout=subprocess.DEVNULL,
            stderr=open(os.path.join(workdir, f"child-{incarnation}.log"),
                        "w"))

    def wait_results(proc, at_least: int, timeout: float) -> int:
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            n = len(_valid_result_lines(results_path)["by_id"])
            if n >= at_least or proc.poll() is not None:
                return n
            time.sleep(0.05)
        return len(_valid_result_lines(results_path)["by_id"])

    rounds, outages = [], []
    incarnation = 0
    # round 0: SIGKILL mid-stream
    proc = spawn(incarnation, paced=True)
    n0 = wait_results(proc, max(2, n_requests // 4), round_wait_s)
    kill_wall = time.time()
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=30)
    rounds.append({"round": "sigkill", "incarnation": incarnation,
                   "results_at_kill": n0})
    incarnation += 1
    drain_row = None
    if sigterm_round:
        # round 1: recover, then SIGTERM for a preemption drain
        restart_wall = time.time()
        outages.append((kill_wall, restart_wall))
        proc = spawn(incarnation, paced=True)
        wait_results(proc, n0 + 1, round_wait_s)
        t_sig = time.monotonic()
        kill_wall = time.time()
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=drain_deadline + 15)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait(timeout=30)
        drain_row = {"round": "sigterm", "incarnation": incarnation,
                     "exit_code": rc,
                     "exit_latency_s": time.monotonic() - t_sig}
        rounds.append(drain_row)
        incarnation += 1
    # final round: recover and run to completion
    restart_wall = time.time()
    outages.append((kill_wall, restart_wall))
    proc = spawn(incarnation, paced=False)
    try:
        rc_final = proc.wait(timeout=round_wait_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        rc_final = -9
    rounds.append({"round": "final", "incarnation": incarnation,
                   "exit_code": rc_final})

    res = _valid_result_lines(results_path)
    by_id = res["by_id"]
    lost = sorted(set(expected) - set(by_id))
    duplicates = mismatches = failures = 0
    for rid, doc in by_id.items():
        if rid not in expected:
            continue
        if ledger.try_complete(rid, "proc") != "ok":
            duplicates += 1
        if doc.get("failed"):
            failures += 1
        elif not np.array_equal(np.asarray(doc.get("out", []), np.int32),
                                expected[rid]):
            mismatches += 1
    for doc in res["extra"]:
        if ledger.try_complete(str(doc.get("id")), "proc") != "ok":
            duplicates += 1
    # SLO continuity: a request created before an outage and completed
    # after it carries a queue wait that spans the outage
    clock_breaks = spanning = 0
    for rid, doc in by_id.items():
        cw, qw = doc.get("cw"), doc.get("qw")
        if cw is None or qw is None or not doc.get("inc"):
            continue
        for k_wall, r_wall in outages[:int(doc["inc"])]:
            if cw <= k_wall:
                spanning += 1
                if qw + 0.75 < r_wall - cw:
                    clock_breaks += 1
                break
    reports = {}
    for k in range(incarnation + 1):
        try:
            with open(os.path.join(workdir, f"report-{k}.json"),
                      encoding="utf-8") as f:
                reports[k] = json.load(f)
        except (OSError, ValueError):
            reports[k] = None
    final_rep = reports.get(incarnation) or {}
    drain_rep = (reports.get(1) or {}).get("drain") if sigterm_round \
        else None
    summary = {
        "seed": seed, "requests": n_requests, "rounds": rounds,
        "lost": len(lost), "lost_ids": lost, "duplicates": duplicates,
        "mismatches": mismatches, "failures": failures,
        "completed": len(by_id),
        "recovered": {k: (rep or {}).get("recovery")
                      for k, rep in reports.items()},
        "recovery_s": {k: (rep or {}).get("recovery_s")
                       for k, rep in reports.items()},
        "clock_spanning_requests": spanning, "clock_breaks": clock_breaks,
        "steady_new_builds": final_rep.get("steady_new_builds"),
        "drain": drain_rep, "drain_exit": drain_row,
        "journal": final_rep.get("journal"),
        "final_exit_code": rc_final,
    }
    if journal_ab:
        summary.update(_journal_ab(net, dec, [r["prompt"] for r in reqs],
                                   [r["gen"] for r in reqs], num_slots,
                                   block_size=block_size))
    drain_ok = (not sigterm_round) or (
        drain_row is not None and drain_row["exit_code"] == 0 and
        drain_rep is not None and bool(drain_rep.get("within_budget")) and
        bool(drain_rep.get("manifest_path")))
    summary["drain_ok"] = bool(drain_ok)
    summary["ok"] = bool(
        not lost and not duplicates and not mismatches and not failures
        and not clock_breaks and rc_final == 0 and drain_ok and
        summary["steady_new_builds"] == 0)
    if not summary["ok"]:
        # the children's stderr tails, for the failing round's reader
        summary["child_logs"] = {}
        for k in range(incarnation + 1):
            try:
                with open(os.path.join(workdir, f"child-{k}.log"),
                          encoding="utf-8", errors="replace") as f:
                    summary["child_logs"][k] = f.read()[-3000:]
            except OSError:
                pass
    if own_workdir:
        shutil.rmtree(workdir, ignore_errors=True)
    return summary


def _process_kill_child(workdir: str, incarnation: int,
                        drain_deadline: float) -> int:
    """The child serving process of :func:`run_process_kill_soak`:
    restores the model, recovers the journal, serves the manifest through
    a journaled engine under a ``PreemptionHandler``, streams result
    lines, and writes a per-incarnation report."""
    import torch

    from ..models.generation import SlotGenerationEngine
    from ..observability.clock import interval_now
    from ..parallel.faults import FaultInjector
    from ..parallel.preemption import PreemptionHandler
    from ..streaming.journal import RequestJournal, recover_from_journal
    from ..utils import restore_computation_graph

    with open(os.path.join(workdir, "manifest.json"),
              encoding="utf-8") as f:
        manifest = json.load(f)
    results_path = os.path.join(workdir, "results.jsonl")
    t_boot = time.monotonic()
    net = restore_computation_graph(
        os.path.join(workdir, "model.zip"), device=manifest["device"],
        compute_dtype=getattr(torch, manifest["compute_dtype"]))
    jr = RequestJournal(os.path.join(workdir, "journal"), fsync="every_n",
                        fsync_n=4)
    inj = None
    slow = float(os.environ.get("DL4J_SOAK_SLOW", "0") or 0)
    if slow > 0:
        inj = FaultInjector()
        inj.hang_for("engine.step", seconds=slow, at=1, times=1_000_000)
    eng = SlotGenerationEngine(
        net, num_slots=int(manifest["num_slots"]),
        block_size=int(manifest["block_size"]), journal=jr,
        fault_injector=inj).start()
    handler = PreemptionHandler(eng, jr, deadline=drain_deadline,
                                manifest_dir=os.path.join(
                                    workdir, "journal")).install()
    # ids that already have a durable result line: never a second one
    have = set(_valid_result_lines(results_path)["by_id"])
    rf = open(results_path, "a", encoding="utf-8")

    def emit(rid, doc):
        if rid in have:
            return
        have.add(rid)
        rf.write(json.dumps({"id": rid, "inc": incarnation, **doc}) + "\n")
        rf.flush()

    t_rec = time.monotonic()
    recovery = recover_from_journal(jr, eng)
    recovery_s = time.monotonic() - t_rec
    entries = recovery.entries
    # finished just before the kill but with its result line torn: the
    # journal's own tokens are the output
    for rid in recovery.already_done:
        e = entries[rid]
        if e.status == "done" and rid not in have and e.prompt is not None:
            emit(rid, {"out": list(e.prompt) + e.tokens(), "src": "journal",
                       "cw": e.created_wall, "qw": None})
    known = set(recovery.recovered) | set(recovery.completed) | \
        set(recovery.already_done) | set(recovery.fenced)
    pending = {r.journal_id: r for r in recovery.requests}
    for r in manifest["requests"]:
        if r["id"] not in known:
            pending[r["id"]] = eng.submit(r["prompt"], r["gen"],
                                          journal_id=r["id"])

    def flush_done():
        for rid, req in list(pending.items()):
            if not req.done():
                continue
            del pending[rid]
            cw = time.time() - max(0.0, interval_now() - req._created_t)
            if req._error is not None:
                emit(rid, {"failed": f"{type(req._error).__name__}: "
                                     f"{req._error}", "cw": cw})
            else:
                qw = None if req._admitted_t is None else \
                    req._admitted_t - req._created_t
                emit(rid, {"out": [int(t) for t in req.result(0)],
                           "src": "live", "cw": cw, "qw": qw})

    while pending and not handler.preempted:
        flush_done()
        time.sleep(0.02)
    report = {"incarnation": incarnation, "recovery": recovery.to_dict(),
              "recovery_s": recovery_s,
              "boot_s": t_rec - t_boot, "preempted": handler.preempted}
    if handler.preempted:
        handler.wait(drain_deadline + 10)
        flush_done()
        report["drain"] = None if handler.report is None \
            else handler.report.to_dict()
    else:
        flush_done()
        if inj is None:
            # a post-recovery wave must build no kernel and cast nothing
            # beyond what this process's first request did
            if not eng.stats()["emitted_tokens"]:
                warm = manifest["requests"][0]
                eng.submit(warm["prompt"], warm["gen"],
                           journal_id=f"warm-{incarnation}").result(60)
            builds0 = _builds(eng.decoder)
            wave = [eng.submit(manifest["requests"][i]["prompt"],
                               manifest["requests"][i]["gen"],
                               journal_id=f"steady-{incarnation}-{i}")
                    for i in range(min(2, len(manifest["requests"])))]
            t_end = time.monotonic() + 60.0
            for w in wave:
                w._done.wait(max(0.0, t_end - time.monotonic()))
            b = _builds(eng.decoder)
            report["steady_new_builds"] = (b[0] - builds0[0]) + \
                (b[1] - builds0[1])
        eng.shutdown()
    report["journal"] = jr.stats()
    jr.close()
    rf.close()
    with open(os.path.join(workdir, f"report-{incarnation}.json"), "w",
              encoding="utf-8") as f:
        json.dump(report, f, default=str)
    return 0


def run_spec_soak(seed: int = 0, n_requests: int = 16, num_slots: int = 2,
                  vocab: int = 12, wait_s: float = 120.0,
                  train_steps: int = 150, device=None) -> dict:
    """The JAX soak's speculative round: a cyclic-trained LM (greedy
    continuation IS the cycle, so the prompt-lookup drafter predicts
    nearly every token and nearly every dispatch is a verify block),
    paged, sentinel-armed speculative engines, three phases. A: one
    engine under a supervisor, a crash injected at ``engine.step``. B: a
    3-replica fleet, r0 crashed mid-verify, its streams migrated. C: a
    NaN in r0's verify forward trips the sentinel and quarantines r0 as
    CORRUPT. Bars: zero stranded or failed, token-identical to the
    non-speculative reference, verify blocks flowed, page audits clean,
    exactly once (B, C), a restart (A) or a migration (B), and no kernel
    build or weight cast on a post-fault wave."""
    from ..models import lm_batch
    from ..models.generation import SlotGenerationEngine, TransformerDecoder
    from ..observability.integrity import IntegrityConfig
    from ..ops.dataset import DataSet
    from ..parallel.failures import EngineSupervisor
    from ..parallel.faults import FaultInjector
    from ..streaming.fleet import (REPLICA_ALIVE, REPLICA_CORRUPT,
                                   EngineFleetRouter)

    rng = np.random.default_rng(seed)
    net = _tiny_lm(vocab, max_length=64, device=device)
    starts = rng.integers(0, vocab, (16, 1))
    cyc = (starts + np.arange(17)[None, :]) % vocab
    x, y = lm_batch(cyc, vocab)
    ds = DataSet(x, y)
    for _ in range(train_steps):
        net.fit_batch(ds)
    cfg = IntegrityConfig(kv_verify_rate=1.0)
    dec = TransformerDecoder(net, sentinel=True, logit_bound=cfg.logit_bound)
    sk = 8
    spec_kw = {"paged": True, "page_size": 8, "integrity": cfg,
               "block_size": 4}
    prompts = [((int(rng.integers(0, vocab)) + np.arange(16)) % vocab)
               .astype(np.int32) for _ in range(n_requests)]
    gens = [int(rng.integers(8, 17)) for _ in range(n_requests)]

    clean = SlotGenerationEngine(net, num_slots=num_slots, decoder=dec,
                                 **spec_kw)
    clean_reqs = [clean.submit(p, g) for p, g in zip(prompts, gens)]
    clean.run_until_drained()
    expected = [r.result(1) for r in clean_reqs]

    inj = FaultInjector()
    crash_at = int(rng.integers(2, 5))
    inj.raise_once("engine.step", RuntimeError(
        f"spec soak: injected crash at step hit {crash_at}"), at=crash_at)
    eng = SlotGenerationEngine(net, num_slots=num_slots, decoder=dec,
                               speculative=True, spec_k=sk,
                               fault_injector=inj, **spec_kw)
    sup = EngineSupervisor(eng, timeout=2.0, interval=0.1,
                           max_restarts=4).start()
    reqs = [sup.submit(p, g) for p, g in zip(prompts, gens)]
    deadline = time.monotonic() + wait_s
    for r in reqs:
        r._done.wait(max(0.0, deadline - time.monotonic()))
    stranded = [r for r in reqs if not r.done()]
    mismatch = sum(1 for r, want in zip(reqs, expected)
                   if r.done() and r.state == r.DONE and
                   not np.array_equal(r.result(0), want))
    failed = sum(1 for r in reqs if r.done() and r.state != r.DONE)
    inj.clear()
    builds0 = _builds(dec)
    wave = [sup.submit(p, g) for p, g in zip(prompts[:4], gens[:4])]
    wave_deadline = time.monotonic() + 60.0
    for r in wave:
        r._done.wait(max(0.0, wave_deadline - time.monotonic()))
    b = _builds(dec)
    stranded += [r for r in wave if not r.done()]
    fin = sup.engine
    spec_blocks = int(fin.stats()["spec_blocks"])
    audit = fin._pager.audit(fin._slot_pages)
    stats = sup.stats()
    sup.stop()
    phase_a = {"crash_at": crash_at, "stranded": len(stranded),
               "mismatches": mismatch, "failed": failed,
               "restarts": stats["restarts"],
               "recovered_requests": stats["recovered_requests"],
               "spec_blocks": spec_blocks,
               "steady_new_builds": (b[0] - builds0[0]) + (b[1] - builds0[1]),
               "page_audit": audit}
    a_ok = (not stranded and not mismatch and not failed and
            stats["restarts"] >= 1 and spec_blocks > 0 and
            phase_a["steady_new_builds"] == 0 and not audit)

    # ---- B: a fleet replica crashes mid-verify; its streams migrate
    injs = [FaultInjector() for _ in range(3)]
    injs[0].raise_once("engine.step", RuntimeError(
        "spec soak: replica kill"), at=3)
    router = EngineFleetRouter(
        net, num_replicas=3, decoder=dec, num_slots=num_slots,
        speculative=True, spec_k=sk, replica_injectors=injs,
        heartbeat_interval=0.03, monitor_interval=0.03,
        suspect_after=0.25, dead_after=1.0, **spec_kw).start()
    frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
    b_stranded = _wait_all(frs, wait_s)
    _, b_failed, b_mismatch, _ = _score(frs, expected)
    for i2 in injs:
        i2.clear()
    states = {rid: router.replica_state(rid)
              for rid in router.replica_ids()}
    survivors = [rid for rid, st in states.items() if st == REPLICA_ALIVE]
    builds0 = _builds(dec)
    wave = [router.submit(prompts[i % n_requests], gens[i % n_requests],
                          replica_id=rid)
            for rid in survivors for i in range(2)]
    b_stranded += _wait_all(wave, 60.0)
    b = _builds(dec)
    b_spec_blocks = _spec_blocks(router)
    b_audit = _page_audit(router)
    b_migrations = int(router.migrations)
    router.shutdown()
    ledger_b = router.ledger.to_dict()
    phase_b = {"stranded": len(b_stranded), "mismatches": b_mismatch,
               "failed": b_failed, "states": states,
               "migrations": b_migrations, "survivors": survivors,
               "spec_blocks": b_spec_blocks, "ledger": ledger_b,
               "steady_new_builds": (b[0] - builds0[0]) +
                                    (b[1] - builds0[1]),
               "page_audit": b_audit}
    b_ok = (not b_stranded and not b_mismatch and not b_failed and
            b_migrations >= 1 and len(survivors) >= 2 and
            b_spec_blocks > 0 and ledger_b["duplicates"] == 0 and
            phase_b["steady_new_builds"] == 0 and not b_audit)

    # ---- C: the sentinel trips on a NaN in the verify forward
    injs_c = [FaultInjector() for _ in range(3)]
    injs_c[0].corrupt("device.corrupt_logits", mode="nan", at=2)
    router_c = EngineFleetRouter(
        net, num_replicas=3, decoder=dec, num_slots=num_slots,
        speculative=True, spec_k=sk, replica_injectors=injs_c,
        heartbeat_interval=0.03, monitor_interval=0.03,
        suspect_after=0.25, dead_after=1.0, **spec_kw).start()
    frs_c = [router_c.submit(p, g) for p, g in zip(prompts, gens)]
    c_stranded = len(_wait_all(frs_c, wait_s))
    _, c_failed, c_mismatch, _ = _score(frs_c, expected)
    states_c = {rid: router_c.replica_state(rid)
                for rid in router_c.replica_ids()}
    c_quarantines = int(router_c.corrupt_quarantines)
    c_spec_blocks = _spec_blocks(router_c)
    c_audit = _page_audit(router_c)
    router_c.shutdown()
    ledger_c = router_c.ledger.to_dict()
    phase_c = {"stranded": c_stranded, "mismatches": c_mismatch,
               "failed": c_failed, "states": states_c,
               "corrupt_quarantines": c_quarantines,
               "spec_blocks": c_spec_blocks, "ledger": ledger_c,
               "page_audit": c_audit}
    c_ok = (not c_stranded and not c_mismatch and not c_failed and
            REPLICA_CORRUPT in states_c.values() and c_quarantines >= 1
            and c_spec_blocks > 0 and ledger_c["duplicates"] == 0 and
            not c_audit)
    return {"seed": seed, "requests": n_requests, "phase_a": phase_a,
            "phase_b": phase_b, "phase_c": phase_c,
            "phase_ok": {"a": a_ok, "b": b_ok, "c": c_ok},
            "ok": bool(a_ok and b_ok and c_ok)}


# ------------------------------------------------------------------ fleet
def _wait_all(handles, wait_s: float) -> list:
    """Wait for every handle up to one shared deadline; the stranded."""
    deadline = time.monotonic() + wait_s
    for h in handles:
        h._done.wait(max(0.0, deadline - time.monotonic()))
    return [h for h in handles if not h.done()]


def _score(handles, expected) -> tuple:
    """(completed, failed, mismatches, failure causes) against the clean
    run's outputs."""
    completed = failed = mismatches = 0
    causes = []
    for h, want in zip(handles, expected):
        if h.state == h.DONE:
            completed += 1
            if not np.array_equal(h.result(0), want):
                mismatches += 1
        else:
            failed += 1
            causes.append(f"{getattr(h, 'request_id', '?')}: "
                          f"{type(h._error).__name__}: {h._error}"[:200])
    return completed, failed, mismatches, causes


def _inner_engines(router):
    for rid, rep in sorted(router._replicas.items()):
        yield rid, (rep.engine.engine if rep.supervised else rep.engine)


def _page_audit(router) -> list:
    """Every replica's allocator audit (survivors and harvested corpses)."""
    bad = []
    for rid, eng in _inner_engines(router):
        if getattr(eng, "_pager", None) is not None:
            bad += [f"{rid}: {p}" for p in eng._pager.audit(eng._slot_pages)]
    return bad


def _spec_blocks(router) -> int:
    return sum(int(eng.stats()["spec_blocks"])
               for _, eng in _inner_engines(router))


def run_fleet_soak(seed: int = 0, replicas: int = 3, n_requests: int = 24,
                   num_slots: int = 2, max_new: int = 6, vocab: int = 12,
                   wait_s: float = 120.0, steady_wave: int = 2,
                   fleet_scale: bool = True,
                   postmortem_dir: Optional[str] = None,
                   paged: bool = False, profile: bool = False,
                   device=None) -> dict:
    """The fleet round of the JAX soak (``--replicas N``): N replicas
    behind an ``EngineFleetRouter`` under load, r0 crash-killed
    mid-stream and (N >= 3) r1 zombied (its steps crawl while its
    heartbeat goes silent, so the monitor declares it DEAD and migration
    re-dispatches clones, whose zombie twins' late completions must be
    fenced). Bars: zero stranded or failed, tokens identical to a clean
    single engine, at least one migration, the ledger's completions
    exactly the requests, no kernel build or weight cast on a wave
    pinned to each survivor, and (``paged``) every allocator audit
    clean. ``fleet_scale`` adds the 1 → N aggregate tok/s A/B
    (:func:`_fleet_scale_ab`), reported, not a bar."""
    from ..models.generation import SlotGenerationEngine, TransformerDecoder
    from ..observability.flightrec import FlightRecorder
    from ..observability.metrics import default_registry
    from ..parallel.faults import FaultInjector
    from ..streaming.fleet import REPLICA_ALIVE, EngineFleetRouter

    rng = np.random.default_rng(seed)
    net = _tiny_lm(vocab, device=device)
    dec = TransformerDecoder(net)
    prompts = [rng.integers(0, vocab, int(rng.integers(2, 5)))
               for _ in range(n_requests)]
    gens = [int(rng.integers(2, max_new + 1)) for _ in range(n_requests)]
    summary = {"seed": seed, "replicas": replicas, "requests": n_requests,
               "paged": bool(paged)}
    eng_kw = {"paged": True, "page_size": 8} if paged else {}
    prof = tl0 = tl_mid = None
    if profile:
        from ..observability.profiler import default_profiler
        prof = default_profiler()
        tl0 = prof.timeline.total_added

    clean = SlotGenerationEngine(net, num_slots=num_slots, decoder=dec)
    clean_reqs = [clean.submit(p, g) for p, g in zip(prompts, gens)]
    clean.run_until_drained()
    expected = [r.result(1) for r in clean_reqs]

    # one injector per replica: replicas never share a hit counter, so a
    # seed reproduces the same deaths
    per_rep = max(1, (sum(gens) // max(1, num_slots)) // replicas)
    crash_hit = int(rng.integers(2, max(3, per_rep)))
    flightrec = FlightRecorder() if postmortem_dir else None
    injs = [FaultInjector(flight_recorder=flightrec)
            for _ in range(replicas)]
    injs[0].raise_once("engine.step", RuntimeError(
        f"fleet soak: r0 crash at step hit {crash_hit}"), at=crash_hit)
    zombie = replicas >= 3
    if zombie:
        injs[1].hang_for("engine.step", seconds=0.15, at=1,
                         times=8 * max(1, per_rep))
        injs[1].drop("fleet.heartbeat", n=1_000_000, at=2)
    summary["crash_hit"] = crash_hit
    summary["zombie"] = "r1" if zombie else None

    router = EngineFleetRouter(
        net, num_replicas=replicas, decoder=dec, num_slots=num_slots,
        replica_injectors=injs, heartbeat_interval=0.03,
        monitor_interval=0.03, suspect_after=0.15, dead_after=0.4,
        recover_beats=3, flight_recorder=flightrec,
        postmortem_dir=postmortem_dir, **eng_kw).start()
    frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
    stranded = _wait_all(frs, wait_s)
    if prof is not None:
        tl_mid = prof.timeline.total_added

    # a wave pinned to each survivor: nothing built, nothing cast
    for inj in injs:
        inj.clear()
    survivors = [rid for rid in router.replica_ids()
                 if router.replica_state(rid) == REPLICA_ALIVE]
    builds0 = _builds(dec)
    wave = [router.submit(prompts[i % n_requests], gens[i % n_requests],
                          replica_id=rid)
            for rid in survivors for i in range(steady_wave)]
    stranded += _wait_all(wave, 60.0)
    builds1 = _builds(dec)
    fleet_table = router.fleet_stats()
    if paged:
        summary["page_audit"] = _page_audit(router)
    router.shutdown()       # the zombie's leftovers land in the ledger
    ledger = router.ledger.to_dict()
    ledger_consistent = ledger["completed"] == \
        n_requests + len(wave) - int(router.shed)

    completed, failed, mismatches, causes = _score(frs, expected)
    summary.update({
        "stranded": len(stranded), "mismatches": mismatches,
        "completed": completed, "failed": failed, "failure_causes": causes,
        "shed": int(router.shed), "migrations": int(router.migrations),
        "migrated_requests": sum(fr.migrations > 0 for fr in frs),
        "survivors": survivors,
        "dead": [rid for rid in router.replica_ids()
                 if rid not in survivors],
        "ledger": ledger, "ledger_consistent": ledger_consistent,
        "steady_new_builds": (builds1[0] - builds0[0]) +
                             (builds1[1] - builds0[1]),
        "injector": {f"r{i}": inj.counters() for i, inj in enumerate(injs)},
        "fleet": fleet_table,
        "metrics": default_registry().snapshot(),
    })
    ok = (not stranded and not mismatches and not failed and
          summary["migrations"] > 0 and ledger_consistent and
          ledger["duplicates"] == 0 and summary["steady_new_builds"] == 0
          and not summary.get("page_audit"))
    if prof is not None:
        doc, prof_ok = _profile_round_check(prof, tl0, tl_mid,
                                            "recorded_after_migration")
        doc["engines_profiled"] = len(prof.channels())
        summary["profile"] = doc
        summary["profile_ok"] = prof_ok
        ok = ok and prof_ok
    if postmortem_dir:
        # one artifact per replica death, written before its re-dispatch:
        # every migrated request is in some artifact's harvest list
        known = {fr.trace.request_id
                 for fr in list(frs) + list(wave) + list(clean_reqs)
                 if fr.trace is not None}
        archive, pm_ok = _verify_postmortems(
            flightrec.dumps, known, expected=len(summary["dead"]),
            id_key="fleet_request_ids",
            known_harvest_ids={fr.request_id for fr in frs + wave},
            exact=False)
        harvested = set()
        for row in archive:
            harvested |= set(row.get("harvested", ()))
        migrated_ids = {fr.request_id for fr in frs if fr.migrations > 0}
        summary["postmortems"] = archive
        summary["postmortem_ok"] = bool(
            pm_ok and len(flightrec.dumps) >= len(summary["dead"]) and
            migrated_ids <= harvested)
        ok = ok and summary["postmortem_ok"]
    if fleet_scale:
        summary["fleet_scale"] = _fleet_scale_ab(replicas, device=device)
    summary["ok"] = bool(ok)
    return summary


def _fleet_scale_ab(replicas: int, n_requests: int = 24,
                    prompt_len: int = 8, gen: int = 16, num_slots: int = 8,
                    net=None, prompts: Optional[Sequence] = None,
                    gens: Optional[Sequence[int]] = None, pairs: int = 1,
                    warm: bool = True, device=None, **router_kw) -> dict:
    """Aggregate generated tok/s of 1 replica against ``replicas``, no
    faults, in ``pairs`` alternating pairs (1, N, N, 1, ...), after one
    warm run each with ``warm`` (a caller whose decoder already served
    these shapes skips them): every router shares ONE decoder, so the
    N-replica fleet builds nothing the 1-replica fleet did not. ``net`` /
    ``prompts`` / ``gens`` default to a d512 4-layer LM (4096 tokens of
    vocabulary) on ``device`` and seeded 8-token prompts of 16 tokens
    each. Reported, not a bar: on one card every replica's serve thread
    launches onto the same device."""
    from ..models import transformer_lm_conf
    from ..models.generation import TransformerDecoder
    from ..nn.graph import ComputationGraph
    from ..streaming.fleet import EngineFleetRouter

    if net is None:
        vocab = 4096
        net = ComputationGraph(transformer_lm_conf(
            vocab, d_model=512, num_heads=8, num_layers=4, max_length=64,
            learning_rate=1e-2, seed=5), device=device).init()
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, vocab, prompt_len)
                   for _ in range(n_requests)]
    if gens is None:
        gens = [gen] * len(prompts)
    dec = TransformerDecoder(net, t_max=router_kw.get("t_max"))
    import torch
    sync = torch.cuda.synchronize if net.device.type == "cuda" \
        else (lambda: None)

    def drain(n: int) -> float:
        router = EngineFleetRouter(net, num_replicas=n, decoder=dec,
                                   num_slots=num_slots, tracing=False,
                                   **router_kw).start()
        try:
            sync()
            t0 = time.perf_counter()
            frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
            toks = sum(len(fr.result(600)) - len(p)
                       for fr, p in zip(frs, prompts))
            sync()
            return toks / (time.perf_counter() - t0)
        finally:
            router.shutdown()

    if warm:
        drain(1)
        drain(replicas)
    one, n_way = [], []
    for i in range(max(1, int(pairs))):
        for n in ((1, replicas) if i % 2 == 0 else (replicas, 1)):
            (one if n == 1 else n_way).append(drain(n))
    m1, mn = float(np.median(one)), float(np.median(n_way))
    return {"replicas": replicas, "tok_s_1": [round(x, 1) for x in one],
            "tok_s_n": [round(x, 1) for x in n_way],
            "speedup": round(mn / m1, 3) if m1 else None}


def run_autoscale_soak(seed: int = 0, max_replicas: int = 3,
                       num_slots: int = 2, waves: int = 3,
                       wave_size: int = 8, max_new: int = 6,
                       vocab: int = 12, wait_s: float = 120.0,
                       shrink_wait_s: float = 120.0,
                       prefill_chunk: int = 8,
                       drain_budget: float = 8.0, device=None) -> dict:
    """The autoscale round of the JAX soak (``--autoscale``): a 1-replica
    fleet under EDF, chunked prefill and adaptive K takes a burst of
    mixed short / long prompts; the :class:`BurnRateAutoscaler` must
    grow the fleet, then, under a trickle of one request at a time,
    shrink it back to one replica through ``retire_replica``'s
    preemption drain. Bars: at least one scale-up and one drain-backed
    scale-down, the fleet back at one replica, nothing lost, failed, shed
    or duplicated, tokens identical to a clean engine, and a post-shrink
    wave that builds nothing. The round's router and scaler read an SLO
    tracker and a metrics registry of their own, so requests that other
    code in the process failed earlier cannot hold its burn rate up; each
    wait polls for the state its bar needs, under a deadline
    (``wait_s``, ``shrink_wait_s``) far above its usual length."""
    from ..models.generation import SlotGenerationEngine, TransformerDecoder
    from ..observability.metrics import MetricsRegistry
    from ..observability.slo import SLOTracker
    from ..streaming.autoscale import BurnRateAutoscaler
    from ..streaming.fleet import REPLICA_DEAD, EngineFleetRouter

    rng = np.random.default_rng(seed)
    net = _tiny_lm(vocab, max_length=64, device=device)
    dec = TransformerDecoder(net)
    sched = dict(scheduling="edf", prefill_chunk=prefill_chunk,
                 adaptive_block=True, block_ladder=(1, 2, 4))
    n_requests = waves * wave_size
    # half short prompts, half long ones that must chunk; prompt +
    # generated stays inside t_max 64
    prompts = [rng.integers(0, vocab, int(rng.integers(2, 6))) if i % 2 == 0
               else rng.integers(0, vocab, int(rng.integers(18, 31)))
               for i in range(n_requests)]
    gens = [int(rng.integers(2, max_new + 1)) for _ in range(n_requests)]
    summary = {"seed": seed, "requests": n_requests,
               "max_replicas": max_replicas}
    clean = SlotGenerationEngine(net, num_slots=num_slots, decoder=dec,
                                 **sched)
    clean_reqs = [clean.submit(p, g) for p, g in zip(prompts, gens)]
    clean.run_until_drained()
    expected = [r.result(1) for r in clean_reqs]

    reg = MetricsRegistry()
    router = EngineFleetRouter(
        net, num_replicas=1, decoder=dec, num_slots=num_slots,
        max_pending=max(64, n_requests), heartbeat_interval=0.03,
        monitor_interval=0.03, suspect_after=0.3, dead_after=1.0,
        registry=reg, slo_tracker=SLOTracker(registry=reg),
        **sched).start()
    scaler = BurnRateAutoscaler(
        router, min_replicas=1, max_replicas=max_replicas,
        saturation_high=1.5, saturation_low=0.5, scale_up_burn=3.0,
        scale_down_burn=0.9, up_consecutive=1, down_consecutive=8,
        cooldown_s=0.5, interval=0.05, drain_budget=drain_budget,
        registry=reg).start()

    # the burst: the queue builds behind the slots, utilization crosses
    # the threshold, and one saturated tick grows the fleet
    frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
    grown_to = len(router.replica_ids())
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        grown_to = max(grown_to, len(router.replica_ids()))
        if all(fr.done() for fr in frs):
            break
        time.sleep(0.05)
    stranded = [fr for fr in frs if not fr.done()]

    # a closed-loop trickle: the next request goes in when the last one
    # ends, so the descale drain finds work live at any speed of the box
    # while utilization (one request over every slot) sits under the
    # scale-down threshold; it ends once a scale-down left one replica
    trickle = []
    t_end = time.monotonic() + shrink_wait_s
    while time.monotonic() < t_end:
        live = sum(1 for rid in router.replica_ids()
                   if router.replica_state(rid) != REPLICA_DEAD)
        if live <= 1 and router.stats()["scale_downs"] >= 1:
            break
        if not trickle or trickle[-1].done():
            j = len(trickle) % n_requests
            trickle.append(router.submit(prompts[j], gens[j]))
        trickle[-1]._done.wait(0.05)
    stranded += _wait_all(trickle, wait_s)

    # the scaler stops first: the wave's own load must not regrow it
    scaler.stop()
    builds0 = _builds(dec)
    wave = [router.submit(prompts[i], gens[i])
            for i in range(min(n_requests, 2 * wave_size))]
    stranded += _wait_all(wave, wait_s)
    builds1 = _builds(dec)
    final_live = len(router.replica_ids())
    stats = router.stats()
    router.shutdown()
    ledger = router.ledger.to_dict()

    handles = list(frs) + list(trickle) + list(wave)
    refs = list(expected) + [expected[j % n_requests]
                             for j in range(len(trickle))] + \
        [expected[i] for i in range(len(wave))]
    completed, failed, mismatches, causes = _score(handles, refs)
    summary.update({
        "completed": completed, "failed": failed, "total": len(handles),
        "failure_causes": causes, "stranded": len(stranded),
        "mismatches": mismatches, "grown_to": grown_to,
        "final_live": final_live, "scale_ups": int(stats["scale_ups"]),
        "scale_downs": int(stats["scale_downs"]),
        "descale_moved": int(stats["migrations"]),
        "trickle": len(trickle), "shed": int(stats["shed"]),
        "ledger": ledger,
        "ledger_consistent": ledger["completed"] == len(handles),
        "steady_new_builds": (builds1[0] - builds0[0]) +
                             (builds1[1] - builds0[1]),
        "timeline": [{k: v for k, v in e.items() if k != "signals"}
                     for e in scaler.history],
        "scaler": scaler.stats(),
        "metrics": reg.snapshot(),
    })
    summary["ok"] = bool(
        not stranded and not mismatches and not failed and
        summary["scale_ups"] >= 1 and summary["scale_downs"] >= 1 and
        grown_to >= 2 and final_live == 1 and summary["shed"] == 0 and
        ledger["duplicates"] == 0 and summary["ledger_consistent"] and
        summary["steady_new_builds"] == 0)
    return summary


def run_disagg_soak(seed: int = 0, prefill_workers: int = 2,
                    decode_workers: int = 2, n_requests: int = 24,
                    num_slots: int = 2, max_new: int = 8, vocab: int = 12,
                    wait_s: float = 120.0, steady_wave: int = 2,
                    prefill_chunk: int = 8, device=None) -> dict:
    """The disaggregated round of the JAX soak (``--disagg``): a
    phase-skewed load (short-prompt decode streams with long-prompt
    bursts) on a :class:`PhaseRouter` over the serialized per-page
    transport, with three faults mid-stream: an injected transport
    failure mid-handoff (the frames are lost), a decode worker and a
    prefill worker crash-killed. Bars: nothing lost, failed or
    duplicated, tokens identical to one both-phase paged engine, SLO
    clocks ordered across every handoff, at least one completed and one
    failed handoff, every allocator audit clean, nothing built on a
    post-fault wave, and the transfer account exact: shipped bytes ==
    pages x per-page pool bytes + the token payload."""
    from ..models.generation import SlotGenerationEngine, TransformerDecoder
    from ..observability.metrics import default_registry
    from ..parallel.faults import FaultInjector
    from ..streaming.disagg import PhaseRouter, SerializedKVTransport
    from ..streaming.fleet import REPLICA_ALIVE

    page_size = 8
    rng = np.random.default_rng(seed)
    net = _tiny_lm(vocab, max_length=64, device=device)
    dec = TransformerDecoder(net)
    # two thirds steady decode streams, one third prefill-heavy rows;
    # prompt + generated stays inside t_max 64
    prompts, gens = [], []
    for i in range(n_requests):
        if i % 3 == 2:
            prompts.append(rng.integers(0, vocab, int(rng.integers(18, 31))))
            gens.append(int(rng.integers(2, 4)))
        else:
            prompts.append(rng.integers(0, vocab, int(rng.integers(2, 5))))
            gens.append(int(rng.integers(4, max_new + 1)))
    transport = SerializedKVTransport(per_page=True, record_ships=True)
    summary = {"seed": seed, "requests": n_requests,
               "prefill_workers": prefill_workers,
               "decode_workers": decode_workers}
    clean = SlotGenerationEngine(net, num_slots=num_slots, decoder=dec,
                                 paged=True, page_size=page_size,
                                 prefill_chunk=prefill_chunk)
    clean_reqs = [clean.submit(p, g) for p, g in zip(prompts, gens)]
    clean.run_until_drained()
    expected = [r.result(1) for r in clean_reqs]

    inj = FaultInjector()
    inj.raise_once("disagg.ship", RuntimeError(
        "soak: injected mid-handoff transport failure"), at=3)
    router = PhaseRouter(
        net, prefill_replicas=prefill_workers,
        decode_replicas=decode_workers, decoder=dec, num_slots=num_slots,
        page_size=page_size, prefill_chunk=prefill_chunk,
        transport=transport, fault_injector=inj,
        max_pending=max(64, n_requests), heartbeat_interval=0.03,
        monitor_interval=0.03, suspect_after=0.2, dead_after=0.6,
        recover_beats=3).start()
    frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
    # the kills land once streams are live: after the first handoffs
    deadline = time.monotonic() + wait_s
    while router.disagg_stats()["handoffs"]["completed"] < 2 and \
            time.monotonic() < deadline:
        time.sleep(0.005)
    router.kill_replica("d0")      # live streams and queued adoptions
    time.sleep(0.05)
    router.kill_replica("p0")      # queued prompts
    stranded = _wait_all(frs, wait_s)

    inj.clear()
    survivors = [rid for rid in router.replica_ids()
                 if router.replica_state(rid) == REPLICA_ALIVE]
    builds0 = _builds(dec)
    wave = [router.submit(prompts[i % n_requests], gens[i % n_requests])
            for _ in survivors for i in range(steady_wave)]
    stranded += _wait_all(wave, 60.0)
    builds1 = _builds(dec)

    disagg = router.disagg_stats()
    page_audit = _page_audit(router)
    page_bytes = None
    for _, eng in _inner_engines(router):
        page_bytes = eng._pool_bytes() // eng.num_pages
    # SLO clocks ordered created <= admitted <= first token although the
    # admission ran on a prefill worker and the completion on a decode
    # worker
    clock_breaks = 0
    for fr in frs:
        inner = fr._inner
        if inner is None or fr.state != fr.DONE:
            continue
        c, a, f = inner._created_t, inner._admitted_t, inner._first_token_t
        if (a is not None and a < c) or \
                (f is not None and a is not None and f < a):
            clock_breaks += 1
    router.shutdown()
    ledger = router.ledger.to_dict()
    ledger_consistent = ledger["completed"] == \
        n_requests + len(wave) - int(router.shed)
    refs = list(expected) + [expected[(j % steady_wave) % n_requests]
                             for j in range(len(wave))]
    completed, failed, mismatches, causes = _score(list(frs) + wave, refs)
    ship_pages = sum(p for p, _, _ in transport.ships)
    ship_bytes = sum(b for _, b, _ in transport.ships)
    ship_tok_bytes = sum(t for _, _, t in transport.ships)
    counters = disagg["handoffs"]
    transfer_exact = (
        page_bytes is not None and counters["bytes"] == ship_bytes and
        counters["pages"] == ship_pages and
        ship_bytes == ship_pages * page_bytes + ship_tok_bytes)
    summary.update({
        "stranded": len(stranded), "mismatches": mismatches,
        "completed": completed, "failed": failed, "failure_causes": causes,
        "total": n_requests + len(wave), "shed": int(router.shed),
        "migrations": int(router.migrations), "handoffs": counters,
        "transfer": {"pages": ship_pages, "bytes": ship_bytes,
                     "token_bytes": ship_tok_bytes,
                     "page_bytes": page_bytes,
                     "wire_bytes": transport.wire_bytes,
                     "exact": transfer_exact},
        "clock_breaks": clock_breaks, "survivors": survivors,
        "dead": ["d0", "p0"], "page_audit": page_audit,
        "ledger": ledger, "ledger_consistent": ledger_consistent,
        "steady_new_builds": (builds1[0] - builds0[0]) +
                             (builds1[1] - builds0[1]),
        "disagg": disagg, "injector": inj.counters(),
        "metrics": default_registry().snapshot(),
    })
    summary["ok"] = bool(
        not stranded and not mismatches and not failed and
        clock_breaks == 0 and not page_audit and
        counters["completed"] >= 1 and counters["failed"] >= 1 and
        ledger["duplicates"] == 0 and ledger_consistent and
        transfer_exact and summary["steady_new_builds"] == 0)
    return summary


def run_corruption_soak(seed: int = 0, n_requests: int = 12,
                        num_slots: int = 2, max_new: int = 6,
                        vocab: int = 12, wait_s: float = 120.0,
                        device=None) -> dict:
    """The silent-data-corruption round of the JAX soak
    (``--corruption``): every scripted corruption is detected before a
    client sees a byte of it.

    A. logits NaN (``device.corrupt_logits``) on r0 of a 3-replica paged
       sentinel fleet under load: the sentinel trips, the block's tokens
       are dropped, r0 is quarantined CORRUPT, its streams migrate and a
       replacement grows. Bars: nothing stranded or failed, tokens
       identical to the clean run, exactly once, audits clean, nothing
       built on a wave pinned to each survivor.
    B. an at-rest page flip (``device.corrupt_page`` at ``registered``):
       the next prefix-cache hit's verification (rate 1.0) catches it,
       evicts the chain and re-prefills: identical tokens, the
       corruption counted, the audit clean.
    C. with verification off, the same flip on the canary prompt's page
       on r0 of a 2-replica fleet: the next golden-canary round sees the
       divergence and quarantines r0 as CORRUPT.
    D. a mid-handoff flip (``device.corrupt_page`` at ``handoff``) on a
       1 + 1 PhaseRouter over the per-page wire: every CRC passes, the
       content check at decode refuses the frames, the handoff
       re-prefills and the stream completes with identical tokens.
    E. a ``journal.write`` OSError burst: the journal degrades and heals
       on the next clean write, with no serving failure."""
    from ..models.generation import SlotGenerationEngine, TransformerDecoder
    from ..observability.integrity import GoldenCanary, IntegrityConfig
    from ..observability.metrics import default_registry
    from ..parallel.faults import FaultInjector
    from ..streaming.disagg import PhaseRouter, SerializedKVTransport
    from ..streaming.fleet import (REPLICA_ALIVE, REPLICA_CORRUPT,
                                   EngineFleetRouter)
    from ..streaming.journal import RequestJournal

    rng = np.random.default_rng(seed)
    net = _tiny_lm(vocab, device=device)
    cfg = IntegrityConfig(kv_verify_rate=1.0, fault_threshold=1)
    dec = TransformerDecoder(net, sentinel=True, logit_bound=cfg.logit_bound)
    ps = 8
    prompts = [rng.integers(0, vocab, int(rng.integers(2, 5)))
               for _ in range(n_requests)]
    gens = [int(rng.integers(2, max_new + 1)) for _ in range(n_requests)]
    summary = {"seed": seed, "requests": n_requests}
    paged_kw = dict(block_size=4, paged=True, page_size=ps, integrity=cfg)
    clean = SlotGenerationEngine(net, num_slots=num_slots, decoder=dec,
                                 **paged_kw)
    clean_reqs = [clean.submit(p, g) for p, g in zip(prompts, gens)]
    clean.run_until_drained()
    expected = [r.result(1) for r in clean_reqs]

    # ---- A: logits NaN → sentinel → CORRUPT quarantine and replacement
    per_rep = max(1, (sum(gens) // max(1, num_slots)) // 3)
    nan_hit = int(rng.integers(1, max(2, per_rep)))
    injs = [FaultInjector() for _ in range(3)]
    injs[0].corrupt("device.corrupt_logits", mode="nan", at=nan_hit)
    router = EngineFleetRouter(
        net, num_replicas=3, decoder=dec, num_slots=num_slots,
        replica_injectors=injs, heartbeat_interval=0.03,
        monitor_interval=0.03, suspect_after=0.25, dead_after=1.0,
        **paged_kw).start()
    frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
    stranded = _wait_all(frs, wait_s)
    completed, failed, mismatches, _ = _score(frs, expected)
    states = {rid: router.replica_state(rid)
              for rid in router.replica_ids()}
    for inj in injs:
        inj.clear()
    survivors = [rid for rid, st in states.items() if st == REPLICA_ALIVE]
    builds0 = _builds(dec)
    wave = [router.submit(prompts[i % n_requests], gens[i % n_requests],
                          replica_id=rid)
            for rid in survivors for i in range(2)]
    stranded += _wait_all(wave, 60.0)
    builds1 = _builds(dec)
    page_audit = _page_audit(router)
    router.shutdown()
    ledger = router.ledger.to_dict()
    steady = (builds1[0] - builds0[0]) + (builds1[1] - builds0[1])
    summary["phase_a"] = {
        "nan_hit": nan_hit, "stranded": len(stranded),
        "mismatches": mismatches, "failed": failed, "states": states,
        "corrupt_quarantines": int(router.corrupt_quarantines),
        "migrations": int(router.migrations),
        "replacement_grown": len(survivors) >= 3, "ledger": ledger,
        "steady_new_builds": steady, "page_audit": page_audit}
    a_ok = (not stranded and not mismatches and not failed and
            REPLICA_CORRUPT in states.values() and
            int(router.corrupt_quarantines) == 1 and len(survivors) >= 3
            and ledger["duplicates"] == 0 and steady == 0 and
            not page_audit)

    # ---- B: an at-rest flip caught by sampled verification
    inj_b = FaultInjector()
    eng_b = SlotGenerationEngine(net, num_slots=num_slots, decoder=dec,
                                 num_pages=64, fault_injector=inj_b,
                                 **paged_kw)
    sys_prompt = rng.integers(0, vocab, 2 * ps + 1)      # 2 full pages
    r1 = eng_b.submit(sys_prompt, 4)
    eng_b.run_until_drained()
    want_b = r1.result(1)
    # the next registration flips the cached chain's first page
    inj_b.corrupt("device.corrupt_page", mode="flip", at=1,
                  where="registered")
    r2 = eng_b.submit(np.concatenate([sys_prompt, [1]]), 4)
    eng_b.run_until_drained()
    r2.result(1)
    r3 = eng_b.submit(sys_prompt, 4)            # a hit on the flipped page
    eng_b.run_until_drained()
    out_b = r3.result(1)
    b_detected = int(eng_b.stats()["kv_page_corruptions"])
    b_audit = eng_b._pager.audit(eng_b._slot_pages)
    eng_b.shutdown()
    summary["phase_b"] = {"detected": b_detected,
                          "token_identical": bool(np.array_equal(out_b,
                                                                 want_b)),
                          "page_audit": b_audit}
    b_ok = b_detected >= 1 and np.array_equal(out_b, want_b) and \
        not b_audit

    # ---- C: the golden canary catches a silent flip (verification off:
    # a flip changes values, not finiteness)
    cfg_c = IntegrityConfig(kv_verify=False, fault_threshold=1,
                            canary_tokens=4)
    dec_c = TransformerDecoder(net, sentinel=True,
                               logit_bound=cfg_c.logit_bound)
    injs_c = [FaultInjector(), FaultInjector()]
    router_c = EngineFleetRouter(
        net, num_replicas=2, decoder=dec_c, num_slots=num_slots,
        block_size=4, paged=True, page_size=4, integrity=cfg_c,
        replica_injectors=injs_c, heartbeat_interval=0.03,
        monitor_interval=0.03).start()
    round1 = router_c.canary_round()      # golden recorded, pages cached
    injs_c[0].corrupt("device.corrupt_page", mode="flip", at=1,
                      where="registered")
    # a filler extending the canary prompt shares its first cached page,
    # which the flip lands on
    filler = router_c.submit(list(GoldenCanary.default_prompt(vocab)) +
                             [1, 1], 2, replica_id="r0")
    filler.result(30)
    round2 = router_c.canary_round()
    states_c = {rid: router_c.replica_state(rid)
                for rid in router_c.replica_ids()}
    quarantines_c = int(router_c.corrupt_quarantines)
    router_c.shutdown()
    summary["phase_c"] = {"round1": round1, "round2": round2,
                          "states": states_c,
                          "corrupt_quarantines": quarantines_c}
    c_ok = (states_c.get("r0") == REPLICA_CORRUPT and quarantines_c >= 1
            and any(st == REPLICA_ALIVE for st in states_c.values()))

    # ---- D: a mid-handoff flip over the wire
    inj_d = [FaultInjector(), FaultInjector()]
    inj_d[0].corrupt("device.corrupt_page", mode="flip", at=1,
                     where="handoff")
    router_d = PhaseRouter(
        net, prefill_replicas=1, decode_replicas=1, decoder=dec,
        transport=SerializedKVTransport(per_page=True),
        num_slots=num_slots, block_size=4, page_size=ps, integrity=cfg,
        replica_injectors=inj_d, heartbeat_interval=0.03,
        monitor_interval=0.03).start()
    frs_d = [router_d.submit(p, g) for p, g in zip(prompts[:6], gens[:6])]
    d_stranded = len(_wait_all(frs_d, wait_s))
    _, d_failed, d_mismatch, _ = _score(frs_d, expected[:6])
    d_corrupt = int(router_d._m_kv_corrupt.value)
    d_handoff_failed = int(router_d._m_handoff["failed"].value)
    router_d.shutdown()
    summary["phase_d"] = {"stranded": d_stranded, "mismatches": d_mismatch,
                          "failed": d_failed, "kv_corruptions": d_corrupt,
                          "handoffs_failed": d_handoff_failed}
    d_ok = (not d_stranded and not d_mismatch and not d_failed and
            d_corrupt >= 1 and d_handoff_failed >= 1)

    # ---- E: journal.write degrades, then heals
    inj_e = FaultInjector()
    inj_e.raise_n("journal.write", OSError, n=4, at=3)
    jdir = tempfile.mkdtemp(prefix="dl4j-corruption-soak-")
    try:
        jr = RequestJournal(jdir, fsync="always", retries=1,
                            retry_backoff=0.001, fault_injector=inj_e)
        eng_e = SlotGenerationEngine(net, num_slots=num_slots, decoder=dec,
                                     journal=jr, **paged_kw)
        reqs_e = [eng_e.submit(p, g) for p, g in zip(prompts, gens)]
        eng_e.run_until_drained()
        e_results_ok = all(np.array_equal(r.result(1), want)
                           for r, want in zip(reqs_e, expected))
        e_stats = jr.stats()
        e_healed = not jr.degraded
        eng_e.shutdown()
        jr.close()
    finally:
        shutil.rmtree(jdir, ignore_errors=True)
    summary["phase_e"] = {
        "results_ok": e_results_ok, "healed": e_healed,
        "dropped_records": int(e_stats.get("dropped_records", 0)),
        "io_errors": int(e_stats.get("io_errors", 0))}
    e_ok = e_results_ok and e_healed and \
        int(e_stats.get("io_errors", 0)) >= 1

    summary["metrics"] = default_registry().snapshot()
    summary["phase_ok"] = {"a": a_ok, "b": b_ok, "c": c_ok, "d": d_ok,
                           "e": e_ok}
    summary["ok"] = bool(a_ok and b_ok and c_ok and d_ok and e_ok)
    return summary

# ------------------------------------------------------ remote fleet soak
def _remote_requests(seed: int, n_requests: int, vocab: int,
                     max_new: int) -> list:
    rng = np.random.default_rng(seed)
    return [{"id": f"req-{i:03d}",
             "prompt": [int(t) for t in
                        rng.integers(0, vocab, int(rng.integers(2, 5)))],
             "gen": int(rng.integers(2, max_new + 1))}
            for i in range(n_requests)]


def _tiny_model(vocab: int) -> dict:
    """The remote rounds' model dict: the soak's tiny LM."""
    return {"vocab": vocab, "d_model": 32, "num_heads": 2, "num_layers": 2,
            "max_length": 32, "seed": 5}


def _remote_net(model: dict, device=None):
    """The f32 net a remote worker builds from ``model``, in this
    process."""
    from ..models import transformer_lm_conf
    from ..nn.graph import ComputationGraph
    return ComputationGraph(transformer_lm_conf(
        model["vocab"], d_model=model["d_model"],
        num_heads=model["num_heads"], num_layers=model["num_layers"],
        max_length=model["max_length"],
        learning_rate=model.get("learning_rate", 1e-2),
        seed=model.get("seed", 5)), device=device).init()


def _engine_kw(engine: dict, paged: bool) -> dict:
    """A worker's engine arguments from its config (``RemoteWorker``)."""
    return {"num_slots": int(engine.get("num_slots", 2)),
            "block_size": int(engine.get("block_size", 1)),
            "paged": paged, "page_size": int(engine.get("page_size", 16))}


def _remote_reference(net, reqs: list, engine: dict, paged: bool) -> dict:
    """In-process uninterrupted ground truth, id → full token array, on
    an engine built as a worker builds its own: every remote round
    (migrated, handed off, re-served after a router restart) must
    reproduce it exactly under greedy decoding."""
    from ..models.generation import SlotGenerationEngine, TransformerDecoder
    dec = TransformerDecoder(net, t_max=engine.get("t_max"))
    eng = SlotGenerationEngine(net, decoder=dec, **_engine_kw(engine, paged))
    handles = [eng.submit(r["prompt"], r["gen"]) for r in reqs]
    eng.run_until_drained()
    return {r["id"]: h.result(1) for r, h in zip(reqs, handles)}


def _proc_stat(pid) -> Optional[list]:
    """The fields of ``/proc/<pid>/stat`` after the command name (state,
    parent pid, ...), or None when the process is gone."""
    try:
        with open(f"/proc/{pid}/stat", encoding="ascii") as f:
            return f.read().rsplit(")", 1)[1].split()
    except (OSError, IndexError):
        return None


def _pid_alive(pid: int) -> bool:
    """A process that exists and is not a zombie."""
    st = _proc_stat(int(pid))
    return st is not None and st[0] != "Z"


def child_pids() -> set:
    """Pids of this process's children that are alive (not zombies)."""
    me, out = str(os.getpid()), set()
    for name in os.listdir("/proc"):
        st = _proc_stat(name) if name.isdigit() else None
        if st is not None and st[1] == me and st[0] != "Z":
            out.add(int(name))
    return out


def _worker_rows(ep) -> dict:
    """Each worker incarnation by pid: its device, weights digest and
    seconds from spawn to hello, and its last report's build account and
    kernel launches (a proxy that outlived its worker keeps the dead
    incarnation's last stats push)."""
    rows = {}
    for p in ep.all_proxies:
        m = p.role_meta
        if not m:
            continue
        st = p.last_stats()
        src = st if "pid" in st else m
        rows[str(src["pid"])] = {
            "replica": p.replica_id, "device": m.get("device"),
            "device_name": m.get("device_name"),
            "params_digest": m.get("params_digest"),
            "hello_s": ep.hello_s.get(f"{p.replica_id}@{src['epoch']}"),
            "boot": m.get("boot"),
            **{k: src.get(k) for k in ("epoch", "nvcc_runs", "param_casts",
                                       "kernel_launches")}}
    return rows


def _launch_sum(rows: dict, name: str = "shortseq_attention") -> int:
    """A kernel's launches summed over the workers' last reports (a
    killed incarnation's launches after its last stats push are lost)."""
    return sum(int((r.get("kernel_launches") or {}).get(name, 0))
               for r in rows.values())


def run_remote_soak(seed: int = 0, n_requests: int = 10,
                    num_slots: int = 2, max_new: int = 6,
                    vocab: int = 12, block_size: int = 4,
                    slow: float = 0.05, round_wait_s: float = 300.0,
                    workdir: Optional[str] = None, rounds: str = "abcd",
                    model: Optional[dict] = None,
                    requests: Optional[list] = None,
                    engine: Optional[dict] = None,
                    hello_deadline: float = 180.0, device=None,
                    after_boot=None) -> dict:
    """Process-per-replica rounds of the JAX soak (``--remote``): every
    replica is its own OS process behind a ``FleetEndpoint`` (TCP broker
    RPC, coordinator-KV heartbeats, supervised respawn), serving on
    ``device`` (None: the CUDA card; each worker builds the f32 weights
    of ``model`` from its seed).

    Round A — SIGKILL a worker mid-stream: the survivor absorbs the
    migrated streams, the launcher respawns the corpse, and the new
    incarnation is re-adopted under the same replica id.
    Round B — a role-split fleet (1 prefill + 2 decode): the KV handoff
    crosses the wire as CRC-framed pages; a decode worker is SIGKILLed
    with handoffs in flight, and the router's wire bytes are held against
    the prefill process's own transport count.
    Round C — partition: SIGSTOP a worker (beats stop, sockets
    black-hole, the process lives). The router ages it to DEAD and
    clone-migrates its streams; on SIGCONT its late results are fenced.
    Round D — router restart: the endpoint process (broker, ledger,
    launcher) is SIGKILLed mid-serve in a child
    (``--remote-router-child``); its orphaned workers are reaped and a
    fresh endpoint serves whatever has no durable result line (first line
    wins).

    The endpoints of rounds A-C boot, and round D (whose router and
    workers are processes of their own) starts, while this process
    computes the references; rounds A-C then run in turn, D beside them.
    ``boot_s`` gives each endpoint's seconds from the start to its last
    hello, ``round_s`` each round's seconds from its start (A-C: waiting
    for its boot included). ``after_boot``, if given, is called once
    those boots and the references have ended (a caller's own boots then
    meet less contention for the host).

    Bars: nothing lost or duplicated (ledger), tokens identical to the
    in-process engine built as the workers build theirs (slab for
    ``both`` workers unless ``engine["paged"]``, paged for the role
    split), every worker on ``device`` with the parent's weights digest,
    no kernel build and no weight cast on a wave after recovery (and no
    kernel build at all: the parent's reference run built them), the
    wire bytes exact when nothing was fenced, and no worker process left
    alive after the rounds. ``rounds`` picks rounds; ``model`` /
    ``requests`` (dicts of id, prompt, gen) / ``engine`` (num_slots,
    block_size, page_size, t_max, paged) override the tiny defaults."""
    from concurrent.futures import ThreadPoolExecutor

    from ..observability.metrics import MetricsRegistry
    from ..streaming.fleet import FleetLedger
    from ..streaming.remote import FleetEndpoint, params_digest

    model = dict(model or _tiny_model(vocab))
    reqs = list(requests) if requests is not None else \
        _remote_requests(seed, n_requests, vocab, max_new)
    n_requests = len(reqs)
    eng_cfg = dict(engine or {"num_slots": num_slots,
                              "block_size": block_size})
    ref_net = _remote_net(model, device)
    own_workdir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="remote-soak-")
    os.makedirs(workdir, exist_ok=True)
    want_device = ref_net.device.type
    digest = params_digest(ref_net)
    if want_device == "cuda":
        # the workers load the attention kernels this process builds, so
        # none of them runs nvcc
        from ..kernels import cuda_lib
        cuda_lib.build(["shortseq_attention", "flash_forward"])
    env_slow = {"DL4J_SOAK_SLOW": str(slow)}
    if want_device == "cpu":
        # the tiny LM gains nothing from intra-op threads, and N workers
        # each with a thread a core only fight over the host
        env_slow["OMP_NUM_THREADS"] = "1"
    spawned: list = []

    def endpoint(sub: str, workers: dict, fleet_id: str):
        # a registry of its own: the router's counters (the wire bytes
        # round B holds) are labelled by fleet id, and a second soak in
        # this process would add to the first one's
        ep = FleetEndpoint(os.path.join(workdir, sub), model,
                           workers=workers, engine=eng_cfg, device=device,
                           fleet_id=fleet_id, env=env_slow,
                           hello_deadline=hello_deadline,
                           registry=MetricsRegistry())
        ep.launcher.on_spawn = lambda rid, epoch, pid: spawned.append(pid)
        return ep

    def wait_done(frs, at_least, timeout):
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            n = sum(1 for fr in frs.values() if fr.done())
            if n >= at_least:
                return n
            time.sleep(0.05)
        return sum(1 for fr in frs.values() if fr.done())

    def drain(frs, timeout):
        end = time.monotonic() + timeout
        for fr in frs.values():
            fr._done.wait(max(0.0, end - time.monotonic()))
        return sum(1 for fr in frs.values() if fr.done())

    def check(frs, want):
        lost = failures = mismatches = 0
        for rid, fr in frs.items():
            if not fr.done():
                lost += 1
                continue
            try:
                out = fr.result(timeout=0)
            except Exception:   # noqa: BLE001 — a typed failure, counted
                failures += 1
                continue
            if not np.array_equal(np.asarray(out, np.int64),
                                  np.asarray(want[rid], np.int64)):
                mismatches += 1
        return {"lost": lost, "failures": failures,
                "mismatches": mismatches,
                "completed": sum(1 for fr in frs.values() if fr.done())}

    def steady_check(ep, sample, pin=True, wait_s=120.0):
        """Builds and casts on each ALIVE worker over a wave after a warm
        one (a respawned process builds its decoder once; the wave after
        it must add nothing), then each one's whole-process build count.
        ``pin=False`` routes the waves through normal dispatch (a
        role-split fleet, where a fresh prompt cannot be pinned onto a
        decode-only worker)."""
        table = ep.fleet_stats()["replicas"]
        alive = [rid for rid, row in table.items()
                 if row["state"] == "ALIVE"]
        deltas, nvcc = {}, {}

        def wave(*rids):
            # one wave on each of ``rids`` at once (None: normal dispatch)
            frs = [ep.submit(r["prompt"], r["gen"], replica_id=rid)
                   for rid in rids for r in sample]
            end = time.monotonic() + wait_s
            for fr in frs:
                fr._done.wait(max(0.0, end - time.monotonic()))

        try:
            if pin:
                wave(*alive)
                for rid in alive:
                    ep.proxy(rid).audit_mark()
                wave(*alive)
            else:
                wave(None)
                wave(None)
                for rid in alive:
                    ep.proxy(rid).audit_mark()
                wave(None)
                wave(None)
            for rid in alive:
                deltas[rid] = ep.proxy(rid).audit_delta(timeout=30.0)
                nvcc[rid] = ep.proxy(rid).refresh_stats(
                    timeout=30.0).get("nvcc_runs")
        except Exception as e:   # noqa: BLE001 — a dead / retired worker
            deltas["error"] = f"{type(e).__name__}: {e}"
        return {"delta": deltas, "nvcc_runs": nvcc}

    def steady_ok(st):
        d = st["delta"]
        return bool(d) and "error" not in d and \
            all(v == {} for v in d.values()) and \
            all(v == 0 for v in st["nvcc_runs"].values())

    def workers_ok(rows):
        return bool(rows) and all(
            r["device"] == want_device and r["params_digest"] == digest
            for r in rows.values())

    def finish(row, ep):
        row["workers"] = _worker_rows(ep)
        row["b1_launches"] = _launch_sum(row["workers"])
        row["workers_ok"] = workers_ok(row["workers"])

    # ---- round A: SIGKILL a worker mid-stream -------------------------
    def round_a(ep, row_a):
        frs = {r["id"]: ep.submit(r["prompt"], r["gen"]) for r in reqs}
        row_a["results_at_kill"] = wait_done(
            frs, max(2, n_requests // 4), round_wait_s)
        ep.kill_worker("w0")
        drain(frs, round_wait_s)
        row_a.update(check(frs, expected))
        # the respawn's hello re-adopts w0 at epoch 2: wait for it
        # before the steady waves pin onto w0
        end = time.monotonic() + hello_deadline
        while time.monotonic() < end and (
                ep.proxy("w0") is None or ep.proxy("w0").epoch < 2 or
                ep.router.replica_state("w0") != "ALIVE"):
            time.sleep(0.05)
        row_a["respawn_epoch"] = ep.launcher.epoch("w0")
        led = ep.fleet_stats()["ledger"]
        row_a["ledger"] = led
        row_a["steady"] = steady_check(ep, reqs[:2])
        finish(row_a, ep)
        return bool(
            not row_a["lost"] and not row_a["failures"]
            and not row_a["mismatches"] and led["duplicates"] == 0
            and 0 < row_a["results_at_kill"] < n_requests
            and row_a["respawn_epoch"] >= 2
            and steady_ok(row_a["steady"]) and row_a["workers_ok"])

    # ---- round B: role-split fleet, SIGKILL decode mid-handoff ---------
    def round_b(ep, row_b):
        frs = {r["id"]: ep.submit(r["prompt"], r["gen"]) for r in reqs}
        end = time.monotonic() + round_wait_s
        while time.monotonic() < end:
            if ep.stats().get("wire_handoffs", 0) >= 2:
                break
            time.sleep(0.02)
        ep.kill_worker("d0")
        drain(frs, round_wait_s)
        row_b.update(check(frs, expected_paged))
        s = ep.stats()
        row_b["wire"] = {k: s[k] for k in (
            "wire_handoffs", "wire_handoffs_fenced",
            "wire_handoff_reprefills", "wire_transfer_bytes",
            "wire_transfer_wire_bytes", "wire_transfer_pages",
            "wire_kv_corruption")}
        # what p0's transport shipped must equal what the router received
        # and forwarded: exactly when nothing was fenced, as an upper bound
        # when a kill raced a handoff
        shipped = int(ep.proxy("p0").refresh_stats(
            timeout=15.0).get("kv_wire_bytes", -1))
        row_b["shipped_wire_bytes"] = shipped
        fenced = row_b["wire"]["wire_handoffs_fenced"]
        exact = shipped == row_b["wire"]["wire_transfer_wire_bytes"]
        row_b["transfer_exact"] = exact
        led = ep.fleet_stats()["ledger"]
        row_b["ledger"] = led
        row_b["steady"] = steady_check(ep, reqs[:2], pin=False)
        finish(row_b, ep)
        return bool(
            not row_b["lost"] and not row_b["failures"]
            and not row_b["mismatches"] and led["duplicates"] == 0
            and row_b["wire"]["wire_handoffs"] >= 2
            and row_b["wire"]["wire_kv_corruption"] == 0
            and (exact if fenced == 0 else
                 row_b["wire"]["wire_transfer_wire_bytes"] <= shipped)
            and steady_ok(row_b["steady"]) and row_b["workers_ok"])

    # ---- round C: partition (SIGSTOP) → DEAD → zombie fenced -----------
    def round_c(ep, row_c):
        frs = {r["id"]: ep.submit(r["prompt"], r["gen"]) for r in reqs}
        wait_done(frs, 1, round_wait_s)
        ep.partition_worker("w0")      # a black hole, not a death
        held = [fr for fr in frs.values()
                if fr.replica_id == "w0" and not fr.done()]
        row_c["held_at_pause"] = len(held)
        drain(frs, round_wait_s)       # DEAD aging + clone migration
        row_c.update(check(frs, expected))
        prox = ep.proxy("w0")
        fenced0 = (prox.counters["fenced_results"],
                   ep.fleet_stats()["ledger"]["fenced"])
        t_heal = time.monotonic()
        ep.heal_worker("w0")           # the zombie returns ...
        # ... finishes what it held and publishes it late: wait for a
        # stats push after the heal that shows it idle, then a pong,
        # which follows every frame it published before
        end = t_heal + round_wait_s
        while time.monotonic() < end:
            st = prox.last_stats()
            if prox._stats_t > t_heal and \
                    not int(st.get("active_slots", 1)) and \
                    not int(st.get("queue_depth", 1)):
                break
            time.sleep(0.05)
        row_c["zombie_pong"] = prox.ping(timeout=30.0)
        led = ep.fleet_stats()["ledger"]
        # a partitioned replica is not quarantined (unreachable), so its
        # late results pass the proxy and meet the ledger's fence
        late = prox.counters["fenced_results"] - fenced0[0] + \
            led["fenced"] - fenced0[1]
        row_c["zombie_fenced"] = {
            "proxy_fenced_results": prox.counters["fenced_results"],
            "stale_epoch": prox.counters["stale_epoch"],
            "ledger_fenced": led["fenced"], "after_heal": late}
        row_c["ledger"] = led
        row_c["migrations"] = ep.stats().get("migrations")
        row_c["steady"] = steady_check(ep, reqs[:2])
        finish(row_c, ep)
        # what the zombie held finished after the heal, and every one of
        # its results was fenced, not served
        return bool(
            not row_c["lost"] and not row_c["failures"]
            and not row_c["mismatches"] and led["duplicates"] == 0
            and row_c["migrations"] and row_c["zombie_pong"]
            and (late >= 1 or not held)
            and steady_ok(row_c["steady"]) and row_c["workers_ok"])

    # ---- round D: router (endpoint process) SIGKILL + restart ---------
    def round_d():
        row_d = {}
        dwd = os.path.join(workdir, "d")
        os.makedirs(dwd, exist_ok=True)
        with open(os.path.join(dwd, "manifest.json"), "w",
                  encoding="utf-8") as f:
            json.dump({"model": model, "requests": reqs, "engine": eng_cfg,
                       "device": device,
                       "hello_deadline": hello_deadline}, f)
        results_path = os.path.join(dwd, "results.jsonl")
        pids_path = os.path.join(dwd, "pids.json")

        def read_pids():
            try:
                with open(pids_path, encoding="utf-8") as f:
                    return json.load(f)
            except (OSError, ValueError):
                return {"live": {}, "spawned": []}

        def spawn_router(incarnation: int, paced: bool):
            env = dict(os.environ, **env_slow)
            env["DL4J_SOAK_SLOW"] = str(slow) if paced else "0"
            log = open(os.path.join(dwd, f"router-{incarnation}.log"), "w")
            try:
                return subprocess.Popen(
                    [sys.executable, "-m", "deeplearning4j_tpu_torch.tools."
                     "chaos_soak", "--remote-router-child", dwd,
                     "--incarnation", str(incarnation)],
                    env=env, cwd=REPO_ROOT, stdout=log,
                    stderr=subprocess.STDOUT)
            finally:
                log.close()

        proc = None
        try:
            proc = spawn_router(0, paced=True)
            end = time.monotonic() + round_wait_s
            while time.monotonic() < end:
                if len(_valid_result_lines(results_path)["by_id"]) >= 2:
                    break
                if proc.poll() is not None:
                    break
                time.sleep(0.05)
            row_d["results_at_kill"] = \
                len(_valid_result_lines(results_path)["by_id"])
            if proc.poll() is None:
                proc.kill()                # the whole routing tier dies
            proc.wait(timeout=30)
            # reap the orphaned workers the dead launcher left
            pids0 = read_pids()
            spawned.extend(pids0.get("spawned", []))
            reaped = 0
            for pid in pids0.get("live", {}).values():
                try:
                    os.kill(int(pid), signal.SIGKILL)
                    reaped += 1
                except (OSError, ValueError):
                    pass
            row_d["orphans_reaped"] = reaped
            proc = spawn_router(1, paced=False)
            try:
                rc = proc.wait(timeout=round_wait_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
                rc = -9
            spawned.extend(read_pids().get("spawned", []))
            row_d["final_exit_code"] = rc
            refs_done.wait()
            if expected is None:
                raise RuntimeError("the references failed")
            res = _valid_result_lines(results_path)
            by_id = res["by_id"]
            # the first durable line per id claims the one completion;
            # every further line must fence
            ledger = FleetLedger()
            for r in reqs:
                ledger.assign(r["id"], "router")
            duplicates = mismatches = failures = 0
            for rid, doc in by_id.items():
                if rid not in expected:
                    continue
                if ledger.try_complete(rid, "router") != "ok":
                    duplicates += 1
                if doc.get("failed"):
                    failures += 1
                elif not np.array_equal(
                        np.asarray(doc.get("out", []), np.int64),
                        np.asarray(expected[rid], np.int64)):
                    mismatches += 1
            for doc in res["extra"]:
                if ledger.try_complete(str(doc.get("id")),
                                       "router") != "ok":
                    duplicates += 1
            lost = sorted(set(expected) - set(by_id))
            try:
                with open(os.path.join(dwd, "report-d-1.json"),
                          encoding="utf-8") as f:
                    rep1 = json.load(f)
            except (OSError, ValueError):
                rep1 = {}
            row_d.update({
                "lost": len(lost), "lost_ids": lost,
                "duplicates": duplicates, "mismatches": mismatches,
                "failures": failures, "completed": len(by_id),
                "steady": rep1.get("steady"),
                "workers": rep1.get("workers") or {},
                "ledger": ledger.to_dict()})
            row_d["b1_launches"] = _launch_sum(row_d["workers"])
            row_d["workers_ok"] = workers_ok(row_d["workers"])
            row_d["ok"] = bool(
                rc == 0 and not lost and not duplicates and not mismatches
                and not failures and isinstance(row_d["steady"], dict)
                and steady_ok(row_d["steady"]) and row_d["workers_ok"])
        except Exception as e:   # noqa: BLE001
            row_d["error"] = f"{type(e).__name__}: {e}"
            row_d["ok"] = False
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            for pid in read_pids().get("live", {}).values():
                try:
                    os.kill(int(pid), signal.SIGKILL)
                except (OSError, ValueError):
                    pass
        return row_d

    def timed(fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        return out, time.monotonic() - t0

    # every round's endpoint boots at once, and round D (a router process
    # of its own and its workers) starts, beside the references this
    # process computes; rounds A-C then run in turn, D beside them
    layouts = {"a": {"w0": "both", "w1": "both"},
               "b": {"p0": "prefill", "d0": "decode", "d1": "decode"},
               "c": {"w0": "both", "w1": "both"}}
    eps = {k: endpoint(k, w, f"r{k}{seed}") for k, w in layouts.items()
           if k in rounds}
    t_start = time.monotonic()

    def boot(ep):
        ep.start()
        return time.monotonic() - t_start

    expected = expected_paged = None
    refs_done = threading.Event()
    pool = ThreadPoolExecutor(len(eps) + 1)
    booting = {k: pool.submit(boot, ep) for k, ep in eps.items()}
    running_d = pool.submit(timed, round_d) if "d" in rounds else None
    try:
        t_ref = time.monotonic()
        both_paged = bool(eng_cfg.get("paged", False))
        expected = _remote_reference(ref_net, reqs, eng_cfg, both_paged)
        expected_paged = _remote_reference(ref_net, reqs, eng_cfg, True) \
            if "b" in rounds else None
        reference_s = time.monotonic() - t_ref
    except BaseException:
        refs_done.set()
        for ep in eps.values():
            ep.shutdown()
        pool.shutdown(wait=True)
        raise
    refs_done.set()
    del ref_net

    summary = {"seed": seed, "requests": n_requests, "workdir": workdir,
               "device": want_device, "model": model, "engine": eng_cfg,
               "reference_s": reference_s}
    t_rounds, t_boot = {}, {}
    try:
        for k, play in (("a", round_a), ("b", round_b), ("c", round_c)):
            if k not in eps:
                continue
            t0 = time.monotonic()
            ep, row = eps[k], {}
            try:
                t_boot[k] = booting[k].result()
                if after_boot is not None and k == min(eps):
                    for fut in booting.values():
                        fut.exception()
                    after_boot()
                row["ok"] = play(ep, row)
            except Exception as e:   # noqa: BLE001 — a wedged round is a
                row["error"] = f"{type(e).__name__}: {e}"   # failed row
                row["ok"] = False
            finally:
                if k == "c":
                    try:
                        ep.heal_worker("w0")   # never leave a SIGSTOPped
                    except Exception:   # noqa: BLE001 — orphan
                        pass
                ep.shutdown()
            summary[f"round_{k}"] = row
            t_rounds[k] = time.monotonic() - t0
        if running_d is not None:
            summary["round_d"], t_rounds["d"] = running_d.result()
    finally:
        for ep in eps.values():
            ep.shutdown()
        pool.shutdown(wait=True)

    # every worker of every round is gone (a zombie awaiting its reaper
    # counts as gone)
    end = time.monotonic() + 30.0
    left = [p for p in spawned if _pid_alive(p)]
    while left and time.monotonic() < end:
        time.sleep(0.1)
        left = [p for p in left if _pid_alive(p)]
    summary["workers_spawned"] = len(spawned)
    summary["leftover_pids"] = left
    summary["round_s"] = t_rounds
    summary["boot_s"] = t_boot
    summary["ok"] = bool(
        all(summary[f"round_{k}"]["ok"] for k in rounds) and not left)
    if not summary["ok"]:
        summary["worker_logs"] = _log_tails(workdir)
    if own_workdir:
        shutil.rmtree(workdir, ignore_errors=True)
        summary.pop("workdir", None)
    return summary


def _log_tails(workdir: str, n: int = 2000) -> dict:
    """The tail of every worker and router log under ``workdir``."""
    out = {}
    for root, _, files in os.walk(workdir):
        for name in sorted(files):
            if name.endswith(".log") and \
                    name.startswith(("worker-", "router-")):
                path = os.path.join(root, name)
                try:
                    with open(path, encoding="utf-8",
                              errors="replace") as f:
                        out[os.path.relpath(path, workdir)] = f.read()[-n:]
                except OSError:
                    pass
    return out


def _remote_router_child(workdir: str, incarnation: int) -> int:
    """The routing-tier process of round D: one FleetEndpoint serving the
    manifest. Ids that already have a durable result line are not
    resubmitted; the worker pids (live and every one spawned) go to
    ``pids.json`` at every (re)spawn, so the parent can reap orphans
    after it SIGKILLs this process."""
    from ..streaming.remote import FleetEndpoint

    with open(os.path.join(workdir, "manifest.json"),
              encoding="utf-8") as f:
        manifest = json.load(f)
    results_path = os.path.join(workdir, "results.jsonl")
    have = set(_valid_result_lines(results_path)["by_id"])
    todo = [r for r in manifest["requests"] if r["id"] not in have]

    ep = FleetEndpoint(os.path.join(workdir, f"fleet-{incarnation}"),
                       manifest["model"],
                       workers={"w0": "both", "w1": "both"},
                       engine=manifest.get("engine"),
                       device=manifest.get("device"),
                       fleet_id=f"rd{incarnation}",
                       env={"DL4J_SOAK_SLOW":
                            os.environ.get("DL4J_SOAK_SLOW", "0")},
                       hello_deadline=float(manifest.get("hello_deadline",
                                                         180.0)))
    pids_path = os.path.join(workdir, "pids.json")
    spawned: list = []

    def dump_pids(_rid=None, _epoch=None, pid=None):
        if pid is not None:
            spawned.append(int(pid))
        tmp = pids_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"live": ep.launcher.pids(), "spawned": spawned}, f)
        os.replace(tmp, pids_path)

    ep.launcher.on_spawn = dump_pids
    try:
        ep.start()
        dump_pids()
        with open(results_path, "a", encoding="utf-8") as rf:
            frs = {r["id"]: ep.submit(r["prompt"], r["gen"]) for r in todo}
            pending = dict(frs)
            while pending:
                for rid, fr in list(pending.items()):
                    if not fr.done():
                        continue
                    del pending[rid]
                    if rid in have:
                        continue
                    have.add(rid)
                    try:
                        out = [int(t) for t in fr.result(0)]
                        doc = {"id": rid, "inc": incarnation, "out": out}
                    except Exception as e:   # noqa: BLE001
                        doc = {"id": rid, "inc": incarnation,
                               "failed": f"{type(e).__name__}: {e}"}
                    rf.write(json.dumps(doc) + "\n")
                    rf.flush()
                time.sleep(0.02)
        # the steady report: a warm wave on every worker, mark, a wave,
        # each worker's delta
        sample = manifest["requests"][:2]
        rids = list(ep.workers)
        delta, nvcc = {}, {}

        def wave():
            frs = [ep.submit(r["prompt"], r["gen"], replica_id=rid)
                   for rid in rids for r in sample]
            end = time.monotonic() + 60.0
            for fr in frs:
                fr._done.wait(max(0.0, end - time.monotonic()))

        try:
            wave()
            for rid in rids:
                ep.proxy(rid).audit_mark()
            wave()
            for rid in rids:
                delta[rid] = ep.proxy(rid).audit_delta(timeout=30.0)
                nvcc[rid] = ep.proxy(rid).refresh_stats(
                    timeout=30.0).get("nvcc_runs")
        except Exception as e:   # noqa: BLE001
            delta["error"] = f"{type(e).__name__}: {e}"
        with open(os.path.join(workdir, f"report-d-{incarnation}.json"),
                  "w", encoding="utf-8") as f:
            json.dump({"incarnation": incarnation, "served": len(todo),
                       "steady": {"delta": delta, "nvcc_runs": nvcc},
                       "workers": _worker_rows(ep)}, f, default=str)
    finally:
        ep.shutdown()
    return 0


def remote_scale_endpoints(model: dict, engine: dict, seed: int = 0,
                           workers: int = 3, slow: float = 0.4,
                           hello_deadline: float = 300.0,
                           device=None) -> dict:
    """The endpoints ``run_remote_scale_ab`` times, by worker count (1
    and ``workers``), each in a temporary directory of its own, not yet
    started: a caller may boot them (``FleetEndpoint.start``) beside
    other work and hand them over as ``endpoints``."""
    from ..ops.platform import resolve_device
    from ..streaming.remote import FleetEndpoint

    resolve_device(device)      # no card and no device="cpu": raise here
    return {n: FleetEndpoint(
        tempfile.mkdtemp(prefix=f"remote-ab{n}-"), model,
        workers={f"w{i}": "both" for i in range(n)}, engine=engine,
        device=device, fleet_id=f"ab{seed}x{n}",
        env={"DL4J_SOAK_SLOW": str(slow)}, hello_deadline=hello_deadline)
        for n in sorted({1, int(workers)})}


def run_remote_scale_ab(seed: int = 0, n_requests: int = 48,
                        num_slots: int = 2, max_new: int = 8,
                        vocab: int = 12, block_size: int = 4,
                        slow: float = 0.4, workers: int = 3,
                        wait_s: float = 900.0, pairs: int = 1,
                        inprocess: bool = False,
                        model: Optional[dict] = None,
                        requests: Optional[list] = None,
                        engine: Optional[dict] = None,
                        hello_deadline: float = 300.0,
                        device=None,
                        endpoints: Optional[dict] = None) -> dict:
    """Aggregate generated tok/s of 1 worker process against ``workers``
    (``--remote-scale``), and with ``inprocess`` against an in-process
    ``EngineFleetRouter`` of ``workers`` replicas on one shared decoder,
    on the same requests, in ``pairs`` alternating pairs (1, N, in; in,
    N, 1; ...). Both endpoints boot once, together (or come booted as
    ``endpoints``, from ``remote_scale_endpoints`` with the same model,
    engine, workers and pace), and every worker serves a warm wave before
    the first timed run; they are shut down and their directories
    removed at the end.

    ``slow`` > 0 paces every engine step (``DL4J_SOAK_SLOW``; the
    in-process replicas take the same injected hang), the JAX soak's
    stand-in for an accelerator-bound step on a CPU host: the ratio then
    measures what the process tier adds, and ``ok`` is the JAX soak's
    gate (N processes at least 2.4 x one). Unpaced (``slow`` 0, the card
    as the device) the numbers are reported and ``ok`` holds nothing:
    on one card without MPS the workers' CUDA contexts time-slice."""
    from concurrent.futures import ThreadPoolExecutor

    from ..models.generation import TransformerDecoder
    from ..parallel.faults import FaultInjector
    from ..streaming.fleet import EngineFleetRouter

    model = dict(model or _tiny_model(vocab))
    if requests is None:
        # uniform streams (every request a whole number of blocks): a
        # throughput A/B wants full block steps and an even split
        reqs = _remote_requests(seed, n_requests, vocab, max_new)
        for r in reqs:
            r["gen"] = max_new
    else:
        reqs = list(requests)
    eng_cfg = dict(engine or {"num_slots": num_slots,
                              "block_size": block_size})
    eps = endpoints if endpoints is not None else remote_scale_endpoints(
        model, eng_cfg, seed=seed, workers=workers, slow=slow,
        hello_deadline=hello_deadline, device=device)
    router = None
    try:
        with ThreadPoolExecutor(len(eps)) as pool:
            for fut in [pool.submit(ep.start) for ep in eps.values()]:
                fut.result()
        hello_s = {n: sorted(ep.hello_s.values())
                   for n, ep in eps.items()}
        warm = [ep.submit(r["prompt"], r["gen"], replica_id=rid)
                for ep in eps.values() for rid in list(ep.workers)
                for r in reqs[:2]]
        for fr in warm:
            fr.result(timeout=wait_s)
        if inprocess:
            net = _remote_net(model, device)
            dec = TransformerDecoder(net, t_max=eng_cfg.get("t_max"))
            injs = None
            if slow > 0:
                injs = [FaultInjector().hang_for(
                    "engine.step", seconds=slow, at=1, times=1_000_000)
                    for _ in range(workers)]
            router = EngineFleetRouter(
                net, num_replicas=workers, decoder=dec, tracing=False,
                replica_injectors=injs,
                **_engine_kw(eng_cfg, bool(eng_cfg.get("paged", False))))
            router.start()
            for fr in [router.submit(r["prompt"], r["gen"])
                       for r in reqs[:2 * workers]]:
                fr.result(timeout=wait_s)

        def timed(target) -> float:
            t0 = time.perf_counter()
            frs = [target.submit(r["prompt"], r["gen"]) for r in reqs]
            toks = sum(len(fr.result(timeout=wait_s)) - len(r["prompt"])
                       for fr, r in zip(frs, reqs))
            return toks / (time.perf_counter() - t0)

        arms = [1, workers] + (["in"] if inprocess else [])
        tps = {a: [] for a in arms}
        for i in range(max(1, int(pairs))):
            for a in (arms if i % 2 == 0 else arms[::-1]):
                tps[a].append(timed(router if a == "in" else eps[a]))
    finally:
        if router is not None:
            router.shutdown()
        for ep in eps.values():
            ep.shutdown()
            shutil.rmtree(ep.workdir, ignore_errors=True)
    med = {a: float(np.median(v)) for a, v in tps.items()}
    ratio = med[workers] / med[1] if med[1] else 0.0
    out = {"seed": seed, "requests": len(reqs),
           "generated_tokens": sum(r["gen"] for r in reqs),
           "pace_s": slow, "device": device or "cuda",
           "tok_s_1p": [round(x, 2) for x in tps[1]],
           f"tok_s_{workers}p": [round(x, 2) for x in tps[workers]],
           "scaling_x": round(ratio, 3), "hello_s": hello_s}
    if inprocess:
        out[f"tok_s_{workers}_inprocess"] = [round(x, 2)
                                             for x in tps["in"]]
        out["process_vs_inprocess_x"] = round(med[workers] / med["in"], 3) \
            if med["in"] else None
    out["ok"] = bool(ratio >= 2.4) if slow > 0 else True
    return out



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--crashes", type=int, default=2)
    ap.add_argument("--hangs", type=int, default=1)
    ap.add_argument("--supervisor-timeout", type=float, default=2.0)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--postmortem-dir", default=None)
    ap.add_argument("--no-overhead-ab", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="the full summary, metrics snapshot included")
    ap.add_argument("--process-kill", action="store_true",
                    help="the SIGKILL / SIGTERM round over a journaled "
                         "child process")
    ap.add_argument("--spec", action="store_true",
                    help="the speculative round (supervised crash, fleet "
                         "crash and NaN quarantine mid-verify)")
    ap.add_argument("--replicas", type=int, default=None, metavar="N",
                    help="the fleet round: N replicas behind an "
                         "EngineFleetRouter, one crash-killed and (N >= 3) "
                         "one zombied mid-stream")
    ap.add_argument("--no-fleet-scale", action="store_true",
                    help="skip the fleet round's 1 -> N tok/s A/B")
    ap.add_argument("--autoscale", action="store_true",
                    help="the autoscale round: burst growth and "
                         "drain-backed shrink")
    ap.add_argument("--max-replicas", type=int, default=3,
                    help="the autoscale round's fleet ceiling")
    ap.add_argument("--disagg", action="store_true",
                    help="the disaggregated prefill / decode round")
    ap.add_argument("--corruption", action="store_true",
                    help="the silent-data-corruption round")
    ap.add_argument("--drain-deadline", type=float, default=8.0)
    ap.add_argument("--device", default=None,
                    help="the tiny LM's device (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch path)")
    ap.add_argument("--remote", action="store_true",
                    help="the process-per-replica rounds: a worker "
                         "SIGKILLed mid-stream, the role-split wire "
                         "handoff with a decode kill, a SIGSTOP partition "
                         "with its zombie fenced, a router-process "
                         "SIGKILL with its orphans reaped")
    ap.add_argument("--remote-scale", action="store_true",
                    help="1 worker process against 3, paced: aggregate "
                         "tok/s (gate: >= 2.4 x)")
    ap.add_argument("--process-kill-child", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--remote-router-child", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--incarnation", type=int, default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.process_kill_child:
        return _process_kill_child(args.process_kill_child,
                                   args.incarnation, args.drain_deadline)
    if args.remote_router_child:
        return _remote_router_child(args.remote_router_child,
                                    args.incarnation)
    if args.remote:
        summary = run_remote_soak(seed=args.seed, n_requests=args.requests,
                                  num_slots=args.slots,
                                  max_new=args.max_new, device=args.device)
    elif args.remote_scale:
        summary = run_remote_scale_ab(seed=args.seed, device=args.device)
    elif args.process_kill:
        summary = run_process_kill_soak(seed=args.seed,
                                        drain_deadline=args.drain_deadline,
                                        device=args.device)
    elif args.spec:
        summary = run_spec_soak(seed=args.seed, device=args.device)
    elif args.replicas:
        summary = run_fleet_soak(seed=args.seed, replicas=args.replicas,
                                 n_requests=args.requests,
                                 num_slots=args.slots, max_new=args.max_new,
                                 fleet_scale=not args.no_fleet_scale,
                                 postmortem_dir=args.postmortem_dir,
                                 paged=args.paged, profile=args.profile,
                                 device=args.device)
    elif args.autoscale:
        summary = run_autoscale_soak(seed=args.seed,
                                     max_replicas=args.max_replicas,
                                     device=args.device)
    elif args.disagg:
        summary = run_disagg_soak(seed=args.seed, device=args.device)
    elif args.corruption:
        summary = run_corruption_soak(seed=args.seed, device=args.device)
    else:
        summary = run_soak(seed=args.seed, n_requests=args.requests,
                           num_slots=args.slots, max_new=args.max_new,
                           crashes=args.crashes, hangs=args.hangs,
                           supervisor_timeout=args.supervisor_timeout,
                           overhead_ab=not args.no_overhead_ab,
                           postmortem_dir=args.postmortem_dir,
                           paged=args.paged, profile=args.profile,
                           device=args.device)
    if not args.json:
        summary.pop("metrics", None)
    print(json.dumps(summary, default=str))
    return 0 if summary.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
