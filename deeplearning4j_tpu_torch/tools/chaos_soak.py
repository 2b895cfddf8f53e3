"""Chaos soak of the port's serving host tier: the single-engine rounds of
the JAX package's ``scripts/chaos_soak.py``.

- :func:`run_soak` — the supervised crash / wedge round: a seeded fault
  schedule (crashes and wedges at ``engine.step``) under an
  ``EngineSupervisor``, with the bars: zero stranded requests, no kernel
  build and no weight cast after a takeover (``cuda_lib.NVCC_RUNS`` and
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
- :func:`run_spec_soak` — phase A of the JAX soak's ``--spec`` round: a
  cyclic-trained LM (so nearly every dispatch is a verify block) under a
  supervisor, a crash injected mid-verify; bars as in :func:`run_soak`.
  Its phases B and C need the fleet router (ROADMAP queue A8b).

By default every round builds a tiny LM on the CUDA card (``device=``,
or ``--device cpu``, runs it on the CPU); ``net=`` (a ComputationGraph on
any device) and ``prompts=`` / ``gens=`` run it on a caller's net
instead, as ``chip_smoke.py`` does with the flagship. Run from the
repository root::

    python -m deeplearning4j_tpu_torch.tools.chaos_soak --seed 7 --json
    python -m deeplearning4j_tpu_torch.tools.chaos_soak --device cpu
    python -m deeplearning4j_tpu_torch.tools.chaos_soak --process-kill
    python -m deeplearning4j_tpu_torch.tools.chaos_soak --spec
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
    return cuda_lib.NVCC_RUNS, dec.param_casts


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
                        id_key: str) -> tuple:
    """Load each post-mortem artifact and check it against the round: the
    embedded traces' request ids equal the ids the recovery harvested
    (``extra[id_key]``) and belong to this round's requests, the event
    timeline shows the injected fault, the registry snapshot is there.
    Returns (archive rows, ok)."""
    archive = []
    ok = len(paths) >= expected
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
                "trace_match": trace_ids == harvested and
                trace_ids <= known_trace_ids,
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
    """Phase A of the JAX soak's speculative round: a cyclic-trained LM
    (greedy continuation IS the cycle, so the prompt-lookup drafter
    predicts nearly every token and nearly every dispatch is a verify
    block), a paged, sentinel-armed speculative engine under a
    supervisor, one crash injected at ``engine.step``. Bars: zero
    stranded, token-identical to the non-speculative reference, >= 1
    restart, verify blocks flowed, the page audit clean, and no kernel
    build or weight cast on a post-restart wave."""
    from ..models import lm_batch
    from ..models.generation import SlotGenerationEngine, TransformerDecoder
    from ..observability.integrity import IntegrityConfig
    from ..ops.dataset import DataSet
    from ..parallel.failures import EngineSupervisor
    from ..parallel.faults import FaultInjector

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
    ok = (not stranded and not mismatch and not failed and
          stats["restarts"] >= 1 and spec_blocks > 0 and
          phase_a["steady_new_builds"] == 0 and not audit)
    return {"seed": seed, "requests": n_requests, "phase_a": phase_a,
            "ok": bool(ok)}


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
                    help="phase A of the speculative round")
    ap.add_argument("--drain-deadline", type=float, default=8.0)
    ap.add_argument("--device", default=None,
                    help="the tiny LM's device (default: the CUDA card; "
                         "'cpu' runs the plain PyTorch path)")
    ap.add_argument("--process-kill-child", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--incarnation", type=int, default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.process_kill_child:
        return _process_kill_child(args.process_kill_child,
                                   args.incarnation, args.drain_deadline)
    if args.process_kill:
        summary = run_process_kill_soak(seed=args.seed,
                                        drain_deadline=args.drain_deadline,
                                        device=args.device)
    elif args.spec:
        summary = run_spec_soak(seed=args.seed, device=args.device)
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
