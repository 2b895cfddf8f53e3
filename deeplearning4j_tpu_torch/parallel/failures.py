"""Failure detection and supervised restart of the serving engine (the
JAX package's ``parallel/failures.py``).

- :class:`HeartbeatMonitor` tracks last-beat times of named workers and
  calls ``on_failure(worker_id)`` once for a worker silent past
  ``timeout``.
- :class:`EngineSupervisor` supervises a ``SlotGenerationEngine``'s serve
  loop: a crash (reported at once by the engine) or a wedge (no beat for
  ``timeout``) quarantines the engine, rebuilds it around the same
  ``TransformerDecoder`` and requeues every harvested request exactly
  once; with ``postmortem_dir`` every takeover writes a flight-recorder
  post-mortem whose trace ids are the recovered requests'.
- :class:`PreemptionHandler` (training side): SIGTERM → a forced
  checkpoint and a drain flag the training loop polls. The serving-side
  drain is ``parallel/preemption.py``.
- :func:`run_elastic` runs tasks over a pool of worker threads that
  survives worker loss."""

from __future__ import annotations

import queue
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence


class WorkerLostError(RuntimeError):
    """Raised by a task to signal its worker is gone (vs a retryable task
    error)."""


class HeartbeatMonitor:
    """Tracks last-beat times per worker; fires ``on_failure(worker_id)``
    once per worker that goes silent for ``timeout`` seconds. ``start()``
    scans every ``interval`` seconds on a daemon thread."""

    def __init__(self, timeout: float = 10.0, interval: float = 1.0,
                 on_failure: Optional[Callable[[str], None]] = None):
        self.timeout = float(timeout)
        self.interval = float(interval)
        self.on_failure = on_failure
        self._beats: Dict[str, float] = {}
        self._failed: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, worker_id: str) -> None:
        with self._lock:
            self._beats[worker_id] = time.monotonic()
            self._failed.discard(worker_id)

    def deregister(self, worker_id: str) -> None:
        with self._lock:
            self._beats.pop(worker_id, None)
            self._failed.discard(worker_id)

    def beat(self, worker_id: str) -> None:
        with self._lock:
            self._beats[worker_id] = time.monotonic()

    def failed_workers(self) -> List[str]:
        with self._lock:
            return sorted(self._failed)

    def check_once(self) -> List[str]:
        """Scan now; returns the newly failed workers (and calls
        ``on_failure`` for each)."""
        now = time.monotonic()
        newly = []
        with self._lock:
            for wid, t in self._beats.items():
                if wid not in self._failed and now - t > self.timeout:
                    self._failed.add(wid)
                    newly.append(wid)
        for wid in newly:
            if self.on_failure is not None:
                self.on_failure(wid)
        return newly

    def start(self) -> "HeartbeatMonitor":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            self.check_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


class EngineSupervisor(HeartbeatMonitor):
    """Supervises a SlotGenerationEngine's serve loop: restart-on-crash,
    restart-on-wedge, and exactly-once recovery of in-flight requests.

    The engine beats this monitor once per loop iteration; a loop that
    stops beating for ``timeout`` seconds (wedged in a device call, hung
    by an injected fault) or that crashes outright (reported immediately
    through the engine's ``_on_crash`` hook) triggers a takeover:

    1. ``engine.quarantine()`` — stop the old loop and harvest every
       recoverable request exactly once (the wedged thread, whenever it
       wakes, sees the quarantine flag and touches nothing);
    2. rebuild the engine AROUND THE SAME TransformerDecoder — its
       device weights (cast once) and the loaded kernel libraries carry
       over, so a restart copies no weight and builds no kernel;
    3. ``requeue()`` each harvested request on the new engine: it
       resumes by re-prefilling prompt + tokens emitted so far
       (token-for-token equal to an uninterrupted greedy run).

    After ``max_restarts`` takeovers the supervisor gives up: harvested
    requests are failed with the underlying cause and later submissions
    fail fast. ``submit()`` proxies to the current engine under the
    supervisor lock, so callers never race a takeover."""

    def __init__(self, engine, timeout: float = 10.0,
                 interval: float = 0.25, max_restarts: int = 3,
                 warmup_grace: float = 300.0, name: str = "slot-engine",
                 flight_recorder=None, postmortem_dir: str = None):
        super().__init__(timeout=timeout, interval=interval,
                         on_failure=self._on_wedge)
        self._engine = engine
        self._name = name
        # crash flight recorder: takeovers append to the
        # engine's event ring, and — when a post-mortem directory is
        # configured — every crash/wedge writes a JSON artifact bundling
        # the last-N events, the harvested requests' traces, and the
        # registry snapshot at death. Defaults to the ENGINE's recorder
        # so engine-side events and supervisor-side takeovers land in
        # one timeline.
        self._flightrec = flight_recorder if flight_recorder is not None \
            else engine._flightrec
        self._postmortem_dir = postmortem_dir
        # observability: takeovers are first-class telemetry —
        # the supervisor publishes restart/recovery counters on the same
        # registry its engine uses, labeled by supervisor name
        reg = engine._registry
        self._m_restarts = reg.counter(
            "supervisor_restarts_total",
            "engine takeovers (crash or wedge) performed",
            ("supervisor",)).labels(name)
        self._m_recovered = reg.counter(
            "supervisor_recovered_requests_total",
            "requests harvested and requeued across takeovers",
            ("supervisor",)).labels(name)
        self.max_restarts = int(max_restarts)
        # cold-start grace: until the engine completes its first decode
        # step, a silent heartbeat more likely means "building kernels"
        # than "wedged" — restarting into the same cold start would burn
        # the whole restart budget
        self.warmup_grace = float(warmup_grace)
        self._started_t = time.monotonic()
        # reentrant: submit() may trigger a restart which re-enters
        # engine bookkeeping under the same lock
        self._sup_lock = threading.RLock()
        self.restarts = 0
        self.recovered_requests = 0
        self.given_up: Optional[BaseException] = None
        self._stopped = False
        # counters carried over from quarantined engines so stats()
        # stays monotonic across takeovers (a dashboard must never see
        # completed/emitted_tokens reset to zero after a restart)
        self._prior_stats: Dict[str, int] = {}
        self._attach(engine)

    # ------------------------------------------------------------ wiring
    def _attach(self, engine) -> None:
        engine._supervised = True
        engine._on_crash = self._on_crash
        engine._beat = lambda: self.beat(self._name)
        self.register(self._name)

    @property
    def engine(self):
        with self._sup_lock:
            return self._engine

    def start(self) -> "EngineSupervisor":
        with self._sup_lock:
            self._engine.start()
        HeartbeatMonitor.start(self)
        return self

    def stop(self) -> None:
        # latch first: a crash/wedge callback racing stop() must not
        # spin up a replacement engine nobody will ever shut down
        with self._sup_lock:
            self._stopped = True
        HeartbeatMonitor.stop(self)
        # read the final engine ref under the lock, shut it down OUTSIDE
        # it: shutdown() joins the serve loop, and a crashing
        # worker's _on_crash callback needs _sup_lock — joining while
        # holding it stalls both sides until the join times out. The
        # _stopped latch makes the ref final: no takeover can swap the
        # engine after it.
        with self._sup_lock:
            eng = self._engine
        eng.shutdown()

    # ---------------------------------------------------------- takeover
    def _on_crash(self, engine, exc: BaseException) -> None:
        """Called from the dying worker thread itself — restart
        immediately instead of waiting out a heartbeat timeout."""
        with self._sup_lock:
            if self._stopped:
                return
            if engine is self._engine and self.given_up is None:
                self._restart(cause=exc)

    def _on_wedge(self, worker_id: str) -> None:
        """Heartbeat timeout: the loop is alive but stuck (device hang,
        injected wedge). The stuck thread cannot be killed — quarantine
        strands it harmlessly and a fresh engine takes the traffic."""
        with self._sup_lock:
            if self._stopped:
                return
            if worker_id == self._name and self.given_up is None:
                eng = self._engine
                if not eng._first_step_done and \
                        time.monotonic() - self._started_t < \
                        self.warmup_grace:
                    # silent because it is still warming up, not wedged:
                    # push the liveness deadline out and look again
                    self.register(self._name)
                    return
                if eng._worker is not None and eng._worker.is_alive():
                    self._restart(cause=RuntimeError(
                        f"serve loop wedged: no progress beat for "
                        f"{self.timeout}s"))

    def _restart(self, cause: Optional[BaseException]) -> None:
        # callers hold _sup_lock
        from ..models.generation import SlotGenerationEngine
        old = self._engine
        recoverable, dead = old.quarantine()
        for k, v in old.stats().items():
            # gauges and topology labels don't accumulate across engines
            if k not in ("queue_depth", "active_slots", "mesh_shape"):
                self._prior_stats[k] = self._prior_stats.get(k, 0) + v
        cause = dead or cause or RuntimeError("engine restarted")
        self._flightrec.record(
            "takeover", supervisor=self._name, engine=old.engine_id,
            cause=f"{type(cause).__name__}: {cause}"[:200],
            recovered=len(recoverable), restarts=self.restarts + 1)
        if self._postmortem_dir:
            # the artifact is the black box a dead replica leaves
            # behind: written BEFORE the requeue so it captures the
            # harvested traces exactly as the dying engine left them
            self._flightrec.write_postmortem(
                self._postmortem_dir, self._name,
                reason=f"engine takeover (restart {self.restarts + 1})",
                cause=cause,
                traces=[r.trace for r in recoverable
                        if r.trace is not None],
                registry=old._registry,
                extra={"supervisor": self._name,
                       "engine": old.engine_id,
                       "recovered_request_ids":
                           [r.trace.request_id for r in recoverable
                            if r.trace is not None],
                       "generated_so_far":
                           {r.trace.request_id: len(r.generated)
                            for r in recoverable
                            if r.trace is not None}})
        if self.restarts >= self.max_restarts:
            self.given_up = cause
            self.deregister(self._name)
            exc = RuntimeError(
                f"engine restart budget exhausted "
                f"({self.max_restarts} restarts)")
            exc.__cause__ = cause
            for req in recoverable:
                req._fail(exc)
            return
        self.restarts += 1
        self._m_restarts.inc()
        new = SlotGenerationEngine(
            old.decoder.net, num_slots=old.num_slots, refill=old.refill,
            seed=old.seed, decoder=old.decoder,   # same device weights
            max_pending=old.max_pending, fault_injector=old._faults,
            block_size=old.block_size,
            # the same telemetry sinks: requeued requests continue their
            # traces, one stable SLO label and profiler channel a replica
            registry=old._registry, trace_store=old._trace_store,
            tracing=old._tracing, slo=old._slo, slo_label=old.slo_label,
            flight_recorder=old._flightrec, profiler=old._profiler,
            profiling=old._profiling,
            # the durable journal: requeued requests keep appending under
            # their original ids
            journal=old._journal,
            scheduling=old.scheduling, shed_headroom=old.shed_headroom,
            headroom_margin=old.headroom_margin,
            prefill_chunk=old.prefill_chunk,
            adaptive_block=old.adaptive_block, block_ladder=old.block_ladder,
            block_latency_target=old.block_latency_target,
            # a fresh pool of the same geometry: requests re-prefill
            paged=old._pager is not None, page_size=old.page_size,
            num_pages=old.num_pages, prefix_cache=old.prefix_cache,
            integrity=old._integrity, speculative=old.speculative,
            spec_k=old.spec_k, spec_ngram=old.spec_ngram,
            spec_threshold=old.spec_threshold,
            spec_probe_every=old.spec_probe_every,
            # a disagg worker keeps its role and its handoff sink
            phase=old.phase, handoff=old._handoff)
        for req in recoverable:      # harvest order: admitting, slots,
            new.requeue(req)         # queue — deterministic resumption
        self.recovered_requests += len(recoverable)
        self._m_recovered.inc(len(recoverable))
        self._attach(new)
        self._engine = new
        new.start()

    # ------------------------------------------------------------ facade
    def submit(self, *args, **kwargs):
        """Submit through the CURRENT engine; serialized against
        takeovers, so a request is never dropped into a dead engine that
        no one will ever restart."""
        with self._sup_lock:
            eng = self._current_engine()
            return eng.submit(*args, **kwargs)

    def adopt(self, req, kv) -> None:
        """Adopt a KV handoff through the CURRENT engine (the disagg
        decode role's intake), serialized against takeovers like
        ``submit``: imported state never lands in an engine a restart is
        about to replace."""
        with self._sup_lock:
            eng = self._current_engine()
            eng.adopt(req, kv)

    def requeue(self, req) -> None:
        """Re-queue a recovered request through the CURRENT engine — the
        cross-replica migration entry point (streaming/fleet.py): a fleet
        router moving work off a dead replica must land it in whatever
        engine this supervisor is running NOW, never in a quarantined one
        a takeover already retired. Serialized against takeovers like
        ``submit()``; recovery bypasses admission control."""
        with self._sup_lock:
            eng = self._current_engine()
            eng.requeue(req)

    def _current_engine(self):
        # callers hold _sup_lock. If the engine crashed but the crash
        # callback lost the race, restart now and hand back the
        # replacement.
        eng = self._engine
        with eng._lock:
            dead = eng._dead
        if dead is not None and self.given_up is None:
            self._restart(cause=dead)
            eng = self._engine
        return eng

    def detach(self):
        """Stop supervising WITHOUT shutting the engine down and return
        the current engine — the preemption-drain seam
        (parallel/preemption.py): the handler must drain the live
        engine itself (retire the in-flight block, then harvest), and a
        crash/wedge callback arriving mid-drain must not spin up a
        replacement that would race the handoff."""
        with self._sup_lock:
            self._stopped = True
            eng = self._engine
        HeartbeatMonitor.stop(self)
        return eng

    def quarantine(self):
        """Retire this supervised replica for fleet-level migration: stop
        supervising (a crash/wedge callback arriving later is a no-op),
        then quarantine the current engine and hand back its recoverable
        requests exactly once — the same harvest contract
        ``SlotGenerationEngine.quarantine`` gives, lifted over takeovers.
        Returns ``(recoverable_requests, death_cause)``."""
        with self._sup_lock:
            self._stopped = True
            eng = self._engine
        HeartbeatMonitor.stop(self)
        # quarantine OUTSIDE _sup_lock (it takes the engine lock; the
        # crash callback path takes _sup_lock from the engine thread —
        # same discipline as stop())
        return eng.quarantine()

    def stats(self) -> dict:
        """Current engine's counters PLUS everything quarantined engines
        accrued before their takeover — monotonic across restarts."""
        with self._sup_lock:
            s = self._engine.stats()
            for k, v in self._prior_stats.items():
                s[k] = s.get(k, 0) + v
            s["restarts"] = self.restarts
            s["recovered_requests"] = self.recovered_requests
        return s


class PreemptionHandler:
    """SIGTERM/SIGINT → force checkpoint + drain flag.

    Training loops poll ``handler.preempted`` between steps and exit
    cleanly; on restart, CheckpointManager.restore_latest resumes exactly
    (updater state included)."""

    def __init__(self, checkpoint_manager=None, net=None,
                 signals: Sequence[int] = (signal.SIGTERM,)):
        self.checkpoint_manager = checkpoint_manager
        self.net = net
        self.signals = tuple(signals)
        self.preempted = False
        self._previous: Dict[int, object] = {}

    def install(self) -> "PreemptionHandler":
        for sig in self.signals:
            self._previous[sig] = signal.signal(sig, self._handle)
        return self

    def _handle(self, signum, frame):
        self.preempted = True
        if self.checkpoint_manager is not None and self.net is not None:
            try:
                self.checkpoint_manager.maybe_save(self.net, force=True)
            except Exception:   # noqa: BLE001 — never die inside a handler
                pass

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()


def run_elastic(tasks: Sequence, worker_fn: Callable[[str, object], object],
                num_workers: int = 4,
                monitor: Optional[HeartbeatMonitor] = None,
                max_requeues: int = 3):
    """Execute ``worker_fn(worker_id, task)`` for every task on a pool of
    worker threads, surviving worker loss.

    A task raising :class:`WorkerLostError` kills its worker; the task goes
    back on the queue (up to ``max_requeues`` times per task) and remaining
    work drains over the survivors. Any other exception propagates (it is a
    task bug, not a lost node — transient retry belongs to
    DistributedDataSet.map_partitions). Returns results in task order.
    Raises RuntimeError if every worker died.
    """
    n = len(tasks)
    results: List = [None] * n
    done = [False] * n
    requeues = [0] * n
    q: "queue.Queue" = queue.Queue()
    for i in range(n):
        q.put(i)
    errors: List[BaseException] = []
    lock = threading.Lock()
    in_flight = [0]      # tasks being executed: they may yet be requeued,
    # so idle survivors must not exit while any are outstanding

    def loop(wid: str):
        if monitor is not None:
            monitor.register(wid)
        try:
            while True:
                # claim atomically: dequeue + in_flight increment under one
                # lock, or an idle peer could observe (empty queue,
                # in_flight==0) between our get() and increment and exit
                # while this task may still be requeued
                with lock:
                    if errors or all(done):
                        return
                    try:
                        i = q.get_nowait()
                        in_flight[0] += 1
                    except queue.Empty:
                        if in_flight[0] == 0:
                            return      # nothing queued, nothing pending
                        i = None
                if i is None:
                    time.sleep(0.02)
                    continue
                if monitor is not None:
                    monitor.beat(wid)
                try:
                    r = worker_fn(wid, tasks[i])
                except WorkerLostError:
                    with lock:
                        in_flight[0] -= 1
                        requeues[i] += 1
                        if requeues[i] > max_requeues:
                            errors.append(RuntimeError(
                                f"task {i} requeued more than "
                                f"{max_requeues} times"))
                        else:
                            q.put(i)
                    return          # this worker is gone
                except BaseException as e:   # noqa: BLE001 — surface task bugs
                    with lock:
                        in_flight[0] -= 1
                        errors.append(e)
                    return
                with lock:
                    results[i] = r
                    done[i] = True
                    in_flight[0] -= 1
        finally:
            if monitor is not None:
                monitor.deregister(wid)

    threads = [threading.Thread(target=loop, args=(f"worker-{w}",),
                                daemon=True)
               for w in range(num_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    if not all(done):
        raise RuntimeError(
            "all workers lost before the task set drained "
            f"({sum(done)}/{n} done)")
    return results
