"""Failure detection and supervised restart of the serving engine (the
JAX package's ``parallel/failures.py``).

- :class:`HeartbeatMonitor` tracks last-beat times of named workers and
  calls ``on_failure(worker_id)`` once for a worker silent past
  ``timeout``.
- :class:`EngineSupervisor` supervises a ``SlotGenerationEngine``'s serve
  loop: a crash (reported at once by the engine) or a wedge (no beat for
  ``timeout``) quarantines the engine, rebuilds it around the same
  ``TransformerDecoder`` and requeues every harvested request exactly
  once.

The training-side driver of that module (``PreemptionHandler``,
``run_elastic``) is not ported."""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional


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
    """Restart-on-crash, restart-on-wedge and exactly-once recovery for a
    ``SlotGenerationEngine``.

    The engine beats this monitor once a serve-loop iteration. A loop
    that crashes (reported through the engine's ``_on_crash`` hook) or
    stops beating for ``timeout`` seconds is taken over:

    1. ``engine.quarantine()`` stops it and harvests every recoverable
       request once (a wedged thread that wakes later touches nothing);
    2. a new engine is built around the SAME ``TransformerDecoder``, so
       its device weights (cast once) and the loaded kernel libraries
       carry over: a restart copies no weight and builds no kernel;
    3. each harvested request is ``requeue()``d; it re-prefills prompt +
       tokens so far and decodes on, token for token as an uninterrupted
       greedy run.

    Until the engine completes its first decode step, silence counts as a
    cold start for ``warmup_grace`` seconds, not as a wedge. After
    ``max_restarts`` takeovers the supervisor gives up: harvested requests
    fail with the cause and later submissions fail fast. ``submit()``
    goes to the current engine under the supervisor's lock."""

    def __init__(self, engine, timeout: float = 10.0,
                 interval: float = 0.25, max_restarts: int = 3,
                 warmup_grace: float = 300.0, name: str = "slot-engine"):
        super().__init__(timeout=timeout, interval=interval,
                         on_failure=self._on_wedge)
        self._engine = engine
        self._name = name
        self.max_restarts = int(max_restarts)
        self.warmup_grace = float(warmup_grace)
        self._started_t = time.monotonic()
        # reentrant: submit() may restart, which re-enters under the lock
        self._sup_lock = threading.RLock()
        self.restarts = 0
        self.recovered_requests = 0
        self.given_up: Optional[BaseException] = None
        self._stopped = False
        # counters of quarantined engines, so stats() stays monotonic
        self._prior_stats: Dict[str, int] = {}
        self._attach(engine)

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
        # latch first: a crash or wedge racing stop() must not build an
        # engine nobody shuts down; shut down outside the lock, because
        # the dying loop's _on_crash needs it
        with self._sup_lock:
            self._stopped = True
        HeartbeatMonitor.stop(self)
        with self._sup_lock:
            eng = self._engine
        eng.shutdown()

    # ---------------------------------------------------------- takeover
    def _on_crash(self, engine, exc: BaseException) -> None:
        """Called from the dying serve loop itself: restart now."""
        with self._sup_lock:
            if self._stopped:
                return
            if engine is self._engine and self.given_up is None:
                self._restart(cause=exc)

    def _on_wedge(self, worker_id: str) -> None:
        """Heartbeat timeout: the loop is alive but stuck. The stuck
        thread cannot be killed; quarantine strands it harmlessly."""
        with self._sup_lock:
            if self._stopped:
                return
            if worker_id == self._name and self.given_up is None:
                eng = self._engine
                if not eng._first_step_done and \
                        time.monotonic() - self._started_t < \
                        self.warmup_grace:
                    # still warming up, not wedged: look again later
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
            if k not in ("queue_depth", "active_slots"):   # gauges
                self._prior_stats[k] = self._prior_stats.get(k, 0) + v
        cause = dead or cause or RuntimeError("engine restarted")
        if self.restarts >= self.max_restarts:
            self.given_up = cause
            self.deregister(self._name)
            exc = RuntimeError(f"engine restart budget exhausted "
                               f"({self.max_restarts} restarts)")
            exc.__cause__ = cause
            for req in recoverable:
                req._fail(exc)
            return
        self.restarts += 1
        new = SlotGenerationEngine(
            old.decoder.net, num_slots=old.num_slots, refill=old.refill,
            seed=old.seed, decoder=old.decoder,   # same device weights
            max_pending=old.max_pending, fault_injector=old._faults,
            block_size=old.block_size, scheduling=old.scheduling,
            shed_headroom=old.shed_headroom,
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
            spec_probe_every=old.spec_probe_every)
        for req in recoverable:      # harvest order: admitting, chunking,
            new.requeue(req)         # slots, queue
        self.recovered_requests += len(recoverable)
        self._attach(new)
        self._engine = new
        new.start()

    # ------------------------------------------------------------ facade
    def submit(self, *args, **kwargs):
        """Submit through the CURRENT engine, serialized against
        takeovers."""
        with self._sup_lock:
            return self._current_engine().submit(*args, **kwargs)

    def requeue(self, req) -> None:
        """Requeue a recovered request through the current engine
        (recovery bypasses admission control)."""
        with self._sup_lock:
            self._current_engine().requeue(req)

    def _current_engine(self):
        # callers hold _sup_lock; a crash whose callback lost the race
        # restarts here
        eng = self._engine
        with eng._lock:
            dead = eng._dead
        if dead is not None and self.given_up is None:
            self._restart(cause=dead)
            eng = self._engine
        return eng

    def quarantine(self):
        """Stop supervising and quarantine the current engine:
        ``(recoverable requests, death cause)``, as
        ``SlotGenerationEngine.quarantine`` gives."""
        with self._sup_lock:
            self._stopped = True
            eng = self._engine
        HeartbeatMonitor.stop(self)
        return eng.quarantine()

    def stats(self) -> dict:
        """The current engine's counters plus those of every quarantined
        engine before it, and ``restarts`` / ``recovered_requests``."""
        with self._sup_lock:
            s = self._engine.stats()
            for k, v in self._prior_stats.items():
                s[k] = s.get(k, 0) + v
            s["restarts"] = self.restarts
            s["recovered_requests"] = self.recovered_requests
        return s
