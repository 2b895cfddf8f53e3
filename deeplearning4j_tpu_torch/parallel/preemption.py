"""Preemption-aware serving drain: SIGTERM → stop admission, retire the
in-flight decode block, journal + fsync, hand off, exit — within a
deadline budget — the JAX package's ``parallel/preemption.py``, copied.

A preempted machine gets SIGTERM with a grace window and then SIGKILL; a serving process that ignores the warning loses everything
the hard way, and the :mod:`..streaming.journal` recovery path has to
regenerate tokens the dying process had already computed. The
:class:`PreemptionHandler` here is the serving-side analogue of the
training-side checkpoint handler in :mod:`.failures` — drain-or-die:

1. **stop admission** — ``engine.begin_drain()``: new submissions shed
   with ``RejectedError`` (a fleet router spills them to survivors);
2. **retire the in-flight decode block** — the serve loop parks at the
   next block boundary and the handler fetches + journals the block's
   tokens (work recovery would otherwise redo), but only while budget
   remains: a loop wedged in a device call is abandoned, not waited out;
3. **harvest + journal + fsync** — quarantine the engine (requests are
   harvested, NOT failed — their journal records stay open for
   recovery), stamp a requeue marker per harvested request, and force
   one final fsync so the tail survives the kill that follows;
4. **handoff manifest** — a flight-recorder post-mortem artifact
   bundling the unfinished ids, their resume points, the drained
   traces, and the registry snapshot: the black box the NEXT
   incarnation (or a human) reads before recovery;
5. **exit within the deadline** — every phase is budget-gated; a second
   SIGTERM (or concurrent ``preempt()``) is idempotent and simply waits
   on the first drain.

The handler never calls ``sys.exit`` itself — the serving main loop
polls :attr:`preempted` / waits on :meth:`wait` and exits, so embedding
processes keep control of their shutdown (``tools/chaos_soak.py
--process-kill``'s child is the reference caller).
"""

from __future__ import annotations

import signal
import threading
import time
from typing import List, Optional, Sequence

from ..observability.flightrec import default_flight_recorder
from ..observability.metrics import default_registry


class DrainReport:
    """What one preemption drain did (also embedded in the manifest)."""

    def __init__(self):
        self.reason = ""
        self.harvested: List = []          # non-terminal requests
        self.drain_s: Optional[float] = None
        self.within_budget = False
        self.journal_synced = False
        self.manifest_path: Optional[str] = None

    def to_dict(self) -> dict:
        return {"reason": self.reason,
                "harvested": len(self.harvested),
                "unfinished_ids": [getattr(r, "journal_id", None)
                                   for r in self.harvested],
                "generated": {str(getattr(r, "journal_id", i)):
                              len(r.generated)
                              for i, r in enumerate(self.harvested)},
                "drain_s": self.drain_s,
                "within_budget": self.within_budget,
                "journal_synced": self.journal_synced,
                "manifest_path": self.manifest_path}


class PreemptionHandler:
    """SIGTERM (or programmatic ``preempt()``) → deadline-budgeted
    serving drain over a ``SlotGenerationEngine`` or an
    ``EngineSupervisor`` wrapping one.

    ``deadline`` is the whole drain's budget in seconds (preemption
    grace windows are ~30s; leave slack for the process to actually
    exit). ``manifest_dir`` defaults to the journal's directory, so the
    handoff artifact lands next to the WAL it describes."""

    def __init__(self, engine, journal=None, *, deadline: float = 10.0,
                 signals: Sequence[int] = (signal.SIGTERM,),
                 manifest_dir: Optional[str] = None,
                 flight_recorder=None, registry=None, on_drained=None):
        self.engine = engine
        self.journal = journal
        self.deadline = float(deadline)
        self.signals = tuple(signals)
        self.manifest_dir = manifest_dir if manifest_dir is not None \
            else getattr(journal, "directory", None)
        self._flightrec = flight_recorder if flight_recorder is not None \
            else default_flight_recorder()
        self._on_drained = on_drained
        # plain (NON-reentrant) Lock, only ever acquired non-blocking:
        # SIGTERM handlers run on the MAIN thread between bytecodes, so
        # the handler can fire while that same thread is inside
        # preempt() — a blocking acquire would self-deadlock, and a
        # reentrant lock would let the nested handler call slip past
        # the latch mid-update and spawn a second drain. `preempted`
        # reads the bare flag for the same signal-safety reason.
        self._lock = threading.Lock()
        self._latched = False
        self._drained = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._previous = {}
        self.report: Optional[DrainReport] = None
        reg = registry if registry is not None else default_registry()
        self._m_drains = reg.counter(
            "preemption_drains_total",
            "preemption drains executed (signal or programmatic)")
        self._h_drain = reg.histogram(
            "preemption_drain_seconds",
            "wall time of a preemption drain, signal to handoff")
        self._g_draining = reg.gauge(
            "preemption_draining",
            "1 while a preemption drain is in progress")
        self._g_draining.set(0)

    # ------------------------------------------------------------ signals
    def install(self) -> "PreemptionHandler":
        for sig in self.signals:
            self._previous[sig] = signal.signal(sig, self._handle)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()

    def _handle(self, signum, frame):
        # keep the signal handler tiny: latch + spawn; the drain itself
        # runs on its own thread so a handler re-entry (double SIGTERM)
        # just observes the latch
        self.preempt(reason=f"signal {signum}")

    # -------------------------------------------------------------- drain
    @property
    def preempted(self) -> bool:
        return self._latched           # lock-free: signal-handler safe

    @property
    def drained(self) -> bool:
        return self._drained.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the drain completes; the serving main loop's
        exit gate."""
        return self._drained.wait(timeout)

    def preempt(self, reason: str = "programmatic") -> bool:
        """Start the drain (idempotent: the first caller wins, every
        later call — second SIGTERM included — returns False and the
        one drain proceeds). Signal-safe by NON-BLOCKING acquisition: a
        SIGTERM handler interrupting this very call on the main thread
        finds the lock held, concludes a latch is already in progress
        (the interrupted call will finish the one spawn), and returns —
        no deadlock, no double drain, whichever invocation wins."""
        if not self._lock.acquire(blocking=False):
            return False
        try:
            if self._latched:
                return False
            self._latched = True
            self._thread = threading.Thread(
                target=self._drain, args=(str(reason),), daemon=True,
                name="preemption-drain")
            self._thread.start()
            return True
        finally:
            self._lock.release()

    def _drain(self, reason: str) -> None:
        t0 = time.monotonic()
        t_end = t0 + self.deadline
        self._m_drains.inc()
        self._g_draining.set(1)
        self._flightrec.record("preempt", reason=reason,
                               budget_s=self.deadline)
        report = DrainReport()
        report.reason = reason
        try:
            eng = self.engine
            if hasattr(eng, "_sup_lock"):
                # supervised replica: stop the supervisor FIRST so a
                # crash/wedge callback racing the drain cannot build a
                # replacement engine that would miss the handoff
                eng = eng.detach()
            try:
                # phase 1: close admission IMMEDIATELY — the loop-park
                # and harvest below may take most of the budget, and
                # every request accepted in that window is one more
                # thing to hand off
                eng.begin_drain()
            except Exception:   # noqa: BLE001 — a half-dead engine
                pass            # still drains below
            try:
                harvested, _ = eng.preempt_drain(
                    budget=max(0.0, t_end - time.monotonic()))
            except Exception:   # noqa: BLE001 — a half-dead engine still
                harvested = []  # gets its journal synced + manifest
            report.harvested = [r for r in harvested if not r.done()]
            jr = self.journal
            if jr is not None:
                for r in report.harvested:
                    # resume markers: replay-inert, but the manifest and
                    # the WAL agree on every resume point
                    jr.requeued(r)
                report.journal_synced = jr.sync()
            report.drain_s = round(time.monotonic() - t0, 4)
            report.within_budget = time.monotonic() <= t_end
            if self.manifest_dir:
                report.manifest_path = self._flightrec.write_postmortem(
                    self.manifest_dir, "preempt",
                    reason=f"preemption drain ({reason})",
                    traces=[r.trace for r in report.harvested
                            if r.trace is not None],
                    registry=default_registry(),
                    extra={"handoff": report.to_dict(),
                           "journal": None if jr is None else jr.stats()})
        finally:
            self._h_drain.observe(time.monotonic() - t0)
            self._g_draining.set(0)
            self.report = report
            self._drained.set()
        cb = self._on_drained
        if cb is not None:
            try:
                cb(report)
            except Exception:   # noqa: BLE001 — a bad hook must not
                pass            # mask a completed drain
