"""Serving lifecycle errors and deterministic fault injection (the JAX
package's ``parallel/faults.py``).

- :class:`DeadlineExceeded`, :class:`Cancelled` and :class:`RejectedError`
  are what the engine raises into request handles: a per-request deadline
  enforced mid-decode, a caller's cancel, and admission control's shed.
- :class:`FaultInjector` arms named injection points of the serving stack
  (``engine.step``, ``engine.prefill``; the corruption points
  ``device.corrupt_logits`` and ``device.corrupt_page``) with scripted
  faults keyed to the point's hit count: raise once or n times, hang, drop,
  or a NaN / sign-flip corruption payload the call site applies. Points
  fire on the host only, between device launches. Components default to
  :data:`NULL_INJECTOR`, whose ``fire`` is a constant ``False``.

The JAX injector also feeds a metrics registry and a flight recorder;
those sinks are not ported, the hit and fire counters are."""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before generation finished; the
    engine freed its slot and failed the caller."""


class Cancelled(RuntimeError):
    """The caller cancelled the request; if it was decoding, its slot was
    freed mid-loop."""


class RejectedError(RuntimeError):
    """Admission control shed the request. ``queue_depth`` is the pending
    depth observed at the decision; ``projected_miss_s`` (headroom
    shedding only) is by how many seconds the measured latency account
    projected the request would miss its deadline."""

    def __init__(self, message: str, queue_depth: int = 0,
                 projected_miss_s: Optional[float] = None):
        super().__init__(message)
        self.queue_depth = int(queue_depth)
        self.projected_miss_s = None if projected_miss_s is None \
            else float(projected_miss_s)


class _NullInjector:
    """Inert injector: ``fire`` never raises, sleeps or drops;
    ``corruption`` never corrupts."""

    def fire(self, point: str) -> bool:
        return False

    def corruption(self, point: str, where: str = "") -> Optional[dict]:
        return None


NULL_INJECTOR = _NullInjector()


class FaultInjector:
    """Scripted, hit-count-keyed fault injection::

        inj = FaultInjector()
        inj.raise_once("engine.step", RuntimeError("boom"), at=7)
        inj.hang_for("engine.step", seconds=0.5, at=4)
        inj.corrupt("device.corrupt_logits", mode="nan")

    ``at`` is the 1-based hit where a plan starts; raise, drop and corrupt
    plans cover ``n`` consecutive hits from there. ``fire(point)`` counts a
    hit and runs the due plans: it raises, sleeps (outside the lock) or
    returns True when the caller should drop the operation. Corruption
    plans are polled with :meth:`corruption` instead, per (point, where)
    site, each site with its own hit counter. ``hits`` / ``fired`` make a
    schedule auditable after a run."""

    def __init__(self):
        self._lock = threading.Lock()
        self._plans: Dict[str, List[dict]] = defaultdict(list)
        self._hits: Dict[str, int] = defaultdict(int)
        self._fired: Dict[str, int] = defaultdict(int)

    # ------------------------------------------------------------- arming
    def raise_once(self, point: str, exc, at: int = 1) -> "FaultInjector":
        return self.raise_n(point, exc, n=1, at=at)

    def raise_n(self, point: str, exc, n: int,
                at: int = 1) -> "FaultInjector":
        """Raise ``exc`` on ``n`` consecutive hits from hit ``at``: an
        exception class (instantiated per raise with a message naming the
        point) or an instance (raised as is)."""
        with self._lock:
            self._plans[point].append(
                {"kind": "raise", "at": int(at), "remaining": int(n),
                 "exc": exc})
        return self

    def hang_for(self, point: str, seconds: float, at: int = 1,
                 times: int = 1) -> "FaultInjector":
        """Sleep ``seconds`` at hits [at, at + times): a wedged loop, seen
        by heartbeat supervision."""
        with self._lock:
            self._plans[point].append(
                {"kind": "hang", "at": int(at), "remaining": int(times),
                 "seconds": float(seconds)})
        return self

    def drop(self, point: str, n: int = 1, at: int = 1) -> "FaultInjector":
        """Tell the call site to drop the operation on ``n`` consecutive
        hits from ``at``."""
        with self._lock:
            self._plans[point].append(
                {"kind": "drop", "at": int(at), "remaining": int(n)})
        return self

    def corrupt(self, point: str, mode: str = "nan", n: int = 1,
                at: int = 1, where: str = "") -> "FaultInjector":
        """Arm a data corruption the call site applies when
        :meth:`corruption` says it is due: a NaN fill (``"nan"``, trips the
        numerics sentinel) or a sign flip (``"flip"``, plausible wrong
        values only content checksums catch). ``where`` scopes the plan to
        one poll site of a point."""
        if mode not in ("nan", "flip"):
            raise ValueError(f"corrupt mode must be 'nan' or 'flip', "
                             f"got {mode!r}")
        with self._lock:
            self._plans[self._ckey(point, where)].append(
                {"kind": "corrupt", "at": int(at), "remaining": int(n),
                 "mode": str(mode)})
        return self

    def clear(self, point: Optional[str] = None) -> None:
        """Disarm every plan, or one point's (its site-scoped corruption
        plans included)."""
        with self._lock:
            if point is None:
                self._plans.clear()
                return
            self._plans.pop(point, None)
            for key in [k for k in self._plans
                        if k.startswith(point + "@")]:
                self._plans.pop(key, None)

    @staticmethod
    def _ckey(point: str, where: str) -> str:
        return f"{point}@{where}" if where else point

    # ------------------------------------------------------------ firing
    def corruption(self, point: str, where: str = "") -> Optional[dict]:
        """Poll a corruption site (one hit of (point, where)): the due
        plan's payload ``{"mode": "nan" | "flip"}`` or None. Never raises
        or sleeps."""
        key = self._ckey(point, where)
        with self._lock:
            self._hits[key] += 1
            hit = self._hits[key]
            for plan in self._plans.get(key, ()):
                if plan["kind"] != "corrupt" or plan["remaining"] <= 0 \
                        or hit < plan["at"]:
                    continue
                plan["remaining"] -= 1
                self._fired[key] += 1
                return {"mode": plan["mode"]}
        return None

    def fire(self, point: str) -> bool:
        """Run the point's due plans: True iff the caller should drop the
        operation; a raise plan raises, a hang plan sleeps first."""
        hang_s = 0.0
        drop = False
        raise_exc = None
        with self._lock:
            self._hits[point] += 1
            hit = self._hits[point]
            for plan in self._plans.get(point, ()):
                if plan["kind"] == "corrupt" or plan["remaining"] <= 0 \
                        or hit < plan["at"]:
                    continue
                plan["remaining"] -= 1
                self._fired[point] += 1
                if plan["kind"] == "hang":
                    hang_s += plan["seconds"]
                elif plan["kind"] == "drop":
                    drop = True
                elif raise_exc is None:
                    raise_exc = plan["exc"]
        if hang_s > 0.0:
            time.sleep(hang_s)        # outside the lock: arming and the
        if raise_exc is not None:     # counters stay live while hung
            if isinstance(raise_exc, type):
                raise raise_exc(f"injected fault at {point}")
            raise raise_exc
        return drop

    # ---------------------------------------------------------- counters
    def hits(self, point: str) -> int:
        with self._lock:
            return self._hits[point]

    def fired(self, point: str) -> int:
        with self._lock:
            return self._fired[point]

    def counters(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {p: {"hits": self._hits[p], "fired": self._fired[p]}
                    for p in set(self._hits) | set(self._fired)}
