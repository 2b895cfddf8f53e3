"""The fleet tier's exactly-once ledger — :class:`FleetLedger` of the JAX
package's ``streaming/fleet.py``. The rest of that module (the router,
replicas, migration and membership) is ROADMAP queue A8b; the ledger is
here because the journal's recovery fences through it and the
process-kill soak checks a result stream against it."""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional


class FleetLedger:
    """Fleet-wide exactly-once dedup ledger: request id → assigned
    replica, with completion fencing.

    The single-engine supervisor gets exactly-once from in-process lock
    discipline (``_admitting`` parking + quarantine). Across replicas —
    where in a real deployment the router cannot reach into a dead
    process — the ledger is the authority instead:

    - ``assign``/``try_reassign`` record which replica OWNS a request;
      reassignment (migration) refuses if the request already completed,
      so migration and completion are mutually exclusive;
    - ``try_complete(req, replica)`` accepts a completion only from the
      CURRENT assignee and only ONCE — a slow-to-die replica's late
      publish for a migrated request is ``fenced``, a second completion
      is a ``duplicate``; both are counted, never served.

    Completed entries are retained in a bounded LRU window
    (``completed_window``) so late duplicates are still classified after
    the router forgot the live request; beyond the window a stale
    completion still fails the assignee check (fenced).
    """

    def __init__(self, completed_window: int = 4096):
        self._lock = threading.Lock()
        self._assignee: Dict[str, str] = {}
        self._completed: "OrderedDict[str, str]" = OrderedDict()
        self._window = int(completed_window)
        self.duplicates = 0
        self.fenced = 0
        self.reassignments = 0
        self.completed_total = 0

    def assign(self, req_id: str, replica_id: str) -> None:
        with self._lock:
            self._assignee[req_id] = replica_id

    def try_reassign(self, req_id: str, replica_id: str) -> bool:
        """Move ownership (migration). False iff the request already
        completed — the migration must then be abandoned, or a finished
        request would decode (and publish) a second time."""
        with self._lock:
            if req_id in self._completed:
                return False
            self._assignee[req_id] = replica_id
            self.reassignments += 1
            return True

    def try_reassign_from(self, req_id: str, from_replica: str,
                          to_replica: str) -> bool:
        """Conditional ownership move: succeeds only while
        ``from_replica`` still owns the request and it has not
        completed. The disagg tier's handoff fence — a prefill worker
        declared dead (its work re-dispatched) that later ships its
        frames loses this compare-and-swap and the stale handoff is
        dropped instead of forking the stream."""
        with self._lock:
            if req_id in self._completed:
                return False
            if self._assignee.get(req_id) != from_replica:
                return False
            self._assignee[req_id] = to_replica
            self.reassignments += 1
            return True

    def try_complete(self, req_id: str, replica_id: str) -> str:
        """Record a completion attempt; returns ``"ok"`` (first
        completion by the current assignee), ``"duplicate"`` (already
        completed) or ``"fenced"`` (stale replica: the request was
        reassigned away, or was never assigned here)."""
        with self._lock:
            if req_id in self._completed:
                self.duplicates += 1
                return "duplicate"
            if self._assignee.get(req_id) != replica_id:
                self.fenced += 1
                return "fenced"
            self._assignee.pop(req_id, None)
            self._completed[req_id] = replica_id
            self.completed_total += 1
            while len(self._completed) > self._window:
                self._completed.popitem(last=False)
            return "ok"

    def reject_stale(self, req_id: str) -> None:
        """Count a completion from an inner handle migration already
        replaced (identity fencing caught it before the ledger had to)."""
        with self._lock:
            self.fenced += 1

    def assignee(self, req_id: str) -> Optional[str]:
        with self._lock:
            return self._assignee.get(req_id)

    def to_dict(self) -> dict:
        with self._lock:
            return {"open": len(self._assignee),
                    "completed": self.completed_total,
                    "reassignments": self.reassignments,
                    "duplicates": self.duplicates,
                    "fenced": self.fenced}
