"""The replicated engine fleet (the JAX package's ``streaming/fleet.py``):
least-loaded routing over N engine replicas with cross-replica
exactly-once migration and corrupt-replica quarantine.

- :class:`EngineFleetRouter` dispatches prompts to N replicas (bare
  engines or ``EngineSupervisor``-wrapped) by least load, read from each
  replica's live queue-depth / active-slot gauges. Health rides a
  heartbeat protocol: ``ALIVE`` → ``SUSPECT`` after ``suspect_after``
  without a beat → ``DEAD`` after ``dead_after``; a SUSPECT replica
  needs ``recover_beats`` fresh scans to return (hysteresis). The router
  duck-types the engine surface (``submit`` / ``start`` / ``shutdown`` /
  ``stats``), so ``GenerationServingRoute(engine=router)`` serves a
  fleet from a topic in submission order.
- Migration: a replica declared dead has its unfinished requests
  re-dispatched to survivors exactly once. A reachable corpse (crash
  callback, explicit kill) is quarantined and its harvested requests
  requeued object for object (they resume by re-prefilling prompt +
  tokens so far); an unreachable one (heartbeat death, a partition)
  gets clones built from the router's own record. The
  :class:`FleetLedger` (request id → owning replica, completion fencing)
  makes it exactly once fleet-wide: a zombie's late completion is
  ``fenced``, a second completion a ``duplicate``.
- Degradation: the router sheds with ``RejectedError`` only when every
  live replica is saturated; SUSPECT replicas take work only when no
  ALIVE one can. Sticky routing (a consistent hash over the prompt
  prefix's page-chain key, ``models/paging.prefix_route_key``) keeps
  same-prefix prompts on one replica and spills to the ring successor.
- Corruption: a NumericalFault burn past the integrity config's
  threshold, or a golden-canary divergence, quarantines a replica as
  CORRUPT; its streams migrate and a replacement grows.

Every replica built from a net shares ONE ``TransformerDecoder`` (one
copy of the device weights and the same kernels). On one card every
replica's serve thread launches onto the same device; the only waits
are the per-copy events of ``ops/transfer.py``, never the whole device,
and the decoder's dispatch lock lets one replica enqueue a decoder call
at a time (the others sleep on it rather than trade the interpreter lock
at every operator).

Fault points (``parallel/faults.py``): ``fleet.dispatch`` per dispatch
attempt, ``fleet.heartbeat`` per replica beat, ``replica.kill`` per
heartbeat iteration; arm one injector per replica so replicas never
share a hit counter.

:class:`KVFleetMembership` takes any client with ``key_value_set`` /
``key_value_dir_get`` / ``key_value_delete``; ``streaming/remote.py``
supplies one across processes (``CoordinatorKVClient``) and the
process-per-replica deployment (``RemoteFleetRouter``). A replica's
engine may decode over a (data, tp) mesh (``mesh=``, through the shared
decoder); data-parallel training and the sharded trainers are
``parallel/wrapper.py`` and ``parallel/tensor.py`` / ``sequence.py``.
"""

from __future__ import annotations

import bisect
import hashlib
import itertools
import json
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..observability.flightrec import default_flight_recorder
from ..observability.integrity import (GoldenCanary, NumericalFault,
                                       as_integrity)
from ..observability.metrics import default_registry
from ..observability.slo import default_slo_tracker
from ..observability.tracing import (default_trace_ring,
                                     interval_now)
from ..parallel.faults import NULL_INJECTOR, RejectedError

#: replica health states (the membership protocol's vocabulary).
#: CORRUPT is the silent-data-corruption quarantine class: a
#: replica whose NumericalFault burn rate crossed the threshold or
#: whose golden-canary probe diverged — reachable (unlike DEAD-by-
#: partition) but never dispatched to again; its streams migrate to
#: healthy replicas under the same ledger fence as replica death, and
#: the worker is replaced.
REPLICA_ALIVE = "ALIVE"
REPLICA_SUSPECT = "SUSPECT"
REPLICA_DEAD = "DEAD"
REPLICA_CORRUPT = "CORRUPT"

_FLEET_SEQ = itertools.count()
_FLEET_REQ_SEQ = itertools.count(1)

#: fleet counters: metric suffix → help text (one labeled child per
#: router instance, label ``fleet=<id>`` — same registry discipline as
#: the engine/route counters)
_FLEET_COUNTERS = {
    "requests": "requests submitted through the fleet router",
    "migrations": "requests migrated off a dead replica",
    "fenced_completions": "completions rejected by fencing (stale "
                          "replica after migration)",
    "duplicate_completions": "completions rejected as duplicates "
                             "(request already completed)",
    "shed": "requests shed by router-level admission control "
            "(all replicas saturated or dead)",
    "dispatch_errors": "dispatch attempts that failed in transport "
                       "(retried on the next-best replica)",
    "scale_ups": "replicas added live (autoscaler or operator)",
    "scale_downs": "replicas retired live through the graceful "
                   "preemption drain (autoscaler or operator)",
    "corrupt_quarantines": "replicas quarantined as CORRUPT (numerics-"
                           "fault burn rate or golden-canary mismatch); "
                           "their streams migrated to healthy replicas",
}


def _ring_hash(s: str) -> int:
    """Deterministic 64-bit hash (stable across processes — ``hash()``
    is salted per interpreter and would break sticky routing)."""
    return int.from_bytes(hashlib.sha1(s.encode()).digest()[:8], "big")


# --------------------------------------------------------------- ledger
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


# ----------------------------------------------------------- membership
class FleetMembership:
    """In-process membership table: replicas ``beat(rid, load)``, the
    router reads ``ages()`` — seconds since each member's last beat,
    plus the load the beat carried. The transport-crossing variant is
    :class:`KVFleetMembership`; both expose the same surface, so the
    router is membership-agnostic."""

    def __init__(self):
        self._lock = threading.Lock()
        self._beats: Dict[str, Tuple[float, int]] = {}

    def register(self, replica_id: str) -> None:
        self.beat(replica_id, 0)

    def beat(self, replica_id: str, load: int) -> None:
        with self._lock:
            self._beats[replica_id] = (time.monotonic(), int(load))

    def leave(self, replica_id: str) -> None:
        with self._lock:
            self._beats.pop(replica_id, None)

    def ages(self) -> Dict[str, Tuple[float, int]]:
        now = time.monotonic()
        with self._lock:
            return {rid: (now - t, load)
                    for rid, (t, load) in self._beats.items()}


class KVFleetMembership:
    """Membership over a coordinator key-value store: any client with
    ``key_value_set`` / ``key_value_dir_get`` (and, optionally,
    ``key_value_delete``) — the cross-process seam, where replicas in
    separate processes beat through one coordinator.

    The store is WRITE-ONCE, so beats are sequence-numbered keys
    (``dl4j/fleet/<fleet>/<rid>/<epoch>-<seq>``) rather than
    overwrites, and liveness is *sequence advancement observed
    locally*: ``ages()`` reports seconds since this process last saw a
    member's (epoch, seq) move — no cross-host clock is ever compared.
    A member leaves by writing a ``<rid>/left`` tombstone.

    ``epoch`` is a per-boot id (wall-clock milliseconds by default): a
    replica restarted after a whole-process kill starts its seq back at
    1, and without the epoch its first beats would collide with the dead
    incarnation's write-once keys and lose the ``latest`` scan to the
    old incarnation's higher seq. (epoch, seq) pairs order
    lexicographically, so a new boot's first beat supersedes every beat
    of an older one; plain-``<seq>`` keys parse as epoch 0.

    Old beat keys accumulate in a write-once store. With
    ``key_value_delete``, ``ages()`` prunes every ``prune_every`` scans:
    per member all but the newest ``prune_keep`` beat keys go (a
    tombstoned member loses every beat key; the tombstone stays), so a
    long-lived fleet's scan cost stays flat. A client without delete
    keeps every key: beat coarsely through it."""

    def __init__(self, client, fleet_id: str = "fleet0",
                 epoch: Optional[int] = None, prune_keep: int = 4,
                 prune_every: int = 50, scan_retries: int = 3,
                 retry_base: float = 0.05, registry=None):
        self._client = client
        self.fleet_id = str(fleet_id)
        self._prefix = f"dl4j/fleet/{self.fleet_id}/"
        self._lock = threading.Lock()
        # coordinator-unreachability hardening:
        # transient scan/beat failures retry with short backoff; when
        # every attempt fails the store is DEGRADED — the gauge flips
        # to 1, ages() keeps growing from the local cache (members age
        # toward SUSPECT, never silently fresh) and the next successful
        # round heals the gauge back to 0.
        self.scan_retries = max(1, int(scan_retries))
        self.retry_base = float(retry_base)
        reg = registry if registry is not None else default_registry()
        self._g_degraded = reg.gauge(
            "membership_degraded",
            "1 while the coordinator KV store is unreachable "
            "(membership running on the local cache)",
            ("fleet",)).labels(self.fleet_id)
        # boot id: unique per incarnation (ms wall clock — collisions
        # would need two boots of the SAME replica id within 1ms). A
        # host whose clock stepped BACKWARD across the restart (pre-NTP
        # boot window) would mint a lower epoch and lose every (epoch,
        # seq) comparison to the dead incarnation — the first beat
        # scans the store once and bumps past any observed epoch.
        self.epoch = int(time.time() * 1000) if epoch is None \
            else int(epoch)
        self._epoch_ready = False
        self._seq: Dict[str, int] = {}
        # rid -> [last (epoch, seq) seen, local time it changed, load]
        self._seen: Dict[str, List] = {}
        # beat-key pruning: superseded keys deleted every
        # prune_every scans when the client supports it
        self.prune_keep = max(1, int(prune_keep))
        self.prune_every = max(1, int(prune_every))
        self._scan_count = 0
        self.pruned_keys = 0

    def register(self, replica_id: str) -> None:
        self.beat(replica_id, 0)

    @property
    def degraded(self) -> bool:
        return bool(self._g_degraded.value)

    def _scan_with_retry(self):
        """One coordinator dir scan, retried ``scan_retries`` times with
        exponential backoff on ANY failure. Success heals the degraded
        gauge; total failure trips it and returns None (callers fall
        back to the local cache). Never raises — a scan exception must
        not kill the router's monitor thread."""
        delay = self.retry_base
        for attempt in range(self.scan_retries):
            try:
                entries = self._client.key_value_dir_get(self._prefix)
            except Exception:   # noqa: BLE001 — unreachable coordinator
                if attempt + 1 < self.scan_retries:
                    time.sleep(delay)
                    delay *= 2
                continue
            self._g_degraded.set(0)
            return entries
        self._g_degraded.set(1)
        return None

    def _max_observed_epoch(self) -> int:
        entries = self._scan_with_retry()
        if entries is None:          # no scan: trust the wall clock
            return -1
        mx = -1
        for key, _ in entries:
            rest = str(key)[len(self._prefix):] \
                if str(key).startswith(self._prefix) else str(key)
            _, _, tail = rest.partition("/")
            ep_s, dash, _ = tail.partition("-")
            if dash:
                try:
                    mx = max(mx, int(ep_s))
                except ValueError:
                    continue
        return mx

    def beat(self, replica_id: str, load: int) -> None:
        with self._lock:
            ready = self._epoch_ready
            self._epoch_ready = True
        if not ready:
            # one-time monotonicity guard: our epoch must exceed every
            # epoch already in the store, or a backward-stepped clock
            # recreates the permanently-dead-rejoin bug epochs fix
            mx = self._max_observed_epoch()
            with self._lock:
                if mx >= self.epoch:
                    self.epoch = mx + 1
        with self._lock:
            self._seq[replica_id] = self._seq.get(replica_id, 0) + 1
            seq = self._seq[replica_id]
        payload = json.dumps({"load": int(load), "epoch": self.epoch})
        key = f"{self._prefix}{replica_id}/{self.epoch:016d}-{seq:08d}"
        delay = self.retry_base
        for attempt in range(self.scan_retries):
            try:
                self._client.key_value_set(key, payload)
                self._g_degraded.set(0)
                return
            except (OSError, ConnectionError):
                # coordinator unreachable: retry the SAME key with
                # backoff, then count the beat as missed and flip the
                # degraded gauge (members age toward SUSPECT — honest)
                if attempt + 1 < self.scan_retries:
                    time.sleep(delay)
                    delay *= 2
            except Exception:   # noqa: BLE001 — a dup key (two beaters
                return          # sharing an epoch) is a missed beat,
                                # not unreachability: no retry, no gauge
        self._g_degraded.set(1)

    def leave(self, replica_id: str) -> None:
        try:
            self._client.key_value_set(
                f"{self._prefix}{replica_id}/left", "1")
        except Exception:   # noqa: BLE001 — second leave: already gone
            pass

    def ages(self) -> Dict[str, Tuple[float, int]]:
        # retried scan; on total failure ages keep growing from the
        # local cache and the degraded gauge reads 1 until a scan lands
        entries = self._scan_with_retry()
        now = time.monotonic()
        prune: Optional[Dict[str, List]] = None
        with self._lock:
            if entries is not None:
                self._scan_count += 1
                # superseded-key pruning: every prune_every scans,
                # collect EVERY beat key per member so the pass below —
                # outside this lock, deletes are I/O — can drop all but
                # the newest prune_keep
                collect = self._scan_count % self.prune_every == 0 and \
                    getattr(self._client, "key_value_delete",
                            None) is not None
                all_keys: Dict[str, List] = {}
                latest: Dict[str, Tuple[Tuple[int, int], str]] = {}
                left = set()
                for key, val in entries:
                    rest = str(key)[len(self._prefix):] \
                        if str(key).startswith(self._prefix) else str(key)
                    rid, _, tail = rest.partition("/")
                    if tail == "left":
                        left.add(rid)
                        continue
                    # epoch-seq beat key; a plain-seq key parses as
                    # epoch 0, so a rejoining
                    # boot's first beat always supersedes it
                    ep_s, dash, seq_s = tail.partition("-")
                    try:
                        stamp = (int(ep_s), int(seq_s)) if dash \
                            else (0, int(tail))
                    except ValueError:
                        continue
                    if collect:
                        all_keys.setdefault(rid, []).append(
                            (stamp, str(key)))
                    if stamp > latest.get(rid, ((-1, -1), ""))[0]:
                        latest[rid] = (stamp, val)
                for rid in left:
                    self._seen.pop(rid, None)
                    latest.pop(rid, None)
                for rid, (stamp, val) in latest.items():
                    rec = self._seen.get(rid)
                    if rec is None or rec[0] != stamp:
                        # payload parsed only on (epoch, seq)
                        # ADVANCEMENT — an unchanged stamp is the same
                        # beat (same load); a NEW epoch with a lower seq
                        # (process restart) advances like any fresh beat
                        # instead of being discarded as a regression
                        try:
                            load = int(json.loads(val).get("load", 0))
                        except (ValueError, TypeError):
                            continue
                        self._seen[rid] = [stamp, now, load]
                if collect:
                    prune = all_keys
                    for rid in left:    # tombstoned: EVERY beat key of
                        if rid in prune:   # the dead incarnation goes
                            prune[rid].append(("left", None))
            result = {rid: (now - t, load)
                      for rid, (_, t, load) in self._seen.items()}
        if prune:
            self._prune(prune)
        return result

    def _prune(self, all_keys: Dict[str, List]) -> None:
        """Delete superseded beat keys (outside the membership lock —
        deletes are coordinator I/O): per member, keep the newest
        ``prune_keep`` (epoch, seq) stamps; a member whose list carries
        the ``left`` marker is tombstoned and loses every beat key.
        Best-effort — a failed delete is retried by a later pass."""
        delete = getattr(self._client, "key_value_delete", None)
        if delete is None:                    # pragma: no cover
            return
        removed = 0
        for rid, stamps in all_keys.items():
            tombstoned = any(s == "left" for s, _ in stamps)
            beats = sorted((s for s in stamps if s[0] != "left"),
                           reverse=True)
            keep = 0 if tombstoned else self.prune_keep
            for _, key in beats[keep:]:
                try:
                    delete(key)
                    removed += 1
                except Exception:   # noqa: BLE001 — raced another
                    continue        # pruner / key already gone
        with self._lock:
            self.pruned_keys += removed


# -------------------------------------------------------------- replica
class EngineReplica:
    """One fleet member: a ``SlotGenerationEngine`` (bare) or an
    ``EngineSupervisor`` wrapping one (restart-in-place is then the
    first line of defense; the fleet only migrates when the whole
    replica dies), plus the heartbeat thread that publishes this
    replica's liveness + load into the membership table.

    ``reachable`` models the transport: a crash the router OBSERVES
    (crash callback, explicit kill) leaves a reachable corpse that can
    be quarantined and harvested; a heartbeat death is treated as a
    partition — the engine may still be running (zombie), so migration
    re-dispatches clones and relies on ledger fencing instead."""

    def __init__(self, replica_id: str, engine, membership,
                 fault_injector=None, heartbeat_interval: float = 0.05):
        self.replica_id = str(replica_id)
        self.engine = engine
        self.supervised = hasattr(engine, "_sup_lock")
        inner = engine.engine if self.supervised else engine
        self.capacity = int(inner.max_pending) + int(inner.num_slots)
        self.slots = int(inner.num_slots)   # decode capacity — the
        #                                     autoscaler's utilization
        #                                     denominator
        self.reachable = True
        self._membership = membership
        self._faults = fault_injector if fault_injector is not None \
            else NULL_INJECTOR
        self.heartbeat_interval = float(heartbeat_interval)
        self._stop_hb = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._on_kill = None        # callable(replica_id, exc) — router

    # ----------------------------------------------------------- engine
    def submit(self, *args, **kwargs):
        return self.engine.submit(*args, **kwargs)

    def requeue(self, req) -> None:
        self.engine.requeue(req)

    def adopt(self, req, kv) -> None:
        """KV-handoff receive (disagg decode role): bare engines and
        supervisors both expose ``adopt``."""
        self.engine.adopt(req, kv)

    def quarantine(self):
        return self.engine.quarantine()

    def shutdown(self) -> None:
        self.stop_heartbeat()
        try:
            if self.supervised:
                self.engine.stop()
            else:
                self.engine.shutdown()
        except Exception:   # noqa: BLE001 — a dead replica's teardown
            pass            # must not abort the fleet's

    def given_up(self) -> Optional[BaseException]:
        return self.engine.given_up if self.supervised else None

    def dead(self) -> bool:
        """True when the engine cannot accept work RIGHT NOW (worker
        crashed, shut down, or a supervisor out of restart budget).
        ``submit`` on such an engine fast-fails the request with the
        replica-local death cause; the router must not deliver that to
        the caller while healthy replicas exist — it spills instead."""
        if self.supervised and self.engine.given_up is not None:
            return True
        eng = self.engine.engine if self.supervised else self.engine
        try:
            with eng._lock:
                return bool(eng._shutdown) or eng._dead is not None
        except Exception:   # noqa: BLE001 — unreadable == not taking work
            return True

    def load(self) -> Optional[int]:
        """Live load (queued + decoding) from the replica's own gauges —
        the number the ``/snapshot`` endpoint serves. ``None`` means the
        replica could not be read (unreachable): callers fall back to
        the membership table's last beat-carried load."""
        try:
            s = self.engine.stats()
            return int(s.get("queue_depth", 0)) + \
                int(s.get("active_slots", 0))
        except Exception:   # noqa: BLE001
            return None

    # -------------------------------------------------------- heartbeat
    def start(self) -> "EngineReplica":
        self.engine.start()
        self._membership.register(self.replica_id)
        if self._hb_thread is None or not self._hb_thread.is_alive():
            self._stop_hb.clear()
            self._hb_thread = threading.Thread(
                target=self._hb_loop, daemon=True,
                name=f"fleet-hb-{self.replica_id}")
            self._hb_thread.start()
        return self

    def stop_heartbeat(self) -> None:
        self._stop_hb.set()

    def _hb_loop(self) -> None:
        while not self._stop_hb.wait(self.heartbeat_interval):
            try:
                # scripted hard kill: a raise here is the replica dying
                # between beats; the router is told and migrates NOW
                self._faults.fire("replica.kill")
            except BaseException as exc:   # noqa: BLE001 — scripted
                cb = self._on_kill
                if cb is not None:
                    cb(self.replica_id, exc)
                return
            try:
                # hang → a momentarily-slow replica (SUSPECT then
                # recovery); drop → a silent one (SUSPECT then DEAD)
                drop = self._faults.fire("fleet.heartbeat")
            except Exception:   # noqa: BLE001 — an injected raise is a
                drop = True     # missed beat, never a dead hb thread
            if drop:
                continue
            load = self.load()
            if load is not None:
                self._membership.beat(self.replica_id, load)


# -------------------------------------------------------- fleet request
class FleetRequest:
    """Fleet-level request handle: survives cross-replica migration.

    Wraps the current replica-local ``GenerationRequest`` (``_inner``);
    migration may swap the inner handle (clone-based re-dispatch), but
    THIS object is what the caller — and the in-order route publisher —
    holds, so ordering and ``result()`` semantics are untouched by
    replica death. The trace rides the inner request(s): migration
    shares one trace object across inners, keeping the
    one-trace-per-request contract (with ``migrate`` spans at the
    seams)."""

    PENDING = "PENDING"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"

    def __init__(self, prompt, max_new_tokens: int, temperature: float,
                 eos_id: Optional[int], deadline: Optional[float] = None,
                 sticky_key=None):
        self.request_id = f"flt{next(_FLEET_REQ_SEQ)}"
        self.prompt = np.asarray(prompt, np.int64).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.deadline = None if deadline is None else float(deadline)
        self._deadline_t = None if deadline is None \
            else interval_now() + float(deadline)
        self.sticky_key = sticky_key
        self._created_t = interval_now()   # original submission clock
        self.migrations = 0
        self.replica_id: Optional[str] = None
        self._inner = None
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._result: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self._cancel_requested = False

    # ------------------------------------------------------------ views
    @property
    def trace(self):
        with self._lock:
            inner = self._inner
        return None if inner is None else inner.trace

    def done(self) -> bool:
        return self._done.is_set()

    @property
    def state(self) -> str:
        from ..parallel.faults import Cancelled
        if self._done.is_set():
            if self._error is None:
                return self.DONE
            if isinstance(self._error, Cancelled):
                return self.CANCELLED
            return self.FAILED
        with self._lock:
            inner = self._inner
        if inner is not None and inner._running:
            return self.RUNNING
        return self.PENDING

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError("generation not finished")
        if self._error is not None:
            raise self._error
        return self._result

    def cancel(self) -> bool:
        if self._done.is_set():
            return False
        with self._lock:
            self._cancel_requested = True
            inner = self._inner
        if inner is not None:
            inner.cancel()
        return True

    # -------------------------------------------------------- internals
    def _complete(self, result: np.ndarray) -> None:
        self._result = result
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._done.set()

    def __repr__(self) -> str:
        mig = "" if not self.migrations else f" migrations={self.migrations}"
        return (f"<FleetRequest {self.request_id} {self.state} "
                f"replica={self.replica_id}{mig}>")


# --------------------------------------------------------------- router
class EngineFleetRouter:
    """Least-loaded router over N engine replicas with health-tracked
    membership, cross-replica exactly-once migration, and router-level
    admission control. Duck-types the engine surface
    (``submit``/``start``/``shutdown``/``stats``), so it drops into
    ``GenerationServingRoute(engine=router)`` unchanged — the fleet
    serves a topic with in-order publishing across migrations.

    Build it from a net (N engines sharing ONE ``TransformerDecoder``,
    so every replica runs the same weights and kernels — migration
    re-serves token-identical greedy outputs and builds nothing new) or hand it prebuilt ``replicas=[engine_or_supervisor, ...]``.

    ``supervised=True`` wraps each replica in an ``EngineSupervisor``:
    crash/wedge restarts stay replica-local and the fleet only migrates
    when a whole replica is lost. ``sticky_prefix=k`` enables sticky
    routing on the first k prompt tokens (consistent hash; overridable
    per ``submit(sticky_key=...)``); saturation or death spills a key to
    its ring successor, deterministically."""

    def __init__(self, net=None, num_replicas: int = 2, *,
                 replicas: Optional[List] = None, decoder=None,
                 num_slots: int = 8, t_max: Optional[int] = None,
                 block_size: int = 1, max_pending: int = 256,
                 refill: bool = True, seed: int = 0,
                 supervised: bool = False,
                 supervisor_timeout: float = 10.0,
                 max_restarts: int = 3,
                 membership=None, fleet_id: Optional[str] = None,
                 fault_injector=None,
                 replica_injectors: Optional[List] = None,
                 heartbeat_interval: float = 0.05,
                 monitor_interval: float = 0.05,
                 suspect_after: float = 0.25, dead_after: float = 1.0,
                 recover_beats: int = 3,
                 sticky_prefix: Optional[int] = None,
                 completed_window: int = 4096,
                 registry=None, trace_store=None, tracing: bool = True,
                 slo_tracker=None, flight_recorder=None,
                 postmortem_dir: Optional[str] = None,
                 journal=None, scheduling: str = "fifo",
                 shed_headroom: bool = False,
                 headroom_margin: float = 1.0,
                 prefill_chunk: Optional[int] = None,
                 adaptive_block: bool = False,
                 block_ladder=None,
                 block_latency_target: float = 0.25,
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 profiler=None, profiling: Optional[bool] = None,
                 sticky_page_size: Optional[int] = None,
                 engine_factory=None,
                 replica_ids: Optional[List[str]] = None,
                 integrity=None, speculative: bool = False,
                 spec_k: Optional[int] = None, spec_ngram: int = 3,
                 spec_threshold: float = 0.35,
                 spec_probe_every: int = 16):
        self.fleet_id = fleet_id if fleet_id is not None \
            else f"fleet{next(_FLEET_SEQ)}"
        # ---- silent-data-corruption defense ----
        # threaded to every replica engine (sentinel + page
        # verification); at fleet level it arms the NumericalFault
        # burn-rate quarantine, the golden-canary prober, and
        # corrupt-replica replacement
        self._integrity = as_integrity(integrity)
        self._fault_times: Dict[str, deque] = {}
        self._canary: Optional[GoldenCanary] = None
        self._canary_ok: Dict[str, float] = {}
        self._canary_thread: Optional[threading.Thread] = None
        self._stop_canary = threading.Event()
        self._registry = registry if registry is not None \
            else default_registry()
        self._trace_store = trace_store if trace_store is not None \
            else default_trace_ring()
        self._tracing = bool(tracing)
        # SLO + flight-recorder sinks: one shared tracker with
        # per-replica labels (fleet_stats() reads attainment per replica
        # from it — routing data and SLO data in ONE document), one
        # shared event ring, and — with a post-mortem dir — a JSON
        # artifact per replica death bundling the victims' traces
        self._slo_tracker = slo_tracker if slo_tracker is not None \
            else default_slo_tracker()
        self._flightrec = flight_recorder if flight_recorder is not None \
            else default_flight_recorder()
        self._postmortem_dir = postmortem_dir
        # durable request journal: ONE shared WAL for the
        # whole fleet (appends are journal-lock serialized); dispatches
        # journal under the FLEET request id, so a restarted process's
        # recovery and a surviving router's clone re-dispatch are
        # arbitrated by the same ledger fence over the same ids
        self._journal = journal
        self._faults = fault_injector if fault_injector is not None \
            else NULL_INJECTOR
        self._membership = membership if membership is not None \
            else FleetMembership()
        self._ledger = FleetLedger(completed_window=completed_window)
        self.monitor_interval = float(monitor_interval)
        self.suspect_after = float(suspect_after)
        self.dead_after = float(dead_after)
        self.recover_beats = int(recover_beats)
        self.sticky_prefix = sticky_prefix if sticky_prefix is None \
            else int(sticky_prefix)
        # sticky keys hash through the SAME content chain the replicas'
        # prefix caches use (models/paging.chain_digests), at the same
        # page boundaries — so the requests this router groups onto one
        # replica are exactly the requests whose pages that replica can
        # share. Default page size follows the replicas' pools.
        from ..models.paging import DEFAULT_PAGE_SIZE
        self.sticky_page_size = int(sticky_page_size) \
            if sticky_page_size is not None \
            else (int(page_size) if paged else DEFAULT_PAGE_SIZE)

        # ---------------------------------------------------- replicas
        self.heartbeat_interval = float(heartbeat_interval)
        self._engine_factory = engine_factory
        if net is not None and replicas is None:
            from ..models.generation import (SlotGenerationEngine,
                                             TransformerDecoder)
            if decoder is None:
                # sentinel decoders carry the verdict column in their
                # impls — ONE shared decoder means every replica (built
                # now or grown later) runs the same defended programs
                icfg = self._integrity
                decoder = TransformerDecoder(
                    net, t_max=t_max,
                    sentinel=icfg is not None and icfg.sentinel,
                    logit_bound=None if icfg is None
                    else icfg.logit_bound)
            shared_decoder = decoder

            def _build_engine(rid: str, fault_injector=None):
                # ONE shared decoder across every replica — built now
                # AND scaled up later — so migration is token-identical
                # and a grown replica builds nothing
                eng = SlotGenerationEngine(
                    net, num_slots=num_slots, refill=refill, seed=seed,
                    decoder=shared_decoder, max_pending=max_pending,
                    fault_injector=fault_injector, block_size=block_size,
                    registry=self._registry,
                    trace_store=self._trace_store, tracing=self._tracing,
                    slo=self._slo_tracker, slo_label=rid,
                    flight_recorder=self._flightrec,
                    journal=journal, scheduling=scheduling,
                    shed_headroom=shed_headroom,
                    headroom_margin=headroom_margin,
                    prefill_chunk=prefill_chunk,
                    adaptive_block=adaptive_block,
                    block_ladder=block_ladder,
                    block_latency_target=block_latency_target,
                    paged=paged, page_size=page_size,
                    num_pages=num_pages, prefix_cache=prefix_cache,
                    # phase profiler: forwarded like every
                    # other sink — replica channels key on rid (the
                    # slo_label), so one injected profiler carries the
                    # whole fleet's phase account
                    profiler=profiler, profiling=profiling,
                    integrity=self._integrity,
                    # speculative decoding: every replica —
                    # built now or grown later — drafts against the
                    # SAME shared decoder's verify impls, so migration
                    # stays token-identical (acceptance is exact-match
                    # against the model's own selections) and a grown
                    # replica builds nothing
                    speculative=speculative, spec_k=spec_k,
                    spec_ngram=spec_ngram,
                    spec_threshold=spec_threshold,
                    spec_probe_every=spec_probe_every)
                if supervised:
                    from ..parallel.failures import EngineSupervisor
                    eng = EngineSupervisor(
                        eng, timeout=supervisor_timeout,
                        max_restarts=max_restarts,
                        name=f"{self.fleet_id}:{rid}",
                        postmortem_dir=postmortem_dir)
                return eng
            if self._engine_factory is None:
                self._engine_factory = _build_engine
        engines = replicas
        if engines is None:
            if net is None:
                raise ValueError("EngineFleetRouter needs a net (to build "
                                 "replicas) or prebuilt replicas=[...]")
            engines = []
            for i in range(int(num_replicas)):
                inj = None if replica_injectors is None \
                    else replica_injectors[i]
                engines.append(self._engine_factory(f"r{i}",
                                                    fault_injector=inj))
        if replica_ids is not None and len(replica_ids) != len(engines):
            raise ValueError(f"replica_ids has {len(replica_ids)} names "
                             f"for {len(engines)} replicas")
        self._next_ridx = itertools.count(len(engines))
        self._replicas: Dict[str, EngineReplica] = {}
        for i, eng in enumerate(engines):
            # prebuilt replicas get the injector too: the heartbeat/kill
            # points live on the EngineReplica, not the engine
            inj = None if replica_injectors is None \
                else replica_injectors[i]
            rid = f"r{i}" if replica_ids is None else str(replica_ids[i])
            rep = EngineReplica(rid, eng, self._membership,
                                fault_injector=inj,
                                heartbeat_interval=heartbeat_interval)
            rep._on_kill = self._on_replica_kill
            self._replicas[rep.replica_id] = rep

        # ------------------------------------------------ health state
        self._lock = threading.Lock()
        self._health: Dict[str, dict] = {
            rid: {"state": REPLICA_ALIVE, "fresh": 0, "load": 0,
                  "age": 0.0} for rid in self._replicas}
        self._dead_handled: set = set()
        # rid -> death cause; written only under _migrate_lock, read by
        # _bind's retired-replica re-check (also under _migrate_lock)
        self._death_cause: Dict[str, BaseException] = {}
        self._live: Dict[str, FleetRequest] = {}
        # serializes migrations; REENTRANT because a requeue inside
        # _redispatch can fast-fail synchronously (destination died in
        # the dispatch window) and re-enter migration through the
        # done-callback completion gate in this same thread
        self._migrate_lock = threading.RLock()
        self._monitor: Optional[threading.Thread] = None
        self._stop_monitor = threading.Event()
        self._started = False
        self._shutdown_flag = False

        # ------------------------------------------------- sticky ring
        self._ring: List[Tuple[int, str]] = self._build_ring()

        # ------------------------------------------------------ metrics
        reg = self._registry
        self._m = {key: reg.counter(f"fleet_{key}_total", desc,
                                    ("fleet",)).labels(self.fleet_id)
                   for key, desc in _FLEET_COUNTERS.items()}
        self._g_replicas = reg.gauge(
            "fleet_replicas", "fleet replicas by health state",
            ("fleet", "state"))
        # canary visibility: probe outcomes + per-replica staleness
        self._m_canary = reg.counter(
            "integrity_canary_probes_total",
            "golden-canary probes, by outcome "
            "(ok / mismatch / fault / skipped)",
            ("fleet", "outcome"))
        self._g_canary_age = reg.gauge(
            "integrity_canary_age_seconds",
            "seconds since the replica's last CLEAN golden-canary probe",
            ("fleet", "replica"))
        self._update_gauges_locked_init()

    def _update_gauges_locked_init(self) -> None:
        with self._lock:
            self._update_gauges_locked()

    def _update_gauges_locked(self) -> None:
        # caller holds self._lock
        counts = {REPLICA_ALIVE: 0, REPLICA_SUSPECT: 0,
                  REPLICA_DEAD: 0, REPLICA_CORRUPT: 0}
        for h in self._health.values():
            counts[h["state"]] += 1
        for state, n in counts.items():
            self._g_replicas.labels(self.fleet_id, state).set(n)

    # ------------------------------------------------------------ intake
    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               deadline: Optional[float] = None, *,
               sticky_key=None, replica_id: Optional[str] = None,
               route: Optional[str] = None) -> FleetRequest:
        """Dispatch to the best replica; returns a :class:`FleetRequest`
        (already failed with :class:`RejectedError` when the whole fleet
        is saturated — mirror of the engine's shed contract, so the
        serving route's publisher counts it as shed, not an error).

        ``sticky_key`` overrides the prompt-prefix sticky key;
        ``replica_id`` pins the request to one replica (falls back to
        least-loaded only if that replica cannot take it)."""
        fr = FleetRequest(prompt, max_new_tokens, temperature, eos_id,
                          deadline=deadline, sticky_key=sticky_key)
        self._m["requests"].inc()
        with self._lock:
            stopped = self._shutdown_flag
        if stopped:
            fr._fail(RuntimeError("EngineFleetRouter shut down"))
            return fr
        key = sticky_key
        if key is None and self.sticky_prefix:
            # the prefix-cache content hash, not a token join: the ring
            # key and the replicas' page-chain keys are ONE function
            # (models/paging), so sticky routing concentrates exactly
            # the prompts whose prefix pages can be shared
            from ..models.paging import prefix_route_key
            key = prefix_route_key(fr.prompt[:self.sticky_prefix],
                                   self.sticky_page_size)
        order, loads = self._dispatch_order(prefer=replica_id,
                                            sticky_key=key)
        total_depth = 0
        for rep in order:
            ld = loads.get(rep.replica_id)
            if ld is None:
                continue                      # unreadable: skip
            if ld >= rep.capacity:
                total_depth += ld             # saturated: spill onward
                continue
            try:
                if self._faults.fire("fleet.dispatch"):
                    self._m["dispatch_errors"].inc()
                    continue                  # injected lost frame
            except Exception:   # noqa: BLE001 — injected transport error
                self._m["dispatch_errors"].inc()
                continue
            # _slo_sync_fail=False: a spilled-past synchronous fast-fail
            # (queue-full race, dead engine) must not SLO-account a
            # request the fleet goes on to serve elsewhere — sync
            # outcomes the fleet DOES propagate are accounted by the
            # completion gate (_on_inner_done) instead
            # journal_id=fleet id: the WAL and the exactly-once ledger
            # speak the same id space, so post-restart recovery is
            # fenced against clone re-dispatch by the same arbiter
            inner = rep.submit(fr.prompt, fr.max_new_tokens,
                               temperature=fr.temperature,
                               eos_id=fr.eos_id, deadline=fr.deadline,
                               route=route, journal_id=fr.request_id,
                               _slo_sync_fail=False)
            err = inner._error if inner.done() else None
            if isinstance(err, RejectedError):
                total_depth += rep.capacity   # raced to saturation
                continue
            if err is not None and rep.dead():
                # the replica died between the health read and this
                # dispatch: its fast-fail carries the crash cause, which
                # must not reach the caller while another replica can
                # serve — spill onward (a genuine synchronous failure,
                # e.g. validation, still binds and propagates below)
                self._m["dispatch_errors"].inc()
                continue
            self._bind(fr, inner, rep)
            return fr
        # every replica saturated, dead, or unreadable: router-level shed
        self._m["shed"].inc()
        # per-replica depths + health states ride the rejection: callers
        # and the autoscaler can tell GLOBAL saturation (every replica
        # deep) from imbalance (one hot replica, the rest dead) without
        # re-scraping the fleet
        with self._lock:
            detail = {rid: {"depth": loads.get(rid),
                            "capacity": self._replicas[rid].capacity
                            if rid in self._replicas else None,
                            "state": h["state"]}
                      for rid, h in self._health.items()}
        self._flightrec.record("shed", fleet=self.fleet_id,
                               queue_depth=total_depth)
        # a router-shed request was never accepted by an engine (inner
        # sync-fails run unarmed, _slo_sync_fail=False, so the spilled
        # handles recorded nothing) — the fleet records the ONE miss
        self._slo_tracker.record(
            "shed", latency=interval_now() - fr._created_t,
            headroom=None if fr._deadline_t is None
            else fr._deadline_t - interval_now(), route=route)
        fr._fail(RejectedError(
            f"fleet {self.fleet_id}: all {len(self._replicas)} replicas "
            f"saturated or dead — request shed",
            queue_depth=total_depth, replica_depths=detail))
        return fr

    def _bind(self, fr: FleetRequest, inner, rep: EngineReplica) -> None:
        with fr._lock:
            fr._inner = inner
            fr.replica_id = rep.replica_id
        self._ledger.assign(fr.request_id, rep.replica_id)
        with self._lock:
            self._live[fr.request_id] = fr
            retired = rep.replica_id in self._dead_handled
        tr = inner.trace
        if tr is not None:
            tr.event("dispatch", fleet=self.fleet_id,
                     replica=rep.replica_id)
        inner.add_done_callback(
            lambda r, _fr=fr: self._on_inner_done(_fr, r))
        if retired:
            # the replica was retired between rep.submit() and this
            # bind, so _migrate's victim snapshot could not include fr —
            # a request the engine accepted (and quarantine may already
            # have harvested) would otherwise be stranded forever.
            # Migrate it here; _redispatch's src-assignee re-check under
            # _migrate_lock makes this and a racing victim-loop pass
            # mutually exclusive, so the inner is requeued exactly once.
            with self._migrate_lock:
                cause = self._death_cause.get(rep.replica_id) \
                    or RuntimeError(f"replica {rep.replica_id} retired")
                if self._redispatch(fr, rep, cause):
                    self._m["migrations"].inc()

    def _dispatch_order(self, prefer: Optional[str] = None,
                        sticky_key=None, rids=None
                        ) -> Tuple[List[EngineReplica], Dict[str, int]]:
        """Candidate replicas in dispatch-preference order, plus their
        observed loads. Base policy: ALIVE by ascending load, then
        SUSPECT by ascending load (a slow replica takes traffic only
        when no healthy one can), DEAD never. A sticky key reorders the
        live set to its consistent-hash ring walk; an explicit pin goes
        first. ``rids`` restricts candidates to a subset — the disagg
        tier's role pools (PhaseRouter) filter through it."""
        with self._lock:
            states = {rid: h["state"] for rid, h in self._health.items()}
            beat_loads = {rid: h["load"] for rid, h in
                          self._health.items()}
            reps = dict(self._replicas)
        if rids is not None:
            allowed = set(rids)
            reps = {rid: rep for rid, rep in reps.items()
                    if rid in allowed}
        loads: Dict[str, int] = {}
        for rid, rep in reps.items():
            if states[rid] in (REPLICA_DEAD, REPLICA_CORRUPT):
                continue      # a CORRUPT replica never takes dispatch
            ld = rep.load()
            if ld is None:
                ld = beat_loads.get(rid)      # fall back to last beat
            if ld is not None:
                loads[rid] = int(ld)
        alive = sorted((rid for rid in loads
                        if states[rid] == REPLICA_ALIVE),
                       key=lambda r: (loads[r], r))
        suspect = sorted((rid for rid in loads
                          if states[rid] == REPLICA_SUSPECT),
                         key=lambda r: (loads[r], r))
        if sticky_key is not None:
            # ring preference applies WITHIN each health class: a
            # SUSPECT ring-owner must not hold its sticky traffic while
            # an ALIVE replica can take it (degradation-ladder contract)
            rank = {rid: i for i, rid in
                    enumerate(self._ring_walk(str(sticky_key)))}
            alive.sort(key=lambda r: rank[r])
            suspect.sort(key=lambda r: rank[r])
        order = alive + suspect
        if prefer is not None and prefer in loads:
            order = [prefer] + [r for r in order if r != prefer]
        return [reps[rid] for rid in order], loads

    def _build_ring(self) -> List[Tuple[int, str]]:
        """Consistent-hash ring over the CURRENT replica set (32 virtual
        nodes each) — rebuilt on scale up/down, so a grown fleet takes
        its share of sticky keys and a retired replica's keys fall to
        their ring successors deterministically."""
        return sorted((_ring_hash(f"{rid}#{v}"), rid)
                      for rid in self._replicas for v in range(32))

    def _ring_walk(self, key: str) -> List[str]:
        """All replica ids in consistent-hash preference order for
        ``key`` (first = owner, rest = successors — the spill order on
        saturation or death)."""
        h = _ring_hash(key)
        idx = bisect.bisect(self._ring, (h, ""))
        seen: List[str] = []
        for i in range(len(self._ring)):
            _, rid = self._ring[(idx + i) % len(self._ring)]
            if rid not in seen:
                seen.append(rid)
        return seen

    # -------------------------------------------------------- completion
    def _on_inner_done(self, fr: FleetRequest, inner) -> None:
        """Done-callback from a replica engine: the fleet's completion
        gate. The inner-identity check fences handles migration already
        replaced; the ledger fences replica-level staleness and
        duplicates. A failure delivered by a replica that is itself dead
        (the destination died inside the dispatch window and fast-failed
        the requeue) is re-migrated instead of accepted — survivors must
        mask a dead replica's cause here exactly as submit() does.
        Accept exactly once, then finish the fleet request."""
        with fr._lock:
            if inner is not fr._inner:
                # a clone superseded this handle (zombie's late publish)
                self._ledger.reject_stale(fr.request_id)
                self._m["fenced_completions"].inc()
                return
            err = inner._error
            rid = fr.replica_id
            cancelled = fr._cancel_requested
        if err is not None and not cancelled and \
                isinstance(err, NumericalFault) and \
                fr.migrations < len(self._replicas):
            # silent-data-corruption verdict: the engine
            # dropped the poisoned tokens and failed the request typed.
            # Fleet response: account the replica's fault burn (which
            # may CORRUPT-quarantine it, migrating every live stream
            # incl. this one), then make sure THIS request resumes on
            # a healthy replica — a caller sees a NumericalFault only
            # when no survivor exists.
            with self._lock:
                stopping = self._shutdown_flag
            rep = self._replicas.get(rid)
            if not stopping and rep is not None:
                self._note_numerical_fault(rid, err)
                with self._migrate_lock:
                    if self._redispatch(fr, rep, err):
                        self._m["migrations"].inc()
                        return
                if fr.done():
                    return      # settled while deciding (no-survivor)
                # else: the quarantine's victim loop already migrated
                # it — fall through; the inner-identity gate below
                # classifies this stale handle as fenced
        if err is not None and not cancelled \
                and not isinstance(err, RejectedError) \
                and fr.migrations < len(self._replicas):
            with self._lock:
                stopping = self._shutdown_flag
            rep = self._replicas.get(rid)
            if not stopping and rep is not None and rep.dead():
                with self._migrate_lock:
                    if self._redispatch(fr, rep, err):
                        self._m["migrations"].inc()
                        return
                if fr.done():
                    return      # settled while deciding (the
                                # no-survivor path completes the ledger)
        with fr._lock:
            if inner is not fr._inner:
                # migration replaced the handle while we were deciding
                self._ledger.reject_stale(fr.request_id)
                self._m["fenced_completions"].inc()
                return
            verdict = self._ledger.try_complete(fr.request_id,
                                                fr.replica_id)
            if verdict != "ok":
                self._m["duplicate_completions" if verdict == "duplicate"
                        else "fenced_completions"].inc()
                return
            err = inner._error
            if err is not None:
                fr._fail(err)
            else:
                fr._complete(inner._result)
        if not inner._slo_done:
            # the inner settled synchronously before its tracker was
            # armed (_slo_sync_fail=False: validation error, instant
            # zero-token complete) and the fleet is propagating that
            # outcome — account it exactly once here
            from ..models.generation import GenerationRequest
            inner._slo = self._slo_tracker
            inner._notify_slo("ok" if err is None
                              else GenerationRequest._slo_status(err))
        with self._lock:
            self._live.pop(fr.request_id, None)

    # --------------------------------------------------------- migration
    def _on_replica_kill(self, rid: str, exc: BaseException) -> None:
        # scripted replica.kill from the heartbeat thread
        self._migrate(rid, exc)

    def _on_replica_crash(self, rid: str, engine, exc: BaseException
                          ) -> None:
        # bare-engine crash hook: called from the dying worker thread
        # itself (no engine locks held) — migrate immediately instead of
        # waiting out the heartbeat
        rep = self._replicas.get(rid)
        if rep is None:
            return
        current = rep.engine if not rep.supervised else None
        if current is not engine:
            return          # a stale engine's death: already migrated
        self._migrate(rid, exc)

    def kill_replica(self, rid: str, mode: str = "crash",
                     cause: Optional[BaseException] = None) -> None:
        """Chaos/ops entry point. ``crash``: the replica is observed
        dead — harvested and migrated NOW (reachable corpse).
        ``zombie``: the replica stops heartbeating and becomes
        unreachable to the router while its engine keeps running (a
        network partition); the monitor declares it DEAD after
        ``dead_after`` and migration re-dispatches clones — the zombie's
        late completions are fenced by the ledger."""
        rep = self._replicas[rid]
        if mode == "zombie":
            rep.reachable = False
            rep.stop_heartbeat()
            return
        self._migrate(rid, cause or RuntimeError(f"replica {rid} killed"))

    # ------------------------------------------------------ elastic fleet
    def add_replica(self, engine=None, *,
                    replica_id: Optional[str] = None) -> str:
        """Grow the fleet LIVE — the autoscaler's scale-up seam (and an
        operator's). Builds the engine through the router's factory
        (``net``-built routers share ONE decoder, so the new replica's
        steady state builds nothing new; prebuilt-replica routers need
        ``engine_factory=`` or an explicit ``engine=``), registers a
        heartbeat BEFORE the monitor can see the member (a fresh row
        must not age into an instant death), rebuilds the sticky ring,
        and starts serving. Returns the new replica id."""
        with self._lock:
            if self._shutdown_flag:
                raise RuntimeError("EngineFleetRouter shut down")
            rid = str(replica_id) if replica_id is not None \
                else f"r{next(self._next_ridx)}"
            if rid in self._replicas:
                raise ValueError(f"replica id {rid!r} already exists")
        if engine is None:
            if self._engine_factory is None:
                raise ValueError(
                    "add_replica needs engine= (or build the router with "
                    "engine_factory=/net= so it can construct replicas)")
            engine = self._engine_factory(rid, fault_injector=None)
        rep = EngineReplica(rid, engine, self._membership,
                            heartbeat_interval=self.heartbeat_interval)
        rep._on_kill = self._on_replica_kill
        self._membership.register(rid)
        with self._lock:
            if rid in self._replicas:
                # lost a race with a concurrent add_replica using the
                # same explicit id: the winner's live replica must not
                # be silently overwritten (ours was never started)
                raise ValueError(f"replica id {rid!r} already exists")
            self._replicas[rid] = rep
            self._health[rid] = {"state": REPLICA_ALIVE, "fresh": 0,
                                 "load": 0, "age": 0.0}
        with self._migrate_lock:
            with self._lock:
                # an explicitly reused id must shed its dead/retired
                # history: _bind's retired re-check would otherwise
                # migrate every request straight off the fresh replica,
                # and a LATER real death would short-circuit in
                # _migrate's already-handled guard, stranding its work
                self._dead_handled.discard(rid)
                self._death_cause.pop(rid, None)
            self._ring = self._build_ring()
            self._update_gauges_locked()
            started = self._started
        if started:
            self._wire_crash_hook(rid, rep)
            rep.start()
        self._m["scale_ups"].inc()
        self._flightrec.record("scale_up", fleet=self.fleet_id,
                               replica=rid)
        return rid

    def retire_replica(self, rid: str, *, budget: float = 10.0,
                       reason: str = "descale") -> dict:
        """Gracefully retire one replica LIVE — the autoscaler's
        scale-down seam. Rides the preemption drain
        (``parallel/preemption.PreemptionHandler``): admission closes,
        the in-flight decode block retires and journals, the engine
        quarantines WITHOUT failing its requests, the journal fsyncs and
        a handoff manifest lands in the post-mortem dir — then every
        harvested request re-dispatches to a survivor under the
        FleetLedger fence, exactly like a migration off a dead replica.
        A descale is therefore zero-lost / zero-duplicated by the same
        arbitration that survives replica death (proven by
        ``tools/chaos_soak.py --autoscale``). Refuses to retire the last live
        replica. Returns a summary dict."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None:
                raise KeyError(f"unknown replica {rid!r}")
            survivors = [r for r, h in self._health.items()
                         if r != rid and h["state"] not in
                         (REPLICA_DEAD, REPLICA_CORRUPT)]
            if not survivors:
                raise ValueError(f"cannot retire {rid}: no surviving "
                                 "replica to absorb its work")
            # stop NEW dispatches immediately; _bind's retired re-check
            # migrates any dispatch that raced this transition
            self._health[rid]["state"] = REPLICA_DEAD
            self._update_gauges_locked()
        cause = RuntimeError(f"replica {rid} retired ({reason})")
        with self._migrate_lock:
            with self._lock:
                self._dead_handled.add(rid)
                self._death_cause[rid] = cause
        # drain-or-die through the SAME machinery a preemption uses
        from ..parallel.preemption import PreemptionHandler
        handler = PreemptionHandler(
            rep.engine, journal=self._journal, deadline=float(budget),
            signals=(), manifest_dir=self._postmortem_dir,
            flight_recorder=self._flightrec, registry=self._registry)
        handler.preempt(reason=f"{reason}:{rid}")
        handler.wait(timeout=float(budget) + 30.0)
        report = handler.report
        moved = 0
        with self._migrate_lock:
            with self._lock:
                victims = [fr for fr in self._live.values()
                           if fr.replica_id == rid and not fr.done()]
            for fr in victims:
                if self._redispatch(fr, rep, cause):
                    moved += 1
        rep.stop_heartbeat()
        self._membership.leave(rid)
        rep.shutdown()
        with self._lock:
            self._replicas.pop(rid, None)
            self._health.pop(rid, None)
            self._ring = self._build_ring()
            self._update_gauges_locked()
        self._m["scale_downs"].inc()
        if moved:
            self._m["migrations"].inc(moved)
        self._flightrec.record(
            "descale", fleet=self.fleet_id, replica=rid, moved=moved,
            within_budget=None if report is None else report.within_budget)
        return {"replica": rid, "moved": moved,
                "harvested": 0 if report is None
                else len(report.harvested),
                "within_budget": None if report is None
                else report.within_budget,
                "journal_synced": None if report is None
                else report.journal_synced,
                "manifest_path": None if report is None
                else report.manifest_path}

    def replica_loads(self) -> Dict[str, Tuple[int, int, str]]:
        """rid → (live load, capacity, health state) over the current
        fleet — the autoscaler's utilization signal (live gauges first,
        last beat-carried load as the fallback for unreadable rows)."""
        with self._lock:
            reps = dict(self._replicas)
            states = {rid: h["state"] for rid, h in self._health.items()}
            beat_loads = {rid: h["load"] for rid, h in
                          self._health.items()}
        out: Dict[str, Tuple[int, int, str]] = {}
        for rid, rep in reps.items():
            ld = rep.load()
            if ld is None:
                ld = beat_loads.get(rid) or 0
            out[rid] = (int(ld), rep.capacity, states.get(rid, "?"))
        return out

    def utilization(self) -> float:
        """Fleet-wide load / DECODE capacity (total cache slots) over
        non-DEAD replicas: 1.0 = every slot busy, >1 = a queue is
        building behind the slots — the autoscaler's saturation signal.
        0.0 on an empty or all-dead fleet."""
        with self._lock:
            slot_counts = {rid: self._replicas[rid].slots
                           for rid in self._replicas}
        load = slots = 0
        for rid, (ld, _, state) in self.replica_loads().items():
            if state in (REPLICA_DEAD, REPLICA_CORRUPT):
                continue
            load += ld
            slots += slot_counts.get(rid, 0)
        return 0.0 if slots == 0 else load / slots

    def _migrate(self, rid: str, cause: BaseException,
                 state: str = REPLICA_DEAD,
                 kind: str = "replica_dead") -> bool:
        """Retire ``rid`` into ``state`` and re-dispatch its
        non-terminal requests to survivors exactly once. Serialized
        globally: concurrent death reports (crash callback vs monitor
        scan vs chaos kill vs corrupt quarantine) collapse to one
        migration per replica. Returns True iff THIS call performed
        the retirement."""
        with self._migrate_lock:
            with self._lock:
                if rid in self._dead_handled:
                    return False
                self._dead_handled.add(rid)
                self._death_cause[rid] = cause
                rep = self._replicas.get(rid)
                if rep is None:
                    return False
                h = self._health[rid]
                h["state"] = state
                self._update_gauges_locked()
            rep.stop_heartbeat()
            self._membership.leave(rid)
            if rep.reachable:
                try:
                    _, dead_cause = rep.quarantine()
                    cause = dead_cause or cause
                    self._death_cause[rid] = cause
                except Exception:   # noqa: BLE001 — treat as unreachable
                    rep.reachable = False
            self._flightrec.record(
                kind, fleet=self.fleet_id, replica=rid,
                reachable=rep.reachable,
                cause=f"{type(cause).__name__}: {cause}"[:200])
            with self._lock:
                victims = [fr for fr in self._live.values()
                           if fr.replica_id == rid and not fr.done()]
            if self._postmortem_dir:
                # artifact BEFORE re-dispatch: it must capture the
                # victims' traces as the dead replica left them, and the
                # fleet request ids migration is about to move
                self._flightrec.write_postmortem(
                    self._postmortem_dir, f"{self.fleet_id}-{rid}",
                    reason=f"replica {rid} dead "
                           f"({'reachable' if rep.reachable else 'partitioned'})",
                    cause=cause,
                    traces=[fr.trace for fr in victims
                            if fr.trace is not None],
                    registry=self._registry,
                    extra={"fleet": self.fleet_id, "replica": rid,
                           "reachable": rep.reachable,
                           "fleet_request_ids":
                               [fr.request_id for fr in victims]})
            moved = 0
            for fr in victims:
                if self._redispatch(fr, rep, cause):
                    moved += 1
            if moved:
                self._m["migrations"].inc(moved)
                self._flightrec.record("migration", fleet=self.fleet_id,
                                       src=rid, moved=moved)
        return True

    # -------------------------------------------- corruption quarantine
    def _note_numerical_fault(self, rid: str,
                              exc: BaseException) -> None:
        """Fold one NumericalFault observation into the replica's burn
        window; crossing ``fault_threshold`` within ``fault_window``
        quarantines the replica as CORRUPT. With no integrity config a
        fault is just a failure — legacy behaviour."""
        cfg = self._integrity
        if cfg is None:
            return
        now = interval_now()
        with self._lock:
            dq = self._fault_times.setdefault(rid, deque())
            dq.append(now)
            while dq and now - dq[0] > cfg.fault_window:
                dq.popleft()
            n = len(dq)
        if n >= max(1, int(cfg.fault_threshold)):
            self.quarantine_corrupt(rid, exc)

    def quarantine_corrupt(self, rid: str,
                           cause: BaseException) -> bool:
        """Quarantine ``rid`` as CORRUPT: the router stops
        dispatching to it, its streams migrate to healthy replicas
        token-identically under the FleetLedger fence (the replica is
        REACHABLE, so the quarantine-harvest path requeues the same
        request objects), and — when the router can build engines and
        ``replace_corrupt`` is on — a replacement replica grows
        immediately (the autoscaler's min-replica clamp is the backstop
        otherwise). Idempotent per replica; returns True iff this call
        performed the quarantine."""
        if not self._migrate(rid, cause, state=REPLICA_CORRUPT,
                             kind="replica_corrupt"):
            return False
        self._m["corrupt_quarantines"].inc()
        cfg = self._integrity
        if cfg is not None and cfg.replace_corrupt:
            with self._lock:
                stopping = self._shutdown_flag
            if not stopping:
                try:
                    self._replace_replica(rid)
                except Exception:   # noqa: BLE001 — no factory / raced
                    pass            # shutdown: autoscaler backstop
        return True

    def _replace_replica(self, rid: str) -> Optional[str]:
        """Grow a replacement for a quarantined worker (subclasses
        preserve role pools); None when the router cannot build
        engines."""
        if self._engine_factory is None:
            return None
        return self.add_replica()

    def _redispatch(self, fr: FleetRequest, src: EngineReplica,
                    cause: BaseException) -> bool:
        """Move one fleet request off a dead replica. Reachable source:
        requeue the SAME harvested request object (supervisor-takeover
        contract — resume by re-prefilling prompt + generated-so-far).
        Unreachable source: requeue a CLONE built from the router's own
        record; the zombie's handle is fenced by identity + ledger."""
        order, loads = self._dispatch_order(sticky_key=fr.sticky_key)
        dst = None
        for rep in order:
            if rep.replica_id != src.replica_id and \
                    loads.get(rep.replica_id) is not None and \
                    not rep.dead():
                dst = rep       # migration bypasses admission control:
                break           # inherited work is never shed
        with fr._lock:
            if fr.done():
                return False
            if fr.replica_id != src.replica_id:
                return False    # already migrated off src (the bind-time
                                # re-check and the victim loop race here)
            if dst is None:
                # no survivors: fail with the death cause chained, the
                # way a supervisor out of restart budget fails requests
                exc = RuntimeError(
                    f"fleet {self.fleet_id}: replica {src.replica_id} "
                    f"died with no surviving replica to migrate to")
                exc.__cause__ = cause
                fr._fail(exc)
                self._ledger.try_complete(fr.request_id, fr.replica_id)
                return False
            if not self._ledger.try_reassign(fr.request_id,
                                             dst.replica_id):
                return False    # completed while we were deciding
            old_inner = fr._inner
            if src.reachable and old_inner is not None \
                    and not old_inner.done():
                inner = old_inner       # quarantined corpse: same object
            else:
                inner = self._clone_inner(fr, old_inner)
                inner.add_done_callback(
                    lambda r, _fr=fr: self._on_inner_done(_fr, r))
                fr._inner = inner
            fr.replica_id = dst.replica_id
            fr.migrations += 1
        tr = inner.trace
        if tr is not None:
            tr.event("migrate", src=src.replica_id, dst=dst.replica_id,
                     generated=len(inner.generated))
        dst.requeue(inner)
        return True

    def _clone_inner(self, fr: FleetRequest, old_inner):
        """Fresh replica-local request resuming the fleet request: the
        unreachable-source migration path. Resumes from a snapshot of
        generated-so-far when the old handle is readable in-process
        (greedy decoding makes ANY resume prefix token-identical); the
        trace object is shared, so the request keeps one timeline."""
        from ..models.generation import GenerationRequest
        clone = GenerationRequest(fr.prompt, fr.max_new_tokens,
                                  fr.temperature, fr.eos_id)
        clone.deadline = fr.deadline
        clone._deadline_t = fr._deadline_t      # original ABSOLUTE deadline
        clone._cancel_requested = fr._cancel_requested
        # the clone inherits the durable id; the zombie's is DETACHED so
        # its engine stops journaling retires (and its terminal callback
        # journals nothing) for the id the clone now owns. Straggler
        # ``ret`` records that raced the detach are harmless (replay
        # places tokens by absolute offset); a straggler ``fin`` is
        # neutralized at recovery by the ledger: an id terminal-on-disk
        # but still ASSIGNED in the ledger is resurrected
        # (recover_from_journal — the completion fence is the arbiter,
        # not the zombie's last write)
        clone.journal_id = fr.request_id
        # SLO clock continuity: the clone inherits the ORIGINAL
        # created/admitted/first-token stamps, so headroom and TTFT are
        # measured from the real submission — migration resets nothing
        clone._created_t = fr._created_t
        if old_inner is not None:
            clone.generated = list(old_inner.generated)
            clone.trace = old_inner.trace
            clone._created_t = getattr(old_inner, "_created_t",
                                       fr._created_t)
            clone._admitted_t = getattr(old_inner, "_admitted_t", None)
            clone._first_token_t = getattr(old_inner, "_first_token_t",
                                           None)
            clone._slo_labels = dict(getattr(old_inner, "_slo_labels",
                                             None) or {})
            # the zombie must not keep spanning the timeline its
            # replacement now owns (if it already finish()ed the shared
            # trace first-wins, the object still accumulates the clone's
            # spans — one ring entry, early status: rare-race tradeoff)
            old_inner.trace = None
            # ... and its late failure must not SLO-account the request
            # the clone now owns (requeue re-arms the clone's tracker).
            # Cleared under the zombie's _cb_lock — _notify_slo consumes
            # under the same lock, so a completion racing this clear
            # either records BEFORE the clone exists or never records.
            # If it DID record first, the clone inherits _slo_done and
            # requeue skips re-arming: one record per request, always.
            with old_inner._cb_lock:
                old_inner._slo = None
            clone._slo_done = old_inner._slo_done
            old_inner.journal_id = None
        return clone

    # --------------------------------------------------------- monitoring
    def _monitor_loop(self) -> None:
        while not self._stop_monitor.wait(self.monitor_interval):
            try:
                self._scan_once()
            except Exception as exc:   # noqa: BLE001 — a scan bug or a
                # coordinator outage outlasting the membership tier's
                # own retries must NOT kill the monitor: a fleet that
                # stops aging its members can never declare anyone DEAD
                self._flightrec.record(
                    "monitor_scan_error", fleet=self.fleet_id,
                    cause=f"{type(exc).__name__}: {exc}"[:160])

    # ------------------------------------------------------ golden canary
    def _canary_loop(self) -> None:
        period = float(self._integrity.canary_period)
        while not self._stop_canary.wait(period):
            try:
                self._canary_round()
            except Exception as exc:   # noqa: BLE001 — a probe bug must
                self._flightrec.record(   # not kill the prober
                    "canary", fleet=self.fleet_id, outcome="error",
                    cause=f"{type(exc).__name__}: {exc}"[:160])

    def canary_round(self) -> Dict[str, str]:
        """Run one golden-canary probe round NOW (the background loop
        calls this on ``canary_period``; tests and the soak drive it
        directly). Returns rid → outcome."""
        return self._canary_round()

    def _canary_round(self) -> Dict[str, str]:
        with self._lock:
            targets = [(rid, self._replicas[rid])
                       for rid, h in self._health.items()
                       if h["state"] in (REPLICA_ALIVE, REPLICA_SUSPECT)
                       and rid in self._replicas]
        out: Dict[str, str] = {}
        for rid, rep in targets:
            outcome = self._probe_replica(rid, rep)
            if outcome is None:
                # not probed BY DESIGN (decode-phase worker): publish
                # no age gauge — a forever-growing age here would be a
                # permanent false alarm on every disagg fleet
                out[rid] = "not_probed"
                continue
            # a replica that has NEVER probed clean ages from its first
            # probe attempt — the worst case (never clean) must read as
            # the STALEST age, not as a fresh 0.0
            self._canary_ok.setdefault(rid, interval_now())
            out[rid] = outcome
            self._m_canary.labels(self.fleet_id, outcome).inc()
            if outcome == "ok":
                self._canary_ok[rid] = interval_now()
            self._g_canary_age.labels(self.fleet_id, rid).set(
                round(interval_now() - self._canary_ok[rid], 3))
        return out

    def _probe_replica(self, rid: str,
                       rep: EngineReplica) -> Optional[str]:
        """One golden-canary probe through the replica's REAL engine
        path (submit → prefill → decode blocks → sentinel → result).
        Probes are never journaled or SLO-accounted (``_canary=True``).
        A decode-only worker is NOT probed (returns None: fresh prompts
        belong on prefill workers; its corruption surface is covered by
        the sentinel + adopt-intake verification, and it must not
        publish a forever-stale age); a prefill-only worker probes with
        a 1-token budget — finish-at-first-token IS its whole local
        path. "skipped" means a probe was ATTEMPTED and couldn't get
        through (busy/shedding/restarting) — its age keeps growing,
        which is the signal."""
        cfg = self._integrity
        inner = rep.engine.engine if rep.supervised else rep.engine
        phase = getattr(inner, "phase", "both")
        if phase == "decode":
            return None
        if self._canary is None:
            prompt = cfg.canary_prompt
            if prompt is None:
                prompt = GoldenCanary.default_prompt(
                    int(inner.decoder.vocab_size))
            self._canary = GoldenCanary(prompt)
        n_tok = 1 if phase == "prefill" else max(1, int(cfg.canary_tokens))
        try:
            req = rep.submit(list(self._canary.prompt), n_tok,
                             temperature=0.0,
                             deadline=cfg.canary_deadline, _canary=True)
            got = req.result(cfg.canary_deadline + 5.0)
        except NumericalFault as exc:
            # the probe itself tripped the sentinel: strongest possible
            # corruption signal — burn-account it (threshold may
            # quarantine the replica right here)
            self._flightrec.record("canary", fleet=self.fleet_id,
                                   replica=rid, outcome="fault")
            self._note_numerical_fault(rid, exc)
            return "fault"
        except Exception:   # noqa: BLE001 — busy/shedding/restarting
            return "skipped"   # replica: not a corruption signal
        verdict = self._canary.observe(n_tok, got)
        if verdict is False:
            # silent wrong-value corruption: the model, params, and
            # programs never change under serving — only broken
            # hardware moves a greedy output. Quarantine.
            self._flightrec.record("canary", fleet=self.fleet_id,
                                   replica=rid, outcome="mismatch")
            self.quarantine_corrupt(rid, NumericalFault(
                f"golden-canary mismatch on replica {rid}: recorded "
                f"sequence diverged — silent corruption"))
            return "mismatch"
        return "ok"

    def _scan_once(self) -> None:
        """One membership scan: age beats into health transitions.
        SUSPECT → ALIVE needs ``recover_beats`` consecutive fresh scans
        (hysteresis); ``dead_after`` without a beat — or a supervisor
        that gave up — is DEAD and triggers migration."""
        ages = self._membership.ages()
        to_kill: List[Tuple[str, BaseException]] = []
        with self._lock:
            for rid, rep in self._replicas.items():
                h = self._health[rid]
                if h["state"] in (REPLICA_DEAD, REPLICA_CORRUPT):
                    continue   # quarantined: never ages back to life
                gave_up = rep.given_up()
                if gave_up is not None:
                    to_kill.append((rid, gave_up))
                    continue
                age, load = ages.get(rid, (None, None))
                if age is None or age > self.dead_after:
                    rep.reachable = False   # heartbeat death == partition
                    to_kill.append((rid, RuntimeError(
                        f"replica {rid}: no heartbeat for "
                        f"{self.dead_after}s")))
                    continue
                h["age"] = age
                h["load"] = load
                if age > self.suspect_after:
                    if h["state"] == REPLICA_ALIVE:
                        h["state"] = REPLICA_SUSPECT
                    h["fresh"] = 0
                elif h["state"] == REPLICA_SUSPECT:
                    h["fresh"] += 1
                    if h["fresh"] >= self.recover_beats:
                        h["state"] = REPLICA_ALIVE
                        h["fresh"] = 0
            self._update_gauges_locked()
        for rid, cause in to_kill:
            self._migrate(rid, cause)

    # ---------------------------------------------------------- lifecycle
    def _wire_crash_hook(self, rid: str, rep: EngineReplica) -> None:
        if not rep.supervised:
            # the fleet IS the supervisor, one level up: a crashing
            # bare engine reports here instead of failing its
            # requests, and migration re-runs them exactly once
            eng = rep.engine
            eng._supervised = True
            eng._on_crash = (lambda engine, exc, _rid=rid:
                             self._on_replica_crash(_rid, engine, exc))

    def start(self) -> "EngineFleetRouter":
        if self._started:
            return self
        self._started = True
        for rid, rep in self._replicas.items():
            self._wire_crash_hook(rid, rep)
            rep.start()
        self._stop_monitor.clear()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True,
                                         name=f"{self.fleet_id}-monitor")
        self._monitor.start()
        if self._integrity is not None and \
                self._integrity.canary_period is not None:
            self._stop_canary.clear()
            self._canary_thread = threading.Thread(
                target=self._canary_loop, daemon=True,
                name=f"{self.fleet_id}-canary")
            self._canary_thread.start()
        return self

    def shutdown(self) -> None:
        with self._lock:
            if self._shutdown_flag:
                return
            self._shutdown_flag = True
            reps = list(self._replicas.values())
        self._stop_monitor.set()
        self._stop_canary.set()
        mon = self._monitor
        if mon is not None and mon is not threading.current_thread():
            mon.join(timeout=2)
        can = self._canary_thread
        if can is not None and can is not threading.current_thread():
            can.join(timeout=2)
        for rep in reps:
            rep.stop_heartbeat()
        for rep in reps:
            rep.shutdown()      # fails outstanding inners → callbacks
        #                         finish their fleet requests
        with self._lock:
            leftovers = [fr for fr in self._live.values()
                         if not fr.done()]
            self._live.clear()
        for fr in leftovers:
            with fr._lock:
                if not fr.done():
                    fr._fail(RuntimeError("EngineFleetRouter shut down"))

    stop = shutdown             # route/supervisor-style alias

    # --------------------------------------------------------------- views
    @property
    def ledger(self) -> FleetLedger:
        """The exactly-once arbiter — ``recover_from_journal(...,
        ledger=router.ledger, replica_id=...)`` fences a restarted
        replica's recovery against clone re-dispatch through it."""
        return self._ledger

    def replica_ids(self) -> List[str]:
        return sorted(self._replicas)

    def replica_state(self, rid: str) -> str:
        with self._lock:
            return self._health[rid]["state"]

    def stats(self) -> dict:
        """Supervisor-style aggregate: every replica's engine counters
        summed (numeric keys only), plus the fleet-level counters — the
        telemetry-source shape dashboards already consume."""
        out: Dict[str, int] = {}
        for rep in self._replicas.values():
            try:
                s = rep.engine.stats()
            except Exception:   # noqa: BLE001 — a dead replica degrades
                continue        # the aggregate, not the endpoint
            for k, v in s.items():
                if isinstance(v, (int, float)) and \
                        not isinstance(v, bool):
                    out[k] = out.get(k, 0) + v
        with self._lock:
            counts = {REPLICA_ALIVE: 0, REPLICA_SUSPECT: 0,
                      REPLICA_DEAD: 0, REPLICA_CORRUPT: 0}
            for h in self._health.values():
                counts[h["state"]] += 1
        out["replicas"] = len(self._replicas)
        out["replicas_alive"] = counts[REPLICA_ALIVE]
        out["replicas_suspect"] = counts[REPLICA_SUSPECT]
        out["replicas_dead"] = counts[REPLICA_DEAD]
        out["replicas_corrupt"] = counts[REPLICA_CORRUPT]
        for key in _FLEET_COUNTERS:
            out[key] = int(self._m[key].value)
        return out

    def fleet_stats(self) -> dict:
        """The router's replica table + ledger summary — a ``/snapshot``
        source (``TelemetryServer.add_source``). Each replica row carries
        its SLO account (rolling-window attainment, headroom/TTFT
        quantiles) from the shared tracker, so routing data and SLO data
        live in ONE document."""
        ages = self._membership.ages()
        with self._lock:
            health = {rid: dict(h) for rid, h in self._health.items()}
        table = {}
        for rid, rep in sorted(self._replicas.items()):
            h = health[rid]
            age, beat_load = ages.get(rid, (None, None))
            row = {"state": h["state"],
                   "heartbeat_age_s": None if age is None
                   else round(age, 3),
                   "load": beat_load if beat_load is not None
                   else h.get("load"),
                   "capacity": rep.capacity,
                   "supervised": rep.supervised,
                   "reachable": rep.reachable}
            try:
                s = rep.engine.stats()
                row["queue_depth"] = s.get("queue_depth")
                row["active_slots"] = s.get("active_slots")
            except Exception:   # noqa: BLE001
                pass
            try:
                inner = rep.engine.engine if rep.supervised \
                    else rep.engine
                label = getattr(inner, "slo_label", rid)
                agg = self._slo_tracker.label_snapshot(
                    "replica", label, window=self._slo_tracker.long_window)
                row["slo"] = {
                    "attainment": agg["attainment"], "n": agg["n"],
                    "headroom_p50_s": agg["headroom_s"]["p50"],
                    "headroom_min_s": agg["headroom_s"]["min"],
                    "ttft_p99_s": agg["ttft_s"]["p99"]}
            except Exception:   # noqa: BLE001 — a dead replica degrades
                row["slo"] = None             # its row, not the table
            table[rid] = row
        return {"fleet": self.fleet_id,
                "replicas": table,
                "ledger": self._ledger.to_dict(),
                "journal": None if self._journal is None
                else self._journal.stats(),
                "slo": {"attainment_short":
                        round(self._slo_tracker.attainment(
                            self._slo_tracker.short_window), 6),
                        "attainment_long":
                        round(self._slo_tracker.attainment(
                            self._slo_tracker.long_window), 6),
                        "burn_rate_short":
                        round(self._slo_tracker.burn_rate(
                            self._slo_tracker.short_window), 6)},
                "counters": {key: int(self._m[key].value)
                             for key in _FLEET_COUNTERS}}


# Legacy-style counter attributes (``router.migrations`` etc.) as
# read-only registry views, matching the engine/route idiom.
for _counter_name in _FLEET_COUNTERS:
    setattr(EngineFleetRouter, _counter_name,
            property(lambda self, _k=_counter_name:
                     int(self._m[_k].value),
                     doc=f"registry view: fleet_{_counter_name}_total"
                         f"{{fleet=<id>}}"))
del _counter_name
