"""The disaggregated prefill/decode serving tier (the JAX package's
``streaming/disagg.py``).

Prefill is compute-bound and bursty, decode bandwidth-bound and steady;
a replica that runs both lets one long prefill stall its decode streams.
This module splits the fleet into phase-specialized workers:

- :class:`PhaseRouter` (an :class:`~.fleet.EngineFleetRouter`) owns two
  role pools. Fresh prompts go to PREFILL workers
  (``SlotGenerationEngine(phase="prefill")``), which fill KV pages
  (prefix-cache hits skip the shared span) and hand each request off
  instead of decoding it. Streams live on DECODE workers
  (``phase="decode"``), reached only through the handoff. Every
  re-prefill (migration off a dead worker of either role, a failed
  handoff, recovery) goes back to the prefill pool.
- :class:`KVTransport` is the handoff seam. The sender exports the
  slot's pages (one gather a layer, 2 x layers ``kv_handoff``
  readbacks), a :class:`~..models.paging.PageFrameSet` crosses the seam,
  and the receiver imports the frames into its own pool (one
  host→device copy from pinned memory) and resumes decode with
  identical tokens. :class:`InProcessKVTransport` passes the frame set
  by reference; :class:`SerializedKVTransport` round-trips the
  CRC-framed wire encoding (``per_page=True``: a header frame and one
  frame per page). Bytes and seconds are counted
  (``kv_transfer_bytes_total``, ``kv_transfer_seconds``).
- Exactly once across the handoff: the ledger's
  ``try_reassign_from(prefill → decode)`` is a compare-and-swap on the
  current owner, so a prefill worker declared dead mid-transfer loses to
  the migration that re-prefilled its work (its late ship is dropped as
  ``fenced``), and a transport failure mid-ship re-prefills on a live
  prefill worker. SLO clocks, the request's one trace (a ``kv_handoff``
  span) and the flight recorder span the handoff.
- Per-role elasticity: ``add_replica(role=...)`` / ``retire_replica``
  (drain-backed, refusing a role's last live worker), and
  :class:`PhaseAutoscaler`, one :class:`~.autoscale.BurnRateAutoscaler`
  a role.

The transport across processes is ``streaming/remote.py``'s wire.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Dict, List, Optional

from ..models.paging import PageCorruptionError, PageFrameSet
from ..observability.integrity import KV_CORRUPTION_COUNTER, as_integrity
from ..observability.tracing import interval_now
from .fleet import (EngineFleetRouter, EngineReplica, REPLICA_CORRUPT,
                    REPLICA_DEAD)

#: disagg roles (the third role, the router, is this module's
#: PhaseRouter itself)
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"

_TRANSPORT_SEQ = itertools.count()


class KVTransportError(RuntimeError):
    """The transport could not move a handoff's page frames."""


class KVTransport:
    """Base seam: ``ship(PageFrameSet) -> PageFrameSet`` moves one
    handoff's frames from the prefill side to the decode side and
    returns what the receiver should import. Implementations count
    nothing themselves — the shipping router measures bytes/seconds
    around the call (one accounting point, not one per transport)."""

    name = "null"

    def ship(self, state: PageFrameSet) -> PageFrameSet:
        raise NotImplementedError

    def stats(self) -> dict:
        return {"transport": self.name}


class InProcessKVTransport(KVTransport):
    """Handle-passing fast path: both roles share one process (and one
    host memory space), so the frame set crosses by REFERENCE — no
    serialization, no copy. The page contents were already gathered to
    host by the export; shipping is free."""

    name = "inproc"

    def __init__(self):
        self.shipped = 0

    def ship(self, state: PageFrameSet) -> PageFrameSet:
        self.shipped += 1
        return state

    def stats(self) -> dict:
        return {"transport": self.name, "shipped": self.shipped}


class SerializedKVTransport(KVTransport):
    """Wire-format path: the frames round-trip the CRC-framed byte
    encoding — exactly what a broker/coordinator hop would carry, so
    in-process tests exercise the same parse/validate path a
    cross-process deployment pays. ``per_page=True`` uses the
    streaming encoding (header + one frame per page): a sender can put
    each page on the wire as it becomes final, overlapping transfer
    with the prefill compute still filling later pages (the receiver
    assembles and validates per-frame CRCs)."""

    def __init__(self, per_page: bool = False,
                 record_ships: bool = False):
        self.per_page = bool(per_page)
        self.name = "frames" if per_page else "bytes"
        self.shipped = 0
        self.wire_bytes = 0
        self.wire_frames = 0
        # record_ships: keep one (n_pages, payload bytes, token bytes)
        # row per ship — the exact-transfer account the soak reads
        self.ships: Optional[List] = [] if record_ships else None

    def ship(self, state: PageFrameSet) -> PageFrameSet:
        if self.ships is not None:
            self.ships.append((state.n_pages, state.nbytes,
                               int(state.tokens.nbytes)))
        try:
            if self.per_page:
                frames = state.to_frames()
                self.wire_frames += len(frames)
                self.wire_bytes += sum(len(f) for f in frames)
                out = PageFrameSet.from_frames(frames)
            else:
                blob = state.to_bytes()
                self.wire_frames += 1
                self.wire_bytes += len(blob)
                out = PageFrameSet.from_bytes(blob)
        except PageCorruptionError:
            raise        # typed through: the router counts CONTENT
        #                  corruption separately from framing failures
        except ValueError as e:
            raise KVTransportError(f"KV frame encoding failed: {e}")
        self.shipped += 1
        return out

    def stats(self) -> dict:
        return {"transport": self.name, "shipped": self.shipped,
                "wire_bytes": self.wire_bytes,
                "wire_frames": self.wire_frames,
                "per_page": self.per_page}


# --------------------------------------------------------------- router
class PhaseRouter(EngineFleetRouter):
    """Phase-specialized fleet router: PREFILL workers fill KV pages
    and hand off, DECODE workers hold the active streams. Duck-types
    the engine surface like its base, so
    ``GenerationServingRoute(engine=router)`` serves a disaggregated
    fleet from a topic unchanged.

    Dispatch policy: fresh prompts (and every re-prefill — migration
    victims of either role, failed handoffs, journal recovery) go to
    the prefill pool; the decode pool is reached only through the
    ledger-fenced KV handoff. ``sticky_prefix`` therefore concentrates
    same-prefix prompts on one PREFILL worker — the prefix cache
    becomes a tier served by prefill workers."""

    def __init__(self, net=None, prefill_replicas: int = 1,
                 decode_replicas: int = 1, *,
                 decoder=None, transport: Optional[KVTransport] = None,
                 num_slots: int = 8,
                 prefill_slots: Optional[int] = None,
                 decode_slots: Optional[int] = None,
                 t_max: Optional[int] = None, block_size: int = 1,
                 max_pending: int = 256, refill: bool = True,
                 seed: int = 0, supervised: bool = False,
                 supervisor_timeout: float = 10.0, max_restarts: int = 3,
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
                 postmortem_dir: Optional[str] = None, journal=None,
                 scheduling: str = "fifo", shed_headroom: bool = False,
                 headroom_margin: float = 1.0,
                 prefill_chunk: Optional[int] = None,
                 adaptive_block: bool = False, block_ladder=None,
                 block_latency_target: float = 0.25,
                 page_size: int = 16,
                 prefill_pages: Optional[int] = None,
                 decode_pages: Optional[int] = None,
                 prefix_cache: bool = True,
                 profiler=None, profiling: Optional[bool] = None,
                 handoff_threads: int = 1,
                 integrity=None, speculative: bool = False,
                 spec_k: Optional[int] = None, spec_ngram: int = 3,
                 spec_threshold: float = 0.35,
                 spec_probe_every: int = 16):
        icfg = as_integrity(integrity)
        if net is None:
            raise ValueError("PhaseRouter builds its own role-"
                             "specialized replicas and needs net=")
        if int(prefill_replicas) < 1 or int(decode_replicas) < 1:
            raise ValueError("need >= 1 replica per role: a missing "
                             "role means nothing can prefill (or "
                             "decode) at all")
        from ..models.generation import (SlotGenerationEngine,
                                         TransformerDecoder)
        from ..observability.flightrec import default_flight_recorder
        from ..observability.metrics import default_registry
        from ..observability.slo import default_slo_tracker
        from ..observability.tracing import default_trace_ring
        registry = registry if registry is not None \
            else default_registry()
        trace_store = trace_store if trace_store is not None \
            else default_trace_ring()
        slo_tracker = slo_tracker if slo_tracker is not None \
            else default_slo_tracker()
        flight_recorder = flight_recorder if flight_recorder is not None \
            else default_flight_recorder()
        if decoder is None:
            decoder = TransformerDecoder(
                net, t_max=t_max,
                sentinel=icfg is not None and icfg.sentinel,
                logit_bound=None if icfg is None else icfg.logit_bound)
        self._transport = transport if transport is not None \
            else InProcessKVTransport()
        prefill_slots = int(num_slots if prefill_slots is None
                            else prefill_slots)
        decode_slots = int(num_slots if decode_slots is None
                           else decode_slots)
        # handoff plumbing exists BEFORE any engine can call the sink
        self._handoff_q: "queue.Queue" = queue.Queue()
        self._handoff_threads: List[threading.Thread] = []
        self._n_handoff_threads = max(1, int(handoff_threads))
        self._handoff_stop = False
        self._roles: Dict[str, str] = {}
        self._role_seq = {ROLE_PREFILL: itertools.count(),
                          ROLE_DECODE: itertools.count()}

        def _phase_factory(rid: str, role: str, fault_injector=None):
            # ONE shared decoder across BOTH roles: the handoff resumes
            # on the same weights and kernels, so imported pages decode
            # token-identically and a grown worker builds nothing new
            eng = SlotGenerationEngine(
                net, num_slots=(prefill_slots if role == ROLE_PREFILL
                                else decode_slots),
                refill=refill, seed=seed, decoder=decoder,
                max_pending=max_pending, fault_injector=fault_injector,
                block_size=block_size, registry=registry,
                trace_store=trace_store, tracing=tracing,
                slo=slo_tracker, slo_label=rid,
                flight_recorder=flight_recorder, journal=journal,
                scheduling=scheduling, shed_headroom=shed_headroom,
                headroom_margin=headroom_margin,
                # role-split policy knobs: chunked prefill belongs to
                # the prefill phase, adaptive decode blocks to decode
                prefill_chunk=(prefill_chunk if role == ROLE_PREFILL
                               else None),
                adaptive_block=(adaptive_block if role == ROLE_DECODE
                                else False),
                # speculation is a DECODE-phase policy (like adaptive
                # blocks): prefill workers hand off before ever
                # decoding. Decode workers draft over adopted
                # contexts — the drafter rebuilds its suffix index
                # from prompt+generated on the first spec block after
                # adoption, no handoff payload changes
                speculative=(speculative if role == ROLE_DECODE
                             else False),
                spec_k=spec_k, spec_ngram=spec_ngram,
                spec_threshold=spec_threshold,
                spec_probe_every=spec_probe_every,
                block_ladder=block_ladder,
                block_latency_target=block_latency_target,
                paged=True, page_size=page_size,
                num_pages=(prefill_pages if role == ROLE_PREFILL
                           else decode_pages),
                prefix_cache=(prefix_cache if role == ROLE_PREFILL
                              else True),
                profiler=profiler, profiling=profiling,
                phase=role,
                handoff=(None if role != ROLE_PREFILL else
                         (lambda req, st, _rid=rid:
                          self._enqueue_handoff(_rid, req, st))),
                integrity=icfg)
            if supervised:
                from ..parallel.failures import EngineSupervisor
                eng = EngineSupervisor(
                    eng, timeout=supervisor_timeout,
                    max_restarts=max_restarts, name=f"disagg:{rid}",
                    postmortem_dir=postmortem_dir)
            return eng
        self._phase_factory = _phase_factory
        engines, ids = [], []
        for role, count in ((ROLE_PREFILL, int(prefill_replicas)),
                            (ROLE_DECODE, int(decode_replicas))):
            for _ in range(count):
                rid = self._mint_rid(role)
                inj = None
                if replica_injectors is not None:
                    inj = replica_injectors[len(engines)]
                engines.append(_phase_factory(rid, role,
                                              fault_injector=inj))
                ids.append(rid)
                self._roles[rid] = role
        super().__init__(
            replicas=engines, replica_ids=ids,
            membership=membership, fleet_id=fleet_id,
            fault_injector=fault_injector,
            replica_injectors=replica_injectors,
            heartbeat_interval=heartbeat_interval,
            monitor_interval=monitor_interval,
            suspect_after=suspect_after, dead_after=dead_after,
            recover_beats=recover_beats, sticky_prefix=sticky_prefix,
            completed_window=completed_window, registry=registry,
            trace_store=trace_store, tracing=tracing,
            slo_tracker=slo_tracker, flight_recorder=flight_recorder,
            postmortem_dir=postmortem_dir, journal=journal,
            paged=True, page_size=page_size, integrity=icfg)
        # KV-handoff accounting: exact payload bytes + pages per handoff, wall-time
        # histogram, and the exactly-once outcome counters
        reg = self._registry
        self._m_handoff = {
            key: reg.counter(f"fleet_kv_handoffs_{key}_total" if key
                             else "fleet_kv_handoffs_total", desc,
                             ("fleet",)).labels(self.fleet_id)
            for key, desc in (
                ("", "KV handoffs completed (prefill → decode)"),
                ("fenced", "handoffs dropped by the ledger fence (the "
                           "request migrated away first — zombie "
                           "late-ships land here)"),
                ("failed", "handoffs that failed in transport/adopt "
                           "and re-prefilled on a surviving prefill "
                           "worker"))}
        self._m_xfer_bytes = reg.counter(
            "kv_transfer_bytes_total",
            "exact KV page-frame payload bytes shipped prefill → "
            "decode", ("fleet", "transport")).labels(
            self.fleet_id, self._transport.name)
        self._m_xfer_pages = reg.counter(
            "kv_transfer_pages_total",
            "KV pages shipped prefill → decode",
            ("fleet", "transport")).labels(self.fleet_id,
                                           self._transport.name)
        self._h_xfer = reg.histogram(
            "kv_transfer_seconds",
            "wall time per KV handoff, export-done to adopt-enqueued",
            ("fleet",)).labels(self.fleet_id)
        # content corruption detected AT the handoff seam (wire decode
        # or adopt intake) — same family the engines count under, one
        # child per component
        self._m_kv_corrupt = reg.counter(
            *KV_CORRUPTION_COUNTER).labels(self.fleet_id)

    def _mint_rid(self, role: str) -> str:
        prefix = "p" if role == ROLE_PREFILL else "d"
        return f"{prefix}{next(self._role_seq[role])}"

    # --------------------------------------------------------------- roles
    def replica_role(self, rid: str) -> Optional[str]:
        return self._roles.get(rid)

    def role_ids(self, role: str) -> List[str]:
        return sorted(r for r, ro in self._roles.items() if ro == role)

    def _dispatch_order(self, prefer=None, sticky_key=None, rids=None):
        """Default candidate set is the PREFILL pool: fresh prompts,
        migration victims, and failed handoffs all re-enter through
        prefill (the decode pool is reached only via the handoff —
        pass ``rids=self.role_ids("decode")`` explicitly)."""
        if rids is None:
            rids = self.role_ids(ROLE_PREFILL)
        return super()._dispatch_order(prefer=prefer,
                                       sticky_key=sticky_key, rids=rids)

    def utilization(self, role: Optional[str] = None) -> float:
        """Fleet-wide (or per-role) load / decode-slot capacity over
        non-DEAD replicas — the per-role autoscalers' saturation
        signals read their own pools."""
        if role is None:
            return super().utilization()
        with self._lock:
            slot_counts = {rid: self._replicas[rid].slots
                           for rid in self._replicas
                           if self._roles.get(rid) == role}
        load = slots = 0
        for rid, (ld, _, state) in self.replica_loads().items():
            if rid not in slot_counts or \
                    state in (REPLICA_DEAD, REPLICA_CORRUPT):
                continue
            load += ld
            slots += slot_counts.get(rid, 0)
        return 0.0 if slots == 0 else load / slots

    def role_burn_rate(self, role: str,
                       window: Optional[float] = None) -> float:
        """Per-role SLO burn: the role's replicas' window records
        pooled by summed met/n (exact, like the scrape merge). The
        per-role autoscalers scale prefill on prefill burn and decode
        on decode burn — phases stop sharing one error budget."""
        tr = self._slo_tracker
        win = tr.short_window if window is None else float(window)
        n = met = 0
        for rid in self.role_ids(role):
            rep = self._replicas.get(rid)
            label = rid
            if rep is not None:
                inner = rep.engine.engine if rep.supervised \
                    else rep.engine
                label = getattr(inner, "slo_label", rid)
            try:
                agg = tr.label_snapshot("replica", label, window=win)
            except Exception:   # noqa: BLE001 — a dead replica degrades
                continue        # its row, not the signal
            k = int(agg.get("n") or 0)
            n += k
            # NOT `or 1.0`: an attainment of exactly 0.0 (total SLO
            # collapse) is falsy and would read as all-met — the one
            # moment the autoscaler must see maximum burn
            att_i = agg.get("attainment")
            met += int(round((1.0 if att_i is None else float(att_i))
                             * k))
        att = 1.0 if not n else met / n
        return (1.0 - att) / (1.0 - tr.target)

    # ------------------------------------------------------- elastic fleet
    def add_replica(self, engine=None, *, role: str = ROLE_DECODE,
                    replica_id: Optional[str] = None) -> str:
        """Grow ONE role pool live (the per-role autoscalers' scale-up
        seam). The new worker shares the fleet's decoder, so it builds
        nothing new."""
        if role not in (ROLE_PREFILL, ROLE_DECODE):
            raise ValueError(f"role must be 'prefill' or 'decode', "
                             f"got {role!r}")
        rid = str(replica_id) if replica_id is not None \
            else self._mint_rid(role)
        if engine is None:
            engine = self._phase_factory(rid, role)
        # role registered BEFORE the base makes the replica dispatchable
        # (an unroled prefill worker would be invisible to dispatch; an
        # unroled decode worker could receive a fresh prompt)
        self._roles[rid] = role
        try:
            return super().add_replica(engine=engine, replica_id=rid)
        except Exception:
            self._roles.pop(rid, None)
            raise

    def retire_replica(self, rid: str, *, budget: float = 10.0,
                       reason: str = "descale") -> dict:
        """Drain-backed retire, refusing a role's LAST live worker (a
        fleet that can no longer prefill — or decode — is an outage,
        not a descale). Harvested work re-enters through the prefill
        pool like every re-prefill."""
        role = self._roles.get(rid)
        if role is not None:
            with self._lock:
                peers = [r for r in self._roles
                         if r != rid and self._roles.get(r) == role and
                         r in self._health and
                         self._health[r]["state"] not in
                         (REPLICA_DEAD, REPLICA_CORRUPT)]
            if not peers:
                raise ValueError(
                    f"cannot retire {rid}: last live {role} worker — "
                    "the fleet would lose the whole phase")
        out = super().retire_replica(rid, budget=budget, reason=reason)
        self._roles.pop(rid, None)
        return out

    def _replace_replica(self, rid: str) -> Optional[str]:
        """Corrupt-quarantine replacement preserves the ROLE pool: a
        quarantined decode worker is replaced by a decode worker (the
        fleet must not silently lose a phase)."""
        role = self._roles.get(rid)
        if role is None:
            return super()._replace_replica(rid)
        return self.add_replica(role=role)

    # ------------------------------------------------------------ handoff
    def _enqueue_handoff(self, src_rid: str, req, state: PageFrameSet
                         ) -> None:
        """Prefill-engine handoff sink (runs on the prefill serve-loop
        thread): enqueue and return — the transfer happens on the
        router's handoff thread, so the wire overlaps the prefill
        worker's NEXT admission wave."""
        self._handoff_q.put((src_rid, req, state))

    def _handoff_loop(self) -> None:
        while True:
            item = self._handoff_q.get()
            if item is None:
                return
            try:
                self._do_handoff(*item)
            except Exception:   # noqa: BLE001 — one broken handoff must
                # not kill the pump; the request's fleet handle fails
                # through the normal completion gate or shutdown drain
                # (a teardown-window failure is not a transport failure)
                if not self._handoff_stop:
                    self._m_handoff["failed"].inc()

    def _first_live(self, order) -> Optional[EngineReplica]:
        for rep in order:
            if not rep.dead():
                return rep
        return None

    def _do_handoff(self, src_rid: str, req, state: PageFrameSet) -> None:
        """Move one prefilled request to a decode worker, exactly once.

        Fencing: the ledger's ``try_reassign_from(src → dst)`` is the
        compare-and-swap — if migration already moved the request off
        ``src_rid`` (the prefill worker died and its work re-prefilled
        elsewhere), this late ship loses and is DROPPED (counted
        ``fenced``, never served). A transport/adopt failure re-enters
        the prefill pool under the same fence (``failed``)."""
        if self._handoff_stop:
            return          # shutting down: the fleet handle fails in
        #                     the base shutdown's leftover sweep instead
        fid = req.journal_id
        with self._lock:
            fr = self._live.get(fid) if fid is not None else None
        if fr is None or fr.done():
            self._m_handoff["fenced"].inc()
            self._flightrec.record("handoff_fenced", fleet=self.fleet_id,
                                   src=src_rid)
            return
        t0 = interval_now()
        with self._migrate_lock:
            with fr._lock:
                stale = fr.done() or fr.replica_id != src_rid
            if stale:
                self._m_handoff["fenced"].inc()
                self._flightrec.record("handoff_fenced",
                                       fleet=self.fleet_id, src=src_rid)
                return
            order, _ = self._dispatch_order(
                rids=self.role_ids(ROLE_DECODE))
            dst = self._first_live(order)
            if dst is None:
                # no decode capacity anywhere: fail like a no-survivor
                # migration (the prompt is safe in the journal — a
                # restarted fleet recovers and re-prefills it)
                exc = RuntimeError(
                    f"fleet {self.fleet_id}: no live decode worker to "
                    "receive the KV handoff")
                with fr._lock:
                    if not fr.done():
                        fr._fail(exc)
                self._ledger.try_complete(fid, src_rid)
                self._m_handoff["failed"].inc()
                return
            if not self._ledger.try_reassign_from(fid, src_rid,
                                                  dst.replica_id):
                self._m_handoff["fenced"].inc()
                self._flightrec.record("handoff_fenced",
                                       fleet=self.fleet_id, src=src_rid)
                return
            with fr._lock:
                fr.replica_id = dst.replica_id
        # the wire + adopt run OUTSIDE the migrate lock (transport I/O);
        # a decode worker dying from here on fast-fails the request,
        # and the completion gate re-migrates it back through prefill
        try:
            self._faults.fire("disagg.ship")
            shipped = self._transport.ship(state)
            t1 = interval_now()
            self._m_xfer_bytes.inc(state.nbytes)
            self._m_xfer_pages.inc(state.n_pages)
            self._h_xfer.observe(t1 - t0)
            tr = req.trace
            if tr is not None:
                tr.add_span("kv_handoff", t0, t1, src=src_rid,
                            dst=dst.replica_id, bytes=state.nbytes,
                            pages=state.n_pages,
                            transport=self._transport.name)
            self._flightrec.record(
                "kv_handoff", fleet=self.fleet_id, src=src_rid,
                dst=dst.replica_id, bytes=state.nbytes,
                pages=state.n_pages, transport=self._transport.name,
                ms=round((t1 - t0) * 1e3, 3))
            dst.adopt(req, shipped)
        except Exception as exc:   # noqa: BLE001 — transport/geometry
            self._m_handoff["failed"].inc()
            if isinstance(exc, PageCorruptionError):
                # content checksum caught a mid-handoff flip the CRCs
                # could not see — counted as corruption, recovered the
                # same way: re-prefill on a prefill worker
                self._m_kv_corrupt.inc()
                self._flightrec.record(
                    "kv_corruption", fleet=self.fleet_id,
                    detector="handoff", src=src_rid)
            self._flightrec.record(
                "handoff_failed", fleet=self.fleet_id, src=src_rid,
                dst=dst.replica_id,
                cause=f"{type(exc).__name__}: {exc}"[:160])
            self._handoff_reprefill(fr, dst.replica_id, exc)
            return
        self._m_handoff[""].inc()

    def _handoff_reprefill(self, fr, owner_rid: str,
                           cause: BaseException) -> None:
        """Recovery for a failed handoff: the frames are gone, but the
        request (prompt + generated-so-far) re-prefills on a surviving
        prefill worker — deterministic, token-identical, exactly-once
        under the same ledger fence as migration."""
        with self._migrate_lock:
            with fr._lock:
                if fr.done():
                    return
                if fr.replica_id != owner_rid:
                    self._m_handoff["fenced"].inc()
                    return
                inner = fr._inner
            order, _ = self._dispatch_order(sticky_key=fr.sticky_key)
            dst = self._first_live(order)
            if dst is None:
                exc = RuntimeError(
                    f"fleet {self.fleet_id}: KV handoff failed with no "
                    "surviving prefill worker to re-prefill on")
                exc.__cause__ = cause
                with fr._lock:
                    if not fr.done():
                        fr._fail(exc)
                self._ledger.try_complete(fr.request_id, owner_rid)
                return
            if not self._ledger.try_reassign_from(
                    fr.request_id, owner_rid, dst.replica_id):
                self._m_handoff["fenced"].inc()
                return
            with fr._lock:
                fr.replica_id = dst.replica_id
                fr.migrations += 1
        tr = inner.trace
        if tr is not None:
            tr.event("handoff_reprefill", dst=dst.replica_id,
                     cause=type(cause).__name__)
        dst.requeue(inner)

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "PhaseRouter":
        super().start()
        if not self._handoff_threads:
            for i in range(self._n_handoff_threads):
                t = threading.Thread(
                    target=self._handoff_loop, daemon=True,
                    name=f"{self.fleet_id}-handoff-{i}")
                t.start()
                self._handoff_threads.append(t)
        return self

    def shutdown(self) -> None:
        # stop the handoff pump first: frames still queued are DROPPED
        # (their fleet handles fail in the base shutdown's leftover
        # sweep — nothing strands, and nothing ships into dying engines
        # to be miscounted as transport failures)
        self._handoff_stop = True
        threads, self._handoff_threads = self._handoff_threads, []
        try:
            while True:
                self._handoff_q.get_nowait()
        except queue.Empty:
            pass
        for _ in threads:
            self._handoff_q.put(None)
        super().shutdown()
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout=2)

    stop = shutdown

    # --------------------------------------------------------------- views
    def disagg_stats(self) -> dict:
        """The ``/snapshot`` ``disagg`` block: role pools, per-role
        utilization/burn, handoff outcomes, and the measured transfer
        account (register with
        ``TelemetryServer.add_source("disagg", router.disagg_stats)``)."""
        roles = {}
        for role in (ROLE_PREFILL, ROLE_DECODE):
            rids = self.role_ids(role)
            with self._lock:
                alive = [r for r in rids if r in self._health and
                         self._health[r]["state"] not in
                         (REPLICA_DEAD, REPLICA_CORRUPT)]
            roles[role] = {
                "replicas": rids, "alive": len(alive),
                "utilization": round(self.utilization(role=role), 4),
                "burn_short": round(self.role_burn_rate(role), 6)}
        hist = self._h_xfer.to_dict()
        hist.pop("buckets", None)     # count/sum/p50/p99 suffice here
        return {
            "fleet": self.fleet_id,
            "roles": roles,
            "handoffs": {
                "completed": int(self._m_handoff[""].value),
                "fenced": int(self._m_handoff["fenced"].value),
                "failed": int(self._m_handoff["failed"].value),
                "bytes": int(self._m_xfer_bytes.value),
                "pages": int(self._m_xfer_pages.value),
                "queued": self._handoff_q.qsize()},
            "transfer_seconds": hist,
            "transport": self._transport.stats()}

    def fleet_stats(self) -> dict:
        out = super().fleet_stats()
        for rid, row in out["replicas"].items():
            row["role"] = self._roles.get(rid)
        out["disagg"] = self.disagg_stats()
        return out


# ----------------------------------------------------------- autoscaler
class PhaseAutoscaler:
    """Two per-role burn-rate controllers over one :class:`PhaseRouter`
    — prefill capacity follows prefill burn/utilization (bursty,
    compute-bound), decode capacity follows decode burn (steady,
    bandwidth-bound). Each is a full
    :class:`~.autoscale.BurnRateAutoscaler` with its own hysteresis
    state, min/max clamp, and victim selection restricted to its role."""

    def __init__(self, router: PhaseRouter, *,
                 prefill_min: int = 1, prefill_max: int = 2,
                 decode_min: int = 1, decode_max: int = 4,
                 **kw):
        from .autoscale import BurnRateAutoscaler
        self.router = router
        self.prefill = BurnRateAutoscaler(
            router, role=ROLE_PREFILL, min_replicas=prefill_min,
            max_replicas=prefill_max, **kw)
        self.decode = BurnRateAutoscaler(
            router, role=ROLE_DECODE, min_replicas=decode_min,
            max_replicas=decode_max, **kw)

    def start(self) -> "PhaseAutoscaler":
        self.prefill.start()
        self.decode.start()
        return self

    def stop(self) -> None:
        self.prefill.stop()
        self.decode.stop()

    def evaluate_once(self) -> Dict[str, Optional[str]]:
        return {ROLE_PREFILL: self.prefill.evaluate_once(),
                ROLE_DECODE: self.decode.evaluate_once()}

    def stats(self) -> dict:
        return {ROLE_PREFILL: self.prefill.stats(),
                ROLE_DECODE: self.decode.stats()}
