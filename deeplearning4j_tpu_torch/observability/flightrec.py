"""Crash flight recorder: a bounded structured event ring with a
post-mortem ``dump()`` — the JAX package's ``observability/flightrec.py``,
copied; its post-mortem artifacts keep that JSON layout.

When a replica dies mid-soak at 3am, the metrics registry says HOW MANY
crashes happened and the trace ring says what one request's timeline
looked like — neither says what the RUNTIME was doing in the seconds
before the death. The flight recorder is that black box: every
lifecycle event on the serving path (admission batches, block retires,
sheds, takeovers, migrations, broker reconnects, fired fault
injections, replica deaths) appends one bounded host-side record, and
when a supervisor or fleet router declares something dead it calls
:meth:`FlightRecorder.write_postmortem`, which bundles

- the last-N events (the ring's whole content),
- the failed/recovered requests' trace timelines,
- the metrics-registry snapshot at death,
- per-tag device→host readback counts (``ops/transfer.py``), and a
  compile-audit report when a caller attaches one (``compile_audit=``;
  the port has no compiler and attaches none),

into one JSON artifact a human (or ``tools/chaos_soak.py``) can read
AFTER the process state is gone.

Overhead rules: ``record()`` is one deque append + one counter bump
under a single lock — events fire at lifecycle rate
(per-admission-batch / per-block / per-takeover), never per token; the
ring is ``capacity``-bounded forever; per-block events are gated on the
engine's ``tracing`` flag so the telemetry-off A/B arm skips them.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .metrics import MetricsRegistry, default_registry

#: canonical event kinds (callers may record others; these are the ones
#: the serving stack emits)
EVENT_KINDS = ("admission", "block_retire", "shed", "takeover",
               "migration", "reconnect", "fault", "crash",
               "replica_dead", "postmortem", "journal", "recovered",
               "preempt", "prefill_chunk", "scale_up", "descale",
               "autoscale", "page_preempt", "kv_handoff",
               "handoff_fenced", "handoff_failed",
               # SDC defense
               "numerical_fault", "kv_corruption", "corruption_injected",
               "replica_corrupt", "canary")


class FlightRecorder:
    """Bounded event ring + post-mortem artifact writer."""

    def __init__(self, capacity: int = 512,
                 registry: Optional[MetricsRegistry] = None,
                 name: str = "flightrec"):
        self.name = str(name)
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._t0 = time.monotonic()
        self._dumps: List[str] = []        # artifact paths written
        reg = registry if registry is not None else default_registry()
        self._m_events = reg.counter(
            "flightrec_events_total", "flight-recorder events, by kind",
            ("kind",))

    # ---------------------------------------------------------- recording
    def record(self, kind: str, **fields) -> None:
        """Append one event (host wall clock, monotonically sequenced).
        Fields must be JSON-serializable scalars/strings — the artifact
        is read long after the objects are gone."""
        t = time.monotonic()
        with self._lock:
            self._seq += 1
            self._ring.append({"seq": self._seq,
                               "t": round(t - self._t0, 6),
                               "kind": str(kind), **fields})
        self._m_events.labels(str(kind)).inc()

    def events(self, n: Optional[int] = None,
               kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs if n is None else evs[-int(n):]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def total_events(self) -> int:
        with self._lock:
            return self._seq

    # --------------------------------------------------------- post-mortem
    def dump(self, *, reason: str, cause: Optional[BaseException] = None,
             traces=(), registry: Optional[MetricsRegistry] = None,
             compile_audit=None, extra: Optional[dict] = None) -> dict:
        """Assemble the post-mortem document (no I/O): last-N events,
        the implicated requests' trace timelines, a registry snapshot,
        transfer deltas since the recorder armed, and the compile-audit
        report when one is attached. Every section degrades
        independently — a half-dead process must still yield a usable
        artifact."""
        doc: dict = {
            "reason": str(reason),
            "recorder": self.name,
            "wall_time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "uptime_s": round(time.monotonic() - self._t0, 3),
        }
        if cause is not None:
            doc["cause"] = f"{type(cause).__name__}: {cause}"[:500]
        doc["events"] = self.events()
        trace_docs = []
        req_ids = []
        for tr in traces:
            if tr is None:
                continue
            try:
                trace_docs.append(tr.to_dict())
                req_ids.append(tr.request_id)
            except Exception:   # noqa: BLE001 — a torn trace degrades
                pass
        doc["traces"] = trace_docs
        doc["request_ids"] = req_ids
        if registry is not None:
            try:
                doc["metrics"] = registry.snapshot()
            except Exception as e:   # noqa: BLE001
                doc["metrics"] = {"error": f"{type(e).__name__}"[:100]}
        try:
            from ..ops.transfer import fetch_counts
            doc["transfers"] = {t: c for t, c in
                                sorted(fetch_counts().items()) if c}
        except Exception:   # noqa: BLE001
            pass
        if compile_audit is not None:
            try:
                doc["compile_audit"] = compile_audit.report()
            except Exception:   # noqa: BLE001
                pass
        if extra:
            doc["extra"] = dict(extra)
        return doc

    def write_postmortem(self, directory: str, tag: str = "engine",
                         **dump_kw) -> Optional[str]:
        """Write one post-mortem artifact into ``directory`` (created if
        missing) and record a ``postmortem`` event pointing at it.
        Returns the path, or None if the write failed — a full disk must
        not turn a recovery path into a second crash."""
        doc = self.dump(**dump_kw)
        with self._lock:
            seq = self._seq + 1            # the postmortem event's seq
        base = f"postmortem-{tag}-{seq:05d}"
        path = os.path.join(directory, base + ".json")
        try:
            os.makedirs(directory, exist_ok=True)
            # seq is per-RECORDER: a second soak round (fresh recorder,
            # same dir) or a second process restarts it, and os.replace
            # would silently clobber the earlier black box — probe past
            # existing artifacts instead of overwriting one
            k = 0
            while os.path.exists(path):
                k += 1
                path = os.path.join(directory, f"{base}.{k}.json")
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1, default=str)
            os.replace(tmp, path)
        except OSError:
            self.record("postmortem", tag=str(tag), error="write failed")
            return None
        with self._lock:
            self._dumps.append(path)
        self.record("postmortem", tag=str(tag), path=path,
                    requests=len(doc.get("request_ids", ())))
        return path

    @property
    def dumps(self) -> List[str]:
        """Paths of every artifact this recorder has written."""
        with self._lock:
            return list(self._dumps)

    def stats(self) -> Dict[str, object]:
        """Snapshot-source shape: ring occupancy + per-kind counts of
        what is currently IN the ring (lifetime counts live on the
        ``flightrec_events_total`` counter)."""
        with self._lock:
            evs = list(self._ring)
            seq = self._seq
            dumps = len(self._dumps)
        kinds: Dict[str, int] = {}
        for e in evs:
            kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
        return {"events_total": seq, "ring": len(evs),
                "capacity": self.capacity, "by_kind": kinds,
                "postmortems_written": dumps}


_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[FlightRecorder] = None


def default_flight_recorder() -> FlightRecorder:
    """Process-default recorder (bound to the default registry) —
    injectable per component, like every other observability sink."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = FlightRecorder()
        return _DEFAULT
