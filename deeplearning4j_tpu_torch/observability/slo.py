"""Per-request SLO accounting: deadline headroom, queue-wait, TTFT, and
rolling-window attainment / burn rate — the JAX package's
``observability/slo.py``, copied.

How much deadline headroom each request FINISHED with, how long it
queued before taking a slot, its time-to-first-token, and whether the
serving process is currently burning its error budget faster than it can
afford: :class:`SLOTracker` is that account. It rides
on the existing ``Trace``/``GenerationRequest`` seam: the engine stamps
three host wall clocks on each request (created / admitted / first
token — the ADMISSION and FIRST-TOKEN stamps are written once and never
reset, so a supervisor takeover or cross-replica migration does not
restart any clock), and the request's exactly-once completion path calls
:meth:`SLOTracker.observe_request`.

Definitions (all host interval-clock seconds — every anchor and every
``now`` comes from :func:`..tracing.interval_now` (``time.perf_counter``),
the observability layer's single interval clock, so a wall-clock NTP
step can never produce a negative queue-wait or garbage headroom):

- ``queue_wait``  — created → admitted (first prefill dispatch);
- ``ttft``        — created → first emitted token;
- ``per_token``   — steady decode: (finish − first token) / (tokens − 1);
- ``latency``     — created → finish;
- ``headroom``    — deadline − finish (absolute deadline anchored at the
  ORIGINAL submission; negative = the request missed, which the engine
  turns into :class:`~..parallel.faults.DeadlineExceeded` — headroom
  records how close every request came, not just the failures);
- ``ok``          — the request completed within its deadline. Requests
  without a deadline count as met (they cannot miss); cancelled
  requests are excluded from attainment (the CALLER withdrew — neither
  met nor missed); sheds and crash-failures count as misses (the user
  did not get service).

Windows: attainment and burn rate are computed over a SHORT and a LONG
rolling window (SRE multi-window burn-rate alerting: the short window
catches a fast burn, the long window keeps a brief blip from paging).
``burn_rate = miss_fraction / (1 − target)`` — 1.0 means the error
budget is being spent exactly at the sustainable rate, 10 means ten
times too fast. Records live in one bounded deque; window queries scan
it under the tracker lock at COLLECTION time (the `/slo` endpoint, the
registry gauges), so the request hot path pays one append per request.

Overhead: recording happens once per REQUEST (not per token or per
block), is plain host Python, and the deque is bounded.
"""

from __future__ import annotations

import threading
import weakref
from collections import deque
from typing import Dict, List, Optional

from .metrics import MetricsRegistry, default_registry
from .tracing import interval_now

#: deadline-headroom histogram buckets (seconds): headroom can be
#: NEGATIVE (finished past the deadline the engine was racing), so the
#: bucket ladder spans both signs
HEADROOM_BUCKETS = (-60.0, -10.0, -1.0, -0.1, 0.0, 0.1, 0.5, 1.0, 2.5,
                    5.0, 10.0, 30.0, 60.0)


class SLORecord:
    """One completed request's SLO account (immutable after creation)."""

    __slots__ = ("t", "status", "ok", "counted", "queue_wait", "ttft",
                 "per_token", "latency", "headroom", "tokens", "route",
                 "replica")

    def __init__(self, t: float, status: str, ok: bool, counted: bool,
                 queue_wait: Optional[float], ttft: Optional[float],
                 per_token: Optional[float], latency: float,
                 headroom: Optional[float], tokens: int,
                 route: Optional[str], replica: Optional[str]):
        self.t = t
        self.status = status
        self.ok = ok
        self.counted = counted
        self.queue_wait = queue_wait
        self.ttft = ttft
        self.per_token = per_token
        self.latency = latency
        self.headroom = headroom
        self.tokens = tokens
        self.route = route
        self.replica = replica

    def to_dict(self) -> dict:
        r = lambda v: None if v is None else round(v, 6)  # noqa: E731
        return {"status": self.status, "ok": self.ok,
                "queue_wait_s": r(self.queue_wait),
                "ttft_s": r(self.ttft), "per_token_s": r(self.per_token),
                "latency_s": r(self.latency),
                "headroom_s": r(self.headroom), "tokens": self.tokens,
                "route": self.route, "replica": self.replica}


def _quantiles(vals: List[float], qs=(50, 99)) -> Dict[str, Optional[float]]:
    """p50/p99 by the same linear interpolation numpy uses — inline so a
    snapshot never imports numpy on the serving thread."""
    out: Dict[str, Optional[float]] = {f"p{q}": None for q in qs}
    if not vals:
        return out
    s = sorted(vals)
    n = len(s)
    for q in qs:
        pos = (q / 100.0) * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        frac = pos - lo
        out[f"p{q}"] = round(s[lo] + (s[hi] - s[lo]) * frac, 6)
    return out


class SLOTracker:
    """Rolling-window SLO accounting over completed requests.

    ``target`` is the attainment objective (0.99 = at most 1% of
    requests may miss); ``short_window``/``long_window`` are the burn-
    rate windows in seconds; ``capacity`` bounds the record deque (and
    therefore memory and the per-collection scan) regardless of uptime.

    Registry integration: ``slo_requests_total{tracker,status}``
    counters plus ``slo_attainment_ratio{tracker,window}`` /
    ``slo_burn_rate{tracker,window}`` gauges (weakref callbacks — a
    retired tracker never pins itself through the registry) and
    ``slo_ttft_seconds`` / ``slo_queue_wait_seconds`` /
    ``slo_deadline_headroom_seconds`` histograms, all evaluated from
    already-recorded state."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 name: str = "default", target: float = 0.99,
                 short_window: float = 60.0, long_window: float = 600.0,
                 capacity: int = 4096):
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        self.name = str(name)
        self.target = float(target)
        self.short_window = float(short_window)
        self.long_window = float(long_window)
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=int(capacity))
        self._totals: Dict[str, int] = {}
        self._requests = 0
        self._missed = 0
        reg = registry if registry is not None else default_registry()
        self._m_requests = reg.counter(
            "slo_requests_total", "requests SLO-accounted, by outcome",
            ("tracker", "status"))
        self._h_ttft = reg.histogram(
            "slo_ttft_seconds", "created -> first token", ("tracker",))
        self._h_queue = reg.histogram(
            "slo_queue_wait_seconds", "created -> admitted", ("tracker",))
        self._h_headroom = reg.histogram(
            "slo_deadline_headroom_seconds",
            "deadline - finish at completion (negative = missed)",
            ("tracker",), buckets=HEADROOM_BUCKETS)
        wself = weakref.ref(self)
        g_att = reg.gauge("slo_attainment_ratio",
                          "rolling-window SLO attainment",
                          ("tracker", "window"))
        g_burn = reg.gauge("slo_burn_rate",
                           "error-budget burn rate (1.0 = sustainable)",
                           ("tracker", "window"))
        for win, secs in (("short", self.short_window),
                          ("long", self.long_window)):
            g_att.labels(self.name, win).set_function(
                lambda _s=secs: (lambda t: 1.0 if t is None else
                                 t.attainment(_s))(wself()))
            g_burn.labels(self.name, win).set_function(
                lambda _s=secs: (lambda t: 0.0 if t is None else
                                 t.burn_rate(_s))(wself()))

    # ---------------------------------------------------------- recording
    def record(self, status: str = "ok", *,
               queue_wait: Optional[float] = None,
               ttft: Optional[float] = None,
               per_token: Optional[float] = None,
               latency: float = 0.0, headroom: Optional[float] = None,
               tokens: int = 0, route: Optional[str] = None,
               replica: Optional[str] = None,
               now: Optional[float] = None) -> SLORecord:
        """Record one completed request. ``now`` is injectable for
        deterministic window tests; production callers omit it."""
        t = interval_now() if now is None else float(now)
        counted = status != "cancelled"
        ok = status == "ok" and (headroom is None or headroom >= 0.0)
        rec = SLORecord(t, str(status), ok, counted, queue_wait, ttft,
                        per_token, float(latency), headroom, int(tokens),
                        route, replica)
        with self._lock:
            self._records.append(rec)
            self._totals[rec.status] = self._totals.get(rec.status, 0) + 1
            if counted:
                self._requests += 1
                if not ok:
                    self._missed += 1
        self._m_requests.labels(self.name, rec.status).inc()
        if ttft is not None:
            self._h_ttft.labels(self.name).observe(ttft)
        if queue_wait is not None:
            self._h_queue.labels(self.name).observe(queue_wait)
        if headroom is not None:
            self._h_headroom.labels(self.name).observe(headroom)
        return rec

    def observe_request(self, req, status: str = "ok") -> SLORecord:
        """The engine-side seam: derive every SLO quantity from the
        request's stamped clocks. Called exactly once per request from
        its completion path (``_complete``/``_fail`` fire once); the
        clocks are anchored at the ORIGINAL submission, so supervisor
        takeover and fleet migration never reset them."""
        now = interval_now()
        created = getattr(req, "_created_t", None)
        if created is None:                      # degrade, never raise
            created = now
        admitted = getattr(req, "_admitted_t", None)
        first_tok = getattr(req, "_first_token_t", None)
        tokens = len(getattr(req, "generated", ()) or ())
        deadline_t = getattr(req, "_deadline_t", None)
        labels = getattr(req, "_slo_labels", None) or {}
        per_token = None
        if first_tok is not None and tokens > 1:
            per_token = (now - first_tok) / (tokens - 1)
        return self.record(
            status,
            queue_wait=None if admitted is None else admitted - created,
            ttft=None if first_tok is None else first_tok - created,
            per_token=per_token, latency=now - created,
            headroom=None if deadline_t is None else deadline_t - now,
            tokens=tokens, route=labels.get("route"),
            replica=labels.get("replica"), now=now)

    # ------------------------------------------------------------- windows
    def _window_records(self, window: Optional[float],
                        now: Optional[float] = None) -> List[SLORecord]:
        t = interval_now() if now is None else float(now)
        with self._lock:
            recs = list(self._records)
        if window is None:
            return recs
        cut = t - float(window)
        return [r for r in recs if r.t >= cut]

    def attainment(self, window: Optional[float] = None,
                   now: Optional[float] = None) -> float:
        """Fraction of counted requests in the window that met their
        SLO; 1.0 on an empty window (no traffic burns no budget)."""
        recs = [r for r in self._window_records(window, now) if r.counted]
        if not recs:
            return 1.0
        return sum(r.ok for r in recs) / len(recs)

    def burn_rate(self, window: Optional[float] = None,
                  now: Optional[float] = None) -> float:
        """Miss fraction over the window divided by the error budget
        (1 − target): 1.0 = burning exactly at the sustainable rate."""
        return (1.0 - self.attainment(window, now)) / (1.0 - self.target)

    # --------------------------------------------------------------- views
    @staticmethod
    def _agg(recs: List[SLORecord]) -> dict:
        counted = [r for r in recs if r.counted]
        met = sum(r.ok for r in counted)
        out = {
            "n": len(counted),
            "met": met,
            "attainment": 1.0 if not counted else
            round(met / len(counted), 6),
            "ttft_s": _quantiles([r.ttft for r in recs
                                  if r.ttft is not None]),
            "queue_wait_s": _quantiles([r.queue_wait for r in recs
                                        if r.queue_wait is not None]),
            "per_token_s": _quantiles([r.per_token for r in recs
                                       if r.per_token is not None]),
            "latency_s": _quantiles([r.latency for r in recs]),
        }
        heads = [r.headroom for r in recs if r.headroom is not None]
        out["headroom_s"] = _quantiles(heads)
        out["headroom_s"]["min"] = round(min(heads), 6) if heads else None
        return out

    def label_snapshot(self, kind: str, label: str,
                       window: Optional[float] = None) -> dict:
        """Aggregate over one label value (``kind`` is "route" or
        "replica") — the per-replica SLO view ``fleet_stats()`` embeds."""
        recs = [r for r in self._window_records(window)
                if getattr(r, kind, None) == label]
        return self._agg(recs)

    def snapshot(self, now: Optional[float] = None) -> dict:
        """The `/slo` endpoint document: lifetime totals, both burn-rate
        windows, latency quantiles, and per-route / per-replica splits."""
        t = interval_now() if now is None else float(now)
        recs = self._window_records(None)
        with self._lock:
            totals = dict(self._totals)
            requests, missed = self._requests, self._missed
        windows = {}
        for win, secs in (("short", self.short_window),
                          ("long", self.long_window)):
            in_win = [r for r in recs if r.t >= t - secs]
            counted = [r for r in in_win if r.counted]
            met = sum(r.ok for r in counted)
            att = 1.0 if not counted else met / len(counted)
            windows[win] = {
                "window_s": secs, "n": len(counted), "met": met,
                "attainment": round(att, 6),
                "burn_rate": round((1.0 - att) / (1.0 - self.target), 6),
            }
        by_route: Dict[str, List[SLORecord]] = {}
        by_replica: Dict[str, List[SLORecord]] = {}
        for r in recs:
            if r.route is not None:
                by_route.setdefault(r.route, []).append(r)
            if r.replica is not None:
                by_replica.setdefault(r.replica, []).append(r)
        return {
            "tracker": self.name,
            "target": self.target,
            "requests": requests,
            "missed": missed,
            "by_status": totals,
            "windows": windows,
            "overall": self._agg(recs),
            "routes": {k: self._agg(v)
                       for k, v in sorted(by_route.items())},
            "replicas": {k: self._agg(v)
                         for k, v in sorted(by_replica.items())},
        }

    def recent(self, n: int = 50) -> List[dict]:
        with self._lock:
            recs = list(self._records)[-int(n):]
        return [r.to_dict() for r in recs]


_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[SLOTracker] = None


def default_slo_tracker() -> SLOTracker:
    """Process-default tracker (bound to the default registry) every
    engine falls back to when none is injected — the same
    default-plus-injectable discipline as the registry and trace ring."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = SLOTracker()
        return _DEFAULT
