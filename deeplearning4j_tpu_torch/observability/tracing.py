"""Per-request tracing for the serving path — the JAX package's
``observability/tracing.py``, copied; :func:`interval_now` is the port's
one interval clock (``observability/clock.py``), re-exported here.

One :class:`Trace` follows one generation request from the moment it
enters the system (route consume / engine submit) to the moment its
output leaves (publish), as a flat list of host-side wall-time
:class:`Span` records: ``consume`` → ``submit`` → ``queued`` →
``prefill`` → ``decode_block``×N → (``takeover`` on supervised
recovery) → ``publish``. The trace object rides ON the
GenerationRequest, so EngineSupervisor quarantine → ``requeue`` keeps
the SAME trace across an engine restart — a recovered request yields
exactly one trace, with a ``takeover`` span marking the seam, never two
half-traces.

Overhead rules:

- spans carry host INTERVAL-clock times only (:func:`interval_now`,
  ``time.perf_counter``; each trace keeps exactly ONE ``time.time()``
  anchor, ``wall_anchor``, for display) — recording a span never touches
  the device, never reads back beyond the serving path's existing
  ``device_fetch`` seam;
- recording is bounded: a trace keeps at most ``max_spans`` spans
  (oldest decode blocks are the ones that matter least; overflow is
  counted in ``dropped_spans``), and completed traces land in a fixed
  ring (:class:`TraceRing`) — memory is O(ring × max_spans) forever.

The training step's phases are spans of another kind: :func:`phase`
puts ``dl4j.<name>`` ``record_function`` ranges on the PyTorch
profiler's clock while a profiler records (any ``torch.profiler``
run, such as ``ui.profiler_trace``), so they land in the same trace
as the kernels they launch, and costs one check and nothing else
otherwise. ``ComputationGraph`` and ``MultiLayerNetwork``
open ``dl4j.fit`` (its argument the iteration) around each update, and
inside it ``dl4j.fit.input`` (the batch to the device in the compute
dtype), ``dl4j.fit.forward`` (the loss), ``dl4j.fit.backward``
(``torch.autograd.grad``), ``dl4j.fit.update`` (normalization, learning
rate and update rule of every leaf; data-parallel steps too) and
``dl4j.fit.listeners``. Layers open spans of their own inside those
(SwinV2's ``dl4j.swin.shuffle``, ``dl4j.swin.bias``,
``dl4j.swin.attention``). :func:`phase_times` reads a Chrome trace of such
a run as device time, launches and device idle time by innermost span.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .clock import interval_now

_TRACE_IDS = itertools.count(1)


class Span:
    """One closed interval on a trace's timeline (host wall clock)."""

    __slots__ = ("name", "t0", "t1", "attrs")

    def __init__(self, name: str, t0: float, t1: float,
                 attrs: Optional[dict] = None):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs or {}

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        d = {"name": self.name, "t0": round(self.t0, 6),
             "t1": round(self.t1, 6),
             "duration_ms": round((self.t1 - self.t0) * 1e3, 3)}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class Trace:
    """Timeline of one request. Thread-safe: the route's consumer thread,
    the engine's serve loop, and the route's publisher thread all append
    to the same trace at different lifecycle stages.

    ``finish()`` is idempotent and pushes the trace into its store
    (ring buffer) exactly once; spans may still be appended afterwards —
    the in-order publisher records its ``publish`` span a beat after the
    engine completes the request, and the ring holds the live object, so
    the span shows up in ``/traces/recent`` regardless."""

    def __init__(self, request_id: Optional[str] = None, store=None,
                 max_spans: int = 512):
        self.trace_id = next(_TRACE_IDS)
        self.request_id = request_id if request_id is not None \
            else f"req-{self.trace_id}"
        self.max_spans = int(max_spans)
        self._store = store
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self.dropped_spans = 0
        self.created_at = interval_now()
        #: the single wall-clock anchor (display only): created_at on
        #: the wall clock — interval math never touches it
        self.wall_anchor = time.time()
        self.finished_at: Optional[float] = None
        self.status: Optional[str] = None
        self.attrs: Dict = {}

    # ---------------------------------------------------------- recording
    def add_span(self, name: str, t0: Optional[float] = None,
                 t1: Optional[float] = None, **attrs) -> None:
        now = interval_now()
        span = Span(name, now if t0 is None else t0,
                    now if t1 is None else t1, attrs or None)
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped_spans += 1
                return
            self._spans.append(span)

    def event(self, name: str, **attrs) -> None:
        """Zero-duration span (a point on the timeline)."""
        self.add_span(name, **attrs)

    def span(self, name: str, **attrs) -> "_SpanCtx":
        """``with trace.span("prefill"):`` records on exit."""
        return _SpanCtx(self, name, attrs)

    def annotate(self, **attrs) -> None:
        with self._lock:
            self.attrs.update(attrs)

    # --------------------------------------------------------- lifecycle
    @property
    def finished(self) -> bool:
        with self._lock:
            return self.finished_at is not None

    @property
    def duration(self) -> Optional[float]:
        with self._lock:
            if self.finished_at is None:
                return None
            return self.finished_at - self.created_at

    def finish(self, status: str = "ok", **attrs) -> None:
        """Close the trace and hand it to the ring — exactly once; later
        calls (a request failed twice through racing paths) are no-ops
        so a request can never occupy two ring slots."""
        with self._lock:
            if self.finished_at is not None:
                return
            self.finished_at = interval_now()
            self.status = status
            if attrs:
                self.attrs.update(attrs)
            store = self._store
        if store is not None:
            store.add(self)

    # ------------------------------------------------------------- views
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def span_names(self) -> List[str]:
        return [s.name for s in self.spans()]

    def to_dict(self) -> dict:
        """JSON timeline: spans sorted by start time (append order may
        interleave across threads), times rebased to the trace origin."""
        with self._lock:
            spans = sorted(self._spans, key=lambda s: (s.t0, s.t1))
            base = self.created_at
            out = {
                "trace_id": self.trace_id,
                "request_id": self.request_id,
                "status": self.status,
                "duration_ms": None if self.finished_at is None else
                round((self.finished_at - base) * 1e3, 3),
                "dropped_spans": self.dropped_spans,
                "wall_time": round(self.wall_anchor, 6),
                "attrs": dict(self.attrs),
            }
        out["spans"] = [{**s.to_dict(),
                         "t0": round(s.t0 - base, 6),
                         "t1": round(s.t1 - base, 6)} for s in spans]
        return out


class _SpanCtx:
    __slots__ = ("_trace", "_name", "_attrs", "_t0")

    def __init__(self, trace: Trace, name: str, attrs: dict):
        self._trace = trace
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> "_SpanCtx":
        self._t0 = interval_now()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self._attrs = dict(self._attrs, error=exc_type.__name__)
        self._trace.add_span(self._name, self._t0, interval_now(),
                             **self._attrs)


class TraceRing:
    """Fixed-capacity ring of completed traces (newest last). The
    ``/traces/recent`` endpoint serves from here; memory is bounded by
    capacity × max_spans regardless of uptime."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._added = 0

    def add(self, trace: Trace) -> None:
        with self._lock:
            self._ring.append(trace)
            self._added += 1

    def recent(self, n: Optional[int] = None) -> List[Trace]:
        with self._lock:
            items = list(self._ring)
        return items if n is None else items[-int(n):]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def total_added(self) -> int:
        with self._lock:
            return self._added


_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[TraceRing] = None


def default_trace_ring() -> TraceRing:
    """Process-default completed-trace ring (capacity 256). Injectable
    per component for test isolation, like the metrics registry."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = TraceRing(256)
        return _DEFAULT


# ------------------------------------------------ training-step phases
#: prefix of the training step's span names
PHASE_PREFIX = "dl4j."
#: what :func:`phase_times` files work and idle time under where no
#: span holds it
OUTSIDE = "outside"
#: Chrome-trace categories of device work, and of the host calls that
#: launch it
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_OFF = contextlib.nullcontext()


def phase(name: str, arg=None):
    """The span ``dl4j.<name>`` of the training step: a
    ``torch.profiler.record_function`` range (``arg``, where given, its
    argument) while a PyTorch profiler records, else one shared null
    context, so with tracing off a phase costs this one check."""
    if torch.autograd._profiler_enabled():
        return _recorded(name, arg)
    return _OFF


def _recorded(name: str, arg):
    return torch.profiler.record_function(
        PHASE_PREFIX + name, None if arg is None else str(arg))


def _innermost(spans: Sequence[Tuple[float, float, str]]):
    """Disjoint (start, end, name) segments, sorted, each named by the
    innermost of the nested ``spans`` that holds it (a child cut to its
    parent's end where rounding lets it run over)."""
    segments: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []
    t = 0.0

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][0] <= limit:
            end, name = stack.pop()
            if end > t:
                segments.append((t, end, name))
                t = end

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_until(a)
        if stack and a > t:
            segments.append((t, a, stack[-1][1]))
        stack.append((min(b, stack[-1][0]) if stack else b, name))
        t = a
    close_until(float("inf"))
    return segments


def phase_times(events: Sequence[Dict],
                window: Optional[Tuple[float, float]] = None
                ) -> Dict[str, Dict[str, float]]:
    """Device seconds, kernel launches and device idle seconds by
    ``dl4j.`` span, from the ``traceEvents`` of a PyTorch profiler's
    Chrome trace (``export_chrome_trace``): {span name or
    :data:`OUTSIDE`: {"device_s", "launches", "idle_s"}}.

    A kernel, copy or memset belongs to the innermost ``dl4j.`` span, on
    the thread of the earliest such span, whose interval holds the host
    time of the runtime or driver call that launched it
    (``args.correlation``), whatever thread made that call:
    the autograd engine launches the backward from a thread of its own
    while the caller waits inside ``dl4j.fit.backward``. Device work that
    overlaps counts once, to the op that started first, so the device
    seconds sum to the union of the device intervals. A gap in that union
    belongs to the innermost span holding its start. ``window`` (host
    microseconds) bounds what is counted; by default from the first to
    the last device op or span."""
    spans = [e for e in events if e.get("ph") == "X" and
             e.get("cat") == "user_annotation" and
             str(e.get("name", "")).startswith(PHASE_PREFIX)]
    tid = min(spans, key=lambda e: float(e["ts"]))["tid"] if spans else None
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in spans if e["tid"] == tid]
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS and
                "correlation" in e.get("args", {})}
    ops = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                   e["cat"], e.get("args", {}).get("correlation"))
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                 key=lambda op: op[:2])
    if window is None:
        ends = [x for a, b, *_ in spans + ops for x in (a, b)]
        window = (min(ends), max(ends)) if ends else (0.0, 0.0)
    w0, w1 = window
    segments = _innermost(spans)
    starts = [s[0] for s in segments]

    def owner(t):
        if t is None:
            return OUTSIDE
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and segments[i][0] <= t < segments[i][1]:
            return segments[i][2]
        return OUTSIDE

    out = defaultdict(lambda: {"device_s": 0.0, "launches": 0,
                               "idle_s": 0.0})
    out[OUTSIDE] = out.default_factory()
    covered = w0
    for a, b, cat, corr in ops:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if a > covered:
            out[owner(covered)]["idle_s"] += (a - covered) * 1e-6
        who = out[owner(launched.get(corr))]
        who["launches"] += int(cat == "kernel")
        if b > covered:
            who["device_s"] += (b - max(a, covered)) * 1e-6
            covered = b
    if w1 > covered:
        out[owner(covered)]["idle_s"] += (w1 - covered) * 1e-6
    return dict(out)
