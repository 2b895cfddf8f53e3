"""Unified metrics registry: labeled Counters, Gauges, and fixed-bucket
Histograms with a Prometheus-style text exposition and a nested-dict
``snapshot()`` — the JAX package's ``observability/metrics.py``, copied
(same families, label handling, snapshot layout and exposition bytes).

The one place a number goes when something countable happens in the
serving tier; the engine's ``stats()``, the supervisor's, the routes' and
the brokers' counters are views over it.

Design rules:

- **Lock discipline** — every mutation happens under the owning child's
  lock; readers take the same lock. Metric updates from thread targets
  are method calls on these objects, never raw attribute writes.
- **Host-side only** — recording is plain Python on host values; nothing
  here touches a device tensor.
- **Labels are cheap and exact** — ``family.labels(engine="e3")``
  returns a per-label-set child (created once, cached); per-instance
  label values (one per engine/route/broker) keep test assertions exact
  while ``/metrics`` still aggregates across the process. Children live
  until removed, so a process that churns through many instances against
  the process default should inject a scoped registry per run or prune
  retired children with ``family.remove(label)``. Gauge callbacks hold
  weak references, so a retired child never pins its engine (or its
  device caches) — it just reads 0.
- **Process default + injectable instances** — components default to
  :func:`default_registry`; tests inject a fresh
  :class:`MetricsRegistry` for isolation.

Histogram percentiles serve two callers: the serving path uses pure
fixed-bucket children (bounded memory, O(#buckets)), while the soak and
smoke drivers construct value-retaining histograms (``sample_limit=None``)
whose ``percentile()`` is exact (numpy linear interpolation).
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

#: default latency buckets (seconds): 100µs .. 60s, roughly log-spaced —
#: covers a CPU decode block through a remote dispatch round trip
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _label_key(label_names: Tuple[str, ...], values: Tuple) -> str:
    """Stable string form of a label set ('' for the unlabeled child)."""
    return ",".join(f"{n}={v}" for n, v in zip(label_names, values))


def _escape_label(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


class _Child:
    """State shared by every per-label-set child: its own lock and the
    (name, label values) identity used at exposition time."""

    def __init__(self, family: "_Family", values: Tuple):
        self._family = family
        self._values = values
        self._lock = threading.Lock()

    @property
    def label_values(self) -> Tuple:
        return self._values


class CounterChild(_Child):
    """Monotonic counter. ``inc`` returns the post-increment value so
    callers that need the running count (e.g. the engine's prefill batch
    number feeding a PRNG salt) read it from the same atomic section."""

    def __init__(self, family, values):
        super().__init__(family, values)
        self._value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self):
        with self._lock:
            return self._value


class GaugeChild(_Child):
    """Settable value; ``set_function`` installs a callable evaluated at
    collection time (zero hot-path cost for 'current depth' gauges).
    Callbacks should hold weak references to their subject so a dead
    engine/route does not live forever inside the registry."""

    def __init__(self, family, values):
        super().__init__(family, values)
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n=1) -> None:
        with self._lock:
            self._value -= n

    def set_function(self, fn: Callable[[], float]) -> None:
        with self._lock:
            self._fn = fn

    @property
    def value(self):
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return fn()
        except Exception:   # noqa: BLE001 — a dead callback reads as 0
            return 0


class HistogramChild(_Child):
    """Fixed-bucket histogram: cumulative-at-exposition bucket counts,
    sum, count; optionally retains raw samples for exact percentiles
    (``sample_limit=None`` → unlimited; 0 → buckets only; N → first N
    samples exact, then bucket-interpolated)."""

    def __init__(self, family, values):
        super().__init__(family, values)
        self._buckets: Tuple[float, ...] = family.buckets
        self._counts = [0] * (len(self._buckets) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._sample_limit = family.sample_limit
        self._samples: List[float] = []

    def observe(self, v) -> None:
        v = float(v)
        # bisect over the sorted bounds: observe() runs on the serving
        # readback thread once per phase per block — O(log #buckets)
        # beats the linear scan the hot path used to pay
        i = bisect.bisect_left(self._buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if self._sample_limit is None or \
                    len(self._samples) < self._sample_limit:
                self._samples.append(v)

    def observe_many(self, vs: Iterable) -> None:
        for v in vs:
            self.observe(v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 100]. Exact (numpy 'linear' interpolation over the
        retained samples) when every observation was retained; otherwise
        estimated by linear interpolation inside the covering bucket.
        None on an empty histogram."""
        with self._lock:
            if self._count == 0:
                return None
            if len(self._samples) == self._count:
                samples = list(self._samples)
            else:
                samples = None
            counts = list(self._counts)
            total = self._count
        if samples is not None:
            return float(np.percentile(np.asarray(samples, np.float64), q))
        # bucket interpolation: rank within the cumulative distribution
        rank = (q / 100.0) * total
        cum = 0
        lo = 0.0
        for i, c in enumerate(counts):
            hi = self._buckets[i] if i < len(self._buckets) else \
                (self._buckets[-1] if self._buckets else lo)
            if cum + c >= rank and c > 0:
                frac = (rank - cum) / c
                return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))
            cum += c
            lo = hi
        return float(lo)

    def to_dict(self) -> dict:
        with self._lock:
            out = {
                "count": self._count,
                "sum": round(self._sum, 9),
                "buckets": {str(b): 0 for b in self._buckets},
            }
            cum = 0
            for i, b in enumerate(self._buckets):
                cum += self._counts[i]
                out["buckets"][str(b)] = cum
            out["buckets"]["+Inf"] = cum + self._counts[-1]
        for q in (50, 99):
            p = self.percentile(q)
            out[f"p{q}"] = None if p is None else round(p, 9)
        return out


class _Family:
    """A named metric with a fixed label schema; children are cached per
    label-value tuple. A family declared with no labels acts as its own
    (single) child: ``family.inc()`` etc. delegate to it."""

    kind = "untyped"
    child_cls = CounterChild

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: Dict[Tuple, _Child] = {}
        if not self.label_names:
            self.labels()                    # materialize the default child

    def labels(self, *values, **kw):
        if kw:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "name, not both")
            try:
                values = tuple(kw[n] for n in self.label_names)
            except KeyError as e:
                raise ValueError(f"missing label {e} for {self.name}; "
                                 f"schema is {self.label_names}") from e
        values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(f"{self.name} takes labels "
                             f"{self.label_names}, got {values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self.child_cls(self, values)
                self._children[values] = child
            return child

    def children(self) -> Dict[str, _Child]:
        with self._lock:
            return {_label_key(self.label_names, v): c
                    for v, c in sorted(self._children.items())}

    def remove(self, *values, **kw) -> bool:
        """Drop one label-set child from exposition (True if it
        existed). Per-instance labels mean instance churn grows a
        family's child set; a long-lived process that creates and
        discards many engines/routes against the PROCESS-DEFAULT
        registry can prune retired children here — or, better, inject a
        scoped ``MetricsRegistry`` per run the way the tests and the A/B
        benches do, and let the whole registry go with the scope."""
        if kw:
            values = tuple(kw[n] for n in self.label_names)
        values = tuple(str(v) for v in values)
        with self._lock:
            return self._children.pop(values, None) is not None

    # unlabeled-family conveniences -------------------------------------
    def _default(self):
        if self.label_names:
            raise ValueError(f"{self.name} is labeled "
                             f"{self.label_names}; call .labels(...)")
        return self.labels()

    def inc(self, n=1):
        return self._default().inc(n)

    @property
    def value(self):
        return self._default().value


class Counter(_Family):
    kind = "counter"
    child_cls = CounterChild


class Gauge(_Family):
    kind = "gauge"
    child_cls = GaugeChild

    def set(self, v):
        return self._default().set(v)

    def set_function(self, fn):
        return self._default().set_function(fn)


class Histogram(_Family):
    """Histogram family. Constructible standalone (the perf scripts build
    value-retaining instances for exact percentiles) or through
    :meth:`MetricsRegistry.histogram`."""

    kind = "histogram"
    child_cls = HistogramChild

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                 sample_limit: Optional[int] = 0):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self.sample_limit = sample_limit
        super().__init__(name, help, label_names)

    def observe(self, v):
        return self._default().observe(v)

    def observe_many(self, vs):
        return self._default().observe_many(vs)

    def percentile(self, q):
        return self._default().percentile(q)

    @property
    def count(self):
        return self._default().count


def percentiles(values: Iterable[float],
                qs: Sequence[float] = (50, 99)) -> Dict[str, float]:
    """One-shot exact percentiles through the shared Histogram path —
    the perf scripts' replacement for their private np.percentile math.
    Returns {"p50": ..., "p99": ...} (None values on empty input)."""
    h = Histogram("adhoc_percentiles", sample_limit=None)
    h.observe_many(values)
    return {f"p{g:g}": h.percentile(g) for g in qs}


class MetricsRegistry:
    """Thread-safe named-family registry.

    ``counter/gauge/histogram`` are idempotent per name: re-declaring an
    existing family returns it (so every engine/route constructor can
    declare its families without coordination), but re-declaring with a
    DIFFERENT kind or label schema raises — a name means one thing."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # ------------------------------------------------------ registration
    def _register(self, cls, name, help, label_names, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or \
                        fam.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.label_names}; cannot re-register "
                        f"as {cls.kind}{tuple(label_names)}")
                return fam
            fam = cls(name, help, label_names, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                label_names: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, label_names)

    def gauge(self, name: str, help: str = "",
              label_names: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, label_names)

    def histogram(self, name: str, help: str = "",
                  label_names: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  sample_limit: Optional[int] = 0) -> Histogram:
        return self._register(Histogram, name, help, label_names,
                              buckets=buckets, sample_limit=sample_limit)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    # ------------------------------------------------------------- views
    def snapshot(self) -> Dict[str, dict]:
        """Nested plain-dict view of everything:
        {name: {"type", "help", "values": {label_key: value|hist}}}."""
        out: Dict[str, dict] = {}
        for fam in self.families():
            vals = {}
            for key, child in fam.children().items():
                if isinstance(child, HistogramChild):
                    vals[key] = child.to_dict()
                else:
                    vals[key] = child.value
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "values": vals}
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4)."""
        lines: List[str] = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for child in fam.children().values():
                pairs = [f'{n}="{_escape_label(v)}"'
                         for n, v in zip(fam.label_names,
                                         child.label_values)]
                base = "{" + ",".join(pairs) + "}" if pairs else ""
                if isinstance(child, HistogramChild):
                    d = child.to_dict()
                    for le, cum in d["buckets"].items():
                        bp = pairs + [f'le="{le}"']
                        lines.append(f"{fam.name}_bucket{{{','.join(bp)}}}"
                                     f" {cum}")
                    lines.append(f"{fam.name}_sum{base} {d['sum']}")
                    lines.append(f"{fam.name}_count{base} {d['count']}")
                else:
                    lines.append(f"{fam.name}{base} {child.value}")
        return "\n".join(lines) + "\n"


_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-default registry every component falls back to when
    no instance is injected. Tests that need isolation construct their
    own MetricsRegistry and pass it down instead of resetting this one
    (per-instance labels keep even the shared default exact)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT
