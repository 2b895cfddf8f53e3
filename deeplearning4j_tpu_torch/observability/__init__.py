"""The serving tier's observability (the JAX package's ``observability/``):

- :mod:`.metrics` — :class:`MetricsRegistry` of labeled Counters,
  Gauges and fixed-bucket Histograms, with ``snapshot()`` and the
  Prometheus text exposition; the engine's, supervisor's, routes' and
  brokers' counters live here.
- :mod:`.tracing` — per-request :class:`Trace` timelines from consume to
  publish, carried across supervisor takeovers, and a :class:`TraceRing`
  of finished traces.
- :mod:`.slo` — :class:`SLOTracker`: deadline headroom, queue wait and
  TTFT per request, rolling-window attainment and burn rate.
- :mod:`.flightrec` — :class:`FlightRecorder`: a bounded event ring with
  post-mortem JSON artifacts.
- :mod:`.profiler` — :class:`PhaseProfiler`: per-block phases, bubbles
  and the roofline join.
- :mod:`.devstats` — device memory, exact KV-cache bytes and analytic
  per-program costs.
- :mod:`.integrity` — the numerics sentinel's config, the page
  verifier and the fleet's golden canary.
- :mod:`.telemetry` — :class:`TelemetryServer`: ``/metrics``,
  ``/snapshot``, ``/slo``, ``/profile``, ``/traces/recent`` and
  ``/healthz`` over HTTP.

Every duration derives from ONE interval clock, :func:`interval_now`
(``observability/clock.py``)."""

from .clock import interval_now
from .devstats import (DeviceStats, device_memory_snapshot,
                       impl_cost_analysis, kv_cache_stats)
from .flightrec import FlightRecorder, default_flight_recorder
from .integrity import (GoldenCanary, IntegrityConfig, NumericalFault,
                        PageVerifier, as_integrity, corrupt_host_frames,
                        logits_fault, page_content_checksum)
from .metrics import (Counter, DEFAULT_LATENCY_BUCKETS, Gauge, Histogram,
                      MetricsRegistry, default_registry, percentiles)
from .profiler import (EngineChannel, PhaseProfiler, PhaseTimeline,
                       default_profiler)
from .slo import SLORecord, SLOTracker, default_slo_tracker
from .telemetry import TelemetryServer
from .tracing import Span, Trace, TraceRing, default_trace_ring

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS", "default_registry", "percentiles",
    "Span", "Trace", "TraceRing", "default_trace_ring", "interval_now",
    "EngineChannel", "PhaseProfiler", "PhaseTimeline", "default_profiler",
    "SLORecord", "SLOTracker", "default_slo_tracker",
    "DeviceStats", "device_memory_snapshot", "impl_cost_analysis",
    "kv_cache_stats",
    "FlightRecorder", "default_flight_recorder",
    "IntegrityConfig", "NumericalFault", "PageVerifier", "as_integrity",
    "GoldenCanary", "TelemetryServer",
    "corrupt_host_frames", "logits_fault", "page_content_checksum",
]
