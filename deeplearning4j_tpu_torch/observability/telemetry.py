"""The live serving-telemetry endpoint (the JAX package's
``observability/telemetry.py``).

:class:`TelemetryServer` is a background HTTP server
(``ui/server.py``'s :class:`JsonHTTPHandler` and
:class:`BackgroundHTTPServer`) over the observability of a running
serving process:

- ``GET /metrics``        — the registry's Prometheus text exposition;
- ``GET /snapshot``       — one JSON document: the registry snapshot,
  per-tag device→host readbacks since the server started
  (``ops.transfer.fetch_counts``) beside the host→device transfers
  staged through pinned memory or taken directly (``h2d.staged``,
  ``h2d.staged_bytes``, ``h2d.direct``: ``ops.transfer.stage_counts``),
  with ``audit_compiles=True`` the
  kernel builds since start (``kernels.cuda_lib.nvcc_runs()``, the port's
  counterpart of the JAX compile audit), the device stats (memory,
  per-engine KV bytes, per-program analytic cost from
  ``devstats.impl_cost_analysis``), the flight-recorder, SLO and
  profiler summaries, and every registered source;
- ``GET /slo``            — the SLO tracker's document;
- ``GET /profile``        — the phase profiler (``?timeline=N`` for the
  last N timeline entries);
- ``GET /traces/recent``  — finished traces as JSON (``?n=`` limits the
  count, ``?status=`` filters; ``failed`` matches every ``failed:*``);
- ``GET /healthz``        — liveness.

Every endpoint renders from state the serving path already keeps;
nothing reads the device. Sources are callables evaluated per request
and guarded: a dying engine degrades the snapshot, not the endpoint.

    srv = TelemetryServer(port=0).add_source(
        "generation", engine.stats).start()
    print(srv.url)
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from ..ui.server import BackgroundHTTPServer, JsonHTTPHandler
from .devstats import DeviceStats
from .flightrec import FlightRecorder, default_flight_recorder
from .metrics import MetricsRegistry, default_registry
from .profiler import PhaseProfiler, default_profiler
from .slo import SLOTracker, default_slo_tracker
from .tracing import TraceRing, default_trace_ring


class _TelemetryHandler(JsonHTTPHandler):
    """Per-TelemetryServer handler subclass (``server_obj`` is bound by
    ``TelemetryServer.start`` via ``type()``, so several telemetry
    servers in one process never share state the way a class attribute
    would)."""

    server_obj: "TelemetryServer" = None

    def do_GET(self):
        srv = type(self).server_obj
        url = urlparse(self.path)
        if srv is None:
            self._json({"error": "server detached"}, code=503)
        elif url.path == "/metrics":
            self._text(srv.registry.render_prometheus(),
                       "text/plain; version=0.0.4")
        elif url.path == "/snapshot":
            self._json(srv.snapshot())
        elif url.path == "/slo":
            self._json(srv.slo_tracker.snapshot())
        elif url.path == "/profile":
            q = parse_qs(url.query)
            try:
                tl = int(q.get("timeline", ["0"])[0]) or None
            except ValueError:
                tl = None
            self._json(srv.profiler.snapshot(timeline_n=tl))
        elif url.path == "/traces/recent":
            q = parse_qs(url.query)
            try:
                n = int(q.get("n", ["0"])[0]) or None
            except ValueError:
                n = None
            status = (q.get("status", [None])[0] or None)
            if status is None:
                traces = srv.trace_store.recent(n)
            else:
                # filter BEFORE the count cut, so ?n=5&status=failed is
                # "the last 5 failures", not "failures among the last 5";
                # bare "failed" covers every failed:<ExcType> status
                traces = [t for t in srv.trace_store.recent(None)
                          if t.status == status or
                          (t.status or "").startswith(status + ":")]
                if n is not None:
                    traces = traces[-n:]
            self._json({"count": len(traces),
                        "total_completed": srv.trace_store.total_added,
                        "traces": [t.to_dict() for t in traces]})
        elif url.path == "/healthz":
            self._json({"ok": True, "uptime_s": round(srv.uptime, 3)})
        else:
            self._json({"error": "not found", "endpoints": [
                "/metrics", "/snapshot", "/slo", "/profile",
                "/traces/recent", "/healthz"]}, code=404)


def _transfer_counts() -> Dict[str, int]:
    """The readback counters by tag and the stage counters as ``h2d.*``."""
    from ..ops.transfer import fetch_counts, stage_counts
    out = fetch_counts()
    out.update({f"h2d.{k}": c for k, c in stage_counts().items()})
    return out


class TelemetryServer:
    """Background telemetry endpoint over a registry and a trace ring.

    ``audit_compiles=True`` adds the kernel builds (nvcc runs) since the
    server started to ``/snapshot``: after warmup a serving process
    builds nothing."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 trace_store: Optional[TraceRing] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 audit_compiles: bool = False,
                 slo_tracker: Optional[SLOTracker] = None,
                 devstats: Optional[DeviceStats] = None,
                 flight_recorder: Optional[FlightRecorder] = None,
                 profiler: Optional[PhaseProfiler] = None):
        # loopback by default: the endpoint is unauthenticated and
        # /snapshot and /traces expose serving internals
        self.registry = registry if registry is not None \
            else default_registry()
        self.trace_store = trace_store if trace_store is not None \
            else default_trace_ring()
        self.slo_tracker = slo_tracker if slo_tracker is not None \
            else default_slo_tracker()
        self.devstats = devstats if devstats is not None \
            else DeviceStats(registry=self.registry)
        self.flight_recorder = flight_recorder \
            if flight_recorder is not None else default_flight_recorder()
        self.profiler = profiler if profiler is not None \
            else default_profiler()
        self._http = BackgroundHTTPServer(None, host=host, port=port)
        self._sources: Dict[str, Callable[[], dict]] = {}
        self._audit_compiles = bool(audit_compiles)
        self._builds_start: Optional[int] = None
        self._transfer_start: Dict[str, int] = {}
        self._started_at: Optional[float] = None

    # ------------------------------------------------------------ wiring
    def add_source(self, name: str, fn: Callable[[], dict]
                   ) -> "TelemetryServer":
        """Register a snapshot source: any zero-argument callable that
        returns JSON-serializable data (an engine's or supervisor's
        ``stats``, a router's ``fleet_stats``, a broker's counters)."""
        self._sources[str(name)] = fn
        return self

    def add_engine(self, name: str, engine) -> "TelemetryServer":
        """An engine's ``stats()`` as a source plus its device stats (the
        KV-cache bytes gauge, its programs' cost in ``/snapshot``)."""
        self.add_source(name, engine.stats)
        self.devstats.attach_engine(name, engine)
        return self

    def start(self) -> "TelemetryServer":
        if self._started_at is not None:
            return self
        from ..kernels import cuda_lib
        self._transfer_start = _transfer_counts()
        if self._audit_compiles:
            self._builds_start = cuda_lib.nvcc_runs()
        handler = type("_BoundTelemetryHandler", (_TelemetryHandler,),
                       {"server_obj": self})
        self._http.handler_cls = handler
        self._http.start()
        self._started_at = time.monotonic()
        return self

    def stop(self) -> None:
        self._http.stop()
        self._started_at = None

    @property
    def port(self) -> int:
        return self._http.port

    @property
    def url(self) -> str:
        return self._http.url

    @property
    def uptime(self) -> float:
        if self._started_at is None:
            return 0.0
        return time.monotonic() - self._started_at

    # ------------------------------------------------------------- views
    def transfer_deltas(self) -> Dict[str, int]:
        """Per-tag ``device_fetch`` readbacks and the ``h2d.*`` stage
        counters since ``start()``."""
        now = _transfer_counts()
        return {t: c - self._transfer_start.get(t, 0)
                for t, c in sorted(now.items())
                if c - self._transfer_start.get(t, 0) > 0}

    def snapshot(self) -> dict:
        out = {
            "uptime_s": round(self.uptime, 3),
            "metrics": self.registry.snapshot(),
            "transfers": self.transfer_deltas(),
            "traces": {"completed": self.trace_store.total_added,
                       "ring": len(self.trace_store)},
        }
        if self._builds_start is not None:
            from ..kernels import cuda_lib
            out["compile_audit"] = {
                "nvcc_runs": cuda_lib.nvcc_runs(),
                "new_since_start": cuda_lib.nvcc_runs() - self._builds_start}
        try:
            out["devstats"] = self.devstats.snapshot()
        except Exception as e:   # noqa: BLE001 — degrade, don't 500
            out["devstats"] = {"error": f"{type(e).__name__}: {e}"[:200]}
        try:
            out["slo"] = self.slo_tracker.snapshot()
        except Exception as e:   # noqa: BLE001
            out["slo"] = {"error": f"{type(e).__name__}: {e}"[:200]}
        try:
            out["flightrec"] = self.flight_recorder.stats()
        except Exception as e:   # noqa: BLE001
            out["flightrec"] = {"error": f"{type(e).__name__}: {e}"[:200]}
        # the profiler's summary (the roofline join lives at /profile)
        try:
            out["profiler"] = self.profiler.summary()
        except Exception as e:   # noqa: BLE001
            out["profiler"] = {"error": f"{type(e).__name__}: {e}"[:200]}
        sources = {}
        for name, fn in self._sources.items():
            try:
                sources[name] = fn()
            except Exception as e:   # noqa: BLE001 — degrade, don't 500
                sources[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
        if sources:
            out["sources"] = sources
        return out
