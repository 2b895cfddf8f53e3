"""Observability UI: the JAX package's ``ui/`` (reference
deeplearning4j-ui-parent): StatsListener → StatsStorage backends → the
web UI server and its remote push, the legacy listeners, the component
library and HTML reports. The listeners read the port's nets on their
device; :class:`JsonHTTPHandler` / :class:`BackgroundHTTPServer` also
carry the telemetry endpoint."""

from .stats import StatsListener, SparkStyntheticPhaseTimer, profiler_trace
from .storage import (StatsStorage, InMemoryStatsStorage, FileStatsStorage,
                      SqliteStatsStorage)
from .server import (BackgroundHTTPServer, JsonHTTPHandler, UIServer,
                     RemoteStatsRouter)
from .legacy_listeners import (HistogramIterationListener,
                               FlowIterationListener,
                               ConvolutionalIterationListener)
from .components import (ChartHistogram, ChartLine, ChartScatter,
                         ChartStackedArea, ChartTimeline, ComponentDiv,
                         ComponentTable, ComponentText, Style,
                         component_from_json, render_page)
from .report import (export_cluster_stats_html, export_stats_html,
                     training_report)

__all__ = ["StatsListener", "SparkStyntheticPhaseTimer", "profiler_trace",
           "StatsStorage", "InMemoryStatsStorage", "FileStatsStorage",
           "SqliteStatsStorage", "UIServer", "RemoteStatsRouter",
           "HistogramIterationListener", "FlowIterationListener",
           "ConvolutionalIterationListener",
           "ChartHistogram", "ChartLine", "ChartScatter",
           "ChartStackedArea", "ChartTimeline", "ComponentDiv",
           "ComponentTable", "ComponentText", "Style",
           "component_from_json", "render_page", "export_stats_html",
           "export_cluster_stats_html", "training_report",
           "BackgroundHTTPServer", "JsonHTTPHandler"]
