"""Standalone HTML training reports built from the component library:
the JAX package's ``ui/report.py``, the same host code (reference
StatsUtils.exportStatsAsHtml: StatsStorage sessions and
ClusterTrainingStats rendered into one self-contained HTML file)."""

from __future__ import annotations

from typing import Optional

from .components import (ChartHistogram, ChartLine, ChartTimeline,
                         ComponentDiv, ComponentTable, ComponentText,
                         render_page)


def training_report(storage, session: Optional[str] = None) -> ComponentDiv:
    """Component tree for one training session: score curve, throughput
    curve, last-iteration parameter histograms, summary table."""
    sessions = storage.list_sessions()
    if session is None:
        if not sessions:
            return ComponentDiv([ComponentText("no sessions recorded")])
        session = sessions[-1]
    updates = storage.get_updates(session)
    div = ComponentDiv([ComponentText(f"session {session}: "
                                      f"{len(updates)} updates")])
    iters = [u["iteration"] for u in updates if "score" in u]
    scores = [u["score"] for u in updates if "score" in u]
    if iters:
        div.add(ChartLine("Score vs iteration")
                .add_series("score", iters, scores))
    rate = [(u["iteration"], u["iterations_per_sec"]) for u in updates
            if "iterations_per_sec" in u]
    if rate:
        div.add(ChartLine("Iterations/sec")
                .add_series("it/s", [r[0] for r in rate],
                            [r[1] for r in rate]))
    hists = next((u for u in reversed(updates)
                  if "param_histograms" in u), None)
    if hists:
        for name in sorted(hists["param_histograms"]):
            h = hists["param_histograms"][name]
            bins, counts = h.get("bins", []), h.get("counts", [])
            chart = ChartHistogram(f"{name} (iter {hists['iteration']})")
            for i, c in enumerate(counts):
                if i + 1 < len(bins):
                    chart.add_bin(bins[i], bins[i + 1], c)
            div.add(chart)
    if updates:
        last = updates[-1]
        rows = [[k, last[k]] for k in sorted(last)
                if isinstance(last[k], (int, float, str))]
        div.add(ComponentTable(["field", "value"], rows))
    return div


def export_stats_html(storage, path, session: Optional[str] = None) -> str:
    """Write the session report as one self-contained HTML file and
    return the path (the exportStatsAsHtml contract)."""
    page = render_page(training_report(storage, session),
                       title="DL4J training report")
    with open(path, "w") as f:
        f.write(page)
    return str(path)


def cluster_stats_report(stats) -> ComponentDiv:
    """ClusterTrainingStats → phase timeline + summary table (the Spark
    stats HTML export role)."""
    div = ComponentDiv([ComponentText("cluster training phases")])
    events = stats.timer.events + stats.worker_events
    if events:
        t0 = min(e["start"] for e in events)
        by_phase = {}
        for e in events:
            by_phase.setdefault(e["phase"], []).append(
                (e["start"] - t0, e["start"] - t0 + e["duration_ms"] / 1e3,
                 f"{e['duration_ms']:.1f} ms"))
        tl = ChartTimeline("Phase timeline")
        for phase in sorted(by_phase):
            tl.add_lane(phase, by_phase[phase])
        div.add(tl)
    rows = [[k, v["count"], f"{v['total_ms']:.1f}",
             f"{v['mean_ms']:.2f}"]
            for k, v in sorted(stats.summary().items())]
    div.add(ComponentTable(["phase", "count", "total ms", "mean ms"],
                           rows))
    return div


def export_cluster_stats_html(stats, path) -> str:
    page = render_page(cluster_stats_report(stats),
                       title="DL4J cluster training stats")
    with open(path, "w") as f:
        f.write(page)
    return str(path)
