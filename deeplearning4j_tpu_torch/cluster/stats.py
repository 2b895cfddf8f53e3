"""Cluster training phase stats (the JAX package's ``cluster/stats.py``;
reference spark/api/stats/SparkTrainingStats, the ParameterAveraging
master and worker stats, and StatsUtils' HTML timeline export)."""

from __future__ import annotations

import json
import time
from collections import defaultdict
from typing import Dict, List


class PhaseTimer:
    """Timestamps named phases (StatsCalculationHelper analog)."""

    def __init__(self):
        self.events: List[dict] = []
        self._open: Dict[str, float] = {}

    def start(self, phase: str) -> None:
        self._open[phase] = time.time()

    def end(self, phase: str) -> None:
        t0 = self._open.pop(phase, None)
        if t0 is not None:
            self.events.append({"phase": phase, "start": t0,
                                "duration_ms": (time.time() - t0) * 1e3})

    def __enter__(self):
        return self

    def phase(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                timer.start(name)

            def __exit__(self, *exc):
                timer.end(name)
        return _Ctx()


class ClusterTrainingStats:
    """Aggregated per-phase timings across splits/workers."""

    def __init__(self):
        self.timer = PhaseTimer()
        self.worker_events: List[dict] = []

    def add_worker_events(self, events: List[dict]) -> None:
        self.worker_events.extend(events)

    def get_keys(self) -> List[str]:
        keys = {e["phase"] for e in self.timer.events}
        keys |= {e["phase"] for e in self.worker_events}
        return sorted(keys)

    def get_value(self, key: str) -> List[float]:
        return [e["duration_ms"] for e in
                self.timer.events + self.worker_events if e["phase"] == key]

    def summary(self) -> Dict[str, dict]:
        acc = defaultdict(list)
        for e in self.timer.events + self.worker_events:
            acc[e["phase"]].append(e["duration_ms"])
        return {k: {"count": len(v), "total_ms": sum(v),
                    "mean_ms": sum(v) / len(v)} for k, v in acc.items()}

    def export_json(self, path) -> None:
        with open(path, "w") as f:
            json.dump({"master": self.timer.events,
                       "workers": self.worker_events,
                       "summary": self.summary()}, f, indent=2)

    def export_html(self, path) -> None:
        """Minimal timeline page (StatsUtils.exportStatsAsHtml analog)."""
        rows = []
        base = min((e["start"] for e in
                    self.timer.events + self.worker_events), default=0.0)
        for src, events in (("master", self.timer.events),
                            ("worker", self.worker_events)):
            for e in events:
                rows.append(
                    f"<tr><td>{src}</td><td>{e['phase']}</td>"
                    f"<td>{(e['start'] - base) * 1e3:.1f}</td>"
                    f"<td>{e['duration_ms']:.1f}</td></tr>")
        html = ("<html><body><h2>Cluster training timeline</h2>"
                "<table border=1><tr><th>source</th><th>phase</th>"
                "<th>t+ms</th><th>duration ms</th></tr>"
                + "".join(rows) + "</table></body></html>")
        with open(path, "w") as f:
            f.write(html)
