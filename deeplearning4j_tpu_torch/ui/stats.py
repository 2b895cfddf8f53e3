"""Training-stats collection: the JAX package's ``ui/stats.py`` on the
port's nets (reference ui-model stats/BaseStatsListener.java: per
iteration score, timing, memory, parameter histograms, routed into a
StatsStorage).

Records are plain dicts (JSON-friendly) with the JAX package's keys and
values. The listener reads the device: the score once a reported
iteration, and on a histogram iteration the whole parameter table in one
copy a dtype, each counted under ``ui.stats`` (``ops.transfer``), so a
step with ``update_frequency`` 1 costs one readback, two on a histogram
step. :func:`profiler_trace` is ``torch.profiler`` (CPU and, where there
is one, CUDA activity) writing a Chrome trace."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.transfer import device_fetch
from ..optimize.listeners import IterationListener


def _histogram(arr: np.ndarray, bins: int = 20) -> Dict:
    arr = np.asarray(arr, np.float64).reshape(-1)
    if arr.size == 0:
        return {"bins": [], "counts": []}
    counts, edges = np.histogram(arr, bins=bins)
    return {"bins": edges.tolist(), "counts": counts.tolist()}


def _score(model) -> float:
    s = model.score_value
    return float(device_fetch(s, "ui.stats")) if torch.is_tensor(s) \
        else float(s)


def _param_table(model) -> Dict[str, np.ndarray]:
    """``model.param_table()``'s names and values, read back in one copy a
    dtype (``{}`` for a model without a parameter table)."""
    if not hasattr(model, "param_table"):
        return {}
    names = [(f"{i}_{k}", v) for i, p in enumerate(model.params)
             for k, v in sorted(p.items())]
    out: Dict[str, np.ndarray] = {}
    for dtype in dict.fromkeys(v.dtype for _, v in names):
        group = [(n, v) for n, v in names if v.dtype == dtype]
        flat = device_fetch(torch.cat([v.detach().reshape(-1)
                                       for _, v in group]), "ui.stats")
        offset = 0
        for n, v in group:
            out[n] = flat[offset:offset + v.numel()].reshape(tuple(v.shape))
            offset += v.numel()
    return {n: out[n] for n, _ in names}


class StatsListener(IterationListener):
    """Collect per-iteration stats into a StatsStorage router."""

    def __init__(self, storage, session_id: Optional[str] = None,
                 update_frequency: int = 1, histograms_frequency: int = 10,
                 collect_histograms: bool = True):
        self.storage = storage
        self.session_id = session_id or f"session_{int(time.time())}"
        self.update_frequency = max(1, int(update_frequency))
        self.histograms_frequency = max(1, int(histograms_frequency))
        self.collect_histograms = collect_histograms
        self._last_time = None
        self._init_reported = False

    def iteration_done(self, model, iteration: int):
        if iteration % self.update_frequency:
            return
        now = time.time()
        record: Dict = {
            "session": self.session_id,
            "type": "update",
            "iteration": iteration,
            "epoch": getattr(model, "epoch", 0),
            "timestamp": now,
            "score": _score(model),
        }
        if self._last_time is not None:
            dt = now - self._last_time
            record["iterations_per_sec"] = self.update_frequency / max(dt, 1e-9)
        self._last_time = now
        if not self._init_reported:
            self._init_reported = True
            self.storage.put_static_info({
                "session": self.session_id,
                "type": "init",
                "timestamp": now,
                "model_class": type(model).__name__,
                "num_params": model.num_params(),
                "num_layers": len(getattr(model, "layers", [])) or
                len(getattr(model.conf, "vertices", {})),
                "config_json": model.conf.to_json(indent=None),
            })
        if self.collect_histograms and \
                iteration % self.histograms_frequency == 0:
            params = _param_table(model)
            record["param_histograms"] = {k: _histogram(v)
                                          for k, v in params.items()}
            record["param_mean_magnitudes"] = {
                k: float(np.mean(np.abs(v))) for k, v in params.items()}
        try:
            import resource
            record["max_rss_mb"] = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1024.0
        except ImportError:             # no resource module (Windows)
            pass
        self.storage.put_update(record)


class SparkStyntheticPhaseTimer:
    """Per-phase timing (reference spark StatsCalculationHelper /
    SparkTrainingStats): time named phases of a distributed run, export a
    timeline."""

    def __init__(self):
        self.events: List[Dict] = []
        self._open: Dict[str, float] = {}

    def start(self, phase: str):
        self._open[phase] = time.time()

    def end(self, phase: str):
        t0 = self._open.pop(phase, None)
        if t0 is not None:
            self.events.append({"phase": phase, "start": t0,
                                "duration": time.time() - t0})

    def timeline(self) -> List[Dict]:
        return list(self.events)

    def export_html(self, path):
        rows = "".join(
            f"<tr><td>{e['phase']}</td><td>{e['start']:.3f}</td>"
            f"<td>{e['duration'] * 1000:.1f} ms</td></tr>"
            for e in self.events)
        with open(path, "w") as f:
            f.write("<html><body><h2>Phase timeline</h2><table border=1>"
                    "<tr><th>phase</th><th>start</th><th>duration</th></tr>"
                    f"{rows}</table></body></html>")


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write its Chrome trace to
    ``<log_dir>/trace.json``. Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
