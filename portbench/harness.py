"""Cells by name: a workload of ``BENCHMARK.json`` resolved to its
configuration file, its traffic file (``traffic/<traffic>.json``), its
limits (``limits/<workload>.json``) and its metrics, each per-layer
metric to its reader (``metrics/<name>.py``, or ``metrics/<prefix>.py``
for all the metrics that share the name's part before its first dot);
then one run of it and the result line.

A traffic file's ``kind`` names the driver module that runs it
(``train`` → ``train.py``). Adding a cell, a configuration, a traffic
mix or a per-layer metric adds files and entries; no file here names
one."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
from pathlib import Path
from typing import Dict, List, Optional

from .compare import correct

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "deeplearning4j_tpu")


def load_json(path: Path) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def resolve(name: str, bench: Optional[Dict] = None) -> Dict:
    """Everything one cell needs, found by the names in ``bench``."""
    bench = bench or benchmark()
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def applies(metric):
        return name in metric.get("workloads", [name])

    return {
        "name": name,
        "chips": cell["chips"],
        "config": load_json(ROOT / conf["file"]),
        "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(HERE / "limits" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``, or where there is
    no such file, of ``metrics/<prefix>.py``, the prefix being the name
    before its first dot (``mfu.lm_train`` → ``mfu.py``)."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Context:
    """What a per-layer reader is given (see ``portbench/README.md``)."""
    config: Dict
    traffic: Dict
    window: Dict
    trace: Dict
    peak: Optional[Dict]


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".", 1)[0] for m in modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def run(cell: Dict, seed: int, seconds: float, traced: bool, device,
        t_process: float, device_info: Dict):
    """One run of ``cell`` (see :func:`resolve`): (the result line as a
    dict, ``checks`` last; where each compared number was read; the
    window's summary)."""
    driver = importlib.import_module(f"portbench.{cell['traffic']['kind']}")
    out = driver.run(cell, seed, seconds, traced, device, t_process)
    metrics = {}
    if traced:
        peak = load_json(HERE / "peaks.json").get(device_info["kind"])
        ctx = Context(cell["config"], cell["traffic"], out["window"],
                      out["trace"], peak)
        for m in cell["per_layer"]:
            value = _finite(reader(m["name"])(ctx))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    device_info = dict(device_info,
                       memory_peak_bytes=out.get("memory_peak_bytes", 0))
    if traced:
        device_info.update(busy_s=out["trace"]["busy_s"],
                           window_s=out["trace"]["window_s"])
    line = {"correct": correct(out["checks"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": device_info}
    if traced:
        line["breakdown"] = out["trace"]["breakdown"]
    line["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                      for k, c in out["checks"].items()}
    return line, {k: c["at"] for k, c in out["checks"].items()}, \
        out["window"]
