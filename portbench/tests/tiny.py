"""Tiny versions of the benchmark's cells for the CPU tests: the same
files, with the sizes under the configuration's and the traffic's
``tiny`` keys put in place of theirs, and the limits as committed.

The cells are those of ``BENCHMARK.json`` and of ``pending.json`` beside
this file: cells the harness carries whose program fault keeps them out
of ``BENCHMARK.json`` for now (PERF.md, Open questions)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from portbench import harness

PENDING = Path(__file__).resolve().parent / "pending.json"


def bench() -> dict:
    """``BENCHMARK.json`` with the pending cells' entries added."""
    merged = harness.benchmark()
    pending = json.loads(PENDING.read_text(encoding="utf-8"))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        merged[key] = merged[key] + pending[key]
    return merged


#: every cell the CPU tests run
CELLS = [w["name"] for w in bench()["workloads"]]


def cell(name: str, bench_=None) -> dict:
    """Cell ``name`` at its files' tiny sizes."""
    c = copy.deepcopy(harness.resolve(name, bench_ or bench()))
    for part in ("config", "traffic"):
        c[part].update(c[part].pop("tiny"))
    return c
