"""The one interval clock of the serving tier (the JAX package's
``observability/tracing.py::interval_now``): request deadlines, the
latency estimates the scheduler reads, and the supervisor's heartbeats
are all differences of two readings of it."""

from __future__ import annotations

import time


def interval_now() -> float:
    """``time.perf_counter()``: monotonic and immune to wall-clock steps.
    Only differences of two readings mean anything."""
    return time.perf_counter()
