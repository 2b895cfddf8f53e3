"""Serving errors the engine raises into request handles (the JAX
package's ``parallel/faults.py``; the fault injector is not ported)."""

from __future__ import annotations

from typing import Optional


class RejectedError(RuntimeError):
    """Admission control shed the request (the pending queue was full);
    ``queue_depth`` is the depth observed at the decision."""

    def __init__(self, message: str, queue_depth: Optional[int] = None):
        super().__init__(message)
        self.queue_depth = queue_depth
