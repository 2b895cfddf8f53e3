"""What the per-layer metric readers share. Shares are in percent."""

from __future__ import annotations

import re


def kernel_seconds(ctx, pattern: str) -> float:
    """Device seconds of the traced kernels whose name matches
    ``pattern``."""
    rx = re.compile(pattern)
    return sum(s for name, s in ctx.trace["kernels"] if rx.search(name))


def roofline(ctx, bound_s_per_step: float, pattern: str):
    """The least time of the traced steps' kernels of one layer over
    their device time, in percent; None where no such kernel ran."""
    spent = kernel_seconds(ctx, pattern)
    if spent <= 0.0:
        return None
    return 100.0 * bound_s_per_step * ctx.trace["steps"] / spent
