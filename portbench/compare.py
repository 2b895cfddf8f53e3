"""The comparison that decides ``correct`` for a training cell.

The numbers a cell compares are the keys of ``limits/<cell>.json``, each
held to its own limit there; of these:

- ``loss_gap``: the largest |program − reference| / |reference| over the
  check steps' losses;
- ``grad_gap``: over the leaves, the largest gap between the norm of the
  program's first gradient (as its optimizer got it) and the
  reference's, over the larger of the reference's norm of that leaf and
  of the median leaf; ``grad_gap_median``: the median leaf's such gap;
- ``change_gap``: the same of each leaf's change after the check steps
  (batch norm's running statistics as leaves of their own), leaving out
  the parameters whose reference gradient is under a thousandth of the
  median leaf's: those move by round-off alone; ``change_gap_median``:
  the median leaf's such gap.

Anything that is not a finite number fails its limit."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

#: a parameter whose reference gradient norm is under this share of the
#: median leaf's is left out of the change
NOUGHT = 1e-3


def leaf_gaps(got: Dict[str, float],
              want: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's |program − reference| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = statistics.median(want.values())
    return {k: abs(got.get(k, math.nan) - w) / max(w, med, 1e-30)
            for k, w in want.items()}


def _worst(got: Dict[str, float], want: Dict[str, float]) -> Tuple[float,
                                                                    str]:
    worst, leaf = 0.0, ""
    for k, gap in leaf_gaps(got, want).items():
        if not gap <= worst:          # a NaN gap is the worst
            worst, leaf = gap, k
            if math.isnan(gap):
                break
    return worst, leaf


def _median(got: Dict[str, float], want: Dict[str, float]) -> float:
    found = list(leaf_gaps(got, want).values())
    return math.nan if any(map(math.isnan, found)) else \
        statistics.median(found)


def gaps(got: Dict, want: Dict) -> Dict[str, Tuple[float, str]]:
    """{number: (value, where)} of the program's readings ``got`` against
    the reference's ``want`` (``train_readings``' layout)."""
    losses = [abs(g - w) / abs(w) for g, w in zip(got["losses"],
                                                  want["losses"])]
    worst_step = max(range(len(losses)), key=lambda i: (
        math.isnan(losses[i]), losses[i]))
    if len(got["losses"]) != len(want["losses"]):
        losses = [math.nan]
    med = statistics.median(want["grads"].values())
    kept = {k: v for k, v in want["change"].items()
            if want["grads"].get(k, math.inf) >= NOUGHT * med}
    return {"loss_gap": (max(losses, key=lambda x: (math.isnan(x), x)),
                         f"step {worst_step + 1}"),
            "grad_gap": _worst(got["grads"], want["grads"]),
            "grad_gap_median": (_median(got["grads"], want["grads"]),
                                "the median leaf"),
            "change_gap": _worst(got["change"], kept),
            "change_gap_median": (_median(got["change"], kept),
                                  "the median leaf")}


def checks(got: Dict, want: Dict, limits: Dict[str, float]) -> Dict:
    """{number: {"value", "limit", "at"}} in the order of ``limits``."""
    found = gaps(got, want)
    return {name: {"value": found[name][0], "limit": limit,
                   "at": found[name][1]}
            for name, limit in limits.items()}


def correct(checked: Dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checked.values())
