"""The yardstick's arithmetic: model operations per training step and the
least operations and bytes of the kernels a per-layer roofline reads,
worked out from a configuration file's published shapes and a traffic
file's sizes. Nothing here asks the program for a shape.

One module per architecture, ``costs/<architecture>.py``, found by the
configuration's ``architecture``; each has ``step_flops(cfg, traffic)``
and whatever least-time counts its metric readers take. The counting
rules are in each module (copied from the repository's smoke driver,
whose counts were checked there by hand). A matrix product of an
[m, k] by a [k, n] operand is 2·m·k·n operations everywhere."""

from __future__ import annotations

import importlib
from typing import Dict

BF16_BYTES = 2
F32_BYTES = 4


def of(cfg: Dict):
    """The cost module of ``cfg``'s architecture."""
    return importlib.import_module(f"portbench.costs.{cfg['architecture']}")


def step_flops(cfg: Dict, traffic: Dict) -> int:
    """Model operations of one training step of the cell."""
    return of(cfg).step_flops(cfg, traffic)
