"""The traffic generator: a traffic file's parameters and a configuration
in, the cell's inputs out, all drawn from ``--seed``.

A traffic file names its ``feed``, a module ``feeds/<feed>.py`` with
``make(cfg, traffic, generator, device)`` (the ring of ``ring`` host
batches (features, labels)) and ``units_per_step(traffic)`` (the work of
one step in the traffic's ``units``). Every draw runs on the device from
a ``torch.Generator`` seeded with a sub-seed of the run's seed, in a few
large calls, and is then brought to the host once, since the program is
fed host arrays."""

from __future__ import annotations

import hashlib
import importlib
from typing import Dict, List, Tuple

import numpy as np
import torch


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose ("weights", "feed", ...) of a run's
    seed: any whole number gives a valid generator seed."""
    digest = hashlib.blake2b(f"{int(seed)}:{purpose}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def of(traffic: Dict):
    """The feed module a traffic file names."""
    return importlib.import_module(f"portbench.feeds.{traffic['feed']}")


def make_ring(cfg: Dict, traffic: Dict, seed: int,
              device) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The traffic's ring of host batches (features, labels) for
    ``seed``."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "feed"))
    return of(traffic).make(cfg, traffic, g, device)


def units_per_step(traffic: Dict) -> int:
    return of(traffic).units_per_step(traffic)
